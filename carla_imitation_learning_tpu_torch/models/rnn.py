"""Recurrent cells with flax's parameter layout and arithmetic.

``LSTMCell`` is flax's ``OptimizedLSTMCell``: input kernels ``ii``,
``if``, ``ig``, ``io`` without bias, hidden kernels ``hi``, ``hf``,
``hg``, ``ho`` with bias, the carry (c, h) starting at zeros and no
forget-gate offset. ``GRUCell`` is flax's ``GRUCell``: input kernels
``ir``, ``iz``, ``in`` each with a bias, hidden kernels ``hr``, ``hz``
without and ``hn`` with one, so n = tanh(in(x) + r · hn(h)); torch's own
GRU cell adds hidden biases to r and z, which flax does not have.

Kernels are stored as flax stores them, (in, out), the gates side by side
along the last axis in the order above. A cell computes in ``dtype`` (None:
the parameters' dtype) as flax's ``Dense`` does, a product then its bias;
the carry keeps its own dtype, so under bf16 compute the GRU's
``(1 − z) · n + z · h`` stays float32 for a float32 carry.
"""

from __future__ import annotations

import torch
from torch import nn


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           dtype: torch.dtype) -> torch.Tensor:
    y = x.to(dtype) @ w.to(dtype)
    return y if b is None else y + b.to(dtype)


class LSTMCell(nn.Module):
    flax_kernels = ("w_i",)
    flax_orthogonal = ("w_h",)
    flax_biases = ("b_h",)

    def __init__(self, in_features: int, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.w_i = nn.Parameter(torch.zeros(in_features, 4 * features))
        self.w_h = nn.Parameter(torch.zeros(features, 4 * features))
        self.b_h = nn.Parameter(torch.zeros(4 * features))

    def initial_state(self, batch: int, device=None):
        z = torch.zeros(batch, self.features, dtype=self.w_h.dtype, device=device)
        return z, z.clone()

    def forward(self, carry, x: torch.Tensor):
        """((c, h), x) → ((c', h'), h')."""
        c, h = carry
        dt = self.dtype or self.w_h.dtype
        gates = _dense(h, self.w_h, self.b_h, dt) + _dense(x, self.w_i, None, dt)
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class GRUCell(nn.Module):
    flax_kernels = ("w_i",)
    flax_orthogonal = ("w_h",)
    flax_biases = ("b_i", "b_hn")

    def __init__(self, in_features: int, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.w_i = nn.Parameter(torch.zeros(in_features, 3 * features))
        self.b_i = nn.Parameter(torch.zeros(3 * features))
        self.w_h = nn.Parameter(torch.zeros(features, 3 * features))
        self.b_hn = nn.Parameter(torch.zeros(features))

    def initial_state(self, batch: int, device=None):
        return torch.zeros(batch, self.features, dtype=self.w_h.dtype, device=device)

    def forward(self, h: torch.Tensor, x: torch.Tensor):
        """(h, x) → (h', h')."""
        dt = self.dtype or self.w_h.dtype
        n_h = self.features
        xi = _dense(x, self.w_i, self.b_i, dt)
        hh = _dense(h, self.w_h, None, dt)
        r = torch.sigmoid(xi[..., :n_h] + hh[..., :n_h])
        z = torch.sigmoid(xi[..., n_h:2 * n_h] + hh[..., n_h:2 * n_h])
        n = torch.tanh(xi[..., 2 * n_h:] + r * (hh[..., 2 * n_h:] + self.b_hn.to(dt)))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h
