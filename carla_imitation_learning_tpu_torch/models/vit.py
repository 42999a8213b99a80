"""ViT driving policy (the JAX package's ``models/vit.py``): patchify →
pre-LN transformer → valid-fraction mean pool → logits.

Written out as flax computes it, so that bf16 rounding takes the same
steps:

- LayerNorm as flax's: epsilon 1e-6, the variance as E[x²] − E[x]²
  (clipped at 0), statistics and output in at least float32;
- attention as flax's ``MultiHeadDotProductAttention``: query, key and
  value are a product then a bias in ``dtype``, the query divided by
  √head_dim before the logits, the softmax in ``dtype`` (exp of the
  max-shifted logits over their sum), the output projection over (heads,
  head_dim). The projections are ``nn.Linear`` over the flattened (heads,
  head_dim) axis; ``convert`` reshapes flax's (dim, heads, head_dim)
  kernels;
- the MLP's GELU is the tanh approximation (flax's ``nn.gelu`` default);
- the position embeddings live on a ``pos_grid``² grid and are resized to
  the token grid with antialiased bilinear interpolation, as
  ``jax.image.resize(..., "bilinear")`` does, so a 256²-trained policy
  runs on the 128² rollout camera;
- an input whose sides are not multiples of ``patch`` is zero-padded up,
  and each token's weight in the pool is its share of real pixels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fast variance, epsilon 1e-6,
    computed and returned in the wider of the input's dtype and float32
    (the parameters' dtype for a float64 reference)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(self.weight.dtype, torch.float32))
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: the product in ``dtype``, then the bias."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, dim // heads, dtype
        self.ln1, self.ln2 = LayerNorm(dim), LayerNorm(dim)
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.out = nn.Linear(dim, dim)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def attention(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b, n, _ = h.shape
        q, k, v = (_dense(h, layer, dt).view(b, n, self.heads, self.head_dim)
                   for layer in (self.query, self.key, self.value))
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=torch.float32,
                             device=q.device).to(dt)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        e = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
        weights = e / e.sum(-1, keepdim=True)
        att = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, -1)
        return _dense(att, self.out, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + self.attention(self.ln1(x).to(dt))
        h = F.gelu(_dense(self.ln2(x).to(dt), self.fc1, dt), approximate="tanh")
        return x + _dense(h, self.fc2, dt)


class ViTPolicy(nn.Module):
    """(B, H, W, obs_size) float [0, 1] → (B, n_actions) logits in the
    parameters' dtype (float32)."""

    flax_normal = {"pos_emb": 0.02}

    def __init__(self, obs_size: int = 4, n_actions: int = 9, patch: int = 16,
                 dim: int = 192, depth: int = 4, heads: int = 3, mlp_ratio: int = 4,
                 pos_grid: int = 16, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.patch, self.dim, self.pos_grid, self.dtype = patch, dim, pos_grid, dtype
        self.patch_embed = nn.Conv2d(obs_size, dim, patch, stride=patch)
        self.pos_emb = nn.Parameter(torch.zeros(pos_grid, pos_grid, dim))
        self.blocks = nn.ModuleList(TransformerBlock(dim, heads, mlp_ratio, dtype)
                                    for _ in range(depth))
        self.norm = LayerNorm(dim)
        self.head = nn.Linear(dim, n_actions)

    def pos_for(self, gh: int, gw: int) -> torch.Tensor:
        """The (gh, gw, dim) position embeddings of a token grid."""
        pos = self.pos_emb
        if (gh, gw) == (self.pos_grid, self.pos_grid):
            return pos
        return F.interpolate(pos.permute(2, 0, 1)[None], size=(gh, gw), mode="bilinear",
                             align_corners=False, antialias=True)[0].permute(1, 2, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p, dt = self.patch, self.dtype
        ph, pw = -h % p, -w % p
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.patch_embed.weight.to(dt), stride=p)
        x = x.permute(0, 2, 3, 1) + self.patch_embed.bias.to(dt)
        gh, gw = x.shape[1], x.shape[2]
        x = (x + self.pos_for(gh, gw).to(dt)).reshape(b, gh * gw, self.dim)
        for block in self.blocks:
            x = block(x)
        if ph or pw:
            wh = torch.clamp((h - torch.arange(gh, device=x.device) * p) / p, 0.0, 1.0)
            ww = torch.clamp((w - torch.arange(gw, device=x.device) * p) / p, 0.0, 1.0)
            wt = (wh[:, None] * ww[None, :]).reshape(1, gh * gw, 1)
            pooled = (x * wt.to(dt)).sum(1).to(torch.promote_types(dt, wt.dtype)) / wt.sum()
        else:
            pooled = x.mean(1)
        out = self.norm(pooled)
        return F.linear(out.to(self.head.weight.dtype), self.head.weight, self.head.bias)
