"""Behavior-cloning CNN policy (the JAX package's ``models/cnn.py``).

Spatial arithmetic matches the JAX package exactly: VALID convs and floor
max-pools, with a SAME-padded conv when the map is smaller than its kernel
and a skipped pool when it is smaller than the window. Compute runs in
``dtype`` (bf16 by default) with float32 parameters and float32 logits.
The public call takes NHWC, the closed loop's frame-window layout; the
trunk permutes to NCHW inside and back before flattening, so the first
Dense layer sees the JAX package's feature order.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """Low/high padding of XLA's SAME rule for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


# reference ConvNet1 trunk (nets.py:17-30)
CHANNELS = (16, 32, 64, 128)
KERNELS = (7, 5, 4, 3)
STRIDES = (3, 1, 1, 1)
POOLS = (3, 2, 2, 2)


class ConvTrunk(nn.Module):
    """Conv→ReLU→MaxPool ×4 trunk: the reference ConvNet1's channels by
    default; ``DualStreamCNN`` passes its wider (32, 64, 128, 256)."""

    def __init__(self, in_channels: int = 4, dtype: torch.dtype = torch.bfloat16,
                 channels: Sequence[int] = CHANNELS):
        super().__init__()
        chans = (in_channels,) + tuple(channels)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], KERNELS[i], stride=STRIDES[i])
            for i in range(len(KERNELS)))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, features) in ``dtype``."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for conv, k, s, p in zip(self.convs, KERNELS, STRIDES, POOLS):
            h, w = x.shape[2], x.shape[3]
            if min(h, w) < k:
                ph, pw = _same_pads(h, k, s), _same_pads(w, k, s)
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype),
                                conv.bias.to(self.dtype), stride=s))
            if min(x.shape[2], x.shape[3]) >= p:
                x = F.max_pool2d(x, p, stride=p)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class MLPHead(nn.Module):
    """Dense→ReLU stack ending in logits of the parameters' dtype (float32;
    float64 when the module is cast to it for a reference)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dims = (in_features,) + tuple(features)
        self.layers = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                    for i in range(len(features)))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(F.linear(x.to(self.dtype), layer.weight.to(self.dtype),
                                layer.bias.to(self.dtype)))
        last = self.layers[-1]
        return F.linear(x.to(last.weight.dtype), last.weight, last.bias)


class PolicyCNN(nn.Module):
    """9-way discrete driving policy on a 4-frame grayscale stack:
    (B, H, W, obs_size) → (B, n_actions) float32 logits. The trunk flattens
    to 128 features for every input from 32² to 256² (its last map is 1×1)."""

    def __init__(self, obs_size: int = 4, n_actions: int = 9,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype)
        self.head = MLPHead(128, (64, 32, n_actions), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x))


class ContinuousPolicyCNN(nn.Module):
    """Continuous-control policy on the same trunk: (B, H, W, obs_size) →
    (B, 2) = tanh of a 128→64→32→2 head, column 0 the steer and column 1
    the signed acceleration (> 0 throttle, < 0 brake), each in [-1, 1] —
    the closed loop's ``control_space="continuous"`` contract. The state
    dict has ``PolicyCNN``'s names (a 2-way head)."""

    def __init__(self, obs_size: int = 4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype)
        self.head = MLPHead(128, (64, 32, 2), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.head(self.trunk(x)))


class DualStreamCNN(nn.Module):
    """Shared-trunk two-stream policy over raw and segmented frame stacks
    (reference ConvNetRawSegment): one (32, 64, 128, 256) trunk applied to
    both streams, the features summed, then a 256→200→48→n_actions head.
    ``(x, x_seg)`` each (B, H, W, obs_size) → (B, n_actions) float32 logits."""

    def __init__(self, obs_size: int = 4, n_actions: int = 9,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype, channels=(32, 64, 128, 256))
        self.head = MLPHead(256, (200, 48, n_actions), dtype=dtype)

    def forward(self, x: torch.Tensor, x_seg: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x) + self.trunk(x_seg))
