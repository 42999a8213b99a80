"""Behavior-cloning CNN policy (the JAX package's ``models/cnn.py``).

Spatial arithmetic matches the JAX package exactly: VALID convs and floor
max-pools, with a SAME-padded conv when the map is smaller than its kernel
and a skipped pool when it is smaller than the window. Compute runs in
``dtype`` (bf16 by default) with float32 parameters and float32 logits.
The public call takes NHWC, the closed loop's frame-window layout; the
trunk permutes to NCHW inside and back before flattening, so the first
Dense layer sees the JAX package's feature order.

``s2d_stem=True`` gives the first conv its space-to-depth form: the input
is zero-padded so the k7/s3 window extends to 9×9, 3×3 blocks fold into
channels (C → 9C), and the conv becomes k3/s1 VALID on the folded layout
(``s2d_stem_kernel`` converts standard-stem weights exactly).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(conv: nn.Module, x: torch.Tensor, stride: int, dtype: torch.dtype,
           s2d_inverse: bool = False) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d`` without padding) on NCHW ``x`` in ``dtype``,
    its weight first unfolded by ``s2d_stem_kernel_inverse`` when
    ``s2d_inverse``. Any other module is an int8 layer of
    ``serving/quant.py``, called on ``x`` as it comes: it returns float32."""
    if not isinstance(conv, nn.Conv2d):
        return conv(x, stride, s2d_inverse)
    weight = s2d_stem_kernel_inverse(conv.weight) if s2d_inverse else conv.weight
    return F.conv2d(x, weight.to(dtype), conv.bias.to(dtype), stride=stride)


def linear(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``layer`` (an ``nn.Linear``) on ``x`` with input, weight and bias cast to
    ``dtype`` (None: the weight's own). Any other module is an int8 layer of
    ``serving/quant.py``, called on ``x`` uncast: it returns float32."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    dt = layer.weight.dtype if dtype is None else dtype
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


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


def space_to_depth_stem_input(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, (H+2)//3, (W+2)//3, 9C) for H, W ≥ 7: zero-pad so
    a stride-3 9×9 window tiles exactly, then fold 3×3 blocks into channels
    in (row, column, channel) order. A k7/s3 VALID conv on ``x`` equals a
    k3/s1 VALID conv on this layout with ``s2d_stem_kernel``'s weight."""
    b, h, w, c = x.shape
    out_h, out_w = (h - 7) // 3 + 1, (w - 7) // 3 + 1
    hp, wp = 3 * (out_h - 1) + 9, 3 * (out_w - 1) + 9
    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x = x.reshape(b, hp // 3, 3, wp // 3, 3, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp // 3, wp // 3, 9 * c)


def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """Exact weight transform for the space-to-depth stem: a (O, C, 7, 7)
    conv weight → (O, 9C, 3, 3). The kernel is zero-padded to 9×9 (the
    padded taps meet the input's zero padding) and its 3×3 tap blocks fold
    into the input channels in ``space_to_depth_stem_input``'s order."""
    o, c = w7.shape[:2]
    k9 = F.pad(w7, (0, 2, 0, 2)).reshape(o, c, 3, 3, 3, 3)   # (o, c, a, p, b, q)
    return k9.permute(0, 3, 5, 1, 2, 4).reshape(o, 9 * c, 3, 3)


def s2d_stem_kernel_inverse(w3: torch.Tensor) -> torch.Tensor:
    """(O, 9C, 3, 3) space-to-depth stem weight → the (O, C, 7, 7) standard
    weight it folds (its taps beyond 7 × 7, which only meet zero padding,
    dropped): the first conv of an s2d trunk on a map smaller than 7."""
    o, c = w3.shape[0], w3.shape[1] // 9
    k9 = w3.reshape(o, 3, 3, c, 3, 3).permute(0, 3, 4, 1, 5, 2).reshape(o, c, 9, 9)
    return k9[:, :, :7, :7]


def convert_params_to_s2d(state_dict: dict, prefix: str = "trunk.") -> dict:
    """A standard-stem policy state dict → the ``s2d_stem`` variant's (the
    first conv's weight folded, everything else shared): checkpoint
    migration without retraining."""
    out = dict(state_dict)
    key = f"{prefix}convs.0.weight"
    out[key] = s2d_stem_kernel(state_dict[key])
    return out


class ConvTrunk(nn.Module):
    """Conv→ReLU→MaxPool ×4 trunk: the reference ConvNet1's channels by
    default; ``DualStreamCNN`` passes its wider (32, 64, 128, 256).
    ``s2d_stem`` makes the first conv the space-to-depth stem (weight
    (16, 9C, 3, 3) under the same state-dict name); on a map smaller than
    the k7 kernel it runs the standard SAME conv with the weight unfolded,
    as the JAX package falls back to the standard stem there."""

    def __init__(self, in_channels: int = 4, dtype: torch.dtype = torch.bfloat16,
                 channels: Sequence[int] = CHANNELS, s2d_stem: bool = False):
        super().__init__()
        chans = (in_channels,) + tuple(channels)
        self.s2d_stem = s2d_stem
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], KERNELS[i], stride=STRIDES[i])
            for i in range(len(KERNELS)))
        if self.s2d_stem:
            self.convs[0] = nn.Conv2d(9 * in_channels, chans[1], 3)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, features) in ``dtype``."""
        x = x.to(self.dtype)
        fold = self.s2d_stem and min(x.shape[1], x.shape[2]) >= KERNELS[0]
        if fold:
            x = space_to_depth_stem_input(x)
        x = x.permute(0, 3, 1, 2)
        for li, (conv, k, s, p) in enumerate(zip(self.convs, KERNELS, STRIDES, POOLS)):
            if li == 0 and fold:
                k, s = 3, 1
            h, w = x.shape[2], x.shape[3]
            if min(h, w) < k:
                ph, pw = _same_pads(h, k, s), _same_pads(w, k, s)
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            unfold = li == 0 and self.s2d_stem and not fold
            x = F.relu(conv2d(conv, x, s, self.dtype, s2d_inverse=unfold))
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
            x = F.relu(linear(layer, x, self.dtype))
        return linear(self.layers[-1], x)


class PolicyCNN(nn.Module):
    """9-way discrete driving policy on a 4-frame grayscale stack:
    (B, H, W, obs_size) → (B, n_actions) float32 logits. The trunk flattens
    to 128 features for every input from 32² to 256² (its last map is 1×1);
    ``s2d_stem`` is the trunk's space-to-depth first conv."""

    def __init__(self, obs_size: int = 4, n_actions: int = 9,
                 dtype: torch.dtype = torch.bfloat16, s2d_stem: bool = False):
        super().__init__()
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype, s2d_stem=s2d_stem)
        self.head = MLPHead(128, (64, 32, n_actions), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x))


class ContinuousPolicyCNN(nn.Module):
    """Continuous-control policy on the same trunk: (B, H, W, obs_size) →
    (B, 2) = tanh of a 128→64→32→2 head, column 0 the steer and column 1
    the signed acceleration (> 0 throttle, < 0 brake), each in [-1, 1] —
    the closed loop's ``control_space="continuous"`` contract. The state
    dict has ``PolicyCNN``'s names (a 2-way head)."""

    def __init__(self, obs_size: int = 4, dtype: torch.dtype = torch.bfloat16,
                 s2d_stem: bool = False):
        super().__init__()
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype, s2d_stem=s2d_stem)
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
