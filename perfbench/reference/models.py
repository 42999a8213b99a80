"""The two policies in plain PyTorch: float32 arithmetic (or an emulated
lower precision for the control), no kernels of the port.

Both take the closed loop's NHWC frame window (B, H, W, C) in [0, 1] and
return (B, n_actions) logits. Parameter names follow the port's state
dicts, so the benchmark hands both sides one dict of weights.

- ``ConvNet1``: the reference repository's ConvNet1
  (HemuManju/carla-imitation-learning ``src/architectures/nets.py``): four
  VALID convolutions (16/32/64/128 channels, kernels 7/5/4/3, strides
  3/1/1/1), each followed by ReLU and a floor max-pool (3/2/2/2) that is
  skipped when the map is smaller than its window; a convolution whose
  input is smaller than its kernel is SAME-padded (XLA's rule). Then
  128→64→32→9 dense layers, ReLU between.
- ``ViT``: DeiT-Ti/16 widths (Touvron et al. 2021, Table 1): a patch
  convolution, learned positions on a 16² grid resized to the token grid
  with antialiased bilinear interpolation, pre-LN blocks (LayerNorm with
  epsilon 1e-6, three-head attention, tanh-GELU MLP of 4× width), a mean
  over tokens, a last LayerNorm and the 9-way head.

``precision="fp8"`` rounds the inputs and weights of every convolution and
matrix product to float8 e4m3 (scaled per tensor to its largest value)
before computing in float32: the control's precision for a policy served
in bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CHANNELS = (16, 32, 64, 128)
KERNELS = (7, 5, 4, 3)
STRIDES = (3, 1, 1, 1)
POOLS = (3, 2, 2, 2)
FP8_MAX = 448.0


def _low(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def convnet1_shapes(obs_size: int = 4, n_actions: int = 9) -> dict:
    """Parameter name → (shape, fan-in or None for a bias)."""
    out, chans = {}, (obs_size,) + CHANNELS
    for i, k in enumerate(KERNELS):
        out[f"trunk.convs.{i}.weight"] = ((chans[i + 1], chans[i], k, k), chans[i] * k * k)
        out[f"trunk.convs.{i}.bias"] = ((chans[i + 1],), None)
    dims = (128, 64, 32, n_actions)
    for i in range(3):
        out[f"head.layers.{i}.weight"] = ((dims[i + 1], dims[i]), dims[i])
        out[f"head.layers.{i}.bias"] = ((dims[i + 1],), None)
    return out


def convnet1(w: dict, x: torch.Tensor, precision: str = "fp32", **_) -> torch.Tensor:
    h = x.to(torch.float32).permute(0, 3, 1, 2)
    for i, (k, s, p) in enumerate(zip(KERNELS, STRIDES, POOLS)):
        if min(h.shape[2], h.shape[3]) < k:
            ph, pw = _same_pads(h.shape[2], k, s), _same_pads(h.shape[3], k, s)
            h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
        h = F.relu(F.conv2d(_low(h, precision), _low(w[f"trunk.convs.{i}.weight"], precision),
                            w[f"trunk.convs.{i}.bias"], stride=s))
        if min(h.shape[2], h.shape[3]) >= p:
            h = F.max_pool2d(h, p, stride=p)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    for i in range(3):
        h = F.linear(_low(h, precision), _low(w[f"head.layers.{i}.weight"], precision),
                     w[f"head.layers.{i}.bias"])
        if i < 2:
            h = F.relu(h)
    return h


def vit_shapes(obs_size: int = 4, n_actions: int = 9, patch: int = 16, dim: int = 192,
               depth: int = 12, heads: int = 3, mlp_ratio: int = 4, pos_grid: int = 16) -> dict:
    """Parameter name → (shape, fan-in, or None for a bias, or "ln_weight",
    "ln_bias", or ("normal", std))."""
    out = {"patch_embed.weight": ((dim, obs_size, patch, patch), obs_size * patch * patch),
           "patch_embed.bias": ((dim,), None),
           "pos_emb": ((pos_grid, pos_grid, dim), ("normal", 0.02))}
    hidden = dim * mlp_ratio
    for b in range(depth):
        pre = f"blocks.{b}."
        for ln in ("ln1", "ln2"):
            out[pre + ln + ".weight"] = ((dim,), "ln_weight")
            out[pre + ln + ".bias"] = ((dim,), "ln_bias")
        for name, (o, i) in (("query", (dim, dim)), ("key", (dim, dim)), ("value", (dim, dim)),
                             ("out", (dim, dim)), ("fc1", (hidden, dim)), ("fc2", (dim, hidden))):
            out[pre + name + ".weight"] = ((o, i), i)
            out[pre + name + ".bias"] = ((o,), None)
    out["norm.weight"] = ((dim,), "ln_weight")
    out["norm.bias"] = ((dim,), "ln_bias")
    out["head.weight"] = ((n_actions, dim), dim)
    out["head.bias"] = ((n_actions,), None)
    return out


def _layer_norm(x, weight, bias, eps: float = 1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def vit(w: dict, x: torch.Tensor, patch: int = 16, dim: int = 192, depth: int = 12,
        heads: int = 3, precision: str = "fp32", **_) -> torch.Tensor:
    b, hgt, wid, _c = x.shape
    if hgt % patch or wid % patch:
        raise ValueError("the reference ViT takes sides that are multiples of the patch")

    def dense(h, name):
        return F.linear(_low(h, precision), _low(w[name + ".weight"], precision),
                        w[name + ".bias"])

    h = F.conv2d(_low(x.to(torch.float32).permute(0, 3, 1, 2), precision),
                 _low(w["patch_embed.weight"], precision), w["patch_embed.bias"], stride=patch)
    gh, gw = h.shape[2], h.shape[3]
    pos = w["pos_emb"]
    if (gh, gw) != tuple(pos.shape[:2]):
        pos = F.interpolate(pos.permute(2, 0, 1)[None], size=(gh, gw), mode="bilinear",
                            align_corners=False, antialias=True)[0].permute(1, 2, 0)
    h = (h.permute(0, 2, 3, 1) + pos).reshape(b, gh * gw, dim)
    hd = dim // heads
    for i in range(depth):
        pre = f"blocks.{i}."
        a = _layer_norm(h, w[pre + "ln1.weight"], w[pre + "ln1.bias"])
        q, k, v = (dense(a, pre + n).view(b, -1, heads, hd).transpose(1, 2)
                   for n in ("query", "key", "value"))
        att = torch.softmax(_low(q, precision) @ _low(k, precision).transpose(-1, -2)
                            / math.sqrt(hd), -1)
        o = (_low(att, precision) @ _low(v, precision)).transpose(1, 2).reshape(b, -1, dim)
        h = h + dense(o, pre + "out")
        m = _layer_norm(h, w[pre + "ln2.weight"], w[pre + "ln2.bias"])
        h = h + dense(F.gelu(dense(m, pre + "fc1"), approximate="tanh"), pre + "fc2")
    pooled = _layer_norm(h.mean(1), w["norm.weight"], w["norm.bias"])
    return dense(pooled, "head")


ARCHS = {"convnet1": (convnet1_shapes, convnet1), "vit": (vit_shapes, vit)}
