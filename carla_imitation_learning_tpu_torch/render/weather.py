"""Weather: exponential distance fog toward the sky colour, and procedural
rain.

- Fog: ``out = color · e^(−β·z) + sky · (1 − e^(−β·z))``. The exact path
  applies it after rasterization from the depth plane; the fast rollout
  kernel fuses the same formula into its epilogue and shrinks ``far`` to
  the visibility limit, so fog also culls geometry.
- Rain: diagonal streaks keyed on (pixel, step) by an integer hash seeded
  with the env's key, plus an overcast darkening. Stateless: the same (key,
  t) gives the same rain, bit for bit the JAX package's.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def visibility_far(fog_density: float, far: float) -> float:
    """Distance beyond which transmittance < 1% — safe far plane under fog."""
    if fog_density <= 0.0:
        return far
    return min(far, 4.6 / fog_density)


def apply_fog(color: torch.Tensor, depth: torch.Tensor, sky: torch.Tensor,
              fog_density: float) -> torch.Tensor:
    """color (B, H, W) gray or (B, H, W, 3) rgb; depth (B, H, W) meters;
    sky broadcastable to color."""
    if fog_density <= 0.0:
        return color
    f = torch.exp(-fog_density * depth)
    if color.dim() == 4:
        f = f[..., None]
    return color * f + sky.expand_as(color) * (1.0 - f)


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x · c mod 2³² for x in [0, 2³²) held in int64, through the 16-bit
    halves of ``c`` so no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The xorshift-multiply integer hash of the JAX package's rain, on the
    low 32 bits of int64 ``x``; int64 in [0, 2³²)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def apply_rain(img: torch.Tensor, key: torch.Tensor, t: torch.Tensor,
               intensity: float) -> torch.Tensor:
    """Rain streaks and darkening on (B, H, W) gray or (B, H, W, 3) RGB
    frames. ``key`` (B, 2) is each env's key (its first word seeds the
    hash), ``t`` (B,) its step. One streak head per 24-row cell of a
    diagonal column, present with probability ~ intensity / 4, 6 px long,
    falling 4 px a step."""
    if intensity <= 0.0:
        return img
    B, H, W = img.shape[:3]
    dev = img.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    col = xx + yy // 3                                         # (H, W)
    phase = yy - 4 * t.to(torch.int64)[:, None, None]          # (B, H, 1)
    seed = key[:, 0].to(torch.int64)[:, None, None]
    h = _hash_u32(col * 9173 + torch.div(phase, 24, rounding_mode="floor") * 271 + seed)
    # the divisor lives on the device: CUDA turns a division by a host
    # scalar into a multiply by its reciprocal, off by an ulp from the
    # JAX package's quotient
    gate = (h & 0xFF).to(torch.float32) / torch.tensor(255.0, device=dev)
    streak = (gate < 0.25 * intensity) & (torch.remainder(phase, 24) < 6)
    drop = streak.to(torch.float32) * (0.35 + 0.4 * gate)
    base = img * (1.0 - 0.18 * intensity)
    if img.dim() == 4:
        drop = drop[..., None]
    return torch.clamp(base + drop * 0.8, 0.0, 1.0)
