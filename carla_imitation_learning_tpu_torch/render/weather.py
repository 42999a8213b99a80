"""Weather: exponential distance fog toward the sky colour.

``out = color · e^(−β·z) + sky · (1 − e^(−β·z))``. The exact path applies it
after rasterization from the depth plane; the fast rollout kernel fuses the
same formula into its epilogue and shrinks ``far`` to the visibility limit,
so fog also culls geometry. (Procedural rain is not ported yet.)
"""

from __future__ import annotations

import torch


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
