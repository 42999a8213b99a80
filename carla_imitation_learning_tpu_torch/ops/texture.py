"""Procedural surface textures: a multiplicative shading factor per pixel.

Projection emits two extra interpolation rows per triangle (``unum``,
``vnum``, built like the depth numerator — render/camera.py), so a pixel's
perspective-correct surface point is ``u = unum·p / den``, ``v = vnum·p /
den``. ``texture_factor`` turns (u, v, class) into the factor:

- SEM_BUILDING walls (u = world x + y, v = world z): a window grid, 0.55 in
  a window and 1.05 on the wall;
- SEM_ROAD / SEM_TERRAIN (u, v = world x, y): a per-cell hash speckle;
- every other class: 1.0.

This is the plain PyTorch definition. Kernel A's textured variant
(``csrc/raster_exact.cu``) repeats it operation for operation, with
``floorf`` and the accurate ``sinf``, so that on the card the two agree bit
for bit. The expression order follows the JAX package's
``ops/texture.py`` so that both compute the same hash.
"""

from __future__ import annotations

import torch

from carla_imitation_learning_tpu_torch.render.geometry import (
    SEM_BUILDING, SEM_ROAD, SEM_TERRAIN,
)

# Window grid: 1/0.7 ≈ 1.4 m column pitch, 1/0.4 = 2.5 m floor pitch.
WIN_U, WIN_V = 0.7, 0.4
# Hash-noise cell sizes (1/freq metres) and contrast per class.
ROAD_FREQ, ROAD_BASE, ROAD_AMP = 2.0, 0.88, 0.24
TERR_FREQ, TERR_BASE, TERR_AMP = 0.5, 0.92, 0.16
HASH_A, HASH_B, HASH_SCALE = 12.9898, 78.233, 43758.5453


def _cell_noise(u, v, freq: float):
    """Deterministic per-cell hash in [0, 1): fract(sin(cu·a + cv·b)·s) on
    a freq-spaced grid, so each cell reads as one speckle."""
    cu = torch.floor(u * freq)
    cv = torch.floor(v * freq)
    h = torch.sin(cu * HASH_A + cv * HASH_B) * HASH_SCALE
    return h - torch.floor(h)


def texture_factor(u, v, cls):
    """Multiplicative shading factor for surface point (u, v) of semantic
    class ``cls`` (shapes broadcast)."""
    wx = u * WIN_U - torch.floor(u * WIN_U)
    wy = v * WIN_V - torch.floor(v * WIN_V)
    window = (wx > 0.2) & (wx < 0.8) & (wy > 0.25) & (wy < 0.75)
    fac_building = torch.where(window, 0.55, 1.05)
    fac_road = ROAD_BASE + ROAD_AMP * _cell_noise(u, v, ROAD_FREQ)
    fac_terrain = TERR_BASE + TERR_AMP * _cell_noise(u, v, TERR_FREQ)
    return torch.where(cls == SEM_BUILDING, fac_building,
                       torch.where(cls == SEM_ROAD, fac_road,
                                   torch.where(cls == SEM_TERRAIN, fac_terrain, 1.0)))
