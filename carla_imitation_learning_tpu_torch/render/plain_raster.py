"""Plain PyTorch z-buffer rasterizer over triangle chunks.

The port's own correctness reference for the exact kernel (ops/raster.py),
the role ``render/jax_raster.py`` plays in the JAX package: per chunk of
triangles, edge and depth rows are evaluated over the whole pixel grid and
the z-test is a masked argmin. A setup with surface-UV rows is textured:
the winner's rows are gathered first and ``texture_factor`` scales its
colour, as ``render/jax_raster.py`` does. Batched over envs; peak memory is
O(B · chunk · H · W).
"""

from __future__ import annotations

import torch

from carla_imitation_learning_tpu_torch.ops.texture import texture_factor
from carla_imitation_learning_tpu_torch.render.camera import TriangleSetup
from carla_imitation_learning_tpu_torch.render.geometry import SEM_SKY, SEMANTIC_PALETTE

SKY_TOP = (0.35, 0.55, 0.85)
SKY_HORIZON = (0.75, 0.85, 0.95)


def sky_image(height: int, width: int, device=None) -> torch.Tensor:
    """(H, W, 3) vertical sky gradient."""
    t = torch.linspace(0.0, 1.0, height, device=device)[:, None, None]
    top = torch.tensor(SKY_TOP, device=device)
    hor = torch.tensor(SKY_HORIZON, device=device)
    return (top * (1 - t) + hor * t).expand(height, width, 3)


def rasterize_plain(setup: TriangleSetup, height: int, width: int,
                    chunk: int = 64, near: float = 0.5, far: float = 300.0):
    """→ (rgb (B, H, W, 3) f32, sem (B, H, W) int32, depth (B, H, W) f32)."""
    B, T = setup.valid.shape
    if T % chunk:
        raise ValueError(f"triangle count {T} must be a multiple of chunk {chunk}")
    dev = setup.edges.device
    PX = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    PY = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]

    zbuf = torch.full((B, height, width), float("inf"), device=dev)
    rgb = sky_image(height, width, dev).expand(B, -1, -1, -1).clone()
    sem = torch.full((B, height, width), SEM_SKY, dtype=torch.int32, device=dev)
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        e_c = setup.edges[:, sl, :, :, None, None]             # (B, C, 3, 3, 1, 1)
        zn_c = setup.znum[:, sl, :, None, None]                # (B, C, 3, 1, 1)
        e = e_c[:, :, :, 0] * PX + e_c[:, :, :, 1] * PY + e_c[:, :, :, 2]  # (B, C, 3, H, W)
        inside = (e > 0.0).all(2) | (e < 0.0).all(2)           # (B, C, H, W)
        den = e.sum(2)
        den_safe = torch.where(den == 0, 1e-9, den)
        z = (zn_c[:, :, 0] * PX + zn_c[:, :, 1] * PY + zn_c[:, :, 2]) / den_safe
        ok = inside & setup.valid[:, sl, None, None] & (z > near) & (z < far)
        zm = torch.where(ok, z, float("inf"))
        win = torch.argmin(zm, dim=1, keepdim=True)            # (B, 1, H, W)
        zwin = torch.gather(zm, 1, win)[:, 0]
        better = zwin < zbuf
        zbuf = torch.where(better, zwin, zbuf)
        flat = win[:, 0].reshape(B, -1)                        # (B, H·W)
        col_win = torch.gather(setup.colors[:, sl], 1,
                               flat[..., None].expand(-1, -1, 3)).reshape(B, height, width, 3)
        cls_win = torch.gather(setup.classes[:, sl], 1, flat).reshape(B, height, width)
        if setup.unum is not None:
            # the winner's affine UV rows, then u, v and the factor at (H, W)
            def row_win(rows):
                return torch.gather(rows[:, sl], 1, flat[..., None].expand(-1, -1, 3)
                                    ).reshape(B, height, width, 3)

            un_w, vn_w = row_win(setup.unum), row_win(setup.vnum)
            den_w = torch.gather(den_safe, 1, win)[:, 0]
            u = (un_w[..., 0] * PX + un_w[..., 1] * PY + un_w[..., 2]) / den_w
            v = (vn_w[..., 0] * PX + vn_w[..., 1] * PY + vn_w[..., 2]) / den_w
            col_win = col_win * texture_factor(u, v, cls_win)[..., None]
        rgb = torch.where(better[..., None], col_win, rgb)
        sem = torch.where(better, cls_win.to(torch.int32), sem)

    hit = torch.isfinite(zbuf)
    shade = torch.where(hit, 1.0 / (1.0 + 0.004 * torch.nan_to_num(zbuf, posinf=0.0)), 1.0)
    rgb = rgb * shade[..., None]
    depth = torch.where(hit, zbuf, far)
    return rgb, sem, depth


def semantic_to_rgb(sem: torch.Tensor) -> torch.Tensor:
    """Semantic ids → palette colours (..., 3)."""
    return torch.as_tensor(SEMANTIC_PALETTE, device=sem.device)[sem.to(torch.int64)]
