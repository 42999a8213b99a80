"""Pinhole camera and 2D-homogeneous triangle setup, batched over envs.

Per triangle, with screen-homogeneous vertices v_i = (sx·w, sy·w, w), the
edge rows are E_i = cross(v_{i+1}, v_{i+2}); for a pixel p = (px, py, 1):

    e_i(p) = E_i · p            inside ⇔ all e_i share a sign
    den(p) = Σ_i e_i(p)
    z(p)   = (Σ_i z_i E_i) · p / den(p)     (perspective-correct depth)

No near-plane clipping is needed: the test and the interpolation never
divide by a per-vertex w.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: torch.Tensor      # (B, 3)
    forward: torch.Tensor  # (B, 3) unit
    right: torch.Tensor    # (B, 3) unit
    down: torch.Tensor     # (B, 3) unit (image y grows downward)


def camera_from_ego(ego_pos, ego_yaw, height: float = 1.6,
                    forward_offset: float = 0.5) -> Camera:
    """Forward dashboard camera mounted at the ego (B, 2)/(B,), looking
    along its heading, horizon level. (The JAX package's side and rear rig
    presets are not ported yet.)"""
    c, s = torch.cos(ego_yaw), torch.sin(ego_yaw)
    zero = torch.zeros_like(c)
    forward = torch.stack([c, s, zero], -1)
    right = torch.stack([s, -c, zero], -1)
    down = torch.tensor([0.0, 0.0, -1.0], device=c.device).expand_as(forward)
    mount = ego_pos + forward_offset * torch.stack([c, s], -1)
    pos = torch.cat([mount, torch.full_like(mount[:, :1], height)], -1)
    return Camera(pos=pos, forward=forward, right=right, down=down)


@dataclasses.dataclass(frozen=True)
class TriangleSetup:
    """Per-triangle rasterization coefficients, batched (B, T, ...)."""

    edges: torch.Tensor    # (B, T, 3, 3) sign-normalized rows E_i
    znum: torch.Tensor     # (B, T, 3) Σ_i z_i E_i (depth numerator row)
    colors: torch.Tensor   # (B, T, 3)
    classes: torch.Tensor  # (B, T) int64
    valid: torch.Tensor    # (B, T) bool — non-degenerate and not fully behind
    bbox: torch.Tensor     # (B, T, 4) screen xmin, xmax, ymin, ymax (conservative)
    zmin: torch.Tensor     # (B, T) nearest camera depth


def _cross(a, b):
    """jnp.cross over the last axis, term for term."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def project_triangles(tris, colors, classes, cam: Camera, width: int,
                      height: int, fov_deg: float = 90.0, near: float = 0.5,
                      cullable=None) -> TriangleSetup:
    """World triangles (B, T, 3, 3) → TriangleSetup. ``cullable`` (B, T)
    marks closed solids whose back faces are dropped."""
    rel = tris - cam.pos[:, None, None, :]                      # (B, T, 3, 3)
    x = (rel * cam.right[:, None, None, :]).sum(-1)             # (B, T, 3)
    y = (rel * cam.down[:, None, None, :]).sum(-1)
    z = (rel * cam.forward[:, None, None, :]).sum(-1)

    half_fov = torch.tensor(fov_deg, dtype=torch.float32) * (math.pi / 180.0) / 2.0
    focal = float(1.0 / torch.tan(half_fov))
    sx_w = (x * focal + z) * (width / 2.0)
    sy_w = (y * focal * (width / height) + z) * (height / 2.0)
    v = torch.stack([sx_w, sy_w, z], -1)                        # (B, T, 3, 3)

    e0 = _cross(v[:, :, 1], v[:, :, 2])
    e1 = _cross(v[:, :, 2], v[:, :, 0])
    e2 = _cross(v[:, :, 0], v[:, :, 1])
    edges = torch.stack([e0, e1, e2], 2)                        # (B, T, 3, 3)
    det = (v[:, :, 0] * e0).sum(-1)                             # v0 · (v1 × v2)
    # sign-normalize so pixels inside the front-projected part of any valid
    # triangle see all e_i > 0 (the fast kernel tests only min(e) > 0)
    edges = edges * torch.where(det < 0.0, -1.0, 1.0)[..., None, None]
    znum = (z[..., None] * edges).sum(2)                        # Σ_i z_i E_i
    any_area = torch.abs(det) > 1e-9
    front = (z > near).any(-1)
    degenerate = (tris == 0.0).all(-1).all(-1)
    valid = any_area & front & ~degenerate

    if cullable is not None:
        # back faces of outward-wound closed solids can never be seen
        n = _cross(tris[:, :, 1] - tris[:, :, 0], tris[:, :, 2] - tris[:, :, 0])
        facing = (n * -rel[:, :, 0]).sum(-1) > 0.0
        valid = valid & (facing | ~cullable)

    # conservative screen bbox; a vertex behind the eye makes the extent
    # unbounded, so the bbox is clamped to the full screen
    safe_z = torch.clamp(z, min=1e-3)
    px = sx_w / safe_z
    py = sy_w / safe_z
    behind = (z <= 1e-3).any(-1)
    bbox = torch.stack([
        torch.where(behind, 0.0, px.amin(-1)),
        torch.where(behind, float(width), px.amax(-1)),
        torch.where(behind, 0.0, py.amin(-1)),
        torch.where(behind, float(height), py.amax(-1)),
    ], -1)
    return TriangleSetup(edges=edges, znum=znum, colors=colors,
                         classes=classes, valid=valid, bbox=bbox,
                         zmin=z.amin(-1))
