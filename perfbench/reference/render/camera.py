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

import numpy as np
import torch

from perfbench.reference.render.geometry import SEM_BUILDING


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: torch.Tensor      # (B, 3)
    forward: torch.Tensor  # (B, 3) unit
    right: torch.Tensor    # (B, 3) unit
    down: torch.Tensor     # (B, 3) unit (image y grows downward)


# The rig presets of the JAX package, named after the reference's cameras
# (forward ``camera`` and ``semantic``, the narrow ``camera_sFOV``, and the
# VAE logs' FL/FR/SL/SR/RR): (yaw offset from the heading in degrees, field
# of view in degrees or None for the render config's).
CAMERA_PRESETS = {
    "camera": (0.0, None),        # forward dashboard
    "semantic": (0.0, None),      # same pose; semantic output channel
    "camera_sFOV": (0.0, 60.0),   # narrow field of view
    "FL": (45.0, None),           # front-left
    "FR": (-45.0, None),          # front-right
    "SL": (90.0, None),           # side-left
    "SR": (-90.0, None),          # side-right
    "RR": (180.0, None),          # rear
}


def rig_yaw(ego_yaw: torch.Tensor, yaw_offset_deg: float) -> torch.Tensor:
    """The heading a rig camera looks along: ``ego_yaw`` plus the offset in
    radians as the JAX package's ``jnp.deg2rad`` rounds it, the float32
    offset times float32(π/180) rounded to float32 (``math.radians`` rounds
    the product in float64 first and can land an ulp away)."""
    return ego_yaw + float(np.float32(yaw_offset_deg) * np.float32(np.pi / 180.0))


def camera_from_ego(ego_pos, ego_yaw, height: float = 1.6,
                    forward_offset: float = 0.5, yaw_offset_deg: float = 0.0) -> Camera:
    """Rig camera mounted at the ego (B, 2)/(B,), on its body
    ``forward_offset`` ahead along its heading, looking along the heading
    turned by ``yaw_offset_deg``, horizon level."""
    ch, sh = torch.cos(ego_yaw), torch.sin(ego_yaw)
    c, s = ch, sh
    if yaw_offset_deg != 0.0:
        yaw = rig_yaw(ego_yaw, yaw_offset_deg)
        c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    forward = torch.stack([c, s, zero], -1)
    right = torch.stack([s, -c, zero], -1)
    down = torch.tensor([0.0, 0.0, -1.0], device=c.device).expand_as(forward)
    mount = ego_pos + forward_offset * torch.stack([ch, sh], -1)
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
    # Surface-UV numerator rows (Σ_i U_i E_i, like znum) for procedural
    # texturing (ops/texture.py); None unless projected with textures=True.
    unum: torch.Tensor | None = None     # (B, T, 3)
    vnum: torch.Tensor | None = None     # (B, T, 3)
    # Screen-affine inverse depth 1/z(p) = den(p)/|det|, one affine row per
    # plane, and the even/odd pairs (2i, 2i+1) that form one planar convex
    # quad; both None unless projected with quads=True (the fast quad
    # kernel's inputs, ops/raster_fast.py fuse_prims).
    zinv: torch.Tensor | None = None     # (B, T, 3)
    pair_ok: torch.Tensor | None = None  # (B, T // 2) bool


def _cross(a, b):
    """jnp.cross over the last axis, term for term."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def project_triangles(tris, colors, classes, cam: Camera, width: int,
                      height: int, fov_deg: float = 90.0, near: float = 0.5,
                      cullable=None, textures: bool = False,
                      quads: bool = False) -> TriangleSetup:
    """World triangles (B, T, 3, 3) → TriangleSetup. ``cullable`` (B, T)
    marks closed solids whose back faces are dropped. ``textures`` adds the
    surface-UV rows; ``quads`` adds ``zinv`` and ``pair_ok`` (T even)."""
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
    extra = {}
    if quads:
        extra["zinv"], extra["pair_ok"] = _quad_rows(tris, colors, edges, det, z, valid)
    if textures:
        # the world-space UV of each vertex interpolates perspective-correctly
        # as u(p) = (Σ_i U_i E_i)·p / den(p): walls take (x + y, z), which
        # runs along either axis-aligned facade, everything else (x, y)
        is_wall = classes == SEM_BUILDING
        U = torch.where(is_wall[..., None], tris[..., 0] + tris[..., 1], tris[..., 0])
        V = torch.where(is_wall[..., None], tris[..., 2], tris[..., 1])
        extra["unum"] = (U[..., None] * edges).sum(2)
        extra["vnum"] = (V[..., None] * edges).sum(2)
    return TriangleSetup(edges=edges, znum=znum, colors=colors,
                         classes=classes, valid=valid, bbox=bbox,
                         zmin=z.amin(-1), **extra)


def _quad_rows(tris, colors, edges, det, z, valid):
    """→ (zinv (B, T, 3), pair_ok (B, T // 2)), term for term as the JAX
    package computes them. A pair fuses when it shares v0 and the diagonal,
    is coplanar (distance of v3 from the plane ≤ 1e-3), has one flat colour,
    lies wholly in front of the eye, keeps one screen winding and both
    triangles are valid."""
    B, T = valid.shape
    if T % 2:
        raise ValueError(f"quad fusion needs an even triangle count, got {T}")
    abs_det = torch.abs(det)
    zinv = edges.sum(2) / torch.where(abs_det > 1e-9, abs_det, 1.0)[..., None]
    t0, t1 = tris[:, 0::2], tris[:, 1::2]
    share = ((t0[:, :, 0] == t1[:, :, 0]).all(-1)
             & (t0[:, :, 2] == t1[:, :, 1]).all(-1))
    n0 = _cross(t0[:, :, 1] - t0[:, :, 0], t0[:, :, 2] - t0[:, :, 0])
    dist = (torch.abs((n0 * (t1[:, :, 2] - t0[:, :, 0])).sum(-1))
            / (torch.linalg.vector_norm(n0, dim=-1) + 1e-12))
    same_col = (colors[:, 0::2] == colors[:, 1::2]).all(-1)
    front = (z.reshape(B, -1, 2, 3) > 1e-3).all(-1).all(-1)
    same_orient = torch.sign(det[:, 0::2]) == torch.sign(det[:, 1::2])
    pair_ok = (share & (dist <= 1e-3) & same_col & front & same_orient
               & valid[:, 0::2] & valid[:, 1::2])
    return zinv, pair_ok
