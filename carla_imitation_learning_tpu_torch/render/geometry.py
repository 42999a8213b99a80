"""Scene assembly: town + world state → fixed-size triangle buffers.

Static geometry (ground, roads, buildings, light poles) is built once per
town on the host with numpy; per step, traffic vehicles and phase-coloured
light heads are added for the whole fleet, padded to ``max_triangles``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.device import map_tensors
from carla_imitation_learning_tpu_torch.sim.town import TownMap

# Semantic classes (CARLA-like reduced set)
(SEM_SKY, SEM_TERRAIN, SEM_ROAD, SEM_BUILDING, SEM_VEHICLE, SEM_LIGHT,
 SEM_PEDESTRIAN, SEM_ROADLINE) = 0, 1, 2, 3, 4, 5, 6, 7

SEMANTIC_PALETTE = np.array([
    [70, 130, 180],   # sky
    [107, 142, 35],   # terrain
    [128, 64, 128],   # road
    [70, 70, 70],     # building
    [0, 0, 142],      # vehicle
    [250, 170, 30],   # traffic light
    [220, 20, 60],    # pedestrian
    [157, 234, 50],   # road line
], dtype=np.float32) / 255.0


@dataclasses.dataclass(frozen=True)
class StaticScene:
    tris: torch.Tensor     # (Ts, 3, 3) world-space vertices
    colors: torch.Tensor   # (Ts, 3) RGB in [0, 1]
    classes: torch.Tensor  # (Ts,) int64 semantic ids

    def to(self, device) -> "StaticScene":
        return map_tensors(self, lambda t: t.to(device))


def _quad(p0, p1, p2, p3) -> list:
    """Two triangles for quad p0-p1-p2-p3 (in order)."""
    return [[p0, p1, p2], [p0, p2, p3]]


def _box_tris(cx, cy, hw, hh, z0, z1) -> list:
    """Axis-aligned box: 4 walls + roof (10 triangles), outward-wound."""
    x0, x1, y0, y1 = cx - hw, cx + hw, cy - hh, cy + hh
    c = lambda x, y, z: [x, y, z]  # noqa: E731
    tris = []
    tris += _quad(c(x0, y0, z0), c(x1, y0, z0), c(x1, y0, z1), c(x0, y0, z1))  # south
    tris += _quad(c(x1, y0, z0), c(x1, y1, z0), c(x1, y1, z1), c(x1, y0, z1))  # east
    tris += _quad(c(x1, y1, z0), c(x0, y1, z0), c(x0, y1, z1), c(x1, y1, z1))  # north
    tris += _quad(c(x0, y1, z0), c(x0, y0, z0), c(x0, y0, z1), c(x0, y1, z1))  # west
    tris += _quad(c(x0, y0, z1), c(x1, y0, z1), c(x1, y1, z1), c(x0, y1, z1))  # roof
    return tris


def build_static_scene(town: TownMap) -> StaticScene:
    """Host-side static scene (CPU tensors), equal to the JAX package's
    default one (building tones from seed 0; facade bands and lane markings
    are not ported yet)."""
    rng = np.random.default_rng(0)
    size = 2.0 * float(town.extent)
    tris, colors, classes = [], [], []

    def add(t_list, color, cls, per_face_shade=True):
        for i, t in enumerate(t_list):
            tris.append(t)
            shade = 1.0 if not per_face_shade else 0.8 + 0.2 * ((i // 2) % 3) / 2.0
            colors.append(np.asarray(color) * shade)
            classes.append(cls)

    # ground plane (slightly below road to avoid z-fighting)
    m = size
    g = -0.02
    add(_quad([-m, -m, g], [size + m, -m, g], [size + m, size + m, g], [-m, size + m, g]),
        SEMANTIC_PALETTE[SEM_TERRAIN], SEM_TERRAIN, per_face_shade=False)

    # roads: one long quad per grid segment
    hwid = float(town.road_half_width)
    for seg in town.road_segments.cpu().numpy():
        x0, y0, x1, y1 = seg
        d = np.array([x1 - x0, y1 - y0])
        n = np.array([-d[1], d[0]])
        n = n / (np.linalg.norm(n) + 1e-9) * hwid
        add(_quad([x0 - n[0], y0 - n[1], 0.0], [x1 - n[0], y1 - n[1], 0.0],
                  [x1 + n[0], y1 + n[1], 0.0], [x0 + n[0], y0 + n[1], 0.0]),
            SEMANTIC_PALETTE[SEM_ROAD], SEM_ROAD, per_face_shade=False)

    for b in town.buildings.cpu().numpy():
        cx, cy, hw, hh, h = b
        tone = rng.uniform(0.6, 1.2)
        add(_box_tris(cx, cy, hw, hh, 0.0, h),
            SEMANTIC_PALETTE[SEM_BUILDING] * tone, SEM_BUILDING)

    # light poles (heads are dynamic — coloured by phase at render time)
    for lp in town.lights_pos.cpu().numpy():
        x, y = lp
        add(_quad([x - 0.15, y, 0.0], [x + 0.15, y, 0.0],
                  [x + 0.15, y, 4.5], [x - 0.15, y, 4.5]),
            np.array([0.3, 0.3, 0.3]), SEM_LIGHT, per_face_shade=False)

    return StaticScene(
        tris=torch.as_tensor(np.array(tris, np.float32)),
        colors=torch.as_tensor(np.clip(np.array(colors, np.float32), 0, 1)),
        classes=torch.as_tensor(np.array(classes, np.int64)),
    )


_UNIT_VEHICLE = np.array(_box_tris(0.0, 0.0, 2.25, 1.0, 0.05, 1.55), np.float32)
_UNIT_PED = np.array(_box_tris(0.0, 0.0, 0.25, 0.25, 0.0, 1.8), np.float32)
_LIGHT_PHASE_COLORS = np.array([
    [0.1, 0.9, 0.1],   # green
    [0.95, 0.8, 0.1],  # yellow
    [0.9, 0.1, 0.1],   # red
], dtype=np.float32)


def vehicle_triangles(pos, yaw):
    """(B, A, 2) pos + (B, A) yaw → (B, A·10, 3, 3) world triangles."""
    base = torch.as_tensor(_UNIT_VEHICLE, device=pos.device)   # (10, 3, 3)
    c = torch.cos(yaw)[..., None, None]                        # (B, A, 1, 1)
    s = torch.sin(yaw)[..., None, None]
    bx, by = base[..., 0], base[..., 1]                        # (10, 3)
    x = c * bx + (-s) * by + pos[..., 0, None, None]
    y = s * bx + c * by + pos[..., 1, None, None]
    z = base[..., 2].expand_as(x)
    B = pos.shape[0]
    return torch.stack([x, y, z], -1).reshape(B, -1, 3, 3)


def pedestrian_triangles(pos):
    """(B, P, 2) walker positions → (B, P·10, 3, 3) (translate only)."""
    base = torch.as_tensor(_UNIT_PED, device=pos.device)       # (10, 3, 3)
    xy = base[..., :2] + pos[:, :, None, None, :]
    z = base[..., 2:].expand(xy.shape[:-1] + (1,))
    return torch.cat([xy, z], -1).reshape(pos.shape[0], -1, 3, 3)


def light_head_triangles(lights_pos, phases):
    """(L, 2) + (B, L) phases → ((L·2, 3, 3) tris, (B, L·2, 3) colours)."""
    x, y = lights_pos[:, 0], lights_pos[:, 1]
    r = 0.45
    v0 = torch.stack([x - r, y, torch.full_like(x, 4.5)], -1)
    v1 = torch.stack([x + r, y, torch.full_like(x, 4.5)], -1)
    v2 = torch.stack([x + r, y, torch.full_like(x, 5.4)], -1)
    v3 = torch.stack([x - r, y, torch.full_like(x, 5.4)], -1)
    t0 = torch.stack([v0, v1, v2], 1)
    t1 = torch.stack([v0, v2, v3], 1)
    tris = torch.stack([t0, t1], 1).reshape(-1, 3, 3)         # pair-adjacent
    col = torch.as_tensor(_LIGHT_PHASE_COLORS, device=phases.device)[phases]
    return tris, torch.repeat_interleave(col, 2, dim=1)


def assemble_scene(static: StaticScene, lights_pos, phases, agents_pos,
                   agents_yaw, max_triangles: int, peds_pos=None):
    """→ (tris (B, T, 3, 3), colors (B, T, 3), classes (B, T) int64), padded
    with all-zero (degenerate) triangles to T = ``max_triangles``."""
    B = agents_pos.shape[0]
    dev = agents_pos.device
    veh = vehicle_triangles(agents_pos, agents_yaw)
    lh_tris, lh_col = light_head_triangles(lights_pos, phases)

    def palette(cls, n):
        return torch.as_tensor(SEMANTIC_PALETTE[cls], device=dev).expand(B, n, 3)

    parts_t = [static.tris.expand(B, -1, -1, -1), veh, lh_tris.expand(B, -1, -1, -1)]
    parts_c = [static.colors.expand(B, -1, -1), palette(SEM_VEHICLE, veh.shape[1]), lh_col]
    parts_k = [static.classes.expand(B, -1),
               torch.full((B, veh.shape[1]), SEM_VEHICLE, device=dev),
               torch.full((B, lh_tris.shape[0]), SEM_LIGHT, device=dev)]
    if peds_pos is not None and peds_pos.shape[1] > 0:
        ped = pedestrian_triangles(peds_pos)
        parts_t.append(ped)
        parts_c.append(palette(SEM_PEDESTRIAN, ped.shape[1]))
        parts_k.append(torch.full((B, ped.shape[1]), SEM_PEDESTRIAN, device=dev))
    n = sum(p.shape[1] for p in parts_t)
    if n > max_triangles:
        raise ValueError(f"scene has {n} triangles > max_triangles={max_triangles}")
    pad = max_triangles - n
    parts_t.append(torch.zeros((B, pad, 3, 3), device=dev))
    parts_c.append(torch.zeros((B, pad, 3), device=dev))
    parts_k.append(torch.zeros((B, pad), dtype=torch.int64, device=dev))
    return torch.cat(parts_t, 1), torch.cat(parts_c, 1), torch.cat(parts_k, 1)
