"""Scene assembly: town + world state → fixed-size triangle buffers.

Static geometry (ground, roads, buildings — optionally with facade bands —
lane markings, light poles) is built once per town on the host with numpy;
per step, traffic vehicles, phase-coloured light heads and (optionally) blob
shadows are added for the whole fleet, padded to ``max_triangles``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.util import map_tensors
from perfbench.reference.sim.town import TownMap

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


def _box_tris_banded(cx, cy, hw, hh, z0, z1, bands: int) -> list:
    """Box walls split into ``bands`` vertical stripes (window floors) + roof."""
    zs = np.linspace(z0, z1, bands + 1)
    tris = []
    for lo, hi in zip(zs[:-1], zs[1:]):
        tris += _box_tris(cx, cy, hw, hh, lo, hi)[:8]  # walls only
    tris += _box_tris(cx, cy, hw, hh, z0, z1)[8:]      # single roof
    return tris


MARKING_Z = 0.004  # above the road plane (0.0), below blob shadows (0.01)
_MARK_WHITE = np.array([0.85, 0.85, 0.85], np.float32)   # dashes / zebra
_MARK_YELLOW = np.array([0.80, 0.70, 0.20], np.float32)  # center divider


def _line_quads(a: np.ndarray, b: np.ndarray, half_w: float,
                z: float = MARKING_Z) -> list:
    """Two triangles for a flat stripe of half-width ``half_w`` from a to b."""
    d = b - a
    n = np.array([-d[1], d[0]])
    n = n / (np.linalg.norm(n) + 1e-9) * half_w
    return _quad([a[0] - n[0], a[1] - n[1], z], [b[0] - n[0], b[1] - n[1], z],
                 [b[0] + n[0], b[1] + n[1], z], [a[0] + n[0], a[1] + n[1], z])


def _marking_geometry(town: TownMap, dash_period: float = 16.0,
                      dash_len: float = 3.0):
    """Lane markings as flat quads just above the road plane (host numpy):
    a solid yellow center line per road segment, dashed white lane dividers
    when ``town.lanes > 1``, white zebra stripes along every crosswalk.
    → (tris list, colours list); all carry SEM_ROADLINE with their paint
    colour."""
    tris, colors = [], []

    def add(quads, color):
        for t in quads:
            tris.append(t)
            colors.append(color)

    lane_w = float(town.road_half_width) / max(1, town.lanes)
    for seg in town.road_segments.cpu().numpy():
        a, b = np.array(seg[:2]), np.array(seg[2:])
        d = b - a
        length = float(np.linalg.norm(d))
        u = d / (length + 1e-9)
        n = np.array([-u[1], u[0]])
        add(_line_quads(a, b, 0.12), _MARK_YELLOW)  # solid center line
        for k in range(1, town.lanes):              # dashed lane dividers
            for side in (-1.0, 1.0):
                off = side * k * lane_w * n
                s = dash_period * 0.5
                while s + dash_len < length:
                    add(_line_quads(a + off + u * s, a + off + u * (s + dash_len),
                                    0.10), _MARK_WHITE)
                    s += dash_period
    for cr in town.crossings.cpu().numpy():         # zebra stripes
        a, b = cr[0], cr[1]
        d = b - a
        span = float(np.linalg.norm(d))
        u = d / (span + 1e-9)
        v = np.array([-u[1], u[0]])                  # travel direction
        n_stripes = max(2, int(span / 1.2))
        for i in range(n_stripes):
            c = a + u * ((i + 0.5) / n_stripes * span)
            add(_line_quads(c - v * 1.25, c + v * 1.25, 0.30), _MARK_WHITE)
    return tris, colors


def build_static_scene(town: TownMap, facade_bands: int = 0,
                       markings: bool = False) -> StaticScene:
    """Host-side static scene (CPU tensors), equal to the JAX package's
    ``build_static_scene`` with the same arguments (building tones from
    seed 0). ``facade_bands > 0`` splits building walls into alternating
    dark/light stripes; ``markings`` adds lane markings and zebra crosswalks
    (SEM_ROADLINE)."""
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
        if facade_bands > 0:
            t_list = _box_tris_banded(cx, cy, hw, hh, 0.0, h, facade_bands)
            for i, t in enumerate(t_list):
                band = (i // 8) if i < 8 * facade_bands else facade_bands
                # alternate window-floor (dark) / wall (light) stripes
                stripe = 0.55 if band % 2 == 1 and band < facade_bands else 1.0
                shade = 0.8 + 0.2 * ((i // 2) % 3) / 2.0
                tris.append(t)
                colors.append(np.asarray(SEMANTIC_PALETTE[SEM_BUILDING])
                              * tone * stripe * shade)
                classes.append(SEM_BUILDING)
        else:
            add(_box_tris(cx, cy, hw, hh, 0.0, h),
                SEMANTIC_PALETTE[SEM_BUILDING] * tone, SEM_BUILDING)

    if markings:
        m_tris, m_colors = _marking_geometry(town)
        tris += m_tris
        colors += m_colors
        classes += [SEM_ROADLINE] * len(m_tris)

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


SHADOW_Z = 0.01  # just above the road, below every occupant
SHADOW_TONE = (0.25, 0.25, 0.27)
# Penumbra ring: a wider, lighter quad under the core (slightly lower z, so
# the core wins the depth test where they overlap and only the rim shows).
PENUMBRA_Z = 0.008
PENUMBRA_TONE = (0.47, 0.47, 0.50)
PENUMBRA_SCALE = 1.5


def _shadow_quads(pos, yaw, half_len: float, half_wid: float,
                  scale: float = 1.15, z: float = SHADOW_Z):
    """(B, A, 2) + (B, A) → (B, A·2, 3, 3) dark ground quads under rotated
    footprints (blob shadows), pair-adjacent like the light heads."""
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]   # (B, A, 1)
    local = torch.tensor([[half_len, half_wid], [-half_len, half_wid],
                          [-half_len, -half_wid], [half_len, -half_wid]],
                         device=pos.device) * scale                # (4, 2)
    lx, ly = local[:, 0], local[:, 1]
    x = c * lx + (-s) * ly + pos[..., 0, None]                     # (B, A, 4)
    y = s * lx + c * ly + pos[..., 1, None]
    p = torch.stack([x, y, torch.full_like(x, z)], -1)             # (B, A, 4, 3)
    t0 = p[..., [0, 1, 2], :]
    t1 = p[..., [0, 2, 3], :]
    return torch.stack([t0, t1], 2).reshape(pos.shape[0], -1, 3, 3)


def assemble_scene(static: StaticScene, lights_pos, phases, agents_pos,
                   agents_yaw, max_triangles: int, peds_pos=None,
                   shadows: bool = False):
    """→ (tris (B, T, 3, 3), colors (B, T, 3), classes (B, T) int64), padded
    with all-zero (degenerate) triangles to T = ``max_triangles``.
    ``shadows`` adds blob contact shadows (core and penumbra) under vehicles
    and walkers, carrying SEM_ROAD so the semantic plane stays clean."""
    B = agents_pos.shape[0]
    dev = agents_pos.device
    veh = vehicle_triangles(agents_pos, agents_yaw)
    lh_tris, lh_col = light_head_triangles(lights_pos, phases)

    def const_colour(rgb, n):
        return torch.as_tensor(rgb, dtype=torch.float32, device=dev).expand(B, n, 3)

    parts_t = [static.tris.expand(B, -1, -1, -1), veh, lh_tris.expand(B, -1, -1, -1)]
    parts_c = [static.colors.expand(B, -1, -1),
               const_colour(SEMANTIC_PALETTE[SEM_VEHICLE], veh.shape[1]), lh_col]
    parts_k = [static.classes.expand(B, -1),
               torch.full((B, veh.shape[1]), SEM_VEHICLE, device=dev),
               torch.full((B, lh_tris.shape[0]), SEM_LIGHT, device=dev)]
    has_peds = peds_pos is not None and peds_pos.shape[1] > 0
    if has_peds:
        ped = pedestrian_triangles(peds_pos)
        parts_t.append(ped)
        parts_c.append(const_colour(SEMANTIC_PALETTE[SEM_PEDESTRIAN], ped.shape[1]))
        parts_k.append(torch.full((B, ped.shape[1]), SEM_PEDESTRIAN, device=dev))
    if shadows:
        for scale, z, tone in ((1.15, SHADOW_Z, SHADOW_TONE),
                               (PENUMBRA_SCALE, PENUMBRA_Z, PENUMBRA_TONE)):
            sh = [_shadow_quads(agents_pos, agents_yaw, 2.25, 1.0, scale=scale, z=z)]
            if has_peds:   # walkers render orientation-free: yaw 0
                sh.append(_shadow_quads(peds_pos, torch.zeros_like(peds_pos[..., 0]),
                                        0.25, 0.25, scale=scale, z=z))
            sh = torch.cat(sh, 1)
            parts_t.append(sh)
            parts_c.append(const_colour(tone, sh.shape[1]))
            parts_k.append(torch.full((B, sh.shape[1]), SEM_ROAD, device=dev))
    n = sum(p.shape[1] for p in parts_t)
    if n > max_triangles:
        raise ValueError(f"scene has {n} triangles > max_triangles={max_triangles}")
    pad = max_triangles - n
    parts_t.append(torch.zeros((B, pad, 3, 3), device=dev))
    parts_c.append(torch.zeros((B, pad, 3), device=dev))
    parts_k.append(torch.zeros((B, pad), dtype=torch.int64, device=dev))
    return torch.cat(parts_t, 1), torch.cat(parts_c, 1), torch.cat(parts_k, 1)
