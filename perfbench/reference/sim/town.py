"""Procedural town: grid road network, lane-offset loop routes, buildings,
traffic lights. Built host-side with numpy once (static geometry), then held
as float32 tensors shared by every env of a fleet.

Conventions: world is z-up, ground plane z=0, distances in meters, yaw in
radians (0 = +x). Right-hand traffic: route loops run counterclockwise around
blocks, offset to the right lane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.util import map_tensors


@dataclasses.dataclass(frozen=True)
class TownMap:
    # Routes: (R, P, 2) closed-loop lane-center polylines, uniformly
    # resampled; (R, P) per-point cumulative arclength; (R,) loop length.
    routes: torch.Tensor
    route_arclen: torch.Tensor
    route_total: torch.Tensor
    # Buildings: (Nb, 5) = cx, cy, half_w, half_h, height (axis-aligned boxes).
    buildings: torch.Tensor
    # Traffic lights: (L, 2) positions at intersections; (L,) phase offsets s.
    lights_pos: torch.Tensor
    lights_offset: torch.Tensor
    # Road segments for off-road checks and rendering: (S, 4) = x0, y0, x1, y1.
    road_segments: torch.Tensor
    road_half_width: torch.Tensor  # () f32
    extent: torch.Tensor           # () f32: half-size of the town square
    # Crosswalks (C, 2, 2), junction centers (J, 2), sidewalk loops
    # (K, SP, 2) with their lengths (K,).
    crossings: torch.Tensor
    junctions: torch.Tensor
    sidewalks: torch.Tensor
    sidewalk_total: torch.Tensor
    # Lanes per direction: route r is lane r % lanes of grid cell r // lanes.
    lanes: int = 1
    lane_width: float = 3.5
    # Junction turn fans (``make_town(turn_fans=True)``, else None): at
    # sample point p of route r, up to K other routes whose polyline runs
    # through the same point with the same heading. Taking slot k rewrites
    # (route, s) to (transfer_route[r, p, k], transfer_s[r, p, k]), which
    # lands on the same world point. (R, P, K) int64 / float32 / bool.
    transfer_route: torch.Tensor | None = None
    transfer_s: torch.Tensor | None = None
    transfer_valid: torch.Tensor | None = None
    # Goal navigation tables (``sim.planner.plan_to_goals``, else None): for
    # goal g at node (route r, sample point p), nav_slot[g, r, p] is the
    # turn-fan slot to take (−1 = stay), nav_dist[g, r, p] the meters to the
    # goal (inf = unreachable), nav_goals[g] the goal point. (G, R, P) int64
    # / (G, R, P) float32 / (G, 2) float32.
    nav_slot: torch.Tensor | None = None
    nav_dist: torch.Tensor | None = None
    nav_goals: torch.Tensor | None = None

    def to(self, device) -> "TownMap":
        return map_tensors(self, lambda t: t.to(device))

    def replace(self, **kw) -> "TownMap":
        return dataclasses.replace(self, **kw)


def _round_corners(corners: np.ndarray, radius: float,
                   pts_per_corner: int = 6) -> np.ndarray:
    """Fillet every corner of a closed polygon with a circular arc of radius
    ≤ ``radius`` (clamped so adjacent fillets never overlap)."""
    K = corners.shape[0]
    out = []
    for i in range(K):
        P, B, N = corners[(i - 1) % K], corners[i], corners[(i + 1) % K]
        u = (P - B) / (np.linalg.norm(P - B) + 1e-12)
        v = (N - B) / (np.linalg.norm(N - B) + 1e-12)
        cosang = np.clip(u @ v, -1.0, 1.0)
        theta = np.arccos(cosang)
        if theta < 1e-3 or theta > np.pi - 1e-3:  # straight/degenerate corner
            out.append(B)
            continue
        max_t = 0.4 * min(np.linalg.norm(P - B), np.linalg.norm(N - B))
        r = min(radius, max_t * np.tan(theta / 2.0))
        t = r / np.tan(theta / 2.0)
        T1, T2 = B + u * t, B + v * t
        center = B + (u + v) / (np.linalg.norm(u + v) + 1e-12) * (r / np.sin(theta / 2.0))
        a1 = np.arctan2(*(T1 - center)[::-1])
        a2 = np.arctan2(*(T2 - center)[::-1])
        da = (a2 - a1 + np.pi) % (2 * np.pi) - np.pi  # short way around
        for k in range(pts_per_corner):
            a = a1 + da * k / (pts_per_corner - 1)
            out.append(center + r * np.array([np.cos(a), np.sin(a)]))
    return np.asarray(out)


def _resample_loop(corners: np.ndarray, n_points: int) -> np.ndarray:
    """Uniformly resample a closed polygon (corners (K,2)) to n_points."""
    pts = np.concatenate([corners, corners[:1]], axis=0)
    seg = np.diff(pts, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = cum[-1]
    s = np.linspace(0.0, total, n_points, endpoint=False)
    idx = np.searchsorted(cum, s, side="right") - 1
    idx = np.clip(idx, 0, len(seg) - 1)
    frac = (s - cum[idx]) / np.maximum(seg_len[idx], 1e-9)
    return pts[idx] + frac[:, None] * seg[idx]


def _build_transfer_table(routes: np.ndarray, arclen: np.ndarray,
                          total: np.ndarray, K: int = 4, tol: float = 0.8,
                          tangent_min: float = 0.95):
    """Turn-fan table: for every sample point of every route, the other
    routes whose polyline passes through that point with the same heading.

    Candidates are matched by point-to-segment perpendicular distance
    (< ``tol`` m) with a tangent alignment test that rejects the opposite
    lane of adjacent blocks, nearest line first; ``transfer_s`` is the
    projected arclength on the target. Host numpy, once per town build, the
    JAX package's table entry for entry (ties included: the same stable
    ``argsort`` and the same float64 arithmetic)."""
    R, P, _ = routes.shape
    seg = np.roll(routes, -1, axis=1) - routes            # (R, P, 2)
    seg_len = np.linalg.norm(seg, axis=-1)                # (R, P)
    tang = seg / np.maximum(seg_len, 1e-9)[..., None]
    tr = np.zeros((R, P, K), np.int32)
    ts = np.zeros((R, P, K), np.float32)
    tv = np.zeros((R, P, K), bool)
    flat_start = routes.reshape(R * P, 2)
    flat_tang = tang.reshape(R * P, 2)
    flat_len = seg_len.reshape(R * P)
    rough = float(np.max(seg_len)) + tol  # start-point cull radius
    for r in range(R):
        pts = routes[r]
        d0 = np.linalg.norm(pts[:, None] - flat_start[None], axis=-1)
        dot = tang[r] @ flat_tang.T
        cand_mask = (d0 < rough) & (dot > tangent_min)
        cand_mask[:, r * P:(r + 1) * P] = False           # never self
        for p in range(P):
            cand = np.nonzero(cand_mask[p])[0]
            if cand.size == 0:
                continue
            off = pts[p] - flat_start[cand]               # (C, 2)
            proj = np.einsum("cd,cd->c", off, flat_tang[cand])
            inside = (proj >= -0.25) & (proj <= flat_len[cand] + 0.25)
            perp = np.linalg.norm(off - proj[:, None] * flat_tang[cand], axis=-1)
            good = inside & (perp < tol)
            cand, proj, perp = cand[good], proj[good], perp[good]
            if cand.size == 0:
                continue
            seen, k = set(), 0
            for idx in np.argsort(perp):                  # nearest line first
                rr, pp = divmod(int(cand[idx]), P)
                if rr in seen or k >= K:
                    continue
                seen.add(rr)
                tr[r, p, k] = rr
                ts[r, p, k] = (arclen[rr, pp] + max(float(proj[idx]), 0.0)) % total[rr]
                tv[r, p, k] = True
                k += 1
    return tr, ts, tv


def make_town(
    blocks: int = 3,
    block_size: float = 80.0,
    lane_width: float = 3.5,
    n_buildings: int = 24,
    n_lights: int = 8,
    route_points: int = 128,
    seed: int = 0,
    corner_radius: float = 0.0,
    lanes_per_direction: int = 1,
    superblocks: bool = False,
    turn_fans: bool = False,
) -> TownMap:
    """Build a (blocks×blocks)-block grid town on the CPU (``.to(device)``
    moves it). Every field equals the JAX package's ``make_town`` with the
    same arguments.

    Routes: ``lanes_per_direction`` counterclockwise loops per block at
    successive right-lane offsets, plus as many perimeter loops, each
    resampled to ``route_points`` points so route following is a gather.
    ``superblocks=True`` adds loops around 2×1/1×2 cell pairs and L-shaped
    3-cell unions; ``corner_radius > 0`` fillets route corners;
    ``turn_fans=True`` builds the route-transfer tables
    (``_build_transfer_table``), meaningful with ``superblocks=True``."""
    rng = np.random.default_rng(seed)
    size = blocks * block_size
    half_lane = lane_width / 2.0
    lanes = max(1, int(lanes_per_direction))

    # --- routes ---------------------------------------------------------
    loops = []

    def rect_loop(x0, y0, x1, y1, o):
        """CCW rectangle offset INWARD by o (right-hand traffic)."""
        return np.array([
            [x0 + o, y0 + o], [x1 - o, y0 + o],
            [x1 - o, y1 - o], [x0 + o, y1 - o],
        ])

    for bi in range(blocks):
        for bj in range(blocks):
            x0, y0 = bi * block_size, bj * block_size
            for k in range(lanes):
                loops.append(rect_loop(x0, y0, x0 + block_size, y0 + block_size,
                                       half_lane + k * lane_width))
    if superblocks and blocks > 1:
        for bi in range(blocks - 1):   # horizontal 2×1 pairs
            for bj in range(blocks):
                x0, y0 = bi * block_size, bj * block_size
                for k in range(lanes):
                    loops.append(rect_loop(x0, y0, x0 + 2 * block_size,
                                           y0 + block_size,
                                           half_lane + k * lane_width))
        for bi in range(blocks):       # vertical 1×2 pairs
            for bj in range(blocks - 1):
                x0, y0 = bi * block_size, bj * block_size
                for k in range(lanes):
                    loops.append(rect_loop(x0, y0, x0 + block_size,
                                           y0 + 2 * block_size,
                                           half_lane + k * lane_width))
        for bi in range(blocks - 1):   # L-shaped 3-cell unions
            for bj in range(blocks - 1):
                x0, x1, x2 = (bi * block_size, (bi + 1) * block_size,
                              (bi + 2) * block_size)
                y0, y1, y2 = (bj * block_size, (bj + 1) * block_size,
                              (bj + 2) * block_size)
                for k in range(lanes):
                    o = half_lane + k * lane_width
                    loops.append(np.array([
                        [x0 + o, y0 + o], [x2 - o, y0 + o],
                        [x2 - o, y2 - o], [x1 + o, y2 - o],
                        [x1 + o, y1 - o], [x0 + o, y1 - o],
                    ]))
    for k in range(lanes):  # outer perimeter loops (CCW, offset outward)
        o = half_lane + k * lane_width
        loops.append(np.array([
            [-o, -o], [size + o, -o], [size + o, size + o], [-o, size + o],
        ]))
    if corner_radius > 0.0:
        loops = [_round_corners(c, corner_radius) for c in loops]
    routes = np.stack([_resample_loop(c, route_points) for c in loops])  # (R,P,2)
    diffs = np.diff(np.concatenate([routes, routes[:, :1]], axis=1), axis=1)
    seg_len = np.linalg.norm(diffs, axis=-1)  # (R,P)
    arclen = np.concatenate([np.zeros((routes.shape[0], 1)),
                             np.cumsum(seg_len, axis=1)[:, :-1]], axis=1)
    total = seg_len.sum(axis=1)

    # --- buildings -------------------------------------------------------
    margin = lanes * lane_width + 2.0  # keep facades off the (wider) roads
    bpb = max(1, -(-n_buildings // (blocks * blocks)))  # ceil; trimmed below
    buildings = []
    for bi in range(blocks):
        for bj in range(blocks):
            x0, y0 = bi * block_size + margin, bj * block_size + margin
            x1, y1 = (bi + 1) * block_size - margin, (bj + 1) * block_size - margin
            for _ in range(bpb):
                hw = rng.uniform(4.0, 12.0)
                hh = rng.uniform(4.0, 12.0)
                cx = rng.uniform(x0 + hw, max(x0 + hw, x1 - hw))
                cy = rng.uniform(y0 + hh, max(y0 + hh, y1 - hh))
                height = rng.uniform(6.0, 25.0)
                buildings.append([cx, cy, hw, hh, height])
    buildings = np.array(buildings[:n_buildings] or [[0, 0, 0, 0, 0]], dtype=np.float32)

    # --- lights at interior intersections ---------------------------------
    nodes = [(i * block_size, j * block_size)
             for i in range(1, blocks) for j in range(1, blocks)]
    if not nodes:  # degenerate 1-block town: corners
        nodes = [(0.0, 0.0)]
    nodes = (nodes * ((n_lights // len(nodes)) + 1))[:n_lights]
    lights_pos = np.array(nodes, dtype=np.float32)
    lights_offset = rng.uniform(0.0, 16.0, size=len(nodes)).astype(np.float32)

    # --- road segments (grid edges) ---------------------------------------
    segs = []
    for i in range(blocks + 1):
        c = i * block_size
        segs.append([0.0, c, size, c])   # horizontal
        segs.append([c, 0.0, c, size])   # vertical
    road_segments = np.array(segs, dtype=np.float32)

    # --- crosswalks: two per interior intersection ------------------------
    w = lanes * lane_width + 0.5  # span the full road (both directions) + curb
    off = lanes * lane_width + 2.5
    cross = []
    xnodes = [(i * block_size, j * block_size)
              for i in range(1, blocks) for j in range(1, blocks)] or [(0.0, 0.0)]
    for (cx, cy) in xnodes:
        cross.append([[cx - w, cy + off], [cx + w, cy + off]])  # over vertical rd
        cross.append([[cx + off, cy - w], [cx + off, cy + w]])  # over horizontal
    crossings = np.array(cross, dtype=np.float32)

    # --- sidewalk loops: one per block, 1.2 m beyond the roadway edge --------
    side_off = lanes * lane_width + 1.2
    side_loops = []
    for bi in range(blocks):
        for bj in range(blocks):
            x0, y0 = bi * block_size, bj * block_size
            side_loops.append(_resample_loop(
                rect_loop(x0, y0, x0 + block_size, y0 + block_size, side_off),
                64))
    sidewalks = np.stack(side_loops).astype(np.float32)  # (K, 64, 2)
    side_d = np.diff(np.concatenate([sidewalks, sidewalks[:, :1]], axis=1),
                     axis=1)
    sidewalk_total = np.linalg.norm(side_d, axis=-1).sum(axis=1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    transfers = {}
    if turn_fans:
        tr, ts, tv = _build_transfer_table(routes, arclen, total)
        transfers = dict(transfer_route=torch.as_tensor(tr.astype(np.int64)),
                         transfer_s=f32(ts), transfer_valid=torch.as_tensor(tv))
    return TownMap(
        routes=f32(routes),
        route_arclen=f32(arclen),
        route_total=f32(total),
        buildings=f32(buildings),
        lights_pos=f32(lights_pos),
        lights_offset=f32(lights_offset),
        road_segments=f32(road_segments),
        road_half_width=f32(lanes * lane_width),
        extent=f32(size / 2.0),
        crossings=f32(crossings),
        junctions=f32([[i * block_size, j * block_size]
                       for i in range(blocks + 1) for j in range(blocks + 1)]),
        sidewalks=f32(sidewalks),
        sidewalk_total=f32(sidewalk_total),
        lanes=lanes,
        lane_width=float(lane_width),
        **transfers,
    )


def mirror_town(town: TownMap) -> TownMap:
    """The town reflected about the y axis (x → −x): every left turn of
    ``make_town``'s counterclockwise loops becomes a right turn, while
    arclengths, lane offsets, the transfer tables' (r, p, k) indices and the
    nav tables (pure topology and lengths) stay valid; only the goal points
    move to their mirror images. Column 0 of the routes, buildings, lights,
    crossings, junctions, sidewalks and goals is negated, and columns 0 and
    2 of the road segments — the JAX package's ``mirror_town`` field for
    field."""

    def neg(a: torch.Tensor | None, cols=(0,)) -> torch.Tensor | None:
        if a is None:
            return None
        a = a.clone()
        for c in cols:
            a[..., c] = -a[..., c]
        return a

    segs = town.road_segments
    if segs is not None and segs.numel():
        segs = neg(segs, (0, 2))
    return town.replace(
        routes=neg(town.routes), buildings=neg(town.buildings),
        lights_pos=neg(town.lights_pos), road_segments=segs,
        crossings=neg(town.crossings), junctions=neg(town.junctions),
        sidewalks=neg(town.sidewalks), nav_goals=neg(town.nav_goals))


def town_kwargs_from_cfg(cfg, seed: int = 0) -> dict:
    """The ``make_town`` arguments of a composed config's ``sim`` block
    (``n_lights`` from ``sim``, the rest from ``sim.town``; ``superblocks``
    and ``turn_fans`` may be absent from the preset)."""
    t = cfg.sim.town
    return dict(
        blocks=int(t.blocks), block_size=float(t.block_size),
        lane_width=float(t.lane_width), n_buildings=int(t.n_buildings),
        n_lights=int(cfg.sim.n_lights), seed=seed,
        corner_radius=float(t.get("corner_radius", 0.0)),
        lanes_per_direction=int(t.get("lanes_per_direction", 1)),
        superblocks=bool(t.get("superblocks", False)),
        turn_fans=bool(t.get("turn_fans", False)),
    )


def make_town_from_cfg(cfg, seed: int = 0) -> TownMap:
    return make_town(**town_kwargs_from_cfg(cfg, seed))


def norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis as sqrt(Σ v²) (jnp.linalg.norm)."""
    return torch.sqrt((v * v).sum(-1))


def route_point(town: TownMap, route: torch.Tensor, s: torch.Tensor):
    """Position (..., 2) and tangent yaw (...) on route ``route`` (int64,
    any shape) at arclength ``s`` (same shape, wrapped). Pure gathers.

    Routes are uniformly resampled, so the segment index is ~s/total·P; chord
    shortening at polygon corners moves it by at most one segment, which a
    branchless ±1 correction fixes."""
    total = town.route_total[route]
    s = torch.remainder(s, total)
    n = town.routes.shape[1]
    i0 = (s / total * n).to(torch.int64).clamp(0, n - 1)
    up = (i0 + 1 < n) & (s >= town.route_arclen[route, (i0 + 1).clamp(max=n - 1)])
    down = s < town.route_arclen[route, i0]
    i = (i0 + up.to(torch.int64) - down.to(torch.int64)).clamp(0, n - 1)
    nxt = (i + 1) % n
    p0 = town.routes[route, i]
    p1 = town.routes[route, nxt]
    seg = p1 - p0
    seg_len = norm2(seg) + 1e-9
    frac = ((s - town.route_arclen[route, i]) / seg_len).clamp(0.0, 1.0)
    pos = p0 + frac[..., None] * seg
    yaw = torch.atan2(seg[..., 1], seg[..., 0])
    return pos, yaw
