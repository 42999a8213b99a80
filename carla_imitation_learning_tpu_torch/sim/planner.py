"""Global A→B route planner (the JAX package's ``sim/planner.py``, the
port's own copy).

Planning runs on the host once per (town, goal set): Dijkstra from each
goal over the quantized (route, sample point) graph — R·P nodes, follow
edges (r, p) → (r, p + 1) weighted by the segment length, and the turn-fan
transfers of ``make_town(turn_fans=True)`` as edges of cost ``_HOP_COST`` —
baked into tables the sim reads by gathers every step (``sim.world``
``_apply_route_transfers``): ``nav_slot (G, R, P)``, the turn-fan slot to
take at a node (−1 = stay), and ``nav_dist (G, R, P)``, the meters to goal
g (inf = unreachable). Numpy on float64 copies of the town's float32
arrays, with the JAX package's heap order, so the tables equal its own
entry for entry.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.sim.town import TownMap

_EPS = 0.5  # meters a transfer must strictly save before it is prescribed
# Tiny positive cost per transfer hop: among equal-length paths Dijkstra
# then takes the fewest hops, so no optimal path hops A → B → A. Small
# against _EPS, so it never changes which paths are optimal.
_HOP_COST = 0.01


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def nearest_node(town: TownMap, xy) -> tuple[int, int]:
    """(route, point index) of the route sample point nearest ``xy``."""
    routes = _np(town.routes)  # (R, P, 2)
    d2 = np.sum((routes - np.asarray(xy, np.float64)) ** 2, axis=-1)
    r, p = np.unravel_index(int(np.argmin(d2)), d2.shape)
    return int(r), int(p)


def _reverse_adjacency(town: TownMap):
    """Reverse edge lists for Dijkstra from the goal → (rev, R, P):
    rev[v] lists (u, w, slot) for each forward edge u → v of weight w; slot
    is the turn-fan slot that realizes the edge (−1 = the follow edge)."""
    routes = _np(town.routes)
    R, P, _ = routes.shape
    seg_len = np.linalg.norm(np.roll(routes, -1, axis=1) - routes, axis=-1)
    total = _np(town.route_total)
    rev: list[list[tuple[int, float, int]]] = [[] for _ in range(R * P)]
    for r in range(R):
        for p in range(P):
            u = r * P + p
            rev[r * P + (p + 1) % P].append((u, float(seg_len[r, p]), -1))
    if town.transfer_route is not None:
        tr, ts, tv = (_np(town.transfer_route), _np(town.transfer_s),
                      _np(town.transfer_valid))
        for r in range(R):
            for p in range(P):
                u = r * P + p
                for k in range(tr.shape[-1]):
                    if not tv[r, p, k]:
                        continue
                    rr = int(tr[r, p, k])
                    pp = int(round(ts[r, p, k] / total[rr] * P)) % P
                    rev[rr * P + pp].append((u, _HOP_COST, k))
    return rev, R, P


def _dijkstra_to(town: TownMap, goal_xy, goal_tol: float = 2.0):
    """(dist (R, P) float64, slot (R, P) int64) for one goal: meters to the
    goal per node (inf = unreachable) and the turn-fan slot of each node's
    edge in the Dijkstra parent tree (−1 = follow the current route), so
    following the prescriptions never cycles. A node whose follow edge is
    within ``_EPS`` of optimal stays (−1): only the turns a path needs are
    prescribed. The goal nodes are every sample point within ``goal_tol``
    of the goal point and the single nearest one."""
    rev, R, P = _reverse_adjacency(town)
    routes = _np(town.routes).reshape(R * P, 2)
    d0 = np.linalg.norm(routes - np.asarray(goal_xy, np.float64), axis=-1)
    sources = set(np.nonzero(d0 < goal_tol)[0].tolist())
    sources.add(int(np.argmin(d0)))
    dist = np.full(R * P, np.inf)
    slot = np.full(R * P, -1, np.int64)
    heap = []
    for s in sources:
        dist[s] = 0.0
        heapq.heappush(heap, (0.0, s))
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        for u, w, k in rev[v]:
            nd = d + w
            if nd < dist[u]:
                dist[u] = nd
                slot[u] = k
                heapq.heappush(heap, (nd, u))
    dist2, slot2 = dist.reshape(R, P), slot.reshape(R, P)
    pts = _np(town.routes)
    seg_len = np.linalg.norm(np.roll(pts, -1, axis=1) - pts, axis=-1)
    follow_cost = seg_len + np.roll(dist2, -1, axis=1)
    follow_ok = follow_cost <= dist2 + _EPS
    slot2[follow_ok & np.isfinite(dist2)] = -1
    return dist2, slot2


def _widen_back(town: TownMap, slot: np.ndarray) -> None:
    """Fire each prescribed transfer at the earliest node of the shared
    stretch, in place: the parent tree prescribes a turn at its last
    useful node, at the junction corner, where a route rewrite yanks the
    pure-pursuit lookahead mid-turn; the two loops coincide along the whole
    stretch, so the same target route is prescribed at every earlier node
    of it. The sim's strict-descent gate blocks any widened transfer back."""
    if town.transfer_route is None:
        return
    tr, tv = _np(town.transfer_route), _np(town.transfer_valid)
    P = slot.shape[1]
    for r, p in zip(*np.nonzero(slot >= 0)):
        target = tr[r, p, slot[r, p]]
        q = (int(p) - 1) % P
        for _ in range(P - 1):
            if slot[r, q] != -1:
                break
            ks = np.nonzero(tv[r, q] & (tr[r, q] == target))[0]
            if ks.size == 0:
                break
            slot[r, q] = ks[0]
            q = (q - 1) % P


def plan_to_goals(town: TownMap, goals_xy, goal_tol: float | None = None) -> TownMap:
    """Bake the shortest-path tables for ``goals_xy`` (G, 2) into the town →
    ``town.replace(nav_slot (G, R, P) int64, nav_dist (G, R, P) float32,
    nav_goals (G, 2) float32)`` on the town's device. An env whose
    ``WorldState.goal`` is g then drives to goal g; goal −1 keeps free roam.

    ``goal_tol`` defaults to 2.0 + lane_width · (lanes − 1), so a goal is
    reached from any lane of its direction (with 2.0 alone, every node of a
    second lane was unreachable on a 2-lane town)."""
    if goal_tol is None:
        goal_tol = 2.0 + float(town.lane_width) * (int(town.lanes) - 1)
    goals = np.atleast_2d(np.asarray(goals_xy, np.float32))
    slots, dists = [], []
    for g in goals:
        dist, slot = _dijkstra_to(town, g, goal_tol)
        _widen_back(town, slot)
        slots.append(slot)
        dists.append(dist.astype(np.float32))
    dev = town.routes.device
    return town.replace(nav_slot=torch.as_tensor(np.stack(slots), device=dev),
                        nav_dist=torch.as_tensor(np.stack(dists), device=dev),
                        nav_goals=torch.as_tensor(goals, device=dev))


def sample_goals(town: TownMap, rng: np.random.Generator | int, n_goals: int,
                 margin: float = 0.8) -> np.ndarray:
    """(G, 2) float32 goal points drawn from route sample points, preferring
    points where a turn-fan transfer exists (reachable from many routes)
    inside ``margin`` of the town's extent, spread by farthest-point
    selection from one ``rng`` draw."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    pts = _np(town.routes).reshape(-1, 2)
    if town.transfer_valid is not None:
        shared = _np(town.transfer_valid).any(-1).reshape(-1)
        if shared.any():
            pts = pts[shared]
    lim = float(_np(town.extent)) * margin
    inside = np.all(np.abs(pts) < lim, axis=-1)
    if inside.any():
        pts = pts[inside]
    goals = [pts[int(rng.integers(len(pts)))]]
    for _ in range(n_goals - 1):
        d2 = np.min(np.sum((pts[:, None] - np.asarray(goals)[None]) ** 2, axis=-1), axis=-1)
        goals.append(pts[int(np.argmax(d2))])
    return np.asarray(goals, np.float32)


def goal_setup(town: TownMap, n_goals: int, n_envs: int, seed: int = 0):
    """The goal-directed setup the experiments share: ``n_goals`` goals
    drawn by ``sample_goals`` from ``seed``, their tables baked by
    ``plan_to_goals``, and round-robin goal ids → (town with nav tables,
    goals (G, 2), goal_ids (B,) int64)."""
    if town.transfer_route is None:
        raise ValueError("goal navigation plans over the turn-fan graph: build the town "
                         "with turn_fans=True")
    goals = sample_goals(town, int(seed), int(n_goals))
    return plan_to_goals(town, goals), goals, np.arange(int(n_envs)) % int(n_goals)
