"""Scripted traffic agents and the traffic-light schedule, batched over
envs: agent tensors are (B, A), light tensors (B, L).

An agent's pose is a pure function of (route, arclength), and a light's
phase a pure function of sim time and its fixed offset.
Phases: 0=green, 1=yellow, 2=red.
"""

from __future__ import annotations

import torch

from perfbench.reference.sim.town import TownMap, norm2, route_point

GREEN, YELLOW, RED = 0, 1, 2


def light_phases(town: TownMap, t_seconds, green: float, yellow: float,
                 red: float):
    """(B, L) int64 phase of every light at sim times t_seconds (B,)."""
    cycle = green + yellow + red
    s = torch.remainder(t_seconds[:, None] + town.lights_offset, cycle)
    return torch.where(s < green, GREEN, torch.where(s < green + yellow, YELLOW, RED))


def red_light_ahead(town: TownMap, pos, yaw, phases, stop_distance: float):
    """True where a non-green light lies within ``stop_distance`` in front.

    pos (B, N, 2), yaw (B, N), phases (B, L) → (B, N) bool."""
    rel = town.lights_pos - pos[..., None, :]            # (B, N, L, 2)
    dist = norm2(rel)
    head = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)
    ahead = (rel * head[..., None, :]).sum(-1) > 0.0
    blocking = (phases[:, None, :] != GREEN) & ahead & (dist < stop_distance)
    return blocking.any(dim=-1)


def agent_positions(town: TownMap, routes, s):
    """(B, A) routes + (B, A) arclengths → ((B, A, 2) pos, (B, A) yaw)."""
    return route_point(town, routes, s)


def step_agents(
    town: TownMap,
    routes: torch.Tensor,   # (B, A) int64
    s: torch.Tensor,        # (B, A) arclength
    v: torch.Tensor,        # (B, A) speed
    phases: torch.Tensor,   # (B, L) light phases
    dt: float,
    target_speed: float,
    accel: float = 3.0,
    stop_distance: float = 12.0,
    gap: float = 8.0,
    junction_radius: float = 6.0,
    yield_at_junctions: bool = True,
    lane_changes: bool = True,
    ego_pos: torch.Tensor | None = None,   # (B, 2)
):
    """One fleet step → (routes, s, v). Agents accelerate to the target
    speed and brake for red lights ahead, for the leader on the same route,
    for the ego in their forward corridor, and (first-come right-of-way) for
    vehicles already inside the junction they are about to enter.

    On multi-lane towns a leader-blocked agent overtakes into the adjacent
    lane on its left, and an unblocked one drifts back right, as a route
    rewrite: lane k of grid cell g is route g·lanes + k, and the fractional
    loop position carries over (concentric loops). Block loops are offset
    inward (k + 1 is the vehicle's left); the perimeter loops outward, so the
    sense flips there. A change needs free headway on the target lane (twice
    the gap for a move back right), no junction within its clearance, no
    lower-index agent bound for the same slot, and a landing point clear of
    the ego."""
    B, A = routes.shape
    pos, yaw = agent_positions(town, routes, s)
    junction_r = torch.clamp(town.road_half_width * 1.8, min=junction_radius)
    has_junctions = town.junctions.shape[0] > 0
    d_junc_all = (norm2(pos[:, :, None, :] - town.junctions)
                  if has_junctions else None)                  # (B, A, J)

    must_stop = red_light_ahead(town, pos, yaw, phases, stop_distance)

    # same-route leader gap: pairwise forward arc distance (A is small)
    total = town.route_total[routes]                           # (B, A)
    ds = torch.remainder(s[:, None, :] - s[:, :, None], total[:, :, None])
    same_route = routes[:, None, :] == routes[:, :, None]
    is_other = ~torch.eye(A, dtype=torch.bool, device=routes.device)
    blocked = same_route & is_other & (ds > 1e-3) & (ds < gap)
    leader_close = blocked.any(dim=2)

    if ego_pos is not None:
        # ego-as-leader: forward-corridor check in each agent's body frame
        rel_ego = ego_pos[:, None, :] - pos                    # (B, A, 2)
        hvec = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)
        lvec = torch.stack([-torch.sin(yaw), torch.cos(yaw)], -1)
        fwd = (rel_ego * hvec).sum(-1)
        lat = (rel_ego * lvec).sum(-1)
        leader_close = leader_close | ((fwd > 0.0) & (fwd < gap) & (torch.abs(lat) < 2.6))

    must_yield = torch.zeros_like(leader_close)
    if yield_at_junctions and d_junc_all is not None:
        jidx = torch.argmin(d_junc_all, dim=2)                 # (B, A)
        d_junc = torch.gather(d_junc_all, 2, jidx[..., None])[..., 0]
        in_junction = d_junc < junction_r
        approaching = (d_junc >= junction_r) & (d_junc < junction_r + gap)
        same_junc = jidx[:, None, :] == jidx[:, :, None]       # (B, A, A)
        occupied = (same_junc & is_other & in_junction[:, None, :]).any(dim=2)
        if ego_pos is not None:
            # an ego inside the junction holds approaching agents too
            d_ego = norm2(ego_pos[:, None, :] - town.junctions)  # (B, J)
            occupied = occupied | (torch.gather(d_ego, 1, jidx) < junction_r)
        must_yield = approaching & occupied

    target = torch.where(must_stop | leader_close | must_yield, 0.0, target_speed)
    dv = torch.clamp(target - v, -2.0 * accel * dt, accel * dt)
    v_new = torch.clamp(v + dv, min=0.0)
    s_new = torch.remainder(s + v_new * dt, total)
    if not (lane_changes and town.lanes > 1):
        return routes, s_new, v_new

    lanes = town.lanes
    frac = s_new / total
    lane_k = routes % lanes
    n_cells = town.routes.shape[0] // lanes
    is_perim = (routes // lanes) == (n_cells - 1)
    ldelta = torch.where(is_perim, -1, 1)
    can_left = torch.where(is_perim, lane_k > 0, lane_k + 1 < lanes)
    can_right = torch.where(is_perim, lane_k + 1 < lanes, lane_k > 0)
    want_left = leader_close & can_left
    want_right = ~leader_close & can_right
    target_route = torch.where(want_left, routes + ldelta,
                               torch.where(want_right, routes - ldelta, routes))
    total_t = town.route_total[target_route]                   # (B, A)
    # [b, i, j]: agent j seen from agent i's target lane
    on_target = routes[:, None, :] == target_route[:, :, None]
    df = torch.abs(torch.remainder(frac[:, None, :] - frac[:, :, None] + 0.5, 1.0) - 0.5)
    gap_m = df * total_t[:, :, None]
    need = torch.where(want_right, 2.0 * gap, gap)             # (B, A)
    target_free = ~(on_target & is_other & (gap_m < need[:, :, None])).any(dim=2)
    wants = want_left | want_right
    change = wants & target_free
    if d_junc_all is not None:
        change = change & (d_junc_all.amin(dim=2) > junction_r + 2.0)
    # two agents bound for the same slot in one step: the lower index wins
    idx = torch.arange(A, device=routes.device)
    rival = ((target_route[:, None, :] == target_route[:, :, None]) & wants[:, None, :]
             & is_other & (gap_m < gap) & (idx[None, :] < idx[:, None]))
    change = change & ~rival.any(dim=2)
    if ego_pos is not None:
        # a change is a lateral jump: veto it when the landing point sits
        # within the same headway of the ego
        land, _ = route_point(town, target_route, frac * total_t)
        change = change & (norm2(land - ego_pos[:, None, :]) > need)
    routes = torch.where(change, target_route, routes)
    s_new = torch.where(change, frac * total_t, s_new)
    return routes, s_new, v_new
