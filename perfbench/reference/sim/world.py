"""World state, batched env step/reset and the autopilot expert.

Every function works on a whole fleet at once: each ``WorldState`` field
carries a leading env axis ``B``. Integer fields are int64; the ``rng`` key
is an int64 (B, 2) pair of uint32 values, the JAX package's raw threefry
key: its first word (the "salt") picks auto-reset states from the packed
spawn pool and seeds the rain, and the turn-fan transfers draw from the
whole key with ``sim.prng``, bit for bit as ``jax.random`` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.reference.util import map_tensors
from perfbench.reference.sim import agents as agent_lib
from perfbench.reference.sim import collision as col
from perfbench.reference.sim import pedestrians as ped_lib
from perfbench.reference.sim import prng
from perfbench.reference.sim.dynamics import bicycle_step
from perfbench.reference.sim.town import TownMap, norm2, route_point


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulation constants (the JAX package's ``SimParams``)."""

    dt: float = 0.05
    wheelbase: float = 2.9
    max_steer: float = 0.6
    max_accel: float = 4.0
    max_brake: float = 8.0
    drag: float = 0.05
    tire_stiffness: float = 9.0
    n_agents: int = 15
    agent_target_speed: float = 7.0
    n_pedestrians: int = 0
    ped_speed: float = 1.4
    ped_sidewalk_frac: float = 0.0
    light_green: float = 8.0
    light_yellow: float = 2.0
    light_red: float = 6.0
    collision_radius: float = 2.2
    collision_model: str = "capsule"
    vehicle_half_len: float = 1.3
    vehicle_radius: float = 1.0
    arrive_radius: float = 4.0
    episode_len: int = 400
    target_speed: float = 8.0  # autopilot cruise speed
    lane_change_period: int = 0
    lane_change_window: int = 12
    headway_gap: float = 7.0
    headway_ttc: float = 1.2
    headway_corridor: float = 2.6
    yield_gap: float = 8.0
    turn_speed: float = 0.0
    turn_period: int = 0
    agent_turn_prob: float = 0.0

    @classmethod
    def from_cfg(cls, cfg) -> "SimParams":
        """The ``sim`` block of a composed config."""
        s = cfg.sim
        return cls(
            dt=float(s.dt), wheelbase=float(s.wheelbase), max_steer=float(s.max_steer),
            max_accel=float(s.max_accel), max_brake=float(s.max_brake),
            drag=float(s.drag), tire_stiffness=float(s.tire_stiffness),
            n_agents=int(s.n_agents), agent_target_speed=float(s.agent_target_speed),
            light_green=float(s.light_green), light_yellow=float(s.light_yellow),
            light_red=float(s.light_red), collision_radius=float(s.collision_radius),
            episode_len=int(s.episode_len),
            n_pedestrians=int(s.get("n_pedestrians", 0)),
            ped_speed=float(s.get("ped_speed", 1.4)),
            ped_sidewalk_frac=float(s.get("ped_sidewalk_frac", 0.0)),
            lane_change_period=int(s.get("lane_change_period", 0)),
            lane_change_window=int(s.get("lane_change_window", 12)),
            turn_period=int(s.get("turn_period", 0)),
            agent_turn_prob=float(s.get("agent_turn_prob", 0.0)),
            arrive_radius=float(s.get("arrive_radius", 4.0)),
            headway_gap=float(s.get("headway_gap", 7.0)),
            headway_ttc=float(s.get("headway_ttc", 1.2)),
            headway_corridor=float(s.get("headway_corridor", 2.6)),
            yield_gap=float(s.get("yield_gap", 8.0)),
            turn_speed=float(s.get("turn_speed", 0.0)),
            collision_model=str(s.get("collision_model", "capsule")),
            vehicle_half_len=float(s.get("vehicle_half_len", 1.3)),
            vehicle_radius=float(s.get("vehicle_radius", 1.0)),
        )


@dataclasses.dataclass(frozen=True)
class WorldState:
    ego_pos: torch.Tensor       # (B, 2)
    ego_yaw: torch.Tensor       # (B,)
    ego_v: torch.Tensor         # (B,)
    ego_steer: torch.Tensor     # (B,) realized wheel angle (rad)
    ego_route: torch.Tensor     # (B,) int64
    ego_s: torch.Tensor         # (B,) arclength of the nearest route point
    agents_route: torch.Tensor  # (B, A) int64
    agents_s: torch.Tensor      # (B, A)
    agents_v: torch.Tensor      # (B, A)
    peds_crossing: torch.Tensor  # (B, P) int64 (P may be 0)
    peds_s: torch.Tensor        # (B, P)
    peds_phase: torch.Tensor    # (B, P)
    t: torch.Tensor             # (B,) int64 step count within the episode
    rng: torch.Tensor           # (B, 2) int64, uint32 values
    goal: torch.Tensor          # (B,) int64, −1 = free roam

    def replace(self, **kw) -> "WorldState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "WorldState":
        return map_tensors(self, lambda t: t.to(device))


@dataclasses.dataclass(frozen=True)
class VehicleControl:
    """CARLA-style normalized control, each (B,)."""

    steer: torch.Tensor     # [-1, 1]
    throttle: torch.Tensor  # [0, 1]
    brake: torch.Tensor     # [0, 1]


def reset_env(params: SimParams, town: TownMap, generator: torch.Generator,
              n_envs: int) -> WorldState:
    """Spawn ``n_envs`` egos and their agents on random routes at spaced
    arclengths. Draws come from ``generator`` (a CPU generator); the state
    lands on the town's device. ``jax.random`` draws cannot be reproduced,
    so only the distribution matches the JAX package's ``reset_env``."""
    dev = town.routes.device
    n_routes = town.routes.shape[0]
    A = params.n_agents
    ego_route = torch.randint(0, n_routes, (n_envs,), generator=generator)
    ego_u = torch.rand(n_envs, generator=generator)
    agents_route = torch.randint(0, n_routes, (n_envs, A), generator=generator)
    agents_u = torch.rand((n_envs, A), generator=generator)
    peds = ped_lib.spawn_pedestrians(town, generator, n_envs,
                                     params.n_pedestrians,
                                     sidewalk_frac=params.ped_sidewalk_frac)
    rng = torch.randint(0, 2 ** 32, (n_envs, 2), generator=generator)

    ego_route, agents_route = ego_route.to(dev), agents_route.to(dev)
    ego_s = ego_u.to(dev) * town.route_total[ego_route]
    ego_pos, ego_yaw = route_point(town, ego_route, ego_s)
    base = (torch.arange(A, dtype=torch.float32, device=dev) + agents_u.to(dev)) / A
    agents_s = base * town.route_total[agents_route]
    zeros = torch.zeros(n_envs, device=dev)
    return WorldState(
        ego_pos=ego_pos, ego_yaw=ego_yaw, ego_v=zeros, ego_steer=zeros.clone(),
        ego_route=ego_route, ego_s=ego_s,
        agents_route=agents_route, agents_s=agents_s,
        agents_v=torch.full((n_envs, A), params.agent_target_speed * 0.5, device=dev),
        peds_crossing=peds[0].to(dev), peds_s=peds[1].to(dev),
        peds_phase=peds[2].to(dev),
        t=torch.zeros(n_envs, dtype=torch.int64, device=dev),
        rng=rng.to(dev),
        goal=torch.full((n_envs,), -1, dtype=torch.int64, device=dev),
    )


def _phases(params: SimParams, town: TownMap, state: WorldState):
    return agent_lib.light_phases(
        town, state.t.to(torch.float32) * params.dt,
        params.light_green, params.light_yellow, params.light_red)


def _ego_red_light(town: TownMap, pos, yaw, phases):
    return agent_lib.red_light_ahead(town, pos[:, None, :], yaw[:, None],
                                     phases, stop_distance=15.0)[:, 0]


def _wrap_angle(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _junction_radius(town: TownMap):
    return torch.clamp(town.road_half_width * 1.8, min=6.0)


def ego_lane_change_plan(params: SimParams, town: TownMap, state: WorldState):
    """Scripted lane changes of the ego → (target_route, command), each
    (B,) int64. The command is 0, 4 (change left) or 5 (change right),
    active for ``lane_change_window`` steps around the switch at
    ``t % period == period // 2``; a pure function of (t, route). The target
    is the next lane up, or back down from the top lane; on the perimeter
    loops (offset outward) a step up is the vehicle's right."""
    if town.lanes <= 1 or params.lane_change_period <= 0:
        return state.ego_route, torch.zeros_like(state.ego_route)
    lanes, period = town.lanes, params.lane_change_period
    k = state.ego_route % lanes
    is_perim = (state.ego_route // lanes) == (town.routes.shape[0] // lanes - 1)
    dk = torch.where(k + 1 < lanes, 1, -1)
    left = torch.where(is_perim, dk < 0, dk > 0)
    cmd = torch.where(left, 4, 5)
    phase = torch.remainder(state.t, period)
    active = torch.abs(phase - period // 2) < params.lane_change_window // 2 + 1
    return state.ego_route + dk, torch.where(active, cmd, 0)


def _apply_ego_lane_change(params: SimParams, town: TownMap, prev: WorldState,
                           mid: WorldState) -> WorldState:
    """The scheduled lane switch on ``mid`` (before the arclength refine):
    the ego's route becomes the target lane at the same fractional loop
    position, unless the ego is near a junction or an agent on the target
    lane is within 10 m along it (judged on ``prev``); a blocked switch
    waits for the next period."""
    if town.lanes <= 1 or params.lane_change_period <= 0:
        return mid
    target_route, _ = ego_lane_change_plan(params, town, prev)
    phase = torch.remainder(prev.t, params.lane_change_period)
    do = (phase == params.lane_change_period // 2) & (target_route != prev.ego_route)
    if town.junctions.shape[0] > 0:
        d = norm2(prev.ego_pos[:, None, :] - town.junctions).amin(dim=1)
        do = do & (d > _junction_radius(town) + 2.0)
    total_t = town.route_total[target_route]
    if prev.agents_s.shape[1] > 0:
        frac = prev.ego_s / town.route_total[prev.ego_route]
        af = prev.agents_s / town.route_total[prev.agents_route]
        df = torch.abs(torch.remainder(af - frac[:, None] + 0.5, 1.0) - 0.5)
        near = (prev.agents_route == target_route[:, None]) & (df * total_t[:, None] < 10.0)
        do = do & ~near.any(dim=1)
    frac = mid.ego_s / town.route_total[prev.ego_route]
    return mid.replace(ego_route=torch.where(do, target_route, mid.ego_route),
                       ego_s=torch.where(do, frac * total_t, mid.ego_s))


def navigation_command(params: SimParams, town: TownMap, state: WorldState):
    """(B,) int64 CIL-style command: 0 follow, 1 left, 2 right, 3 straight
    through the next junction, 4 / 5 change lane left / right (the scripted
    plan of ``ego_lane_change_plan``, which takes precedence)."""
    _, yaw_now = route_point(town, state.ego_route, state.ego_s)
    _, yaw_ahead = route_point(town, state.ego_route, state.ego_s + 15.0)
    dyaw = _wrap_angle(yaw_ahead - yaw_now)
    turn = torch.where(dyaw > 0, 1, 2)
    straight_junc = torch.zeros_like(dyaw, dtype=torch.bool)
    if town.junctions.shape[0] > 0:
        p_ahead, _ = route_point(town, state.ego_route, state.ego_s + 10.0)
        d = norm2(p_ahead[:, None, :] - town.junctions).amin(dim=1)
        straight_junc = d < _junction_radius(town) + 2.0
    base = torch.where(torch.abs(dyaw) >= 0.15, turn, torch.where(straight_junc, 3, 0))
    _, lane_cmd = ego_lane_change_plan(params, town, state)
    return torch.where(lane_cmd > 0, lane_cmd, base)


def _route_index(town: TownMap, route, s):
    """Sample-point index of arclength ``s`` on ``route`` (uniform
    resampling makes it a multiply)."""
    n = town.routes.shape[1]
    total = town.route_total[route]
    return (torch.remainder(s, total) / total * n).to(torch.int64).clamp(0, n - 1)


def _transfer(town: TownMap, route, s, slot, do):
    """Take turn-fan slot ``slot`` where ``do``: the same world point on the
    target route, the source's offset within its segment carried over."""
    i = _route_index(town, route, s)
    do = do & town.transfer_valid[route, i, slot]
    new_route = town.transfer_route[route, i, slot]
    frac_off = torch.remainder(s, town.route_total[route]) - town.route_arclen[route, i]
    new_s = torch.remainder(town.transfer_s[route, i, slot] + frac_off,
                            town.route_total[new_route])
    return torch.where(do, new_route, route), torch.where(do, new_s, s)


def _apply_route_transfers(params: SimParams, town: TownMap, state: WorldState,
                           mid: WorldState) -> WorldState:
    """Junction turn fans: every ``turn_period`` steps the ego re-rolls a
    uniform slot of the K-wide fan at its position (an invalid slot means
    stay), and each agent takes a uniform slot with probability
    ``agent_turn_prob`` a step. The draws are ``jax.random``'s from the
    key ``fold_in(fold_in(rng, 0x7F2B), t)`` of the state before the step,
    so a fleet converted from the JAX package takes the same turns.

    With nav tables (``sim.planner.plan_to_goals``), an ego whose goal is
    ≥ 0 instead takes the slot its goal's table prescribes at its node, on
    every step, and only where the table distance at the node it lands on
    is strictly smaller than at its node (the monotone-descent gate, which
    keeps a ±1-node landing from bouncing between coincident loops). This
    runs whenever the town has nav tables, ``turn_period`` 0 included."""
    nav = town.nav_slot is not None
    if town.transfer_route is None or (params.turn_period <= 0
                                       and params.agent_turn_prob <= 0.0 and not nav):
        return mid
    K = town.transfer_route.shape[-1]
    if params.turn_period > 0 or params.agent_turn_prob > 0.0:
        key = prng.fold_in(prng.fold_in(state.rng, 0x7F2B), state.t)
        keys = prng.split(key, 3)
        k_slot, k_ag, k_agslot = keys[:, 0], keys[:, 1], keys[:, 2]
    out = mid
    if params.turn_period > 0 or nav:
        route, s = mid.ego_route, mid.ego_s
        i = _route_index(town, route, s)
        if params.turn_period > 0:
            slot = prng.randint(k_slot, (), 0, K)
            hit = torch.remainder(mid.t, params.turn_period) == 0
        else:
            slot = torch.zeros_like(route)
            hit = torch.zeros_like(route, dtype=torch.bool)
        if nav:
            g = mid.goal.clamp(0, town.nav_slot.shape[0] - 1)
            nav_slot = town.nav_slot[g, route, i]
            nav_on = mid.goal >= 0
            slot = torch.where(nav_on, nav_slot.clamp(min=0), slot)
            hit = torch.where(nav_on, nav_slot >= 0, hit)
        do = hit & town.transfer_valid[route, i, slot]
        new_route = town.transfer_route[route, i, slot]
        frac_off = torch.remainder(s, town.route_total[route]) - town.route_arclen[route, i]
        new_s = torch.remainder(town.transfer_s[route, i, slot] + frac_off,
                                town.route_total[new_route])
        if nav:
            i_new = _route_index(town, new_route, new_s)
            descent = town.nav_dist[g, new_route, i_new] < town.nav_dist[g, route, i]
            do = do & (descent | ~nav_on)
        out = out.replace(ego_route=torch.where(do, new_route, route),
                          ego_s=torch.where(do, new_s, s))
    if params.agent_turn_prob > 0.0:
        A = mid.agents_route.shape[1]
        slots = prng.randint(k_agslot, (A,), 0, K)
        roll = prng.uniform(k_ag, (A,)) < params.agent_turn_prob
        route, s = _transfer(town, mid.agents_route, mid.agents_s, slots, roll)
        out = out.replace(agents_route=route, agents_s=s)
    return out


def _nearest_s_update(town: TownMap, state: WorldState):
    """Track the ego's arclength by a local window search around ego_s."""
    route = state.ego_route
    total = town.route_total[route]
    offsets = torch.arange(-4, 9, dtype=torch.float32, device=route.device)
    cand = torch.remainder(state.ego_s[:, None] + offsets, total[:, None])  # (B, 13)
    pts, _ = route_point(town, route[:, None].expand_as(cand), cand)
    d = pts - state.ego_pos[:, None, :]
    d2 = (d * d).sum(-1)
    return torch.gather(cand, 1, torch.argmin(d2, dim=1, keepdim=True))[:, 0]


def step_env(params: SimParams, town: TownMap, state: WorldState,
             control: VehicleControl, fresh: WorldState):
    """One sim tick for the fleet → (new_state, info). Envs that end their
    episode (collision, off-road, timeout, and with nav tables arrival at
    the goal or a node with no path to it) continue from ``fresh`` (picked
    from the spawn pool, see ``pick_fresh_packed``). After the dynamics come
    the ego's scripted lane change, the arclength refine and the turn-fan
    transfers, in the JAX package's order."""
    phases = _phases(params, town, state)

    steer_cmd = control.steer.clamp(-1.0, 1.0) * params.max_steer
    ego_pos, ego_yaw, ego_v, ego_steer = bicycle_step(
        state.ego_pos, state.ego_yaw, state.ego_v, state.ego_steer,
        steer_cmd, control.throttle.clamp(0.0, 1.0), control.brake.clamp(0.0, 1.0),
        dt=params.dt, wheelbase=params.wheelbase, max_accel=params.max_accel,
        max_brake=params.max_brake, drag=params.drag,
        tire_stiffness=params.tire_stiffness)

    agents_route, agents_s, agents_v = agent_lib.step_agents(
        town, state.agents_route, state.agents_s, state.agents_v, phases,
        dt=params.dt, target_speed=params.agent_target_speed,
        ego_pos=state.ego_pos)
    agents_pos, agents_yaw = agent_lib.agent_positions(town, agents_route, agents_s)

    peds_s, peds_phase = ped_lib.step_pedestrians(
        town, state.peds_crossing, state.peds_s, state.peds_phase,
        dt=params.dt, speed=params.ped_speed)
    peds_pos = ped_lib.ped_positions(town, state.peds_crossing, peds_s)

    if params.collision_model == "capsule":
        hl, vr = params.vehicle_half_len, params.vehicle_radius
        hit_vehicle = col.capsule_vehicle_collision(
            ego_pos, ego_yaw, agents_pos, agents_yaw, hl, vr)
        hit_building = col.capsule_building_collision(
            ego_pos, ego_yaw, hl, vr, town.buildings)
        hit_ped = col.capsule_point_collision(
            ego_pos, ego_yaw, hl, vr, peds_pos, ped_lib.PED_RADIUS)
    else:  # the legacy discs of collision_radius
        r = params.collision_radius
        hit_vehicle = col.any_vehicle_collision(ego_pos, agents_pos, r)
        hit_building = col.any_building_collision(ego_pos, town.buildings, r)
        hit_ped = col.circle_circle(ego_pos, r, peds_pos, ped_lib.PED_RADIUS).any(dim=1)
    off = col.offroad(ego_pos, town.road_segments, town.road_half_width)
    collided = hit_vehicle | hit_building | hit_ped
    t_new = state.t + 1
    timeout = t_new >= params.episode_len
    arrived = torch.zeros_like(timeout)
    unreachable = torch.zeros_like(timeout)
    if town.nav_goals is not None:
        # goal navigation: reaching the goal point ends the episode as a
        # success; a node with no path to the goal (inf in the table) ends
        # it at once, so the respawn tries again from a connected spawn
        g = state.goal.clamp(0, town.nav_goals.shape[0] - 1)
        nav_on = state.goal >= 0
        arrived = nav_on & (norm2(ego_pos - town.nav_goals[g]) < params.arrive_radius)
        i = _route_index(town, state.ego_route, state.ego_s)
        unreachable = nav_on & ~torch.isfinite(town.nav_dist[g, state.ego_route, i])
    done = collided | off | timeout | arrived | unreachable

    mid = WorldState(
        ego_pos=ego_pos, ego_yaw=ego_yaw, ego_v=ego_v, ego_steer=ego_steer,
        ego_route=state.ego_route, ego_s=state.ego_s,
        agents_route=agents_route, agents_s=agents_s, agents_v=agents_v,
        peds_crossing=state.peds_crossing, peds_s=peds_s, peds_phase=peds_phase,
        t=t_new, rng=state.rng, goal=state.goal)
    mid = _apply_ego_lane_change(params, town, state, mid)
    mid = mid.replace(ego_s=_nearest_s_update(town, mid))
    mid = _apply_route_transfers(params, town, state, mid)

    # auto-reset: branchless select between continued and fresh state; the
    # goal survives auto-resets
    fresh = fresh.replace(goal=state.goal)

    def select(a, b):
        return torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    new_state = WorldState(**{
        f.name: select(getattr(fresh, f.name), getattr(mid, f.name))
        for f in dataclasses.fields(WorldState)})

    # stop-line crossing on red: a red light AHEAD in the ego's lane corridor
    # before the step and BEHIND after it
    h_pre = col.heading(state.ego_yaw)                      # (B, 2)
    l_pre = torch.stack([-h_pre[:, 1], h_pre[:, 0]], -1)
    h_post = col.heading(ego_yaw)
    rel_pre = town.lights_pos - state.ego_pos[:, None, :]   # (B, L, 2)
    rel_post = town.lights_pos - ego_pos[:, None, :]
    crossed = (((rel_pre * h_pre[:, None, :]).sum(-1) > 0.0)
               & ((rel_post * h_post[:, None, :]).sum(-1) <= 0.0)
               & (torch.abs((rel_pre * l_pre[:, None, :]).sum(-1)) < 4.0)
               & (norm2(rel_pre) < 10.0))
    ran_red = (crossed & (phases == agent_lib.RED)).any(dim=1)

    info = {
        "collision": collided, "offroad": off, "timeout": timeout, "done": done,
        "speed": ego_v, "red_light": _ego_red_light(town, ego_pos, ego_yaw, phases),
        "ran_red": ran_red, "pedestrian": hit_ped, "arrived": arrived,
    }
    return new_state, info


def autopilot_control(params: SimParams, town: TownMap, state: WorldState
                      ) -> VehicleControl:
    """Expert: pure pursuit along the ego's route and discrete CARLA-like
    pedals — (1, 0), (0.5, 0), (0, 1) — with the safety envelope: stop for
    red lights and crossing pedestrians, keep time headway to vehicles in the
    forward corridor, yield to vehicles in (or closer to) the junction ahead,
    and cap cruise speed through curves (``turn_speed``)."""
    lookahead = torch.clamp(0.8 * state.ego_v, min=4.0)
    target_pos, _ = route_point(town, state.ego_route, state.ego_s + lookahead)
    rel = target_pos - state.ego_pos
    alpha = _wrap_angle(torch.atan2(rel[:, 1], rel[:, 0]) - state.ego_yaw)
    ld = norm2(rel) + 1e-6
    steer_angle = torch.atan2(2.0 * params.wheelbase * torch.sin(alpha), ld)
    steer = (steer_angle / params.max_steer).clamp(-1.0, 1.0)

    phases = _phases(params, town, state)
    must_stop = _ego_red_light(town, state.ego_pos, state.ego_yaw, phases)
    if params.n_pedestrians > 0:
        peds_pos = ped_lib.ped_positions(town, state.peds_crossing, state.peds_s)
        on_crossing = state.peds_crossing < town.crossings.shape[0]
        must_stop = must_stop | ped_lib.pedestrian_ahead(
            state.ego_pos, state.ego_yaw, peds_pos, mask=on_crossing)

    if (params.headway_gap > 0.0 or params.yield_gap > 0.0) \
            and state.agents_s.shape[1] > 0:
        head = col.heading(state.ego_yaw)                   # (B, 2)
        left = torch.stack([-head[:, 1], head[:, 0]], -1)
        agents_pos, _ = agent_lib.agent_positions(
            town, state.agents_route, state.agents_s)
        if params.headway_gap > 0.0:
            rel = agents_pos - state.ego_pos[:, None, :]    # (B, A, 2)
            fwd = (rel * head[:, None, :]).sum(-1)
            lat = (rel * left[:, None, :]).sum(-1)
            watch = params.headway_gap + params.headway_ttc * state.ego_v
            lead = (fwd > 0.0) & (fwd < watch[:, None]) \
                & (torch.abs(lat) < params.headway_corridor)
            must_stop = must_stop | lead.any(dim=1)
        if params.yield_gap > 0.0 and town.junctions.shape[0] > 0:
            d_all = norm2(town.junctions - state.ego_pos[:, None, :])  # (B, J)
            jidx = torch.argmin(d_all, dim=1)
            d_junc = torch.gather(d_all, 1, jidx[:, None])[:, 0]
            junction_r = _junction_radius(town)
            junc = town.junctions[jidx]                     # (B, 2)
            ahead = ((junc - state.ego_pos) * head).sum(-1) > 0.0
            approaching = (d_junc >= junction_r) \
                & (d_junc < junction_r + params.yield_gap) & ahead
            d_agents = norm2(agents_pos - junc[:, None, :])  # (B, A)
            occupied = (d_agents < junction_r).any(dim=1)
            rival = ((d_agents >= junction_r)
                     & (d_agents < junction_r + params.yield_gap)
                     & (d_agents < d_junc[:, None] - 0.5)).any(dim=1)
            must_stop = must_stop | (approaching & (occupied | rival))

    cruise = params.target_speed
    if params.turn_speed > 0.0:
        _, yaw_near = route_point(town, state.ego_route, state.ego_s + 3.0)
        _, yaw_far = route_point(town, state.ego_route, state.ego_s + 13.0)
        dyaw = _wrap_angle(yaw_far - yaw_near)
        cruise = torch.where(torch.abs(dyaw) >= 0.15, params.turn_speed, cruise)
    err = cruise - state.ego_v
    throttle = torch.where(err > 1.0, 1.0, torch.where(err > -0.5, 0.5, 0.0))
    brake = torch.where(err <= -0.5, 1.0, 0.0)
    throttle = torch.where(must_stop, 0.0, throttle)
    brake = torch.where(must_stop, 1.0, brake)
    return VehicleControl(steer=steer, throttle=throttle, brake=brake)


def sensor_vector(params: SimParams, state: WorldState):
    """(B, 3) = (current_steer, speed_long, speed)."""
    beta = torch.atan(0.5 * torch.tan(state.ego_steer))
    return torch.stack([state.ego_steer / params.max_steer,
                        state.ego_v * torch.cos(beta), state.ego_v], -1)


def traffic_light_state(params: SimParams, town: TownMap, state: WorldState):
    """(B,) int64 — 1 when a red/yellow light blocks the ego."""
    phases = _phases(params, town, state)
    return _ego_red_light(town, state.ego_pos, state.ego_yaw, phases).to(torch.int64)


# ---------------------------------------------------------------------------
# Packed spawn pool. The packed layout is the JAX package's
# (sim/world.py pack_spawn_pool): WorldState fields in declaration order,
# each flattened per row, non-float fields bitcast to float32 — so a pool
# packed by either package can be picked by the other.
# ---------------------------------------------------------------------------

_I32 = ("ego_route", "agents_route", "peds_crossing", "t", "goal")
_U32 = ("rng",)


def pool_layout(params: SimParams):
    """[(field, width)] of a packed pool row, in column order."""
    A, P = params.n_agents, params.n_pedestrians
    widths = {"ego_pos": 2, "agents_route": A, "agents_s": A, "agents_v": A,
              "peds_crossing": P, "peds_s": P, "peds_phase": P, "rng": 2}
    return [(f.name, widths.get(f.name, 1)) for f in dataclasses.fields(WorldState)]


def pack_spawn_pool(pool: WorldState) -> torch.Tensor:
    """WorldState with ``size`` rows → (size, D) float32 matrix."""
    cols = []
    for f in dataclasses.fields(WorldState):
        a = getattr(pool, f.name).reshape(pool.t.shape[0], -1)
        if f.name in _U32:
            a = torch.where(a >= 2 ** 31, a - 2 ** 32, a)
        if f.name in _I32 + _U32:
            a = a.to(torch.int32).view(torch.float32)
        cols.append(a)
    return torch.cat(cols, dim=1)


def pick_fresh_packed(packed: torch.Tensor, params: SimParams,
                      state: WorldState) -> WorldState:
    """Deterministic per-env, per-episode pool pick: row
    (salt + t) mod 2³² mod size, salt = rng[:, 0] — the JAX package's
    uint32 arithmetic, done in int64."""
    size = packed.shape[0]
    idx = ((state.rng[:, 0] + state.t) & 0xFFFFFFFF) % size
    row = packed[idx]
    fields, off = {}, 0
    for name, width in pool_layout(params):
        piece = row[:, off:off + width]
        off += width
        if name in _I32 + _U32:
            piece = piece.view(torch.int32).to(torch.int64)
            if name in _U32:
                piece = piece & 0xFFFFFFFF
        shape = getattr(state, name).shape[1:]
        fields[name] = piece.reshape((row.shape[0],) + tuple(shape))
    return WorldState(**fields)


def make_spawn_pool(params: SimParams, town: TownMap,
                    generator: torch.Generator, size: int = 1024) -> torch.Tensor:
    """Packed (size, D) pool of reset states drawn from ``generator``."""
    return pack_spawn_pool(reset_env(params, town, generator, size))
