#!/usr/bin/env python3
"""Expert crash forensics on the A→B towns, in the PyTorch port.

The port of the JAX package's ``benchmarks/crash_forensics.py``. It re-runs
the privileged expert on the route-quality world (2 lanes a direction,
super-blocks, turn fans, 8 goals, 15 agents, scheduled ego lane changes
every 160 steps) with the sim alone (no rendering), and classifies every
collision event by mechanism:

- building                  : a collision without a vehicle capsule hit
- veh_lane_teleport         : the colliding agent changed lanes this step
                              (an agent's lane change is an instantaneous
                              lateral jump)
- veh_rear_end              : the culprit behind the ego (more than 0.5 m)
- veh_frontal               : the culprit ahead (more than 0.5 m) inside
                              the ego's corridor (|lateral| < 2 m)
- veh_side                  : a lateral conflict (junction cross / merge)
- veh_other                 : the rest
each counted inside junctions and by the ego's navigation command, beside
the off-road-only events.

``features`` computes the expert's control once and reads the state
before the step for both the features and ``step_env``: the culprit is the
agent whose capsule (after ``step_agents`` with the ego's pre-step
position) comes nearest the ego's capsule after the bicycle step, as in
the step's own collision test. An env whose episode ends continues from a
state that ``reset_env`` draws for it anew every step, as the JAX
harness's ``step_env`` does from each env's key (here from one generator
for the fleet: the same distribution, other draws). ``classify`` turns the (T, B) feature arrays into the report's counts.

    python3 benchmarks_torch/crash_forensics.py [--envs 32] [--steps 2000]
        [--goals 8] [--seed 0] [--episode-len 2500] [--device cuda] [--out PATH]

Writes ``--out`` (default ``reports/torch_crash_forensics.json``, beside
the JAX package's ``reports/crash_forensics.json``) with the JAX report's
keys, ``device`` and, on a card, its ``nvidia-smi`` name and power limit;
the same JSON is the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("building", "veh_lane_teleport", "veh_rear_end", "veh_frontal", "veh_side",
         "veh_other")
KEEP = ("collision", "offroad", "done", "arrived", "timeout")


def route_world(seed: int, n_goals: int, episode_len: int, dev):
    """The route-quality world → (params, town with nav tables on ``dev``)."""
    from carla_imitation_learning_tpu_torch.sim.planner import plan_to_goals, sample_goals
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams

    town = make_town(blocks=3, n_buildings=24, n_lights=8, lanes_per_direction=2,
                     superblocks=True, turn_fans=True, seed=seed)
    town = plan_to_goals(town, sample_goals(town, seed, n_goals))
    params = SimParams(n_agents=15, episode_len=episode_len, lane_change_period=160)
    return params, town.to(dev)


def features(params, town, state, fresh):
    """One fleet step, envs that end their episode continuing from
    ``fresh``, and the classification features of that transition →
    (new_state, {name: (B,) tensor})."""
    import torch

    from carla_imitation_learning_tpu_torch.sim import agents as agent_lib
    from carla_imitation_learning_tpu_torch.sim import collision as col
    from carla_imitation_learning_tpu_torch.sim import world as w
    from carla_imitation_learning_tpu_torch.sim.dynamics import bicycle_step
    from carla_imitation_learning_tpu_torch.sim.town import norm2

    ctrl = w.autopilot_control(params, town, state)
    phases = agent_lib.light_phases(
        town, state.t.to(torch.float32) * params.dt,
        params.light_green, params.light_yellow, params.light_red)
    ego_pos, ego_yaw, _, _ = bicycle_step(
        state.ego_pos, state.ego_yaw, state.ego_v, state.ego_steer,
        ctrl.steer.clamp(-1, 1) * params.max_steer,
        ctrl.throttle.clamp(0, 1), ctrl.brake.clamp(0, 1),
        dt=params.dt, wheelbase=params.wheelbase,
        max_accel=params.max_accel, max_brake=params.max_brake,
        drag=params.drag, tire_stiffness=params.tire_stiffness)
    routes_post, s_post, _ = agent_lib.step_agents(
        town, state.agents_route, state.agents_s, state.agents_v, phases,
        dt=params.dt, target_speed=params.agent_target_speed, ego_pos=state.ego_pos)
    ap_, ay_ = agent_lib.agent_positions(town, routes_post, s_post)
    hl, vr = params.vehicle_half_len, params.vehicle_radius
    he = col.heading(ego_yaw)                                   # (B, 2)
    ha = col.heading(ay_)                                       # (B, A, 2)
    d = col.segment_segment_distance(ego_pos - hl * he, ego_pos + hl * he,
                                     ap_ - hl * ha, ap_ + hl * ha)   # (B, A)
    culprit = torch.argmin(d, dim=1, keepdim=True)              # (B, 1)
    left = torch.stack([-he[:, 1], he[:, 0]], -1)
    rel = torch.gather(ap_, 1, culprit[..., None].expand(-1, 1, 2))[:, 0] - ego_pos
    d_junc = norm2(town.junctions - ego_pos[:, None, :]).amin(dim=1)
    junction_r = torch.clamp(town.road_half_width * 1.8, min=6.0)
    new_state, info = w.step_env(params, town, state, ctrl, fresh)
    feats = {
        "hit_v": torch.gather(d, 1, culprit)[:, 0] < 2.0 * vr,
        "culprit_fwd": (rel * he).sum(-1), "culprit_lat": (rel * left).sum(-1),
        "culprit_changed": (torch.gather(routes_post, 1, culprit)
                            != torch.gather(state.agents_route, 1, culprit))[:, 0],
        "in_junction": d_junc < junction_r + 2.0,
        "cmd": w.navigation_command(params, town, state),
        "ego_v": state.ego_v,
    }
    return new_state, {**feats, **{k: info[k] for k in KEEP}}


def classify(tr: dict, dt: float) -> dict:
    """(T, B) numpy feature arrays → the report's counts: collision events
    by mode, in junctions and by command, off-road-only events, km, the
    mean ego speed at impact and arrivals."""
    import numpy as np

    coll = np.asarray(tr["collision"], bool)
    modes = {m: 0 for m in MODES}
    junction_ct: dict = {}
    cmd_ct: dict = {}
    ev_speed = []
    for t, b in zip(*np.nonzero(coll)):
        in_j = bool(tr["in_junction"][t, b])
        cmd = int(tr["cmd"][t, b])
        ev_speed.append(float(tr["ego_v"][t, b]))
        if tr["hit_v"][t, b]:
            fwd, lat = float(tr["culprit_fwd"][t, b]), float(tr["culprit_lat"][t, b])
            if tr["culprit_changed"][t, b]:
                mode = "veh_lane_teleport"
            elif fwd < -0.5:
                mode = "veh_rear_end"
            elif fwd > 0.5 and abs(lat) < 2.0:
                mode = "veh_frontal"
            elif abs(lat) >= 2.0 or abs(fwd) <= 0.5:
                mode = "veh_side"
            else:
                mode = "veh_other"
        else:
            mode = "building"
        modes[mode] += 1
        junction_ct[mode] = junction_ct.get(mode, 0) + int(in_j)
        cmd_ct.setdefault(mode, {}).setdefault(cmd, 0)
        cmd_ct[mode][cmd] += 1
    n_events = int(coll.sum())
    km = float(np.asarray(tr["ego_v"], np.float64).sum() * dt / 1e3)
    return {
        "km": km, "collision_events": n_events,
        "offroad_only_events": int((np.asarray(tr["offroad"], bool) & ~coll).sum()),
        "collisions_per_km": n_events / km if km else None,
        "modes": modes, "in_junction_by_mode": junction_ct, "cmd_by_mode": cmd_ct,
        "mean_ego_speed_at_impact": float(np.mean(ev_speed)) if ev_speed else None,
        "arrivals": int(np.asarray(tr["arrived"]).sum()),
    }


def run_forensics(params, town, n_envs: int, n_steps: int, n_goals: int, seed: int, dev):
    """The expert fleet from reset for ``n_steps`` → ((T, B) numpy features,
    wall seconds including the host copy)."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    gen = torch.Generator().manual_seed(seed + 7)
    states = reset_env(params, town, gen, n_envs)
    states = states.replace(goal=torch.arange(n_envs, device=dev) % n_goals)
    t0 = time.perf_counter()
    outs = []
    with torch.no_grad():
        for _ in range(n_steps):
            states, out = features(params, town, states,
                                   reset_env(params, town, gen, n_envs))
            outs.append(out)
    tr = {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
    return tr, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--goals", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--episode-len", type=int, default=2500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_crash_forensics.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device

    dev = resolve_device(args.device)
    params, town = route_world(args.seed, args.goals, args.episode_len, dev)
    tr, wall = run_forensics(params, town, args.envs, args.steps, args.goals, args.seed, dev)
    out = {"envs": args.envs, "steps": args.steps, **classify(tr, params.dt),
           "wall_seconds": wall, "device": str(dev)}
    if dev.type == "cuda":
        out["card"] = card_line()
    for k, v in out.items():
        print(f"{k}: {v}", file=sys.stderr)
    line = json.dumps(out)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
