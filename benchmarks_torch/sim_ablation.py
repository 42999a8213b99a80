#!/usr/bin/env python3
"""Sim-step ablation in the PyTorch port: where do the ms per fleet step
of the pure sim go?

The port of the JAX package's ``benchmarks/sim_ablation.py``. It bisects
the sim step by timing stripped variants of it (marginal protocol, 1024
envs on the bench town, 15 agents):

- full            : autopilot (incl. safety envelope) + the step (+ pool)
- no_envelope     : headway/yield envelope off (``headway_gap=0,
                    yield_gap=0``: the expert's corridor and yield math)
- circle_collision: the legacy disc collision model (− the oriented-capsule
                    segment-segment math)
- const_control   : step with constant control (− autopilot entirely)
- no_agents       : traffic agents frozen (− ``step_agents``' route math)
- no_nearest      : ego_s dead-reckoned (− the 13-candidate window search)
- no_reset        : no done / select / pool pick (− the auto-reset)
- no_collision    : collision / off-road forced False (needs no_reset too)

``custom_step`` is the JAX harness's step over the port's batched sim
functions: the ego's dynamics, the agents without the ego corridor, no
walkers, lane changes or turn fans, and a reset that replaces every field
of an ended env by the spawn pool's pick (``pick_fresh_packed``, the JAX
``pick_fresh``'s row, in the packed layout both packages share).
``marginal`` is Δwall/80 between runs of 16 and 96 steps, the median of
three pairs, each run ended by one host read of the summed speeds; the
port's loop pays a host cost per launch that XLA's ``lax.scan`` does not,
and that cost is part of what it measures on the card.

    python3 benchmarks_torch/sim_ablation.py [--envs 1024] [--device cuda]
        [--out PATH]

Writes ``--out`` (default ``reports/torch_sim_ablation.json``, beside the
JAX package's ``reports/sim_ablation.json``): ``envs``, ``ms`` per variant
(ms per fleet step), ``compile_s`` (the seconds of the first 16 + 96
steps: warm-up, no compile here), ``device`` and, on a card, its
``nvidia-smi`` name and power limit; the same JSON is the last line of
standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_TOWN = {"blocks": 3, "n_buildings": 24, "n_lights": 8}
POOL_SEED, POOL_SIZE, STATES_SEED = 0x5EED, 1024, 2


def variants(params) -> dict:
    """name → keyword arguments of ``make_runner`` (the JAX harness's eight)."""
    no_env = dataclasses.replace(params, headway_gap=0.0, yield_gap=0.0)
    circle = dataclasses.replace(params, collision_model="circle")
    return {
        "full": dict(auto=True),
        "no_envelope": dict(auto=True, p=no_env),
        "circle_collision": dict(auto=True, p=circle),
        "const_control": dict(auto=False),
        "no_agents": dict(auto=True, agents=False),
        "no_nearest": dict(auto=True, nearest=False),
        "no_reset": dict(auto=True, reset=False),
        "no_collision": dict(auto=True, reset=False, collide=False),
    }


def custom_step(state, control, *, p, town, pool, agents=True, nearest=True,
                reset=True, collide=True):
    """One fleet step of the ablation with parts switched off → the new
    state. ``pool`` is a packed spawn pool of ``p``'s agent count."""
    import torch

    from carla_imitation_learning_tpu_torch.sim import agents as agent_lib
    from carla_imitation_learning_tpu_torch.sim import collision as col
    from carla_imitation_learning_tpu_torch.sim import world as w
    from carla_imitation_learning_tpu_torch.sim.dynamics import bicycle_step

    phases = agent_lib.light_phases(
        town, state.t.to(torch.float32) * p.dt,
        p.light_green, p.light_yellow, p.light_red)
    ego_pos, ego_yaw, ego_v, ego_steer = bicycle_step(
        state.ego_pos, state.ego_yaw, state.ego_v, state.ego_steer,
        control.steer.clamp(-1, 1) * p.max_steer,
        control.throttle.clamp(0, 1), control.brake.clamp(0, 1),
        dt=p.dt, wheelbase=p.wheelbase,
        max_accel=p.max_accel, max_brake=p.max_brake,
        drag=p.drag, tire_stiffness=p.tire_stiffness)
    if agents:
        agents_route, agents_s, agents_v = agent_lib.step_agents(
            town, state.agents_route, state.agents_s, state.agents_v,
            phases, dt=p.dt, target_speed=p.agent_target_speed)
    else:
        agents_route, agents_s, agents_v = (
            state.agents_route, state.agents_s, state.agents_v)
    if collide:
        ap_, ay_ = agent_lib.agent_positions(town, agents_route, agents_s)
        if p.collision_model == "capsule":
            hit = (col.capsule_vehicle_collision(
                       ego_pos, ego_yaw, ap_, ay_,
                       p.vehicle_half_len, p.vehicle_radius)
                   | col.capsule_building_collision(
                       ego_pos, ego_yaw, p.vehicle_half_len,
                       p.vehicle_radius, town.buildings))
        else:
            hit = (col.any_vehicle_collision(ego_pos, ap_, p.collision_radius)
                   | col.any_building_collision(ego_pos, town.buildings,
                                                p.collision_radius))
        off = col.offroad(ego_pos, town.road_segments, town.road_half_width)
    else:
        hit = off = torch.zeros_like(state.t, dtype=torch.bool)
    t_new = state.t + 1
    mid = state.replace(
        ego_pos=ego_pos, ego_yaw=ego_yaw, ego_v=ego_v, ego_steer=ego_steer,
        agents_route=agents_route, agents_s=agents_s, agents_v=agents_v,
        t=t_new)
    if nearest:
        mid = mid.replace(ego_s=w._nearest_s_update(town, mid))
    else:
        mid = mid.replace(ego_s=mid.ego_s + ego_v * p.dt)
    if reset:
        done = hit | off | (t_new >= p.episode_len)
        fresh = w.pick_fresh_packed(pool, p, state)
        mid = w.WorldState(**{
            f.name: torch.where(done.view((-1,) + (1,) * (getattr(mid, f.name).dim() - 1)),
                                getattr(fresh, f.name), getattr(mid, f.name))
            for f in dataclasses.fields(w.WorldState)})
    return mid


def make_runner(params, town, pool, auto=True, p=None, **kw):
    """→ ``run(states, n) -> (states, speeds (n, B))``: ``n`` fleet steps
    of one variant, driven by the autopilot (``auto``) or by constant
    control (steer 0, throttle 1, brake 0)."""
    import torch

    from carla_imitation_learning_tpu_torch.sim import world as w

    p = params if p is None else p

    @torch.no_grad()
    def run(states, n: int):
        speeds = []
        for _ in range(n):
            if auto:
                control = w.autopilot_control(p, town, states)
            else:
                zeros = torch.zeros_like(states.ego_v)
                control = w.VehicleControl(steer=zeros, throttle=torch.ones_like(zeros),
                                           brake=zeros)
            states = custom_step(states, control, p=p, town=town, pool=pool, **kw)
            speeds.append(states.ego_v)
        return states, torch.stack(speeds)

    return run


def marginal(run, states, n_small: int = 16, n_big: int = 96, reps: int = 3):
    """→ (median Δwall per step over ``reps`` pairs, seconds of the first
    pair): each run ends in one host read of its summed speeds, and the
    state evolves across runs."""
    import numpy as np

    def timed(states, n):
        t0 = time.perf_counter()
        states, v = run(states, n)
        float(v.sum())
        return states, time.perf_counter() - t0

    t0 = time.perf_counter()
    states, _ = timed(states, n_small)
    states, _ = timed(states, n_big)
    warm_s = time.perf_counter() - t0
    deltas = []
    for _ in range(reps):
        states, ts = timed(states, n_small)
        states, tb = timed(states, n_big)
        deltas.append((tb - ts) / (n_big - n_small))
    return float(np.median(deltas)), warm_s


def ablate(n_envs: int, dev, **marginal_kw) -> dict:
    """The ablation on the bench town: ``ms`` and ``compile_s`` for each of
    the eight variants."""
    import torch

    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import (
        SimParams, make_spawn_pool, reset_env,
    )

    town = make_town(**BENCH_TOWN).to(dev)
    params = SimParams(n_agents=15)
    pool = make_spawn_pool(params, town, torch.Generator().manual_seed(POOL_SEED), POOL_SIZE)
    states0 = reset_env(params, town, torch.Generator().manual_seed(STATES_SEED), n_envs)
    out, warm = {}, {}
    for name, kw in variants(params).items():
        per, warm_s = marginal(make_runner(params, town, pool, **kw), states0, **marginal_kw)
        out[name], warm[name] = per * 1e3, warm_s
        print(f"{name}: {per * 1e3:.3f} ms/fleet-step (warm {warm_s:.1f} s)",
              file=sys.stderr, flush=True)
    return {"envs": n_envs, "ms": out, "compile_s": warm}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_sim_ablation.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device

    dev = resolve_device(args.device)
    result = ablate(args.envs, dev)
    result["device"] = str(dev)
    if dev.type == "cuda":
        result["card"] = card_line()
    line = json.dumps(result)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
