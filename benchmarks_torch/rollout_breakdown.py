#!/usr/bin/env python3
"""Closed-loop component breakdown in the PyTorch port.

The port of the JAX package's ``benchmarks/rollout_breakdown.py``.
Marginal-cost protocol: every number is Δwall/Δsteps between runs of 16
and 96 steps (median of 3 pairs) with one host read of a reduction at the
end of each run and the state evolving across runs. The components, each
a loop over the whole fleet:

- full        : sim + render + frame window + policy (``make_rollout``
                with a random-weight bf16 ``PolicyCNN``, kernel B)
- expert      : the same with the expert driving (− the policy forward)
- sim_only    : sim step + autopilot + spawn-pool pick, no frames
- lists_only  : an evolving camera → project, fuse quads, pack the
                primitive table and build ``tile_lists_fast`` (no kernel)
- render_only : an evolving camera → the whole fast render

The render-side loops advance each ego 0.4 m along its route a step and
project with the quad rows, as the JAX harness's ``project_triangles``
does, so ``render_only`` runs ``rasterize_luma_fast(..., quads=True)``:
kernel C, the kernel the JAX package's ``quads=None`` picks for such a
setup, and ``lists_only`` mirrors its front end. The JAX harness passes
``lod_px=--lod`` to the render and ``max(--lod, 0)`` to the lists; both
packages cull nothing at −1 there. ``derived_ms`` gives ``policy_fwd``
(full − expert) and ``raster_kernel`` (render_only − lists_only).

The port's loops pay a host cost per launch that XLA's ``lax.scan`` does
not; that cost is what the card's numbers measure, and nothing here hides
it (no CUDA graphs, no ``torch.compile``).

    python3 benchmarks_torch/rollout_breakdown.py [--envs 1024] [--rich]
        [--lod -1] [--device cuda] [--out PATH]

Writes ``--out`` (default ``reports/torch_rollout_breakdown.json``) with
the JAX harness's keys (``envs``, ``rich``, ``lod_px``,
``ms_per_fleet_step``, ``env_steps_per_sec_full``, ``derived_ms``),
``device`` and, on a card, its ``nvidia-smi`` name and power limit; the
same JSON is the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_TOWN = {"blocks": 3, "n_buildings": 24, "n_lights": 8}
COMPONENTS = ("full", "expert", "sim_only", "lists_only", "render_only")
ADVANCE_M = 0.4     # the render loops' camera step along the route


def render_config(rich: bool, lod: float):
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig

    return RenderConfig(height=128, width=128, fast=True, rgb=False,
                        max_triangles=1024 if rich else 512,
                        facade_bands=3 if rich else 0, shadows=rich, lod_px=lod)


def marginal(run, carry, n_small: int = 16, n_big: int = 96, reps: int = 3):
    """→ (carry, median Δwall per step): ``run(carry, n) -> (carry,
    seconds)``, one warm pair first."""
    import numpy as np

    carry, _ = run(carry, n_small)
    carry, _ = run(carry, n_big)
    deltas = []
    for _ in range(reps):
        carry, t_s = run(carry, n_small)
        carry, t_b = run(carry, n_big)
        deltas.append((t_b - t_s) / (n_big - n_small))
    return carry, float(np.median(deltas))


def make_scene_setup(params, town, rcfg, dev):
    """→ ``scene_setup(states, dt_s) -> (advanced states, TriangleSetup)``:
    each ego moved ``dt_s`` metres along its route, the scene of the state's
    lights and agents seen from there, with the quad rows."""
    import torch

    from carla_imitation_learning_tpu_torch.render import geometry as geo
    from carla_imitation_learning_tpu_torch.render.camera import (
        camera_from_ego, project_triangles,
    )
    from carla_imitation_learning_tpu_torch.sim import agents as agent_lib
    from carla_imitation_learning_tpu_torch.sim.town import route_point

    static = geo.build_static_scene(town, facade_bands=rcfg.facade_bands).to(dev)
    H, W, T = rcfg.height, rcfg.width, rcfg.max_triangles

    def scene_setup(s, dt_s: float):
        s_adv = s.replace(ego_s=s.ego_s + dt_s)
        pos, yaw = route_point(town, s_adv.ego_route, s_adv.ego_s)
        phases = agent_lib.light_phases(
            town, s.t.to(torch.float32) * params.dt,
            params.light_green, params.light_yellow, params.light_red)
        ap, ay = agent_lib.agent_positions(town, s.agents_route, s.agents_s)
        tris, colors, classes = geo.assemble_scene(static, town.lights_pos, phases, ap, ay, T,
                                                   shadows=rcfg.shadows)
        cullable = (classes == geo.SEM_BUILDING) | (classes == geo.SEM_VEHICLE)
        cam = camera_from_ego(pos, yaw)
        return s_adv, project_triangles(tris, colors, classes, cam, W, H, 90.0, 0.5,
                                        cullable=cullable, quads=True)

    return scene_setup


def make_render_loop(scene_setup, rcfg, do_kernel: bool):
    """→ ``loop((states, acc), n) -> (states, acc)``: ``n`` steps of the
    render side, the whole fast render (``do_kernel``) or its front end
    alone, each step's result summed into ``acc`` (B,)."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    H, W, T = rcfg.height, rcfg.width, rcfg.max_triangles

    @torch.no_grad()
    def loop(carry, n: int):
        s, acc = carry
        for _ in range(n):
            s, setup = scene_setup(s, ADVANCE_M)
            if do_kernel:
                g = rf.rasterize_luma_fast(setup, H, W, lod_px=rcfg.lod_px, quads=True)
                acc = acc + g.sum((1, 2))
            else:
                prims = rf.fuse_prims(setup)
                tbl = rf.pack_setup_prims(prims)
                _idx, count = rf.tile_lists_fast(prims, H, T, width=W,
                                                 lod_px=max(rcfg.lod_px, 0.0))
                acc = acc + tbl[:, 0].sum(-1) + count.sum(-1).to(torch.float32)
        return s, acc

    return loop


def breakdown(n_envs: int, rich: bool, lod: float, dev, **marginal_kw) -> dict:
    """The five components' seconds per fleet step on the bench town."""
    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import (
        SimParams, autopilot_control, make_spawn_pool, pick_fresh_packed, reset_env, step_env,
    )
    from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
    from carla_imitation_learning_tpu_torch.training.steps import flax_init_

    town = make_town(**BENCH_TOWN).to(dev)
    params = SimParams(n_agents=15)
    rcfg = render_config(rich, lod)
    results = {}

    model = flax_init_(PolicyCNN(), torch.Generator().manual_seed(0)).to(dev).eval()

    def policy_fn(obs):
        return model(obs).argmax(-1)

    for name, pf in (("full", policy_fn), ("expert", None)):
        init_fn, rollout_fn = make_rollout(params, town, rcfg, pf, device=dev)
        carry = init_fn(torch.Generator().manual_seed(1), n_envs)

        def run(carry, n, _rf=rollout_fn):
            t0 = time.perf_counter()
            carry, traj = _rf(carry, n)
            float(traj["speed"].sum())
            return carry, time.perf_counter() - t0

        _, results[name] = marginal(run, carry, **marginal_kw)

    pool = make_spawn_pool(params, town, torch.Generator().manual_seed(0x5EED), 1024)
    states = reset_env(params, town, torch.Generator().manual_seed(2), n_envs)

    @torch.no_grad()
    def run_sim(states, n):
        t0 = time.perf_counter()
        speeds = []
        for _ in range(n):
            control = autopilot_control(params, town, states)
            fresh = pick_fresh_packed(pool, params, states)
            states, info = step_env(params, town, states, control, fresh)
            speeds.append(info["speed"])
        float(torch.stack(speeds).sum())
        return states, time.perf_counter() - t0

    _, results["sim_only"] = marginal(run_sim, states, **marginal_kw)

    scene_setup = make_scene_setup(params, town, rcfg, dev)
    for name, do_kernel in (("lists_only", False), ("render_only", True)):
        loop = make_render_loop(scene_setup, rcfg, do_kernel)

        def run_r(carry, n, _loop=loop):
            t0 = time.perf_counter()
            carry = _loop(carry, n)
            float(carry[1].sum())
            return carry, time.perf_counter() - t0

        _, results[name] = marginal(run_r, (states, torch.zeros(n_envs, device=dev)),
                                    **marginal_kw)
    return results


def report(n_envs: int, rich: bool, lod: float, results: dict) -> dict:
    return {
        "envs": n_envs, "rich": bool(rich), "lod_px": lod,
        "ms_per_fleet_step": {k: results[k] * 1e3 for k in COMPONENTS},
        "env_steps_per_sec_full": n_envs / results["full"],
        "derived_ms": {
            "policy_fwd": (results["full"] - results["expert"]) * 1e3,
            "raster_kernel": (results["render_only"] - results["lists_only"]) * 1e3,
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--rich", action="store_true",
                    help="rich-scene config (facade bands, shadows, 1024 tris)")
    ap.add_argument("--lod", type=float, default=-1.0,
                    help="-1 = auto (rollout default 2px), 0 = off")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_rollout_breakdown.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device

    dev = resolve_device(args.device)
    out = report(args.envs, args.rich, args.lod, breakdown(args.envs, args.rich, args.lod, dev))
    out["device"] = str(dev)
    if dev.type == "cuda":
        out["card"] = card_line()
    line = json.dumps(out)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
