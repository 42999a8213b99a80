#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT_DIR]

Phases (any failure exits nonzero, with no result line):
1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: both hand-written kernels from ``csrc/`` (one nvcc each, in
   parallel);
3. kernel A (exact z-buffer) vs its plain PyTorch version, and
4. kernel B (fast grayscale) vs its plain version and vs kernel A's luma, on
   the bench town's fleet (1024 envs, 128², T=512) from three seeds; each
   kernel and plain version is timed with CUDA events at those shapes;
5. the main path on 8 envs, on the card vs on the CPU's plain versions: an
   expert rollout with auto-resets, and an fp32 ``PolicyCNN`` forward (TF32
   is switched off for that comparison and restored after it);
6. the main path, with launch counts reset just before it: the exact-vs-
   plain render gate of the JAX package's bench (through ``make_renderer``),
   then a 1024-env closed-loop rollout with a bf16 ``PolicyCNN`` in the loop
   (``make_rollout``), timed as marginal env-steps/s between rollouts of 16
   and 96 steps (median of 5 pairs), each ending in a host fetch of a
   reduced value.
``--profile`` adds a per-stage breakdown and a torch.profiler summary.

The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ENVS, HW, T = 1024, 128, 512
ROLLOUT_REPEATS = 5      # marginal (96 − 16 steps) timings; the median is reported
CROSS_ENVS, CROSS_STEPS = 8, 8   # the card-vs-CPU check of the main path
FP32_PEAK = 67e12        # H100 SXM float32 outside the tensor cores, op/s
HBM_RATE = 3.35e12       # H100 SXM device memory, B/s
# Least operations per pixel and listed triangle, with the rank-1 terms
# (a·px per column, b·py per row) shared. B: 4 row adds, 2 min, 1 compare,
# 2 adds (den), 1 reciprocal, 1 mul, 1 compare (near), 1 and, 2 bit ops,
# 1 select, 1 min. A: 8 row adds, 10 for the sign test, 4 for den (2 adds,
# compare, select), 1 divide, 4 for near < z < zbuf, 2 selects (z, class),
# plus one select per colour channel.
OPS_PER_PASS_B = 17
OPS_PER_PASS_A = 29


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip(), f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def b_tolerance(got, want, what: str) -> float:
    d = (got - want).abs()
    mean, frac = float(d.mean()), float((d > 2 / 255).float().mean())
    check(mean < 2e-3 and frac < 0.01,
          f"{what}: mean|d|={mean:.3e}, {frac:.3%} of pixels off by > 2/255")
    return float(d.max())


def run(args) -> dict:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    try:
        from carla_imitation_learning_tpu_torch.models import PolicyCNN
        from carla_imitation_learning_tpu_torch.ops import cuda_lib
        from carla_imitation_learning_tpu_torch.ops import raster as ra
        from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
        from carla_imitation_learning_tpu_torch.render.pipeline import (
            RenderConfig, make_renderer, make_scene_setup,
        )
        from carla_imitation_learning_tpu_torch.render.plain_raster import rasterize_plain
        from carla_imitation_learning_tpu_torch.sim.town import make_town
        from carla_imitation_learning_tpu_torch.sim.world import SimParams, reset_env
        from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
    except ImportError as e:
        raise SmokeFailure(f"the port package is not importable next to this script: {e}")

    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {kind} (count {count}); nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = cuda_lib.build()
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    town = make_town(blocks=3, n_buildings=24, n_lights=8).to(dev)
    params = SimParams(n_agents=15)
    rcfg = RenderConfig(height=HW, width=HW, max_triangles=T)
    scene_setup = make_scene_setup(params, town, rcfg, device=dev)
    rows = ra.band_rows(HW)

    # --- phases 3-4: kernels vs plain versions at the fleet's shapes ------
    errs = {"A": 0.0, "B": 0.0}
    inputs = {}
    for seed in range(3):
        states = reset_env(params, town, torch.Generator().manual_seed(seed), N_ENVS)
        setup = scene_setup(states)
        idx, cnt = ra.tile_lists(setup, HW, T, width=HW)
        for n_ch in (1, 3):
            tbl = ra.pack_setup(setup, luma_only=n_ch == 1)
            args_a = (tbl, idx, cnt, HW, HW, rcfg.near, rcfg.far, n_ch, rows)
            sem_k, col_k, depth_k = ra.raster_bands(*args_a)
            sem_p, col_p, depth_p = ra.raster_bands_plain(*args_a)
            torch.cuda.synchronize()
            check(torch.equal(sem_k, sem_p), f"kernel A seed {seed} C={n_ch}: semantic plane differs")
            err = max(float((col_k - col_p).abs().max()), float((depth_k - depth_p).abs().max()))
            check(err < 1e-5, f"kernel A seed {seed} C={n_ch}: max|d| {err:.3e}")
            errs["A"] = max(errs["A"], err)
            if seed == 0 and n_ch == 1:
                inputs["A"] = args_a
        tbl_b = rf.pack_setup_fast(setup)
        idx_b, cnt_b = rf.tile_lists_fast(setup, HW, T, width=HW, lod_px=2.0,
                                          rows_per_band=rows)
        args_b = (tbl_b, idx_b, cnt_b, HW, HW, rcfg.near, rcfg.far, 0.0, rows)
        out_k = rf.fast_bands(*args_b)
        out_p = rf.fast_bands_plain(*args_b)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        check(err < 1e-5, f"kernel B seed {seed}: max|d| vs plain {err:.3e}")
        errs["B"] = max(errs["B"], err)
        if seed == 0:
            inputs["B"] = args_b
        g_fast = rf.rasterize_luma_fast(setup, HW, HW)
        g_exact, _, _ = ra.rasterize_exact_luma(setup, HW, HW)
        worst = b_tolerance(g_fast, g_exact, f"kernel B vs kernel A luma, seed {seed}")
        log(f"seed {seed}: A vs plain ok, B vs plain max|d|={err:.3e}, "
            f"B vs A luma max|d|={worst:.3e}")

    kernels = []
    for name, fn, plain, src, replaces in (
            ("A", ra.raster_bands, ra.raster_bands_plain, "raster_exact.cu",
             "carla_imitation_learning_tpu/ops/raster.py:120"),
            ("B", rf.fast_bands, rf.fast_bands_plain, "raster_fast.cu",
             "carla_imitation_learning_tpu/ops/raster_fast.py:400")):
        a = inputs[name]
        tbl, idx, cnt = a[0], a[1], a[2]
        ms = cuda_ms(lambda: fn(*a), reps=20)
        plain_ms = cuda_ms(lambda: plain(*a), reps=2, warmup=1)
        pix = rows * HW
        passes = float(cnt.sum())
        if name == "A":
            n_ch = a[7]
            ops = passes * pix * (OPS_PER_PASS_A + n_ch)
            out_bytes = N_ENVS * HW * HW * 4 * (2 + n_ch)
        else:
            ops = passes * pix * OPS_PER_PASS_B
            out_bytes = N_ENVS * HW * HW * 4
        nbytes = (tbl.numel() + idx.numel() + cnt.numel()) * 4 + out_bytes
        bound_ms, bound_by = bound(ops, nbytes)
        kernels.append({
            "name": "raster_exact (kernel A, luma)" if name == "A" else "raster_fast (kernel B)",
            "route": "cuda",
            "source": f"carla_imitation_learning_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": 0, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "passes_per_band": passes / (N_ENVS * idx.shape[1])})
        log(f"kernel {name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound "
            f"{bound_ms:.3f} ms by {bound_by}, {passes / (N_ENVS * idx.shape[1]):.1f} "
            f"passes per band)")
    del inputs

    cross = check_against_cpu(params, town, rcfg, dev)
    log(json.dumps({"card_vs_cpu": cross}))

    # --- phase 6: the main path ------------------------------------------
    ra.EXACT_KERNEL.launches = 0
    rf.FAST_KERNEL.launches = 0
    gate_states = reset_env(params, town, torch.Generator().manual_seed(7), 3)
    exact = make_renderer(params, town, rcfg, device=dev)(gate_states)
    rgb_ref, sem_ref, _ = rasterize_plain(scene_setup(gate_states), HW, HW)
    check(torch.equal(exact["semantic"], sem_ref), "render gate: semantic plane differs")
    gate_err = float((exact["rgb"] - rgb_ref).abs().max())
    check(gate_err < 1e-5, f"render gate: exact kernel vs plain reference max|d| {gate_err:.3e}")
    luma_cfg = RenderConfig(height=HW, width=HW, max_triangles=T, rgb=False)
    fast_cfg = RenderConfig(height=HW, width=HW, max_triangles=T, rgb=False, fast=True)
    b_tolerance(make_renderer(params, town, fast_cfg, device=dev)(gate_states)["gray"],
                make_renderer(params, town, luma_cfg, device=dev)(gate_states)["gray"],
                "render gate: fast vs exact luma")
    log(f"render gate: exact kernel vs plain reference max|d|={gate_err:.3e}")

    torch.manual_seed(0)
    model = PolicyCNN().to(dev).eval()

    def policy_fn(obs):
        return model(obs).argmax(-1)

    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, device=dev)
    carry = init_fn(torch.Generator().manual_seed(1), N_ENVS)

    def timed(carry, n):
        t0 = time.perf_counter()
        carry, traj = rollout_fn(carry, n)
        fetched = float(traj["speed"].sum())
        return carry, time.perf_counter() - t0, traj, fetched

    t0 = time.perf_counter()
    carry, _, _, _ = timed(carry, 16)
    carry, _, traj, _ = timed(carry, 96)
    warm_s = time.perf_counter() - t0
    check(tuple(traj["gray"].shape) == (96, N_ENVS, HW, HW)
          and traj["gray"].dtype == torch.uint8, "rollout frames have the wrong shape")
    check(tuple(carry[1].shape) == (N_ENVS, HW, HW, 4), "frame window has the wrong shape")
    for key in ("speed", "sensor", "steer", "route_ds"):
        check(bool(torch.isfinite(traj[key]).all()), f"rollout {key} not finite")
    check(bool(traj["gray"].float().std() > 1.0), "rollout frames are blank")
    ends = int(traj["done"].sum())
    del traj
    deltas = []
    for _ in range(ROLLOUT_REPEATS):
        carry, t16, _, _ = timed(carry, 16)
        carry, t96, _, _ = timed(carry, 96)
        deltas.append((t96 - t16) / 80)
    state = carry[0]
    for name in ("ego_pos", "ego_yaw", "ego_v", "ego_s", "agents_s", "agents_v"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"state {name} not finite")
    launches = {"A": ra.EXACT_KERNEL.launches, "B": rf.FAST_KERNEL.launches}
    check(launches["A"] > 0, "kernel A was not launched on the main path")
    check(launches["B"] >= (1 + ROLLOUT_REPEATS) * 112, "kernel B was not launched every rollout step")
    for k, name in zip(kernels, ("A", "B")):
        k["launches"] = launches[name]
    per_step = sorted(deltas)[len(deltas) // 2]
    rollout = {"n_envs": N_ENVS, "hw": HW, "env_steps_per_s": N_ENVS / per_step,
               "ms_per_step": per_step * 1e3, "deltas_ms": [d * 1e3 for d in deltas],
               "warmup_s": warm_s, "episode_ends_in_96_steps": ends,
               "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(json.dumps({"rollout": rollout}))

    if args.profile:
        profile(args.profile, params, town, rcfg, model, policy_fn, carry, rollout_fn)
    return {"kernels": kernels, "smi": smi, "kind": kind, "count": count}


def check_against_cpu(params, town, rcfg, dev) -> dict:
    """The main path on a small fleet, on the card and on the CPU (where the
    wrappers run the plain versions), from the same reset draws and pool:
    an expert rollout of CROSS_STEPS steps in which half the envs auto-reset,
    and an fp32 ``PolicyCNN`` forward on its last frame window with TF32
    off. Flags and actions must be equal, sim floats within rtol 1e-5 /
    atol 1e-4, frames within the fast-raster tolerance, logits within 1e-4.
    → the largest differences seen."""
    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.closed_loop import (
        make_rollout, rollout_spawn_pool,
    )

    cpu = torch.device("cpu")
    pool = rollout_spawn_pool(params, town.to(cpu))
    runs = []
    for d in (dev, cpu):
        init_fn, rollout_fn = make_rollout(params, town, rcfg, None, spawn_pool=pool, device=d)
        states, framebuf, just_reset = init_fn(torch.Generator().manual_seed(11), CROSS_ENVS)
        near_end = torch.arange(CROSS_ENVS, device=d) % 2 == 0
        states = states.replace(t=torch.where(near_end, params.episode_len - 3, states.t))
        (states, framebuf, _), traj = rollout_fn((states, framebuf, just_reset), CROSS_STEPS)
        runs.append((states, framebuf, {k: v.to(cpu) for k, v in traj.items()}))
    (s_k, _, tr_k), (s_p, fb_p, tr_p) = runs
    check(bool(tr_p["done"].any()), "card vs CPU: no auto-reset happened")
    for key in ("action", "done", "collision", "offroad", "red_light", "ran_red",
                "traffic", "command"):
        check(torch.equal(tr_k[key], tr_p[key]), f"card vs CPU: {key} differs")
    worst = {"sim": 0.0}
    floats = [(k, tr_k[k], tr_p[k]) for k in ("speed", "sensor", "steer", "route_ds")]
    floats += [(name, getattr(s_k, name).to(cpu), getattr(s_p, name))
               for name in ("ego_pos", "ego_yaw", "ego_v", "ego_s", "agents_s", "agents_v")]
    for name, got, want in floats:
        excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
        check(excess <= 1e-4, f"card vs CPU: {name} off by {excess:.3e} beyond rtol 1e-5")
        worst["sim"] = max(worst["sim"], float((got - want).abs().max()))
    worst["frames"] = b_tolerance(tr_k["gray"].float() / 255, tr_p["gray"].float() / 255,
                                  "card vs CPU frames")

    torch.manual_seed(0)
    model = PolicyCNN(dtype=torch.float32).eval()
    obs = fb_p.float() / 255
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = model(obs)
            got = model.to(dev)(obs.to(dev)).to(cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    worst["logits"] = float((got - want).abs().max())
    check(worst["logits"] < 1e-4, f"card vs CPU: fp32 logits off by {worst['logits']:.3e}")
    return worst


def profile(out_dir, params, town, rcfg, model, policy_fn, carry, rollout_fn) -> None:
    """Per-stage host-clock breakdown of one fleet step, and a torch.profiler
    window of 8 steps (device time by kernel, device busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_renderer
    from carla_imitation_learning_tpu_torch.sim.world import (
        autopilot_control, pick_fresh_packed, step_env,
    )
    from carla_imitation_learning_tpu_torch.training.closed_loop import rollout_spawn_pool

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    states, framebuf = carry[0], carry[1]
    render = make_renderer(params, town, RenderConfig(
        height=rcfg.height, width=rcfg.width, max_triangles=rcfg.max_triangles,
        rgb=False, fast=True, lod_px=2.0), device="cuda")
    pool = rollout_spawn_pool(params, town)
    obs = framebuf.to(torch.float32) / 255.0

    def sim_step():
        ctrl = autopilot_control(params, town, states)
        step_env(params, town, states, ctrl, pick_fresh_packed(pool, params, states))

    stages = {}
    with torch.no_grad():
        for name, fn in (("render", lambda: render(states)),
                         ("policy", lambda: policy_fn(obs)),
                         ("sim_expert_step", sim_step)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            stages[name + "_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    log(json.dumps({"stages": stages}))

    rollout_fn(carry, 4)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout_fn(carry, 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies); one stream, so they do not
    # overlap and their durations sum to the device's busy time
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups: dict[str, list] = {}
    for e in kernels:
        name = e.name
        group = ("raster_fast kernel" if "fast_band_kernel" in name
                 else "policy convolutions" if any(s in name for s in (
                     "xmma", "cudnn", "conv", "Nchw", "Nhwc", "nchw", "nhwc"))
                 else "sort" if "sort" in name.lower()
                 else "other elementwise / index / reduce")
        g = groups.setdefault(group, [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    busy_us = sum(g[0] for g in groups.values())
    summary = {"steps": 8, "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
               "device_idle_share": 1.0 - busy_us / 1e6 / wall,
               "device_launches": len(kernels),
               "groups": {k: {"device_ms": v[0] / 1e3, "launches": v[1]}
                          for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])}}
    (out / "profile_summary.json").write_text(json.dumps(summary, indent=1))
    log(json.dumps({"profile": summary}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT_DIR", default=None,
                        help="also write a per-stage breakdown and a profiler trace")
    args = parser.parse_args()
    try:
        res = run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": res["kernels"]}), flush=True)
    print(res["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": res["kind"],
                                             "count": res["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
