#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT_DIR]

Phases (any failure exits nonzero, with no result line):
1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every hand-written kernel from ``csrc/`` (one nvcc per source,
   all started together);
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
   and 96 steps (median of 3 pairs), each ending in a host fetch of a
   reduced value;
7. the rich fleet (same town and envs, the rich128 preset: facade bands,
   markings, shadows, textures, T=1408) from three seeds: kernel A's
   textured variant (C=1 and C=3), kernel C (fused quads) and kernel D
   (grouped band tables) vs their plain versions, C vs B within the quad
   contract, D vs B bit for bit; each timed at those shapes;
8. the rich collection path, counts reset just before it: the expert
   rollout with ``record_semantic=True`` on the rich preset at 1024 envs
   (what segmentation collection runs: kernel B for the policy frame, kernel
   A's textured variant for the class ids), marginal env-steps/s as above,
   with a per-stage split;
9. the quad and vec paths, counts reset just before them: the same rich
   rollout without the semantic stream with ``quads=False``, ``quads=True``
   and ``vec=True``, in turns, marginal env-steps/s between 16 and 64 steps
   (median of 3 pairs each) — an A/B of kernels C and D against B.
``--profile`` adds a per-stage breakdown and a torch.profiler summary.

The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ENVS, HW, T = 1024, 128, 512
T_RICH = 1408            # the rich128 preset's table
DEVICE = "cuda"
ROLLOUT_SHORT, ROLLOUT_LONG = 16, 96   # marginal rollout pair
ROLLOUT_REPEATS = 3      # marginal pairs; the median is reported
AB_SHORT, AB_LONG = 16, 64   # the quad / vec A/B's marginal pair
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
# C, per pixel and listed primitive: 5 row adds (4 borders, 1/z), 3 min,
# 2 compares (min > 0, 1/z < 1/near), 1 and, 2 bit ops, 1 select, 1 max.
# D computes B's function: B's 17 per listed entry.
OPS_PER_PASS_C = 15
OPS_PER_PASS_D = OPS_PER_PASS_B
# A's textured variant needs the texture once per hit pixel (the winner's):
# 2 × 4 for the u, v numerators, 2 divides, 14 for the factor (2 mul, 2
# floor, 2 mul + 1 add for the hash argument, 1 sin, 1 mul, 1 floor, 1 sub,
# 1 mul, 1 add, 1 select) — plus one multiply per colour channel.
OPS_PER_PIXEL_TEX = 24


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

    dev = torch.device(DEVICE)
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

    # --- phases 3-4: kernels A and B vs plain versions at the fleet's shapes
    errs = {"A": 0.0, "B": 0.0}
    inputs = {}
    for seed in range(3):
        states = reset_env(params, town, torch.Generator().manual_seed(seed), N_ENVS)
        setup = scene_setup(states)
        check(setup.unum is None and setup.zinv is None,
              "the standard setup carries rows only the rich paths read")
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

    pix = rows * HW
    kernels = [
        kernel_entry("raster_exact (kernel A, luma)", "A", "raster_exact.cu",
                     "carla_imitation_learning_tpu/ops/raster.py:120", ra.raster_bands,
                     ra.raster_bands_plain, inputs["A"], errs["A"],
                     ops=float(inputs["A"][2].sum()) * pix * (OPS_PER_PASS_A + 1),
                     out_bytes=N_ENVS * HW * HW * 4 * 3,
                     passes_per_band=float(inputs["A"][2].float().mean())),
        kernel_entry("raster_fast (kernel B)", "B", "raster_fast.cu",
                     "carla_imitation_learning_tpu/ops/raster_fast.py:400", rf.fast_bands,
                     rf.fast_bands_plain, inputs["B"], errs["B"],
                     ops=float(inputs["B"][2].sum()) * pix * OPS_PER_PASS_B,
                     out_bytes=N_ENVS * HW * HW * 4,
                     passes_per_band=float(inputs["B"][2].float().mean())),
    ]
    del inputs

    cross = check_against_cpu(params, town, rcfg, dev)
    log(json.dumps({"card_vs_cpu": cross}))

    # --- phase 6: the main path ------------------------------------------
    reset_counts()
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
    carry, _, _, _ = timed(carry, ROLLOUT_SHORT)
    carry, _, traj, _ = timed(carry, ROLLOUT_LONG)
    warm_s = time.perf_counter() - t0
    check(tuple(traj["gray"].shape) == (ROLLOUT_LONG, N_ENVS, HW, HW)
          and traj["gray"].dtype == torch.uint8, "rollout frames have the wrong shape")
    check(tuple(carry[1].shape) == (N_ENVS, HW, HW, 4), "frame window has the wrong shape")
    for key in ("speed", "sensor", "steer", "route_ds"):
        check(bool(torch.isfinite(traj[key]).all()), f"rollout {key} not finite")
    check(bool(traj["gray"].float().std() > 1.0), "rollout frames are blank")
    ends = int(traj["done"].sum())
    del traj
    deltas = []
    for _ in range(ROLLOUT_REPEATS):
        carry, t_short, _, _ = timed(carry, ROLLOUT_SHORT)
        carry, t_long, _, _ = timed(carry, ROLLOUT_LONG)
        deltas.append((t_long - t_short) / (ROLLOUT_LONG - ROLLOUT_SHORT))
    state = carry[0]
    for name in ("ego_pos", "ego_yaw", "ego_v", "ego_s", "agents_s", "agents_v"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"state {name} not finite")
    launches = read_counts()
    check(launches["A"] > 0, "kernel A was not launched on the main path")
    check(launches["B"] >= (1 + ROLLOUT_REPEATS) * (ROLLOUT_SHORT + ROLLOUT_LONG),
          "kernel B was not launched every rollout step")
    check(launches["A-tex"] + launches["C"] + launches["D"] == 0,
          "the main path launched a rich-scene kernel")
    per_step = sorted(deltas)[len(deltas) // 2]
    rollout = {"n_envs": N_ENVS, "hw": HW, "env_steps_per_s": N_ENVS / per_step,
               "ms_per_step": per_step * 1e3, "deltas_ms": [d * 1e3 for d in deltas],
               "warmup_s": warm_s, "episode_ends_in_long_rollout": ends,
               "launches": launches,
               "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(json.dumps({"rollout": rollout}))
    paths = {"main": launches}
    # the rich phases allocate gigabytes of temporaries; they run after the
    # main path has been timed
    kernels += rich_kernels(params, town, dev, rows)
    paths["rich_collection"] = rich_collection(params, town, dev)
    paths["quad_vec_ab"] = quad_vec_ab(params, town, dev, kernels)
    for k in kernels:
        path = k.pop("path")
        k["launches"] = paths[path][k.pop("counter")]
        k["launches_path"] = path

    if args.profile:
        profile(args.profile, params, town, rcfg, model, policy_fn, carry, rollout_fn)
    return {"kernels": kernels, "smi": smi, "kind": kind, "count": count}



def counters() -> dict:
    """name → LaunchCount of every kernel wrapper."""
    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    return {"A": ra.EXACT_KERNEL, "A-tex": ra.EXACT_TEX_KERNEL, "B": rf.FAST_KERNEL,
            "C": rf.PRIM_KERNEL, "D": rf.VEC_KERNEL}


def reset_counts() -> None:
    for c in counters().values():
        c.launches = 0


def read_counts() -> dict:
    return {name: c.launches for name, c in counters().items()}


def kernel_entry(name, counter, src, replaces, fn, plain, args, err, ops, out_bytes,
                 table_bytes=None, path="main", **extra) -> dict:
    """One entry of the ``kernels`` line: the kernel and its plain version
    timed with CUDA events on ``args``, and the bound from ``ops`` and the
    bytes of the inputs (each read once) and outputs (each written once)."""
    ms = cuda_ms(lambda: fn(*args), reps=20)
    plain_ms = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
    if table_bytes is None:
        table_bytes = sum(a.numel() * a.element_size() for a in args
                          if hasattr(a, "numel"))
    bound_ms, bound_by = bound(ops, table_bytes + out_bytes)
    log(f"{name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms "
        f"by {bound_by}, max|d| vs plain {err:.3e})")
    return {"name": name, "route": "cuda",
            "source": f"carla_imitation_learning_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "path": path, "counter": counter, **extra}


def rich_config(**kw):
    """The rich128 preset (facade bands, shadows, markings, textures)."""
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig

    return RenderConfig(height=HW, width=HW, max_triangles=T_RICH, facade_bands=3,
                        shadows=True, markings=True, texture_detail=True, **kw)


def rich_kernels(params, town, dev, rows) -> list:
    """Phase 7: kernel A's textured variant, C and D on the rich fleet vs
    their plain versions (and C, D vs B) from three seeds; → their entries
    of the ``kernels`` line, timed on seed 0's inputs."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.render.pipeline import make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    rich = rich_config()
    tex_setup = make_scene_setup(params, town, rich, device=dev)
    quad_setup = make_scene_setup(params, town, dataclasses.replace(
        rich, rgb=False, fast=True, quads=True), device=dev)
    near, far = rich.near, rich.far
    errs = {"A-tex": 0.0, "C": 0.0, "D": 0.0}
    inputs, report = {}, {"seeds": []}
    for seed in range(3):
        states = reset_env(params, town, torch.Generator().manual_seed(seed), N_ENVS)
        s_tex = tex_setup(states)
        check(s_tex.unum is not None, "the rich exact setup has no UV rows")
        idx, cnt = ra.tile_lists(s_tex, HW, T_RICH, width=HW)
        for n_ch in (1, 3):
            tbl = ra.pack_setup(s_tex, luma_only=n_ch == 1)
            check(tbl.shape[1] == ra.TEX_PACK_WIDTH, "the rich table is not textured")
            args = (tbl, idx, cnt, HW, HW, near, far, n_ch, rows)
            sem_k, col_k, depth_k = ra.raster_bands(*args)
            sem_p, col_p, depth_p = ra.raster_bands_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(sem_k, sem_p), f"kernel A-tex seed {seed} C={n_ch}: semantic plane differs")
            err = max(float((col_k - col_p).abs().max()), float((depth_k - depth_p).abs().max()))
            check(err < 1e-5, f"kernel A-tex seed {seed} C={n_ch}: max|d| {err:.3e}")
            errs["A-tex"] = max(errs["A-tex"], err)
            if seed == 0 and n_ch == 1:
                inputs["A-tex"] = args
                hits = float((depth_k < far).sum())
        del s_tex, tbl, sem_k, col_k, depth_k, sem_p, col_p, depth_p

        s_q = quad_setup(states)
        prims = rf.fuse_prims(s_q)
        tbl_c = rf.pack_setup_prims(prims)
        idx_c, cnt_c = rf.tile_lists_fast(prims, HW, T_RICH, width=HW, lod_px=2.0,
                                          rows_per_band=rows)
        args_c = (tbl_c, idx_c, cnt_c, HW, HW, near, far, 0.0, rows)
        out_c = rf.prim_bands(*args_c)
        err = float((out_c - rf.prim_bands_plain(*args_c)).abs().max())
        check(err < 1e-5, f"kernel C seed {seed}: max|d| vs plain {err:.3e}")
        errs["C"] = max(errs["C"], err)

        tbl_b = rf.pack_setup_fast(s_q)
        seen, counts = {}, {"A-tex": cnt, "C": cnt_c}
        for lod in (2.0, 0.0):
            idx_b, cnt_b = rf.tile_lists_fast(s_q, HW, T_RICH, width=HW, lod_px=lod,
                                              rows_per_band=rows)
            args_b = (tbl_b, idx_b, cnt_b, HW, HW, near, far, 0.0, rows)
            btbl = rf.gather_band_tables(tbl_b, idx_b)
            args_d = (btbl, cnt_b, HW, HW, near, far, 0.0, rows)
            out_b, out_d = rf.fast_bands(*args_b), rf.vec_bands(*args_d)
            check(torch.equal(out_d, rf.vec_bands_plain(*args_d)),
                  f"kernel D seed {seed} lod {lod}: differs from its plain version")
            seen[lod] = int((out_d != out_b).sum())
            if lod == 0.0:   # no LOD-culled entries in the tails: equal to B
                check(seen[lod] == 0, f"kernel D seed {seed}: {seen[lod]} pixels differ from B")
                fog_b = rf.fast_bands(*args_b[:7], 0.02, rows)
                fog_d = rf.vec_bands(*args_d[:6], 0.02, rows)
                fog_err = float((fog_b - fog_d).abs().max())
                check(fog_err <= 1.2e-7, f"kernel D seed {seed} with fog: max|d| vs B {fog_err:.3e}")
            else:
                counts["B"] = cnt_b
                b_tolerance(out_d, out_b, f"kernel D vs B seed {seed} lod 2")
                d = (out_c - out_b).abs()
                quad = {"mean": float(d.mean()), "frac_over_2_255": float((d > 2 / 255).float().mean()),
                        "max": float(d.max())}
                check(quad["mean"] < 1e-3 and quad["frac_over_2_255"] < 0.005,
                      f"kernel C vs B seed {seed}: outside the quad contract {quad}")
                if seed == 0:
                    inputs["B-rich"], inputs["D"] = args_b, args_d
                    inputs["C"] = args_c
        report["seeds"].append({"seed": seed, "C_vs_B": quad,
                                "D_vs_B_pixels_differing_lod2": seen[2.0],
                                "D_vs_B_pixels_differing_lod0": seen[0.0],
                                "fog_D_vs_B_max": fog_err,
                                "passes_per_band": {k: float(v.float().mean())
                                                    for k, v in counts.items()}})
        del s_q, prims
        torch.cuda.synchronize()
        log(f"rich seed {seed}: A-tex vs plain ok, C vs B {quad}, D vs B pixels "
            f"differing {seen}")

    pix = rows * HW
    a_args, c_args, d_args = inputs["A-tex"], inputs["C"], inputs["D"]
    b_ms = cuda_ms(lambda: rf.fast_bands(*inputs["B-rich"]), reps=20)
    report["kernel_ms_per_frame"] = {"B": b_ms}
    entries = [
        kernel_entry("raster_exact textured (kernel A-tex, luma)", "A-tex", "raster_exact.cu",
                     "carla_imitation_learning_tpu/ops/raster.py:151", ra.raster_bands,
                     ra.raster_bands_plain, a_args, errs["A-tex"],
                     ops=float(a_args[2].sum()) * pix * (OPS_PER_PASS_A + 1)
                     + hits * (OPS_PER_PIXEL_TEX + 1),
                     out_bytes=N_ENVS * HW * HW * 4 * 3, path="rich_collection"),
        kernel_entry("raster_prim (kernel C)", "C", "raster_prim.cu",
                     "carla_imitation_learning_tpu/ops/raster_fast.py:265", rf.prim_bands,
                     rf.prim_bands_plain, c_args, errs["C"],
                     ops=float(c_args[2].sum()) * pix * OPS_PER_PASS_C,
                     out_bytes=N_ENVS * HW * HW * 4, path="quad_vec_ab", b_ms_same_scene=b_ms),
        kernel_entry("raster_vec (kernel D)", "D", "raster_vec.cu",
                     "carla_imitation_learning_tpu/ops/raster_fast.py:341", rf.vec_bands,
                     rf.vec_bands_plain, d_args, errs["D"],
                     ops=float(d_args[1].sum()) * pix * OPS_PER_PASS_D,
                     # the listed entries it needs (64 B each), counts, output
                     table_bytes=float(d_args[1].sum()) * 64 + d_args[1].numel() * 4,
                     out_bytes=N_ENVS * HW * HW * 4, path="quad_vec_ab", b_ms_same_scene=b_ms),
    ]
    for e in entries:
        report["kernel_ms_per_frame"][e["counter"]] = e["ms"]
    log(json.dumps({"rich_kernels": report}))
    return entries


def marginal(rollout_fn, carry, short: int, long: int, repeats: int):
    """Marginal seconds per fleet step between rollouts of ``short`` and
    ``long`` steps, each ending in a host fetch; → (carry, [s per step])."""
    import torch

    def timed(carry, n):
        t0 = time.perf_counter()
        carry, traj = rollout_fn(carry, n)
        float(traj["speed"].sum())
        return carry, time.perf_counter() - t0

    deltas = []
    for _ in range(repeats):
        carry, ts = timed(carry, short)
        carry, tl = timed(carry, long)
        deltas.append((tl - ts) / (long - short))
    torch.cuda.synchronize()
    return carry, deltas


def rate_summary(deltas) -> dict:
    per_step = sorted(deltas)[len(deltas) // 2]
    return {"env_steps_per_s": N_ENVS / per_step, "ms_per_step": per_step * 1e3,
            "env_steps_per_s_min": N_ENVS / max(deltas),
            "env_steps_per_s_max": N_ENVS / min(deltas),
            "deltas_ms": [d * 1e3 for d in deltas]}


def rich_collection(params, town, dev) -> dict:
    """Phase 8: the expert collection rollout with the semantic stream on
    the rich preset at 1024 envs; → launch counts of that path."""
    import torch

    from carla_imitation_learning_tpu_torch.ops.raster import rasterize_exact_luma
    from carla_imitation_learning_tpu_torch.render.geometry import SEM_ROADLINE
    from carla_imitation_learning_tpu_torch.render.pipeline import make_renderer, make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import (
        autopilot_control, pick_fresh_packed, step_env,
    )
    from carla_imitation_learning_tpu_torch.training.closed_loop import (
        make_rollout, rollout_spawn_pool,
    )

    rich = rich_config()
    reset_counts()
    init_fn, rollout_fn = make_rollout(params, town, rich, None, device=dev,
                                       record_semantic=True)
    carry = init_fn(torch.Generator().manual_seed(2), N_ENVS)
    t0 = time.perf_counter()
    carry, _ = rollout_fn(carry, ROLLOUT_SHORT)
    tex_before = counters()["A-tex"].launches
    carry, traj = rollout_fn(carry, ROLLOUT_LONG)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sem = traj["semantic"]
    check(tuple(sem.shape) == (ROLLOUT_LONG, N_ENVS, HW, HW) and sem.dtype == torch.uint8,
          f"semantic stream has shape {tuple(sem.shape)} {sem.dtype}")
    check(int(sem.max()) <= 7 and bool((sem == SEM_ROADLINE).any()),
          "semantic stream: ids outside 0-7 or no lane markings seen")
    check(counters()["A-tex"].launches - tex_before >= ROLLOUT_LONG,
          "kernel A-tex was not launched every collection step")
    check(tuple(traj["gray"].shape) == (ROLLOUT_LONG, N_ENVS, HW, HW),
          "collection frames have the wrong shape")
    check(bool(traj["gray"].float().std() > 1.0), "collection frames are blank")
    for key in ("speed", "sensor", "steer", "route_ds"):
        check(bool(torch.isfinite(traj[key]).all()), f"collection {key} not finite")
    classes = torch.bincount(sem[::8].reshape(-1).long(), minlength=8)
    del traj, sem
    carry, deltas = marginal(rollout_fn, carry, ROLLOUT_SHORT, ROLLOUT_LONG, ROLLOUT_REPEATS)
    for name in ("ego_pos", "ego_yaw", "ego_v", "ego_s", "agents_s", "agents_v"):
        check(bool(torch.isfinite(getattr(carry[0], name)).all()), f"state {name} not finite")
    launches = read_counts()
    check(launches["B"] > 0 and launches["A-tex"] > 0, "the collection path skipped a kernel")
    check(launches["A"] + launches["C"] + launches["D"] == 0,
          "the collection path launched a kernel it does not run")

    # per-stage split, host clock around synchronized calls, mean of 10
    states = carry[0]
    fast_render = make_renderer(params, town, dataclasses.replace(
        rich, rgb=False, fast=True, lod_px=2.0), device=dev)
    sem_setup = make_scene_setup(params, town, dataclasses.replace(rich, rgb=False), device=dev)
    pool = rollout_spawn_pool(params, town)

    def sim_step():
        ctrl = autopilot_control(params, town, states)
        step_env(params, town, states, ctrl, pick_fresh_packed(pool, params, states))

    stages = {}
    for name, fn in (("fast_render", lambda: fast_render(states)),
                     ("semantic_render", lambda: rasterize_exact_luma(sem_setup(states), HW, HW)),
                     ("sim_expert_step", sim_step)):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        stages[name + "_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    reset_counts()
    res = {"n_envs": N_ENVS, "t": T_RICH, **rate_summary(deltas), "warmup_s": warm_s,
           "stages": stages, "class_pixels_every_8th_step": classes.tolist(),
           "launches": launches,
           "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(json.dumps({"rich_collection": res}))
    return launches


def quad_vec_ab(params, town, dev, kernels) -> dict:
    """Phase 9: the rich rollout without the semantic stream, with kernel
    B, C (quads) and D (vec), marginal rates in turns; → launch counts."""
    import torch

    from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout

    variants = {"B": rich_config(), "C": rich_config(quads=True), "D": rich_config(vec=True)}
    reset_counts()
    runs = {}
    for name, rcfg in variants.items():
        init_fn, rollout_fn = make_rollout(params, town, rcfg, None, device=dev)
        carry = init_fn(torch.Generator().manual_seed(3), N_ENVS)
        carry, _ = marginal(rollout_fn, carry, AB_SHORT, AB_LONG, 1)   # warm-up
        runs[name] = [rollout_fn, carry, []]
    for rep in range(ROLLOUT_REPEATS):
        order = list(runs) if rep % 2 == 0 else list(runs)[::-1]
        for name in order:
            run = runs[name]
            run[1], d = marginal(run[0], run[1], AB_SHORT, AB_LONG, 1)
            run[2] += d
    launches = read_counts()
    steps = (1 + ROLLOUT_REPEATS) * (AB_SHORT + AB_LONG)
    for name in ("B", "C", "D"):
        check(launches[name] >= steps, f"kernel {name} was not launched every A/B step")
    ms = {k["counter"]: k["ms"] for k in kernels if k["counter"] in ("C", "D")}
    ms["B"] = next(k["b_ms_same_scene"] for k in kernels if k["counter"] == "C")
    res = {name: {**rate_summary(run[2]), "kernel_ms_per_frame": ms.get(name)}
           for name, run in runs.items()}
    for name in ("C", "D"):
        res[name]["speedup_vs_B"] = res["B"]["ms_per_step"] / res[name]["ms_per_step"]
    res["launches"] = launches
    log(json.dumps({"quad_vec_ab": res}))
    return launches


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
    summary["rich_fast_render"] = profile_rich_render(params, town)
    (out / "profile_summary.json").write_text(json.dumps(summary, indent=1))
    log(json.dumps({"profile": summary}))


def profile_rich_render(params, town) -> dict:
    """The rich fast render of a 1024-env fleet under kernels B, C (quads)
    and D (vec): host ms per synchronized frame (mean of 10), and the
    device time of 5 profiled frames by operator, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from carla_imitation_learning_tpu_torch.render.pipeline import make_renderer
    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    states = reset_env(params, town, torch.Generator().manual_seed(5), N_ENVS)
    res = {}
    for name, kw in (("B", {}), ("C", {"quads": True}), ("D", {"vec": True})):
        render = make_renderer(params, town, rich_config(rgb=False, fast=True, lod_px=2.0, **kw),
                               device=DEVICE)
        for _ in range(3):
            render(states)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            render(states)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                render(states)
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages() if e.device_time_total > 0]
        ops.sort(key=lambda e: -e.device_time_total)
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        res[name] = {"host_ms_per_frame": host_ms,
                     "device_ms_per_frame": sum(e.time_range.elapsed_us()
                                                for e in dev_events) / 5e3,
                     "device_launches_per_frame": len(dev_events) / 5,
                     "top_ops": [{"op": e.key[:60], "device_ms_per_frame": e.device_time_total / 5e3,
                                  "calls_per_frame": e.count / 5} for e in ops[:8]]}
    return res


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
