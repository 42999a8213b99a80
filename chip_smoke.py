#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT_DIR]

Phases (any failure exits nonzero, with no result line):
1. device: the card's name, and its name and power limit from nvidia-smi;
   the issue rate the bounds divide operation counts by (SMs × 128 lanes ×
   the maximum SM clock);
2. build: every hand-written kernel from ``csrc/`` (one nvcc per source,
   all started together), with ptxas's registers and spills and every
   kernel's launch facts (registers, spills, shared memory, resident blocks
   per SM); then kernels A (flat and textured, C = 1 and 3), B, C and D bit
   for bit against their plain versions on the synthetic edge cases of
   ``edge_case_tables``;
3. kernel A (exact z-buffer) vs its plain PyTorch version, and
4. kernel B (fast grayscale) vs its plain version and vs kernel A's luma, on
   the bench town's fleet (1024 envs, 128², T=512) from three seeds; each
   kernel and plain version is timed with CUDA events at those shapes;
   bounds count the (entry, pixel) pairs in the 16 × 16 warp tiles that the
   exact cull keeps (the band-list figure, every listed entry on every pixel
   of its band, is reported beside them) and, for B, C and D, the table and
   list bytes of the positions they walk;
5. the main path on 8 envs, on the card vs on the CPU's plain versions: an
   expert rollout with auto-resets, and an fp32 ``PolicyCNN`` forward (TF32
   is switched off for that comparison and restored after it);
6. the main path, with launch counts reset just before it: the exact-vs-
   plain render gate of the JAX package's bench (through ``make_renderer``),
   then a 1024-env closed-loop rollout with a bf16 ``PolicyCNN`` in the loop
   (``make_rollout``), timed as marginal env-steps/s between rollouts of 16
   and 96 steps (median of 3 pairs), each ending in a host fetch of a
   reduced value;
6b. BC training (``bc_training``), counts reset just before its
   collection: an expert ``collect_dataset`` at 1024 envs × 24 steps (kernel
   B once per step plus the first frame), a shuffled ``DeviceDataset`` on the
   card (batch 256) with a validation tail cut by ``FrameStore.slice``, one
   fp32 train step on the card against the CPU (TF32 off, the clip
   triggered), a bf16 ``Trainer.fit`` of 2 epochs of at most 40 batches,
   the train step timed with CUDA events (median of 3 runs of 50 steps) and
   the trained policy in ``evaluate_policy`` at 256 envs × 50 steps; its
   tensors are freed before the rich phases;
7. the rich fleet (same town and envs, the rich128 preset: facade bands,
   markings, shadows, textures, T=1408) from three seeds: kernel A's
   textured variant (C=1 and C=3), kernel B on the rich lists (2 px and 0
   px LOD), kernel C (fused quads) and kernel D (grouped band tables) vs
   their plain versions, C vs B within the quad contract, D vs B bit for bit
   at 0 px; each timed at those shapes;
8. the rich collection path, counts reset just before it: the expert
   rollout with ``record_semantic=True`` on the rich preset at 1024 envs
   (what segmentation collection runs: kernel B for the policy frame, kernel
   A's textured variant for the class ids), marginal env-steps/s as above,
   with a per-stage split;
9. the quad and vec paths, counts reset just before them: the same rich
   rollout without the semantic stream with ``quads=False``, ``quads=True``
   and ``vec=True``, in turns, marginal env-steps/s between 16 and 64 steps
   (median of 3 pairs each) — an A/B of kernels C and D against B.
``--profile`` adds a per-stage breakdown and torch.profiler summaries (the
policy rollout, the rich fast render, and 10 train steps in ``bc_training``).

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
BC_ENVS, BC_STEPS = 1024, 24     # the BC phase's expert collection (≈ 400 MB of frames)
BC_BATCH, BC_EPOCHS, BC_BATCHES = 256, 2, 40   # its bf16 fit: batches per epoch at most
BC_TIMED_STEPS, BC_TIMED_REPEATS = 50, 3       # train-step timing: median of 3 runs of 50
BC_EVAL_ENVS, BC_EVAL_STEPS = 256, 50          # the trained policy in the closed loop
BC_CLIP, BC_LR = 0.5, 1e-3       # the JAX package's trainer and model defaults
LANES_PER_SM = 128       # lane-instructions an SM issues per clock (4 × 32)
HBM_RATE = 3.35e12       # H100 SXM device memory, B/s
WARP_TILE = 16           # kernels A and B cull per 16 × 16 pixel warp tile
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
# Epilogues, per pixel of the frame. A (C = 1): the winner's class
# conversion and colour. B, C and D: the key decode (2 ands, 1 conversion, 2
# mul, 1 add, 1 reciprocal, 1 mul) and the hit-or-sky compare and select.
OPS_PER_PIXEL_EPILOGUE_A = 2
OPS_PER_PIXEL_EPILOGUE_B = 10
# Bytes a band kernel reads per walked list position: B gathers 13 floats
# through a 4-byte index, C 16 floats through one, D reads a 64-byte row of
# its band's own table.
FAST_ENTRY_BYTES = 13 * 4 + 4
PRIM_ENTRY_BYTES = 16 * 4 + 4
VEC_ENTRY_BYTES = 16 * 4


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


def issue_rate() -> float:
    """Lane-instructions per second the card can issue: SMs × 128 × the
    maximum SM clock. The operation counts of the bounds are single
    instructions (the kernels are built with -fmad=false), so this, and not
    the FP32 peak that counts an FMA as two, is their rate."""
    import torch

    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip(), f"nvidia-smi failed: {res.stderr}")
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * LANES_PER_SM * mhz * 1e6
    log(f"issue rate: {sms} SMs × {LANES_PER_SM} lanes × {mhz:.0f} MHz = {rate:.4e} "
        f"lane-instructions/s")
    return rate


def bound(ops: float, nbytes: float, rate: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def launch_facts(name: str, *variant: int) -> dict:
    """Registers, spill bytes, shared memory, threads and resident blocks
    per SM of a kernel, from its library's ``<name>_info`` entry point."""
    import ctypes

    from carla_imitation_learning_tpu_torch.ops import cuda_lib

    fn = cuda_lib.entry_point(name, f"{name}_info",
                              [ctypes.c_int] * len(variant) + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 5)()
    cuda_lib.raise_on_error(fn(*variant, out), f"{name}_info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "threads", "blocks_per_sm"), out))


def warp_tile_keep(tbl, idx, count, width: int, rows: int, exact: bool, edges: int = 3,
                   group: int = 2):
    """The warp-tile cull of kernel A (``exact``) or B, per 16 × 16 tile of a
    band: the kernels' corner test with their expressions (A: (a·x + b·y) +
    c, either winding; B: a·x + (b·y + c), positive). With ``edges`` = 4 it
    is the same test on kernel C's quads. Yields (x0, x1, y0, y1, keep (B, R,
    K) bool, live (B, R, K) bool) per tile, pixel columns x0..x1 and band
    rows y0..y1; ``live`` marks the positions a kernel walks (A: the count;
    B, C and D: the count rounded up to a ``group``, 2 for the pair walk of B
    and C, 8 for D's groups)."""
    import torch

    B, R, K = idx.shape
    n = count.long() if exact else torch.clamp((count.long() + group - 1) // group * group, max=K)
    live = torch.arange(K, device=idx.device) < n[..., None]
    nc = 3 * edges
    co = torch.gather(tbl[:, :nc], 2, idx.reshape(B, 1, R * K).long().expand(-1, nc, -1))
    co = co.reshape(B, nc, R, K)
    y_band = torch.arange(R, dtype=torch.float32, device=idx.device).view(1, R, 1) * rows
    for x0 in range(0, width, WARP_TILE):
        for y0 in range(0, rows, WARP_TILE):
            x1, y1 = min(x0 + WARP_TILE, width) - 1, min(y0 + WARP_TILE, rows) - 1
            xs = (x0 + 0.5, x1 + 0.5)
            if exact:
                ys = ((y_band + y0) + 0.5, (y_band + y1) + 0.5)
            else:
                ys = (y0 + (y_band + 0.5), y1 + (y_band + 0.5))
            pos = torch.ones_like(live)
            neg = torch.ones_like(live)
            for i in range(edges):
                a, b, c = co[:, 3 * i], co[:, 3 * i + 1], co[:, 3 * i + 2]
                x_hi = torch.where(a > 0, xs[1], xs[0])
                x_lo = torch.where(a > 0, xs[0], xs[1])
                y_hi = torch.where(b > 0, ys[1], ys[0])
                y_lo = torch.where(b > 0, ys[0], ys[1])
                if exact:
                    pos &= (a * x_hi + b * y_hi) + c > 0
                    neg &= (a * x_lo + b * y_lo) + c < 0
                else:
                    pos &= a * x_hi + (b * y_hi + c) > 0
            yield x0, x1, y0, y1, (pos | neg) if exact else pos, live


def warp_tile_pairs(tbl, idx, count, height: int, width: int, rows: int, exact: bool,
                    **kw) -> tuple[int, int]:
    """(listed entry, warp tile) pairs that the cull of ``warp_tile_keep``
    keeps, and (listed entry, pixel) pairs in those tiles: the pass work this
    run's data needs, which the bounds of kernels A to D count."""
    tiles = pixels = 0
    for x0, x1, y0, y1, keep, live in warp_tile_keep(tbl, idx, count, width, rows, exact, **kw):
        n = int((keep & live).sum())
        tiles += n
        pixels += n * (x1 - x0 + 1) * (y1 - y0 + 1)
    return tiles, pixels


def b_tolerance(got, want, what: str) -> float:
    d = (got - want).abs()
    mean, frac = float(d.mean()), float((d > 2 / 255).float().mean())
    check(mean < 2e-3 and frac < 0.01,
          f"{what}: mean|d|={mean:.3e}, {frac:.3%} of pixels off by > 2/255")
    return float(d.max())


def bench_fleet(dev):
    """The bench town on ``dev`` and its sim parameters → (params, town)."""
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams

    return SimParams(n_agents=15), make_town(blocks=3, n_buildings=24, n_lights=8).to(dev)


def exact_args(setup, t: int, near: float, far: float, n_ch: int, rows: int, lists=None):
    """Kernel A's arguments for a fleet's scene setup at HW²: its table
    (luma only when ``n_ch`` = 1; textured when the setup has UV rows), the
    band lists of ``tile_lists`` (or ``lists``) and the frame."""
    from carla_imitation_learning_tpu_torch.ops import raster as ra

    idx, cnt = lists if lists is not None else ra.tile_lists(setup, HW, t, width=HW)
    return (ra.pack_setup(setup, luma_only=n_ch == 1), idx, cnt, HW, HW, near, far, n_ch, rows)


def fast_args(setup, t: int, near: float, far: float, rows: int, lod: float = 2.0):
    """Kernel B's arguments for a fleet's scene setup at HW²: its table, the
    band lists of ``tile_lists_fast`` at ``lod`` px, no fog."""
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    idx, cnt = rf.tile_lists_fast(setup, HW, t, width=HW, lod_px=lod, rows_per_band=rows)
    return (rf.pack_setup_fast(setup), idx, cnt, HW, HW, near, far, 0.0, rows)


def prim_args(setup, t: int, near: float, far: float, rows: int):
    """Kernel C's arguments for a fleet's quad-ready setup at HW²: the fused
    primitives' table, their band lists at 2 px LOD, no fog."""
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    prims = rf.fuse_prims(setup)
    idx, cnt = rf.tile_lists_fast(prims, HW, t, width=HW, lod_px=2.0, rows_per_band=rows)
    return (rf.pack_setup_prims(prims), idx, cnt, HW, HW, near, far, 0.0, rows)


def vec_args(args_b):
    """Kernel D's arguments from kernel B's: B's table gathered through its
    lists (T_RICH is a multiple of VEC_P, so no padding is needed)."""
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    return (rf.gather_band_tables(args_b[0], args_b[1]), *args_b[2:])


def kernel_inputs(kernel: str, dev, seed: int = 0):
    """(wrapper, plain version, arguments) of kernel A (luma, T = 512),
    A-tex (luma, the rich preset, T = 1408), B (T = 512), B-rich (B on the
    rich preset's lists), C (the rich preset's fused quads) or D (B-rich's
    lists as band tables) on ``seed``'s 1024-env fleet: the inputs that the
    kernel phases time."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    params, town = bench_fleet(dev)
    standard = RenderConfig(height=HW, width=HW, max_triangles=T)
    quad_ready = rich_config(rgb=False, fast=True, quads=True)
    rcfg, t = {"A": (standard, T), "B": (standard, T), "A-tex": (rich_config(), T_RICH),
               "B-rich": (quad_ready, T_RICH), "C": (quad_ready, T_RICH),
               "D": (quad_ready, T_RICH)}[kernel]
    states = reset_env(params, town, torch.Generator().manual_seed(seed), N_ENVS)
    setup = make_scene_setup(params, town, rcfg, device=dev)(states)
    rows = ra.band_rows(HW)
    if kernel.startswith("A"):
        return (ra.raster_bands, ra.raster_bands_plain,
                exact_args(setup, t, rcfg.near, rcfg.far, 1, rows))
    if kernel == "C":
        return rf.prim_bands, rf.prim_bands_plain, prim_args(setup, t, rcfg.near, rcfg.far, rows)
    args = fast_args(setup, t, rcfg.near, rcfg.far, rows)
    if kernel == "D":
        return rf.vec_bands, rf.vec_bands_plain, vec_args(args)
    return rf.fast_bands, rf.fast_bands_plain, args


def check_exact(args, what: str) -> tuple[float, int]:
    """Kernel A on ``args`` against its plain version: the semantic plane,
    colours and depths must be equal. → (max|d|, hit pixels)."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster as ra

    sem_k, col_k, depth_k = ra.raster_bands(*args)
    sem_p, col_p, depth_p = ra.raster_bands_plain(*args)
    check(torch.equal(sem_k, sem_p), f"{what}: semantic plane differs")
    err = max(float((col_k - col_p).abs().max()), float((depth_k - depth_p).abs().max()))
    check(torch.equal(col_k, col_p) and torch.equal(depth_k, depth_p), f"{what}: max|d| {err:.3e}")
    return err, int((depth_k < args[6]).sum())


def check_fast(args, what: str):
    """Kernel B on ``args`` against its plain version, bit for bit. →
    (max|d|, the kernel's frame)."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    got, want = rf.fast_bands(*args), rf.fast_bands_plain(*args)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"{what}: max|d| vs plain {err:.3e}")
    return err, got


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
        from carla_imitation_learning_tpu_torch.sim.world import reset_env
        from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
    except ImportError as e:
        raise SmokeFailure(f"the port package is not importable next to this script: {e}")

    dev = torch.device(DEVICE)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {kind} (count {count}); nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    rate = issue_rate()
    t0 = time.perf_counter()
    reports = cuda_lib.build()
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    facts = {"A": launch_facts("raster_exact", 1, 0), "A-tex": launch_facts("raster_exact", 1, 1),
             "B": launch_facts("raster_fast"), "C": launch_facts("raster_prim"),
             "D": launch_facts("raster_vec")}
    log(json.dumps({"launch_facts": facts}))

    # --- phase 2b: kernels A to D vs plain on synthetic edge cases
    t0 = time.perf_counter()
    edges = edge_case_phase(dev)
    log(json.dumps({"edge_cases": {**edges, "s": time.perf_counter() - t0}}))

    params, town = bench_fleet(dev)
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
        lists = ra.tile_lists(setup, HW, T, width=HW)
        for n_ch in (1, 3):
            args_a = exact_args(setup, T, rcfg.near, rcfg.far, n_ch, rows, lists)
            errs["A"] = max(errs["A"], check_exact(args_a, f"kernel A seed {seed} C={n_ch}")[0])
            if seed == 0 and n_ch == 1:
                inputs["A"] = args_a
        args_b = fast_args(setup, T, rcfg.near, rcfg.far, rows)
        err = check_fast(args_b, f"kernel B seed {seed}")[0]
        errs["B"] = max(errs["B"], err)
        if seed == 0:
            inputs["B"] = args_b
        g_fast = rf.rasterize_luma_fast(setup, HW, HW)
        g_exact, _, _ = ra.rasterize_exact_luma(setup, HW, HW)
        worst = b_tolerance(g_fast, g_exact, f"kernel B vs kernel A luma, seed {seed}")
        log(f"seed {seed}: A vs plain ok, B vs plain max|d|={err:.3e}, "
            f"B vs A luma max|d|={worst:.3e}")

    a_args, b_args = inputs.pop("A"), inputs.pop("B")
    frame_px = N_ENVS * HW * HW
    a_tiles, a_kept = warp_tile_pairs(*a_args[:5], rows, exact=True)
    b_tiles, b_kept = warp_tile_pairs(*b_args[:5], rows, exact=False)
    kernels = [
        kernel_entry("raster_exact (kernel A, luma)", "A", "raster_exact.cu",
                     "carla_imitation_learning_tpu/ops/raster.py:120", ra.raster_bands,
                     ra.raster_bands_plain, a_args, errs["A"], rate,
                     ops=a_kept * OPS_PER_PASS_A + frame_px * OPS_PER_PIXEL_EPILOGUE_A,
                     band_list_ops=listed(a_args[2], rows) * (OPS_PER_PASS_A + 1),
                     out_bytes=frame_px * 4 * 3, rows=rows, warp_tile_pairs=a_tiles,
                     kept_pairs=a_kept, passes_per_band=float(a_args[2].float().mean()),
                     **facts["A"]),
        kernel_entry("raster_fast (kernel B)", "B", "raster_fast.cu",
                     "carla_imitation_learning_tpu/ops/raster_fast.py:400", rf.fast_bands,
                     rf.fast_bands_plain, b_args, errs["B"], rate,
                     ops=b_kept * OPS_PER_PASS_B + frame_px * OPS_PER_PIXEL_EPILOGUE_B,
                     band_list_ops=listed(b_args[2], rows) * OPS_PER_PASS_B,
                     table_bytes=walked_bytes(b_args[2], 2, b_args[1].shape[2], FAST_ENTRY_BYTES),
                     out_bytes=frame_px * 4, rows=rows, warp_tile_pairs=b_tiles,
                     kept_pairs=b_kept, passes_per_band=float(b_args[2].float().mean()),
                     **facts["B"]),
    ]
    del a_args, b_args

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
    bc_training(params, town, rcfg, dev, profile=args.profile is not None)
    # the rich phases allocate gigabytes of temporaries; they run after the
    # main path has been timed
    rich, b_rich_err = rich_kernels(params, town, dev, rows, rate, facts)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], b_rich_err)
    kernels += rich
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


def walked_bytes(count, group: int, k: int, entry_bytes: int) -> float:
    """Bytes of table and list that a band kernel reads: ``entry_bytes`` for
    each list position it walks (the count rounded up to a ``group``, at most
    ``k``), and the counts."""
    import torch

    n_pass = torch.clamp((count.long() + group - 1) // group * group, max=k)
    return float(n_pass.sum()) * entry_bytes + count.numel() * 4


def listed(count, rows: int) -> float:
    """(entry, pixel) pairs of band lists of ``count`` entries over bands of
    ``rows`` × HW pixels: what a pass without a cull walks."""
    return float(count.sum()) * rows * HW


def kernel_entry(name, counter, src, replaces, fn, plain, args, err, rate, ops, out_bytes,
                 table_bytes=None, path="main", band_list_ops=None, rows=None, count=None,
                 **extra) -> dict:
    """One entry of the ``kernels`` line: the kernel and its plain version
    timed with CUDA events on ``args``, and the bound from ``ops`` at the
    issue ``rate`` and the bytes of the inputs (each read once) and outputs
    (each written once). ``ops`` counts the pass work this run's data needs,
    the (entry, pixel) pairs in the warp tiles that the exact cull keeps,
    plus the epilogue. With ``band_list_ops`` (the same count over every
    listed entry on every pixel of its band), also the band-list figure, and
    with ``rows``, the listed pairs (of the list counts ``count``, by
    default ``args[2]``) and the lane-instruction slots the kernel's time
    held per listed pair."""
    ms = cuda_ms(lambda: fn(*args), reps=20)
    plain_ms = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
    if table_bytes is None:
        table_bytes = sum(a.numel() * a.element_size() for a in args
                          if hasattr(a, "numel"))
    bound_ms, bound_by = bound(ops, table_bytes + out_bytes, rate)
    if band_list_ops is not None:
        extra["band_list_bound_ms"] = bound(band_list_ops, table_bytes + out_bytes, rate)[0]
    if rows is not None:
        pairs = listed(args[2] if count is None else count, rows)
        extra.update(listed_pairs=pairs, slots_per_pair=ms * 1e-3 * rate / pairs,
                     band_tile_pairs=pairs / (rows * HW) * (HW // WARP_TILE) * (rows // WARP_TILE))
    log(f"{name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms "
        f"by {bound_by}, band-list bound {extra.get('band_list_bound_ms', float('nan')):.3f} ms, "
        f"max|d| vs plain {err:.3e})"
        + (f", {extra['registers']} registers, {extra['spill_bytes']} spill bytes, "
           f"{extra['smem_bytes']} B shared, {extra['blocks_per_sm']} blocks/SM"
           if "registers" in extra else ""))
    return {"name": name, "route": "cuda",
            "source": f"carla_imitation_learning_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "path": path, "counter": counter, **extra}


# (H, W): bands of 32, 32, 24, 20 and 20 rows; 150 columns is no multiple of 4,
# which takes the kernels' column-by-column row stores
EDGE_FRAMES = ((64, 64), (96, 96), (48, 80), (40, 160), (40, 150))
EDGE_T = 640             # table width of the synthetic frames
EDGE_LONG = 300          # entries on the long list: more than two staging chunks
EDGE_NEAR, EDGE_FAR = 0.5, 300.0
EDGE_FOG = 0.02          # the fog density the edge cases also run at
EDGE_OVER_Z = 0.6        # depth of kernel C's strip with an overflowing border


def _screen_rows(xy, w, depth, uv):
    """Rows of screen triangles as ``project_triangles`` builds them, in
    float64: vertices (n, 3, 2) in pixels with homogeneous weights w (n, 3),
    depths (n, 3) and surface coordinates uv (n, 3, 2) → edges (n, 3, 3)
    (E_i = v_{i+1} × v_{i+2}, not sign-normalized), znum, unum, vnum (n, 3),
    det (n,)."""
    import numpy as np

    v = np.stack([xy[..., 0] * w, xy[..., 1] * w, w], -1)
    edges = np.stack([np.cross(v[:, 1], v[:, 2]), np.cross(v[:, 2], v[:, 0]),
                      np.cross(v[:, 0], v[:, 1])], 1)
    det = (v[:, 0] * edges[:, 0]).sum(-1)
    znum = (depth[..., None] * edges).sum(1)
    unum = (uv[..., 0, None] * edges).sum(1)
    vnum = (uv[..., 1, None] * edges).sum(1)
    return edges, znum, unum, vnum, det


def _plane_rows(xy, values):
    """Rows (a, b, c) of the screen-affine functions through ``values`` (n,
    3) at the vertices ``xy`` (n, 3, 2), in float64; zeros where the
    vertices are collinear."""
    import numpy as np

    m = np.concatenate([xy, np.ones(xy.shape[:2] + (1,))], -1)       # (n, 3, 3)
    ok = np.abs(np.linalg.det(m)) > 1e-9
    out = np.zeros((len(xy), 3))
    out[ok] = np.linalg.solve(m[ok], values[ok][..., None])[..., 0]
    return out


def _border_rows(quads):
    """Sign-normalized border rows (n, 4, 3) of convex quads (n, 4, 2): the
    line through corners i and i + 1, positive inside."""
    import numpy as np

    h = np.concatenate([quads, np.ones(quads.shape[:2] + (1,))], -1)
    rows = np.cross(h, np.roll(h, -1, axis=1))
    centre = np.concatenate([quads.mean(1), np.ones((len(quads), 1))], -1)
    sign = np.where((rows * centre[:, None]).sum(-1) < 0, -1.0, 1.0)
    return rows * sign[..., None]


def _band_lists(meets, zmin, special: int, sub_lod: int, env: int):
    """Nearest-first lists of what ``meets`` (R, n) each band, with the
    ``special`` entry (one that lights nothing) inserted mid-list and the
    last band of env 1 empty. → (the lists; (listed count, list) pairs in
    which even bands list an odd count followed by the ``sub_lod`` entry;
    and pairs in which even bands list a count 1 to 5 past a multiple of 8
    followed by two ``special`` entries and the ``sub_lod`` entry, so that it
    lies in the tail that kernel D's groups of 8 walk and B's pairs do
    not)."""
    import numpy as np

    lists, counted, counted_d = [], [], []
    for r in range(len(meets)):
        cand = np.flatnonzero(meets[r])
        order = [int(i) for i in cand[np.argsort(zmin[cand], kind="stable")]]
        order.insert(len(order) // 2, special)
        if env == 1 and r == len(meets) - 1:
            order = []                       # an empty band
        lists.append(order)
        if r % 2 == 0 and len(order) > 1:    # an odd count, then the sub-LOD entry
            listed = len(order) - (1 - len(order) % 2)
            counted.append((listed, order[:listed] + [sub_lod] + order[listed:]))
            listed = max(i for i in range(1, len(order)) if 1 <= i % 8 <= 5)
            counted_d.append((listed, order[:listed] + [special, special, sub_lod]
                              + order[listed:]))
        else:
            counted.append((len(order), order))
            counted_d.append((len(order), order))
    return lists, counted, counted_d


def _edge_frame(rng, rng_c, n_envs: int, height: int, width: int, rows: int):
    """One synthetic frame shape: → (tex (B, 23, T), fast (B, 13, T), prim
    (B, 16, T), lists_a, lists_b, lists_c, lists_d) with nested per-(env,
    band) index lists; those of B, C and D are (listed count, list) pairs.
    ``rng_c`` draws what only kernel C's table adds."""
    import numpy as np

    n_bands = height // rows
    tex = np.zeros((n_envs, 23, EDGE_T), np.float32)
    fast = np.zeros((n_envs, 13, EDGE_T), np.float32)
    prim = np.zeros((n_envs, 16, EDGE_T), np.float32)
    lists_a, lists_b, lists_c, lists_d = [], [], [], []
    for b in range(n_envs):
        xy, w, depth, flip = [], [], [], []

        def add(verts, ws=(1.0, 1.0, 1.0), zs=None, negate=False):
            xy.append(verts)
            w.append(ws)
            depth.append(ws if zs is None else zs)
            flip.append(negate)

        # full-frame background pair at one depth: a shared diagonal and a tie
        add([(-1, -1), (width + 1, -1), (width + 1, height + 1)], zs=(250,) * 3)
        add([(-1, -1), (width + 1, height + 1), (-1, height + 1)], zs=(250,) * 3)
        # vertices on warp-tile corners and on pixel centres (16-pixel grid)
        for gx in range(0, width, 16):
            for gy in range(0, height, 16):
                h = 0.5 * rng.integers(0, 2)
                add([(gx + h, gy + h), (gx + 16 + h, gy + 0.5), (gx + 0.5, gy + 16 + h)],
                    zs=tuple(rng.uniform(5, 40, 3)), negate=bool(rng.integers(0, 2)))
        # random triangles, perspective weights, some crossing the eye plane
        for _ in range(60):
            c = rng.uniform([-8, -8], [width + 8, height + 8])
            verts = c + rng.normal(0, rng.choice([2.0, 8.0, 30.0]), (3, 2))
            ws = rng.uniform(0.6, 50.0, 3)
            if rng.random() < 0.1:
                ws[rng.integers(0, 3)] *= -1.0
            add(verts, ws=tuple(ws), negate=bool(rng.integers(0, 2)))
        # slivers: a quarter- to half-pixel tall, along rows and columns
        for _ in range(8):
            x0, y0 = rng.integers(0, width - 8), rng.integers(0, height - 4)
            t = 0.25 * rng.integers(1, 3)
            if rng.random() < 0.5:
                add([(x0, y0 + 0.5), (x0 + rng.integers(8, 60), y0 + 0.5 + t), (x0, y0 + 0.5 + 2 * t)],
                    zs=tuple(rng.uniform(1, 30, 3)))
            else:
                add([(x0 + 0.5, y0), (x0 + 0.5 + t, y0 + rng.integers(4, 40)), (x0 + 0.5 + 2 * t, y0)],
                    zs=tuple(rng.uniform(1, 30, 3)))
        # near the clip planes: in front of `near`, and beyond `far`
        add([(4, 4), (30, 6), (8, 28)], zs=(0.3, 0.4, 0.45))
        add([(10, 2), (40, 10), (12, 30)], zs=(301, 320, 400))
        n_random = len(xy)
        # equal-z duplicates: the first writer must win
        dup_of = rng.choice(n_random, 10, replace=False)
        for i in dup_of:
            add(xy[i], ws=w[i], zs=depth[i], negate=flip[i])
        # a sub-LOD triangle in front of everything (placed after odd counts):
        # it covers the centre (20.5, 3.5), and (21.5, 3.5), (20.5, 4.5) lie
        # on its hypotenuse
        sub_lod = len(xy)
        add([(20.1, 3.1), (21.9, 3.1), (20.1, 4.9)], zs=(0.9, 0.9, 0.9))
        # many small triangles in band 0 (env 0): a list of EDGE_LONG
        long_first = len(xy)
        if b == 0:
            for _ in range(EDGE_LONG):
                c = rng.uniform([0, 0], [width, rows])
                add(c + rng.uniform(-3, 3, (3, 2)), zs=tuple(rng.uniform(2, 60, 3)))
        n = len(xy)
        uv = rng.uniform(-60, 60, (n, 3, 2))
        edges, znum, unum, vnum, det = _screen_rows(
            np.asarray(xy, np.float64), np.asarray(w, np.float64),
            np.asarray(depth, np.float64), uv)
        # sign-normalized as the camera does; kernel A also gets the other
        # winding (every row negated, so z, u and v are unchanged)
        sign = np.where(det < 0, -1.0, 1.0)
        sign_a = np.where(flip, -sign, sign)[:, None]
        colors = rng.uniform(0, 1, (n, 3))
        classes = rng.integers(0, 8, n)
        flat = np.concatenate([edges.reshape(n, 9) * sign_a, znum * sign_a, colors,
                               classes[:, None], np.asarray(depth).min(-1, keepdims=True),
                               unum * sign_a, vnum * sign_a], -1)
        tex[b, :, :n] = flat.T
        lum = np.clip(np.round((colors @ np.array([0.299, 0.587, 0.114])) * 4095), 0, 4095)
        fast[b, :, :n] = np.concatenate([edges.reshape(n, 9) * sign[:, None],
                                         znum * sign[:, None], lum[:, None]], -1).T
        # den = 0 on every pixel (e2 = -(e0 + e1)): no pixel can pass it
        den0 = n
        tex[b, :9, den0] = fast[b, :9, den0] = [1, 0, -7, 0, 1, -9, -1, -1, 16]

        # nearest-first lists of what meets each band's rows (a bbox test; a
        # vertex behind the eye meets every band)
        pts = np.asarray(xy, np.float64)[..., 1]
        behind = (np.asarray(w) <= 0).any(-1)
        zmin = np.asarray(depth).min(-1)
        y_band = np.arange(n_bands)[:, None] * rows
        meets = behind | ((pts.max(-1) >= y_band) & (pts.min(-1) <= y_band + rows))
        meets[:, sub_lod] = False
        meets[1 if b == 0 else 0:, long_first:] = False
        band_a, band_b, band_d = _band_lists(meets, zmin, den0, sub_lod, b)
        lists_a.append(band_a)
        lists_b.append(band_b)
        lists_d.append(band_d)

        # kernel C's table: the same triangles as 4-border primitives (the
        # first edge row repeated) with the 1/z row through their vertices,
        # then quads whose corners lie on warp-tile corners and pixel centres
        # (borders through both), two full-width strips whose 1/z is 1/near
        # exactly: on the whole of one, and on the other left of x = 64
        # (right of it, 1/z rounds below 1/near), and a strip over rows 0-4
        # whose top border overflows: below the first row its a·px and b·py
        # round to +inf and -inf, so the border is NaN there while the warp
        # tile's corner test keeps the strip (a border test that drops a
        # NaN, as fminf does, would light those pixels)
        prim[b, :9, :n + 1] = fast[b, :9, :n + 1]
        prim[b, 9:12, :n + 1] = fast[b, :3, :n + 1]
        prim[b, 12:15, :n] = _plane_rows(np.asarray(xy, np.float64),
                                         1.0 / np.asarray(depth, np.float64)).T
        prim[b, 15, :n] = lum
        corners, quad_z = [], []
        for gx in range(0, width, 16):
            for gy in range(0, height, 16):
                h = 0.5 * rng_c.integers(0, 2, 3)
                corners.append([(gx + h[0], gy + h[0]), (gx + 16 + h[1], gy + 0.5),
                                (gx + 16.5, gy + 16 + h[2]), (gx + 0.5, gy + 16 + h[1])])
                quad_z.append(rng_c.uniform(3, 40, 4))
        corners += [[(0, 4), (width, 4), (width, 12), (0, 12)]] * 2
        quad_z += [np.full(4, EDGE_NEAR)] * 2
        corners, quad_z = np.asarray(corners, np.float64), np.asarray(quad_z)
        q0, nq = den0 + 1, len(corners)
        prim[b, :12, q0:q0 + nq] = _border_rows(corners).reshape(nq, 12).T
        prim[b, 12:15, q0:q0 + nq] = _plane_rows(corners[:, :3], 1.0 / quad_z[:, :3]).T
        prim[b, 15, q0:q0 + nq] = rng_c.integers(0, 4096, nq)
        inv_near = np.float32(1.0 / EDGE_NEAR)
        prim[b, 12:15, q0 + nq - 2] = [0.0, 0.0, inv_near]
        prim[b, 12:15, q0 + nq - 1] = [-2.0 ** -30, 0.0, inv_near]
        over = q0 + nq
        prim[b, :12, over] = _border_rows(np.asarray(
            [[(0, 0), (width, 0), (width, 4), (0, 4)]], np.float64)).reshape(12)
        prim[b, :3, over] = [3e38, -3e38, 0.0]
        prim[b, 12:15, over] = [0.0, 0.0, 1.0 / EDGE_OVER_Z]
        prim[b, 15, over] = 4095
        meets_c = np.concatenate([meets, np.zeros((n_bands, 1), bool),
                                  (corners[..., 1].max(-1) >= y_band)
                                  & (corners[..., 1].min(-1) <= y_band + rows),
                                  y_band == 0], 1)
        zmin_c = np.concatenate([zmin, [np.inf], quad_z.min(-1), [EDGE_OVER_Z]])
        lists_c.append(_band_lists(meets_c, zmin_c, den0, sub_lod, b)[1])
    return tex, fast, prim, lists_a, lists_b, lists_c, lists_d


def _pack_lists(lists, n_envs: int, n_bands: int, counted: bool, multiple: int = 2):
    """Nested per-(env, band) lists → (idx (B, R, K) int32 with K a multiple
    of ``multiple`` and unused slots pointing at table column 0, count (B,
    R) int32)."""
    import numpy as np

    items = [[lst if counted else (len(lst), lst) for lst in env] for env in lists]
    k = max(2, max(len(lst) for env in items for _, lst in env) + 1)
    k += -k % multiple
    idx = np.zeros((n_envs, n_bands, k), np.int32)
    count = np.zeros((n_envs, n_bands), np.int32)
    for b, env in enumerate(items):
        for r, (listed, lst) in enumerate(env):
            idx[b, r, :len(lst)] = lst
            count[b, r] = listed
    return idx, count


def edge_case_tables(device, n_envs: int = 8, seed: int = 0) -> list:
    """Synthetic band tables for kernels A to D at the cases that warp-tile
    culling, deferred shading and a staging ring could get wrong: edges
    through pixel centres and warp-tile corners (integer and half-integer
    vertices), slivers, both windings (and all-negative regions of triangles
    crossing the eye plane), entries whose den is 0 on every pixel, equal-z
    duplicates and a shared-diagonal tie, a list longer than two staging
    chunks, an empty band, odd counts followed by a sub-LOD triangle that
    covers pixels, depths in front of near and beyond far, and frames whose
    bands are 32, 24 and 20 rows, up to 160 columns, one of them a width
    that is no multiple of 4. Kernel D walks B's table gathered through its
    own lists (``gather_band_tables``) in groups of 8: their counts end 1 to
    5 entries into a group, and the sub-LOD triangle lies in the tail that D
    walks and B does not. Kernel C gets the same triangles as 16-row
    primitives (the first edge row repeated, 1/z through the vertices),
    quads whose corners are warp-tile corners and pixel centres, strips with
    1/z exactly at 1/near, a strip with a border that is NaN inside a tile
    its corner test keeps, and lists built the same way (equal keys from the
    duplicates, the empty band, odd counts with the sub-LOD entry). Built
    with numpy from ``seed`` and moved to ``device``. → one dict per frame shape: height, width, rows, tex (B,
    23, T) f32 (its first 17 rows are the flat table), idx_a / count_a
    (exact lists), fast (B, 13, T) f32, idx_b / count_b (fast lists), idx_d
    / count_d (D's lists, K a multiple of 8), prim (B, 16, T) f32, idx_c /
    count_c."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.ops.raster import band_rows

    rng, rng_c = np.random.default_rng(seed), np.random.default_rng(seed + 1)
    cases = []
    for height, width in EDGE_FRAMES:
        rows = band_rows(height)
        tex, fast, prim, lists_a, lists_b, lists_c, lists_d = _edge_frame(
            rng, rng_c, n_envs, height, width, rows)
        n_bands = height // rows
        idx_a, count_a = _pack_lists(lists_a, n_envs, n_bands, counted=False)
        idx_b, count_b = _pack_lists(lists_b, n_envs, n_bands, counted=True)
        idx_d, count_d = _pack_lists(lists_d, n_envs, n_bands, counted=True, multiple=8)
        idx_c, count_c = _pack_lists(lists_c, n_envs, n_bands, counted=True)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        cases.append({"height": height, "width": width, "rows": rows,
                      "tex": dev(tex), "idx_a": dev(idx_a), "count_a": dev(count_a),
                      "fast": dev(fast), "idx_b": dev(idx_b), "count_b": dev(count_b),
                      "idx_d": dev(idx_d), "count_d": dev(count_d), "prim": dev(prim),
                      "idx_c": dev(idx_c),
                      "count_c": dev(count_c)})
    return cases


def edge_case_phase(dev) -> dict:
    """Kernels A (flat and textured, C = 1 and C = 3), B, C and D bit for bit
    against their plain versions on ``edge_case_tables``; B, C and D with no
    fog and at ``EDGE_FOG``. → a summary."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    near, far = EDGE_NEAR, EDGE_FAR
    summary = {"frames": [], "fog": EDGE_FOG, **{f"pixels_hit_{k}": 0 for k in "ABCD"}}
    for case in edge_case_tables(dev):
        h, w, rows = case["height"], case["width"], case["rows"]
        for textured in (False, True):
            tbl = case["tex"] if textured else case["tex"][:, :ra.PACK_WIDTH].contiguous()
            for n_ch in (1, 3):
                args = (tbl, case["idx_a"], case["count_a"], h, w, near, far, n_ch, rows)
                got, want = ra.raster_bands(*args), ra.raster_bands_plain(*args)
                what = f"edge cases {h}x{w} kernel A textured={textured} C={n_ch}"
                check(torch.equal(got[0], want[0]), f"{what}: semantic plane differs")
                check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
                      f"{what}: colour or depth differs "
                      f"(max|d| {float((got[1] - want[1]).abs().max()):.3e}, "
                      f"{float((got[2] - want[2]).abs().max()):.3e})")
            summary["pixels_hit_A"] += int((want[2] < far).sum())
        count_b = case["count_b"]
        sky = rf.fast_bands_plain(case["fast"], case["idx_b"], torch.zeros_like(count_b),
                                  h, w, near, far, 0.0, rows)
        btbl = rf.gather_band_tables(case["fast"], case["idx_d"])
        for name, fn, plain, args in (
                ("B", rf.fast_bands, rf.fast_bands_plain, (case["fast"], case["idx_b"], count_b)),
                ("C", rf.prim_bands, rf.prim_bands_plain,
                 (case["prim"], case["idx_c"], case["count_c"])),
                ("D", rf.vec_bands, rf.vec_bands_plain, (btbl, case["count_d"]))):
            for fog in (0.0, EDGE_FOG):
                full = (*args, h, w, near, far, fog, rows)
                got, want = fn(*full), plain(*full)
                check(torch.equal(got, want), f"edge cases {h}x{w} kernel {name} fog {fog}: "
                      f"max|d| {float((got - want).abs().max()):.3e}")
                if fog == 0.0:
                    summary[f"pixels_hit_{name}"] += int((want != sky).sum())
        summary["frames"].append({"hw": [h, w], "rows": rows,
                                  "max_count_a": int(case["count_a"].max()),
                                  "max_count_c": int(case["count_c"].max()),
                                  "empty_bands": int((case["count_a"] == 0).sum())})
    return summary


def rich_config(**kw):
    """The rich128 preset (facade bands, shadows, markings, textures)."""
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig

    return RenderConfig(height=HW, width=HW, max_triangles=T_RICH, facade_bands=3,
                        shadows=True, markings=True, texture_detail=True, **kw)


def rich_kernels(params, town, dev, rows, rate, facts) -> tuple[list, float]:
    """Phase 7: kernel A's textured variant, B, C and D on the rich fleet vs
    their plain versions (and C, D vs B) from three seeds; → their entries
    of the ``kernels`` line, timed on seed 0's inputs (bounds at the issue
    ``rate``; ``facts``: every kernel's launch facts), and kernel B's max|d|
    vs its plain version on these lists. Kernel B on the same fleet's lists
    is timed too and reported in the ``rich_kernels`` line."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.render.pipeline import make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    rich = rich_config()
    tex_setup = make_scene_setup(params, town, rich, device=dev)
    quad_setup = make_scene_setup(params, town, rich_config(rgb=False, fast=True, quads=True),
                                  device=dev)
    near, far = rich.near, rich.far
    errs = {"A-tex": 0.0, "B": 0.0, "C": 0.0, "D": 0.0}
    inputs, report = {}, {"seeds": []}
    for seed in range(3):
        states = reset_env(params, town, torch.Generator().manual_seed(seed), N_ENVS)
        s_tex = tex_setup(states)
        check(s_tex.unum is not None, "the rich exact setup has no UV rows")
        lists = ra.tile_lists(s_tex, HW, T_RICH, width=HW)
        for n_ch in (1, 3):
            args = exact_args(s_tex, T_RICH, near, far, n_ch, rows, lists)
            check(args[0].shape[1] == ra.TEX_PACK_WIDTH, "the rich table is not textured")
            err, hit_px = check_exact(args, f"kernel A-tex seed {seed} C={n_ch}")
            errs["A-tex"] = max(errs["A-tex"], err)
            if seed == 0 and n_ch == 1:
                inputs["A-tex"], hits = args, hit_px
        del s_tex, args

        s_q = quad_setup(states)
        args_c = prim_args(s_q, T_RICH, near, far, rows)
        out_c, want_c = rf.prim_bands(*args_c), rf.prim_bands_plain(*args_c)
        err = float((out_c - want_c).abs().max())
        check(torch.equal(out_c, want_c), f"kernel C seed {seed}: max|d| vs plain {err:.3e}")
        errs["C"] = max(errs["C"], err)

        seen, counts = {}, {"A-tex": lists[1], "C": args_c[2]}
        for lod in (2.0, 0.0):
            args_b = fast_args(s_q, T_RICH, near, far, rows, lod=lod)
            err, out_b = check_fast(args_b, f"kernel B seed {seed} lod {lod} (rich lists)")
            errs["B"] = max(errs["B"], err)
            args_d = vec_args(args_b)
            out_d = rf.vec_bands(*args_d)
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
                counts["B"] = args_b[2]
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
        del s_q
        torch.cuda.synchronize()
        log(f"rich seed {seed}: A-tex and B vs plain ok, C vs B {quad}, D vs B pixels "
            f"differing {seen}")

    frame_px = N_ENVS * HW * HW
    a_args, b_args, c_args, d_args = (inputs[k] for k in ("A-tex", "B-rich", "C", "D"))
    b_ms = cuda_ms(lambda: rf.fast_bands(*b_args), reps=20)
    b_tiles, b_kept = warp_tile_pairs(*b_args[:5], rows, exact=False)
    b_bytes = walked_bytes(b_args[2], 2, b_args[1].shape[2], FAST_ENTRY_BYTES) + frame_px * 4
    b_listed = listed(b_args[2], rows)
    report["kernel_ms_per_frame"] = {"B": b_ms}
    report["B_rich_lists"] = {
        "ms": b_ms, "max_abs_err": errs["B"],
        "bound_ms": bound(b_kept * OPS_PER_PASS_B + frame_px * OPS_PER_PIXEL_EPILOGUE_B,
                          b_bytes, rate)[0],
        "band_list_bound_ms": bound(b_listed * OPS_PER_PASS_B, b_bytes, rate)[0],
        "listed_pairs": b_listed, "slots_per_pair": b_ms * 1e-3 * rate / b_listed,
        "kept_pairs": b_kept, "warp_tile_pairs": b_tiles,
        "band_tile_pairs": b_listed / (rows * HW) * (HW // WARP_TILE) * (rows // WARP_TILE)}
    a_tiles, a_kept = warp_tile_pairs(*a_args[:5], rows, exact=True)
    c_tiles, c_kept = warp_tile_pairs(*c_args[:5], rows, exact=False, edges=4)
    # D walks B's lists (seed 0's, at 2 px) in whole groups of VEC_P
    d_tiles, d_kept = warp_tile_pairs(*b_args[:5], rows, exact=False, group=rf.VEC_P)
    entries = [
        kernel_entry("raster_exact textured (kernel A-tex, luma)", "A-tex", "raster_exact.cu",
                     "carla_imitation_learning_tpu/ops/raster.py:151", ra.raster_bands,
                     ra.raster_bands_plain, a_args, errs["A-tex"], rate,
                     ops=a_kept * OPS_PER_PASS_A + frame_px * OPS_PER_PIXEL_EPILOGUE_A
                     + hits * (OPS_PER_PIXEL_TEX + 1),
                     band_list_ops=listed(a_args[2], rows) * (OPS_PER_PASS_A + 1)
                     + hits * (OPS_PER_PIXEL_TEX + 1),
                     out_bytes=frame_px * 4 * 3, path="rich_collection", rows=rows,
                     warp_tile_pairs=a_tiles, kept_pairs=a_kept, **facts["A-tex"]),
        kernel_entry("raster_prim (kernel C)", "C", "raster_prim.cu",
                     "carla_imitation_learning_tpu/ops/raster_fast.py:265", rf.prim_bands,
                     rf.prim_bands_plain, c_args, errs["C"], rate,
                     ops=c_kept * OPS_PER_PASS_C + frame_px * OPS_PER_PIXEL_EPILOGUE_B,
                     band_list_ops=listed(c_args[2], rows) * OPS_PER_PASS_C,
                     table_bytes=walked_bytes(c_args[2], 2, c_args[1].shape[2], PRIM_ENTRY_BYTES),
                     out_bytes=frame_px * 4, path="quad_vec_ab", rows=rows,
                     warp_tile_pairs=c_tiles, kept_pairs=c_kept, b_ms_same_scene=b_ms,
                     **facts["C"]),
        kernel_entry("raster_vec (kernel D)", "D", "raster_vec.cu",
                     "carla_imitation_learning_tpu/ops/raster_fast.py:341", rf.vec_bands,
                     rf.vec_bands_plain, d_args, errs["D"], rate,
                     ops=d_kept * OPS_PER_PASS_D + frame_px * OPS_PER_PIXEL_EPILOGUE_B,
                     band_list_ops=listed(d_args[1], rows) * OPS_PER_PASS_D,
                     table_bytes=walked_bytes(d_args[1], rf.VEC_P, d_args[0].shape[2],
                                              VEC_ENTRY_BYTES),
                     out_bytes=frame_px * 4, path="quad_vec_ab", rows=rows, count=d_args[1],
                     warp_tile_pairs=d_tiles, kept_pairs=d_kept, b_ms_same_scene=b_ms,
                     **facts["D"]),
    ]
    for e in entries:
        report["kernel_ms_per_frame"][e["counter"]] = e["ms"]
    log(json.dumps({"rich_kernels": report}))
    return entries, errs["B"]


def bc_card_vs_cpu(train, dev) -> dict:
    """One fp32 train step from the same weights and batch on the card and
    on the CPU, TF32 off, with the global-norm clip triggered, each held
    against the same step in float64 on the CPU. The loss within rtol 1e-5
    of float64; per tensor, the card's gradient no further from float64
    than 4× the CPU's fp32 gradient is, plus 1e-6 of the tensor's scale (a
    convolution's weight gradient sums hundreds of thousands of products
    that cancel, so fp32 rounding in either reduction order is visible at
    1e-3 of the scale); after the step, no more parameters off float64's
    by over 1 % of the learning rate on the card than 4× the CPU's count
    plus 1 in 10,000 (Adam's first step moves each weight by about lr ·
    sign(g), so a near-zero gradient may flip its step). → the errors."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer,
    )

    cpu = torch.device("cpu")
    tx = make_optimizer({"LEARNING_RATE": BC_LR, "gradient_clip_val": BC_CLIP})
    x, y = train.make_batch(np.arange(BC_BATCH))
    init = create_train_state(PolicyCNN(dtype=torch.float32), tx,
                              generator=torch.Generator().manual_seed(3), device=cpu)
    runs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for name, d, dtype in (("card", dev, torch.float32), ("cpu", cpu, torch.float32),
                               ("f64", cpu, torch.float64)):
            model = PolicyCNN(dtype=dtype).to(dtype)
            model.load_state_dict(init.model.state_dict())
            state = create_train_state(model, tx, device=d)
            loss, _ = bc_loss_fn(state.model, (x.to(d, dtype), y.to(d)))
            loss.backward()
            grads = {k: p.grad.to(cpu, torch.float64).clone()
                     for k, p in state.model.named_parameters()}
            state.apply_gradients()
            runs[name] = (float(loss.detach()), grads,
                          {k: v.to(cpu, torch.float64) for k, v in state.model.state_dict().items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    loss64, g64, p64 = runs["f64"]
    sides = ("card", "cpu")
    res = {"grad_norm": float(torch.sqrt(sum((g ** 2).sum() for g in g64.values()))),
           "loss_f64": loss64, "tensors": {}}
    for side in sides:
        res[f"loss_rel_err_{side}"] = abs(runs[side][0] - loss64) / abs(loss64)
        res[f"params_off_{side}"] = 0
    for k, g in g64.items():
        scale = float(g.abs().max())
        res["tensors"][k] = {"grad_scale": scale}
        for side in sides:
            res["tensors"][k][f"grad_err_{side}"] = float((runs[side][1][k] - g).abs().max())
            res[f"params_off_{side}"] += int(((runs[side][2][k] - p64[k]).abs()
                                              > 0.01 * BC_LR).sum())
    res["params"] = sum(p.numel() for p in p64.values())
    res["param_max_diff_card_cpu"] = max(float((runs["card"][2][k] - runs["cpu"][2][k])
                                               .abs().max()) for k in p64)
    for side in sides:
        res[f"grad_max_rel_err_{side}"] = max(t[f"grad_err_{side}"] / max(t["grad_scale"], 1e-30)
                                              for t in res["tensors"].values())
    log(json.dumps({"bc_card_vs_cpu": res}))
    check(res["grad_norm"] > BC_CLIP,
          f"BC card vs CPU: gradient norm {res['grad_norm']:.3f} does not trigger the clip")
    for side in sides:
        check(res[f"loss_rel_err_{side}"] <= 1e-5,
              f"BC card vs CPU: {side} loss {runs[side][0]} vs float64 {loss64}")
    for k, t in res["tensors"].items():
        check(t["grad_err_card"] <= 4 * t["grad_err_cpu"] + 1e-6 * t["grad_scale"],
              f"BC card vs CPU: {k} gradient {t['grad_err_card']:.3e} from float64, "
              f"CPU {t['grad_err_cpu']:.3e} (scale {t['grad_scale']:.3e})")
    check(res["params_off_card"] <= 4 * res["params_off_cpu"] + res["params"] // 10000,
          f"BC card vs CPU: {res['params_off_card']} parameters off float64's step by "
          f"> 1 % of lr (CPU {res['params_off_cpu']})")
    return res


def bc_training(params, town, rcfg, dev, profile: bool = False) -> None:
    """Phase 6b: BC training on the card. An expert ``collect_dataset`` at
    BC_ENVS × BC_STEPS (kernel B once per step plus the first frame, counts
    reset just before it), a shuffled ``DeviceDataset`` on the card with a
    validation tail cut by ``FrameStore.slice``, one fp32 step on the card
    against the CPU, a bf16 ``Trainer.fit`` of BC_EPOCHS epochs of at most
    BC_BATCHES batches, the train step timed with CUDA events, and the
    trained policy in ``evaluate_policy``. Prints one ``bc_training`` line
    and frees its tensors."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.closed_loop import (
        collect_dataset, evaluate_policy,
    )
    from carla_imitation_learning_tpu_torch.training.loop import Trainer
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_eval_step, make_fused_epoch, make_optimizer,
    )

    res = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    store, _, traj = collect_dataset(params, town, rcfg, torch.Generator().manual_seed(21),
                                     BC_ENVS, BC_STEPS, device=dev)
    collect_s = time.perf_counter() - t0
    launches = read_counts()
    del traj
    check(launches["B"] == BC_STEPS + 1,
          f"BC collection launched kernel B {launches['B']} times for {BC_STEPS} steps")
    check(launches["A"] + launches["A-tex"] + launches["C"] + launches["D"] == 0,
          "BC collection launched a kernel it does not run")
    check(store.frames.shape == (BC_ENVS * BC_STEPS, HW, HW) and store.frames.std() > 1.0,
          "BC collection frames are blank or misshapen")
    check(bool(np.isfinite(store.sensors).all() and np.isfinite(store.controls).all()),
          "BC collection sensors or controls not finite")
    res["collect"] = {"n_envs": BC_ENVS, "steps": BC_STEPS, "seconds": collect_s,
                      "env_steps_per_s": BC_ENVS * BC_STEPS / collect_s, "launches": launches,
                      "frames_mib": store.frames.nbytes / 2 ** 20,
                      "episode_starts": int(store.starts.sum())}

    n_val = len(store) // 10
    train = DeviceDataset(store.slice(0, len(store) - n_val), BC_BATCH, shuffle=True,
                          device=dev)
    val = DeviceDataset(store.slice(len(store) - n_val, len(store)), BC_BATCH,
                        drop_last=False, device=dev)
    del store
    res["dataset"] = {"train_windows": train.n_samples, "val_windows": val.n_samples,
                      "train_batches": len(train),
                      "device_mib": (train.frames.nbytes + val.frames.nbytes) / 2 ** 20}
    res["card_vs_cpu"] = bc_card_vs_cpu(train, dev)

    cfg = {"LEARNING_RATE": BC_LR, "gradient_clip_val": BC_CLIP,
           "trainer": {"max_epochs": BC_EPOCHS, "num_sanity_val_steps": 1,
                       "limit_train_batches": BC_BATCHES}}
    state = create_train_state(PolicyCNN(dtype=torch.bfloat16),
                               make_optimizer(cfg, steps_per_epoch=BC_BATCHES),
                               generator=torch.Generator().manual_seed(0), device=dev)
    first = train.fork(0).epoch_indices()[:BC_BATCH]    # the fit's first batch
    first_loss = float(make_eval_step(bc_loss_fn)(state, train.make_batch(first))["loss"])
    fit = Trainer(cfg, device=dev).fit(state, bc_loss_fn,
                                       {"train_dataloader": train, "val_dataloader": val})
    hist = fit.history
    check(all(np.isfinite(v) for row in hist for v in row.values()),
          f"BC fit: non-finite history {hist}")
    check(hist[-1]["train_loss"] < first_loss,
          f"BC fit: last epoch's train loss {hist[-1]['train_loss']:.4f} not below the "
          f"first batch's {first_loss:.4f}")
    res["fit"] = {"first_batch_loss": first_loss, "history": hist, "steps": state.step,
                  "throughput": fit.throughput}

    # the train step alone: fused epochs of BC_TIMED_STEPS on a copy of the state
    snap = state.snapshot()
    epoch = make_fused_epoch(bc_loss_fn, train.pure_batch)
    order = torch.from_numpy(train.epoch_indices()[:BC_TIMED_STEPS * BC_BATCH]
                             .reshape(BC_TIMED_STEPS, BC_BATCH)).to(dev)
    epoch(state, order[:5])
    times = []
    for _ in range(BC_TIMED_REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, _, metrics = epoch(state, order)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / BC_TIMED_STEPS)
        check(bool(torch.isfinite(metrics["loss"]).all()), "BC timed steps: loss not finite")
    ms = sorted(times)[len(times) // 2]
    res["train_step"] = {"batch": BC_BATCH, "dtype": "bfloat16", "ms_per_step": ms,
                         "ms_runs": times, "images_per_s": BC_BATCH / ms * 1e3}
    if profile:
        res["train_step"]["profile"] = profile_train_step(epoch, state, order[:10])
    state.restore(snap)

    reset_counts()
    model = state.model
    metrics = evaluate_policy(params, town, rcfg, lambda obs: model(obs).argmax(-1),
                              torch.Generator().manual_seed(22), n_envs=BC_EVAL_ENVS,
                              n_steps=BC_EVAL_STEPS, device=dev)
    eval_launches = read_counts()
    check(eval_launches["B"] == BC_EVAL_STEPS + 1, "BC evaluation skipped kernel B")
    for key in ("driving_score", "route_completion", "mean_speed", "action_agreement",
                "collisions_per_1k_steps", "clean_episode_rate"):
        check(np.isfinite(metrics[key]), f"BC evaluation: {key} = {metrics[key]}")
    res["eval"] = {"n_envs": BC_EVAL_ENVS, "steps": BC_EVAL_STEPS,
                   "launches": eval_launches, **metrics}
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"bc_training": res}))
    del train, val, state, snap, epoch, order, fit, model
    torch.cuda.empty_cache()


def profile_train_step(epoch, state, order) -> dict:
    """torch.profiler over a fused epoch of len(order) train steps: device
    launches per step, device busy ms per step and the idle share of the
    host-clock window, the device time by kernel group and the operators
    with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch(state, order)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    groups: dict[str, list] = {}
    for e in events:
        name = e.name.lower()
        group = ("convolution" if any(s in name for s in ("conv", "xmma", "cudnn", "nchw",
                                                          "nhwc", "implicit"))
                 else "matmul" if any(s in name for s in ("gemm", "cublas", "cutlass"))
                 else "optimizer" if any(s in name for s in ("foreach", "multi_tensor",
                                                             "adam"))
                 else "other")
        g = groups.setdefault(group, [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    n = len(order)
    busy_us = sum(g[0] for g in groups.values())
    ops = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)
    return {"steps": n, "wall_ms_per_step": wall * 1e3 / n,
            "top_ops": [{"op": e.key[:60], "device_ms_per_step": e.device_time_total / 1e3 / n,
                         "calls_per_step": e.count / n} for e in ops[:10]],
            "device_busy_ms_per_step": busy_us / 1e3 / n,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_launches_per_step": len(events) / n,
            "groups": {k: {"device_ms_per_step": v[0] / 1e3 / n, "launches_per_step": v[1] / n}
                       for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])}}


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
