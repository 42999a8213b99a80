#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT_DIR]

Phases (any failure exits nonzero, with no result line):
1. device: the card's name, and its name and power limit from nvidia-smi;
   the issue rate the bounds divide operation counts by (SMs × 128 lanes ×
   the maximum SM clock);
2. build: every hand-written kernel from ``csrc/`` (one nvcc per source,
   all started together, beside g++ for the frame store's library), with
   ptxas's registers and spills and every kernel's launch facts
   (registers, spills, shared memory, resident blocks per SM); then kernels A (flat and textured, C = 1 and 3), B, C and D bit
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
6c. DAgger (``dagger_phase``), from 6b's trained state, counts reset just
   before it: a ``dagger_iteration`` round at 1024 envs × 24 steps with the
   trained policy driving, a noisy expert collection at the same size (the
   executed steer is the clean steer plus the schedule, the labels the
   clean driver's), one online-DAgger masked train step in fp32 on the
   card and on the CPU, each against float64, ``make_online_dagger`` for 4
   rounds × 256 envs × 32 steps × 200 train steps at batch 256 (agreement
   1 in round 0, above 2/9 in the last round), its train step timed with
   CUDA events, and a K = 4 ensemble round at 256 × 24 (disagreement
   within [0, 1 − 1/K]) with its masked dataset and 5 ensemble steps, then
   the ensemble in fp32 against its members one at a time (forward and two
   train steps); kernel B's launches counted;
6d. file-backed BC (``file_io_phase``), through the port's CLI in this
   process on temporary directories, kernel B's launches counted per run:
   ``run collect_data`` at 256 envs × 48 steps (PNG log, state.csv and a
   packed store, reopened equal to the collected store; a 4-thread
   ``PrefetchReader`` yields the 1-thread batches), ``run split_folders``,
   ``run bc`` at 128², batch 256, 2 epochs (frames read back from PNG bit
   for bit; the best-k checkpoint restores its epoch's weights and fp32
   logits bit for bit; an in-memory fit beside it), ``run closed_loop_eval``
   from the checkpoint at 256 × 50, ``run bc_streaming`` in both tiers at
   1024 × 24 (the store also saved sharded: one epoch of each sharded
   reader covers exactly ``DeviceDataset``'s windows), and ``run bc`` on an
   empty data_dir (a synthetic 256² log, 2048 frames); ``--profile`` adds
   the idle share of each streaming tier's train steps;
6e. the scenario suite (``scenarios_phase``), counts reset just before
   it: ``run scenario_eval`` through the CLI on 6d's best checkpoint at
   1024 envs × 100 steps, all eight scenarios (kernel B once per step of
   each of the 16 rollouts plus their first frames), then kernel B bit for
   bit against its plain version on one frame of each scenario's fleet
   (T = 530, 650 on ``busy``; fog 0.04 on ``fog``), the ``storm`` and
   ``night_rain`` frames on the card against the CPU (the rain hash and
   rain on one frame bit for bit), and a direct 1024-env × 100-step expert
   run on the ``turns`` and ``multilane`` worlds that must take ego and
   agent route transfers and lane changes;
6f. goal-directed driving and the policy families (``routes_phase``) on
   the JAX route harness's world (2 lanes a direction, super-blocks, turn
   fans, 8 goals, 2500-step attempts, 128²): kernel B bit for bit on the
   mirrored town's 1024-env fleet, then, counts reset: the route planner's
   tables, ``evaluate_routes`` of the expert at 1024 envs × 400 steps (it
   arrives; a direct 64-env run checks each arrival against its goal
   point), goal-directed collection on the town and on its mirror at 1024
   × 96 (all six commands), 200 bf16 CIL train steps (the loss falls,
   timed with CUDA events) and the CIL policy on the routes through the
   rollout's extras, the fp32 CIL rollout and forward on the card against
   the CPU, continuous BC (a noisy collection, 200 steps, a continuous
   rollout whose controls stay in the unit square) and ``run route_eval``
   on the CIL checkpoint through the CLI; kernel B once per rollout step;
6g. the aux, dual-stream, augmentation and VAE experiments
   (``aux_vae_phase``), counts reset just before ``run bc_aux -o
   aux_seg_weight=0.5`` through the CLI: an expert collection at 256 envs
   × 200 steps that records the class plane (kernel A every step, B for
   the frames), AuxNet with its seg decoder in bf16 at batch 64 for 2
   epochs (the loss falls; the test mIoU above the test split's
   majority-class share), the closed loop at 256 × 100 (B); A and B on the
   collection's first inputs bit for bit against their plain versions; the
   AuxNet-seg train step alone (CUDA events); then ``bc_aux`` and
   ``bc_raw_segment`` at 256², ``bc -o augment=true``, ``vae_pooled`` and
   ``vae_leave_one_out`` at 1×224×224 on synthetic logs through the CLI
   (each loss falls, no kernel launched); one fp32 step of the AuxNet seg,
   dual-stream, VAE (fixed noise) and augmented BC (fixed draws) losses on
   the card and on the CPU against float64;
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
policy rollout, the rich fast render, 10 train steps in ``bc_training``, a
short online-DAgger run in ``dagger_phase`` and 8 steps of the CIL route
rollout in ``routes_phase``). Each entry of the ``kernels`` line counts
its launches on its own path (``launches``) and on every path that ran it
(``launches_by_path``). The train-step checks
against float64 also run the CPU side once with oneDNN (mkldnn) off, and
the device phase prints torch's CPU build settings.

The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import threading
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
DAGGER_ENVS, DAGGER_STEPS = 1024, 24   # a DAgger round and a noisy collection
ONLINE_ROUNDS, ONLINE_ENVS, ONLINE_STEPS = 4, 256, 32   # online DAgger's run
ONLINE_TRAIN_STEPS, ONLINE_BATCH = 200, 256              # its train steps per round
ONLINE_TIMED_STEPS = 20                                  # the masked step's timing
# A policy that plays one action, as one trained too little does, agrees
# with the expert as often as the expert picks that action: 0.09-0.13 of
# the time after its first round, against 0.27-0.40 in rounds 3 and 4 of
# runs that train 200 steps a round (benchmarks_torch/online_dagger_ablation.py
# on the card, PERF.md).
ONLINE_MIN_AGREEMENT = 2 / 9
ENSEMBLE_K, ENSEMBLE_ENVS, ENSEMBLE_STEPS = 4, 256, 24   # the uncertainty-gated round
ENSEMBLE_TAU, ENSEMBLE_TRAIN_STEPS = 0.25, 5
FILE_COLLECT_ENVS, FILE_COLLECT_STEPS = 256, 48      # the file phase's PNG log
FILE_EVAL_ENVS, FILE_EVAL_STEPS = 256, 50            # closed_loop_eval of its checkpoint
FILE_STREAM_ENVS, FILE_STREAM_STEPS = 1024, 24       # bc_streaming's collection
FILE_BATCH, FILE_EPOCHS, FILE_SHARD_FRAMES = 256, 2, 4096
FILE_SYNTHETIC_FRAMES = 2048     # the README's first command: bc on an empty data_dir
SCENARIO_ENVS, SCENARIO_STEPS = 1024, 100   # scenario_eval: every scenario, policy and expert
# ``busy`` adds 12 walkers and 9 vehicles, but its delta raises the table
# by the walkers' 120 triangles only, so on the bench town its 650-triangle
# scene overflows the preset's 512 + 120 (the JAX package raises alike);
# a base of 530 gives busy exactly 650
SCENARIO_T = 530
SCENARIO_CROSS_ENVS = 8          # rainy frames on the card vs the CPU
# The routes phase, on the JAX route harness's world (benchmarks/route_quality.py):
# 2 lanes a direction, super-blocks, turn fans, 8 goals, 2500-step attempts.
ROUTE_ENVS, ROUTE_STEPS, ROUTE_GOALS = 1024, 400, 8      # evaluate_routes, expert and CIL
# goal-directed collection per world (the town and its mirror): the scripted
# lane changes announce commands 4 and 5 around t ≡ 80 (mod 160) only, so a
# collection from reset needs 87 steps for all six commands
ROUTE_COLLECT_STEPS = 96
ROUTE_TRAIN_STEPS, ROUTE_BATCH, ROUTE_TIMED_FROM = 200, 256, 20   # CIL steps; timed after 20
ROUTE_ARRIVE_ENVS, ROUTE_ARRIVE_STEPS = 64, 200   # direct step_env run from 15-40 m short
ROUTE_CROSS_ENVS, ROUTE_CROSS_STEPS = 8, 24       # the CIL rollout on the card vs the CPU
CONT_ENVS, CONT_STEPS, CONT_TRAIN_STEPS = 1024, 24, 200   # continuous BC
CONT_EVAL_ENVS, CONT_EVAL_STEPS = 256, 50
ROUTE_CLI_ENVS, ROUTE_CLI_STEPS = 1024, 100       # run route_eval on the CIL checkpoint
ROUTE_PROFILE_WARM, ROUTE_PROFILE_STEPS = 4, 8    # --profile: the CIL route rollout
# The aux_vae phase: ``run bc_aux -o aux_seg_weight=0.5`` on the bench town at 128²
AUX_ENVS, AUX_STEPS = 256, 200                # the record_semantic collection
AUX_EVAL_ENVS, AUX_EVAL_STEPS = 256, 100
AUX_BATCH, AUX_EPOCHS = 64, 2
# each model's train step alone: warm-up, repeats of timed steps, profiled steps
AUX_TIMED_WARM, AUX_TIMED_STEPS, AUX_TIMED_REPEATS, AUX_PROFILED_STEPS = 5, 50, 5, 10
AUX_IMG = 256                                 # the file-backed runs' frames (the reference's)
AUX_FILE_FRAMES, AUX_FILE_EPOCHS = 640, 3     # the synthetic log of the file runs (a gate)
AUX_VAE_FRAMES = 120                          # per log, six logs at 224²
AUX_CROSS_BATCH = 8                           # the card-vs-CPU steps
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
        from carla_imitation_learning_tpu_torch.native import framestore
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
    log(json.dumps({"torch_cpu_config": [
        line.strip() for line in torch.__config__.show().splitlines()
        if any(k in line for k in ("CPU capability", "MKL", "oneDNN", "OpenMP", "LAPACK"))]}))

    rate = issue_rate()
    t0 = time.perf_counter()
    # the frame store's g++ build runs beside the kernels' nvcc builds
    host_lib = threading.Thread(target=framestore.build_library)
    host_lib.start()
    reports = cuda_lib.build()
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)
    host_lib.join()
    framestore.build_library()  # raises here if the threaded build failed
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
    bc_state = bc_training(params, town, rcfg, dev, profile=args.profile is not None)
    paths["dagger"] = dagger_phase(params, town, rcfg, dev, bc_state,
                                   profile=args.profile is not None)
    del bc_state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as keep:
        paths["file_io"] = file_io_phase(dev, profile=args.profile is not None,
                                         keep=Path(keep))
        torch.cuda.empty_cache()
        paths["scenarios"] = scenarios_phase(dev, Path(keep) / "best")
    torch.cuda.empty_cache()
    paths["routes"] = routes_phase(dev, profile=args.profile is not None)
    torch.cuda.empty_cache()
    paths["aux_vae"] = aux_vae_phase(dev)
    # the rich phases allocate gigabytes of temporaries; they run after the
    # main path has been timed
    rich, b_rich_err = rich_kernels(params, town, dev, rows, rate, facts)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], b_rich_err)
    kernels += rich
    paths["rich_collection"] = rich_collection(params, town, dev)
    paths["quad_vec_ab"] = quad_vec_ab(params, town, dev, kernels)
    for k in kernels:
        path, counter = k.pop("path"), k.pop("counter")
        k["launches"] = paths[path][counter]
        k["launches_path"] = path
        k["launches_by_path"] = {p: c[counter] for p, c in paths.items() if c[counter]}

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
    """``step_card_vs_cpu`` of the BC loss on the first BC_BATCH windows of
    ``train``, printed as the ``bc_card_vs_cpu`` line."""
    import numpy as np

    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn

    return step_card_vs_cpu("bc_card_vs_cpu", bc_loss_fn,
                            train.make_batch(np.arange(BC_BATCH)), dev)


def _move(obj, d, dtype):
    """``obj`` (tensors in nested tuples) on ``d``, float tensors in ``dtype``."""
    if isinstance(obj, (tuple, list)):
        return tuple(_move(o, d, dtype) for o in obj)
    return obj.to(d, dtype) if obj.is_floating_point() else obj.to(d)


def step_card_vs_cpu(name: str, loss_fn, batch, dev, require_clip: bool = True,
                     model_fn=None) -> dict:
    """One fp32 train step of ``loss_fn`` from the same weights and batch on
    the card and on the CPU, TF32 off, with the global-norm clip (when
    ``require_clip``, checked to trigger), each held against the same step
    in float64 on the CPU. The loss within rtol 1e-5
    of float64; per tensor, the card's gradient no further from float64
    than 4× the CPU's fp32 gradient is, plus 1e-6 of the tensor's scale (a
    convolution's weight gradient sums hundreds of thousands of products
    that cancel, so fp32 rounding in either reduction order is visible at
    1e-3 of the scale); after the step, no more parameters off float64's
    by over 1 % of the learning rate on the card than 4× the CPU's count
    plus 1 in 10,000 (Adam's first step moves each weight by about lr ·
    sign(g), so a near-zero gradient may flip its step). Float tensors of
    ``batch`` (nested tuples allowed) take each run's dtype. The model is
    ``model_fn(dtype)`` (default a ``PolicyCNN``). Prints the ``name``
    line; → the errors."""
    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer,
    )

    make = model_fn or (lambda dtype: PolicyCNN(dtype=dtype))
    cpu = torch.device("cpu")
    tx = make_optimizer({"LEARNING_RATE": BC_LR, "gradient_clip_val": BC_CLIP})
    init = create_train_state(make(torch.float32), tx,
                              generator=torch.Generator().manual_seed(3), device=cpu)
    runs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        # the CPU's fp32 step also once with oneDNN (mkldnn) convolutions off
        for side, d, dtype, mkldnn in (("card", dev, torch.float32, True),
                                       ("cpu", cpu, torch.float32, True),
                                       ("cpu_no_mkldnn", cpu, torch.float32, False),
                                       ("f64", cpu, torch.float64, True)):
            model = make(dtype).to(dtype)
            model.load_state_dict(init.model.state_dict())
            state = create_train_state(model, tx, device=d)
            with torch.backends.mkldnn.flags(enabled=mkldnn and torch.backends.mkldnn.enabled):
                loss, _ = loss_fn(state.model, _move(batch, d, dtype))
                loss.backward()
            grads = {k: p.grad.to(cpu, torch.float64).clone()
                     for k, p in state.model.named_parameters()}
            state.apply_gradients()
            runs[side] = (float(loss.detach()), grads,
                          {k: v.to(cpu, torch.float64) for k, v in state.model.state_dict().items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    loss64, g64, p64 = runs["f64"]
    sides = ("card", "cpu", "cpu_no_mkldnn")
    res = {"grad_norm": float(torch.sqrt(sum((g ** 2).sum() for g in g64.values()))),
           "loss_f64": loss64, "tensors": {},
           "mkldnn": {"available": torch.backends.mkldnn.is_available(),
                      "enabled": torch.backends.mkldnn.enabled}}
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
    res["clip_triggered"] = res["grad_norm"] > BC_CLIP
    log(json.dumps({name: res}))
    if require_clip:
        check(res["clip_triggered"],
              f"{name}: gradient norm {res['grad_norm']:.3f} does not trigger the clip")
    for side in ("card", "cpu"):
        check(res[f"loss_rel_err_{side}"] <= 1e-5,
              f"{name}: {side} loss {runs[side][0]} vs float64 {loss64}")
    for k, t in res["tensors"].items():
        check(t["grad_err_card"] <= 4 * t["grad_err_cpu"] + 1e-6 * t["grad_scale"],
              f"{name}: {k} gradient {t['grad_err_card']:.3e} from float64, "
              f"CPU {t['grad_err_cpu']:.3e} (scale {t['grad_scale']:.3e})")
    check(res["params_off_card"] <= 4 * res["params_off_cpu"] + res["params"] // 10000,
          f"{name}: {res['params_off_card']} parameters off float64's step by "
          f"> 1 % of lr (CPU {res['params_off_cpu']})")
    return res


def bc_training(params, town, rcfg, dev, profile: bool = False):
    """Phase 6b: BC training on the card. An expert ``collect_dataset`` at
    BC_ENVS × BC_STEPS (kernel B once per step plus the first frame, counts
    reset just before it), a shuffled ``DeviceDataset`` on the card with a
    validation tail cut by ``FrameStore.slice``, one fp32 step on the card
    against the CPU, a bf16 ``Trainer.fit`` of BC_EPOCHS epochs of at most
    BC_BATCHES batches, the train step timed with CUDA events, and the
    trained policy in ``evaluate_policy``. Prints one ``bc_training`` line,
    frees its tensors and returns the trained ``TrainState``."""
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
    del train, val, snap, epoch, order, fit, model
    torch.cuda.empty_cache()
    return state


def cli_run(*argv) -> dict:
    """``cli.main(["run", *argv, "-o", "device=<DEVICE>", "--json"])`` in
    this process; its result (the last stdout line) parsed, its stdout kept
    off this script's."""
    import contextlib
    import io

    from carla_imitation_learning_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["run", *argv, "-o", f"device={DEVICE}", "--json"])
    check(rc == 0, f"cli run {' '.join(argv)} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


class Capture:
    """Wrap ``module.name`` (a module's function or a class's method) while
    the ``with`` block runs, appending ``record(args, kwargs, result)`` of
    every call to ``calls``; ``record`` runs when the call returns."""

    def __init__(self, module, name: str, record=lambda a, k, out: out):
        self.module, self.name, self.record, self.calls = module, name, record, []

    def __enter__(self) -> "Capture":
        orig = self.orig = getattr(self.module, self.name)

        def spy(*a, **k):
            out = orig(*a, **k)
            self.calls.append(self.record(a, k, out))
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.orig)


def window_keys(windows, labels, weights):
    """Order-free identity of windows: a weighted sum of each (B, fs, H, W)
    uint8 window's pixels (int64, random weights below 2^20) times 16 plus
    its label, so multisets of windows compare as sorted key vectors."""
    import torch

    fp = (windows.to(torch.int64) * weights).sum(dim=(1, 2, 3))
    return fp * 16 + labels.to(torch.int64)


def file_io_phase(dev, profile: bool = False, keep: Path | None = None) -> dict:
    """Phase 6d: BC from CARLA-contract logs on disk, through the port's CLI
    in this process, on temporary ``data_dir`` and ``log_dir``, kernel B's
    launches counted per step:
    1. ``run collect_data`` (FILE_COLLECT_ENVS × FILE_COLLECT_STEPS, PNG +
       state.csv + a packed store): the packed file reopened equals the
       in-memory store; a 4-thread ``PrefetchReader`` yields the 1-thread
       batch sequence;
    2. ``run split_folders`` and ``run bc`` on the log at 128², batch 256,
       2 epochs: the frames read back from PNG equal the collected ones bit
       for bit; the best-k checkpoint restores its epoch's weights bit for
       bit (fp32 logits of one batch); a ``Trainer.fit`` on the in-memory
       store gives the same-process rate to hold the file path against;
    3. ``run closed_loop_eval`` from the best checkpoint;
    4. ``run bc_streaming`` in both tiers at FILE_STREAM_ENVS ×
       FILE_STREAM_STEPS; the collected store saved sharded, and one epoch
       of ``ShardedPrefetchReader`` and of ``DeviceShardStreamer`` each
       cover exactly the multiset of windows ``DeviceDataset`` draws;
    5. ``run bc`` on an empty ``data_dir`` (a synthetic 256² log of
       FILE_SYNTHETIC_FRAMES frames, 1 epoch at the model preset's batch).
    Prints one ``file_io`` line; returns kernel B's launches of steps 1–4's
    main path (collect, eval, streaming). With ``keep``, the best
    checkpoint is copied to ``keep / "best"`` for the scenario phase."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.native import (
        DeviceShardStreamer, NativeFrameStore, PrefetchReader, ShardedFrameStore,
        ShardedPrefetchReader, save_sharded_framestore,
    )
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.loop import Trainer
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer,
    )
    from carla_imitation_learning_tpu_torch.utils import checkpoint as ckpt_lib

    res, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_file_io_") as tmp:
        tmp = Path(tmp)
        base = ["-o", f"data_dir={tmp / 'data'}", "-o", f"log_dir={tmp / 'logs'}",
                "-o", "train_logs=['SimLog1']"]

        # 1. collect_data → PNG log + state.csv + packed store
        torch.cuda.synchronize()
        reset_counts()
        with Capture(cl, "collect_dataset", lambda a, k, out: out[0]) as cap:
            out = cli_run("collect_data", *base, "-o", f"n_envs={FILE_COLLECT_ENVS}",
                          "-o", f"n_steps={FILE_COLLECT_STEPS}")
        launches["collect"] = read_counts()
        check(launches["collect"]["B"] == FILE_COLLECT_STEPS + 1,
              f"collect_data launched kernel B {launches['collect']['B']} times for "
              f"{FILE_COLLECT_STEPS} steps")
        check(sum(launches["collect"].values()) == launches["collect"]["B"],
              "collect_data launched a kernel it does not run")
        store = cap.calls[0]
        n = FILE_COLLECT_ENVS * FILE_COLLECT_STEPS
        check(out["frames"] == n and store.frames.shape == (n, HW, HW), "collect_data size")
        packed = Path(out["framestore"])
        with NativeFrameStore(packed) as nfs:
            for f in ("frames", "actions", "starts"):
                check(np.array_equal(getattr(nfs, f), getattr(store, f)),
                      f"packed store: {f} differ from the collected store")
            t0 = time.perf_counter()
            mapped = np.array(nfs.frames)
            read_s = time.perf_counter() - t0
            orders = []
            for threads in (1, 4):
                sums = [(f.astype(np.int64).sum(axis=(1, 2, 3)), lab) for f, lab in
                        PrefetchReader(nfs, FILE_BATCH, 4, n_threads=threads, shuffle=True,
                                       seed=3)]
                orders.append(sums)
            check(len(orders[0]) == len(orders[1]) > 0, "prefetch: batch counts differ")
            for (a, la), (b, lb) in zip(*orders):
                check(np.array_equal(a, b) and np.array_equal(la, lb),
                      "prefetch: 4 threads and 1 thread yield different batch sequences")
        del mapped
        secs = out["seconds"]
        res["collect"] = {
            "n_envs": FILE_COLLECT_ENVS, "steps": FILE_COLLECT_STEPS, "frames": n,
            "frames_mb": store.frames.nbytes / 1e6, "launches": launches["collect"],
            "collect_s": secs["collect"], "env_steps_per_s": n / secs["collect"],
            "png_write_frames_per_s": n / secs["png_and_csv_write"],
            "png_mb": sum(p.stat().st_size for p in
                          (tmp / "data" / "raw" / "SimLog1" / "camera").iterdir()) / 1e6,
            "packed_write_gb_per_s": packed.stat().st_size / secs["packed_write"] / 1e9,
            "packed_mmap_read_gb_per_s": store.frames.nbytes / read_s / 1e9,
            "prefetch_batches_compared": len(orders[0])}
        del orders

        # 2. split_folders + bc from the PNG log
        split = cli_run("split_folders", *base)["counts"]
        cfg = compose("config", overrides=["model=imitation", f"data_dir={tmp / 'data'}",
                                           "train_logs=['SimLog1']", "camera=camera"])
        t0 = time.perf_counter()
        back = [FrameStore.from_processed_dir(cfg, s) for s in ("train", "val", "test")]
        png_read_s = time.perf_counter() - t0
        check(np.array_equal(np.concatenate([b.frames for b in back]), store.frames),
              "frames read back from PNG differ from the collected frames")
        check(split == {k: len(b) for k, b in zip(("train", "val", "test"), back)},
              f"split counts {split}")
        bc_args = [*base, "-o", "bc_cameras=['camera']", "-o", f"image_height={HW}",
                   "-o", f"image_width={HW}", "-o", f"NUM_EPOCHS={FILE_EPOCHS}",
                   "-o", f"BATCH_SIZE={FILE_BATCH}"]
        # save(self, step, payload, metrics): the payload holds the live
        # state's tensors, which later epochs change, so copy them at the call
        with Capture(ckpt_lib.BestKCheckpointManager, "save", lambda a, k, out: (
                a[1], {n: v.detach().clone() for n, v in a[2]["params"].items()})) as saves:
            t0 = time.perf_counter()
            bc = cli_run("bc", *bc_args)["camera"]
            bc_wall = time.perf_counter() - t0
        kept = dict(saves.calls)
        best = Path(bc["best_path"])
        check(best.is_dir() and (best.parent / "index.json").is_file(),
              "bc wrote no best-k checkpoint")
        step = int(best.name.rsplit("step", 1)[1])
        model = PolicyCNN().to(dev)
        t0 = time.perf_counter()
        restored = ckpt_lib.restore_params(best, model.state_dict())
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        for k, v in kept[step].items():
            check(torch.equal(restored[k], v), f"best checkpoint: {k} differs from epoch {step}")
        trained = PolicyCNN().to(dev)
        trained.load_state_dict(kept[step])
        model.load_state_dict(restored)
        val = DeviceDataset(back[1], FILE_BATCH, drop_last=False, device=dev)
        x, _ = next(iter(val))
        with torch.no_grad():
            logits, want = model(x), trained(x)
        check(logits.dtype == torch.float32 and torch.equal(logits, want),
              "restored checkpoint: logits differ from the trained weights'")
        t0 = time.perf_counter()
        ckpt_lib.save_pytree(tmp / "ckpt_timing", {"params": kept[step]})
        save_ms = (time.perf_counter() - t0) * 1e3
        # the same fit on the in-memory store (no files): the rate to hold bc's against
        n_train, n_val = len(back[0]), len(back[1])
        mem = {"train_dataloader": DeviceDataset(store.slice(0, n_train), FILE_BATCH,
                                                 shuffle=True, device=dev),
               "val_dataloader": DeviceDataset(store.slice(n_train, n_train + n_val),
                                               FILE_BATCH, drop_last=False, device=dev)}
        mcfg = compose("config", overrides=["model=imitation"])
        mstate = create_train_state(PolicyCNN(), make_optimizer(
            mcfg, steps_per_epoch=len(mem["train_dataloader"])),
            generator=torch.Generator().manual_seed(0), device=dev)
        mfit = Trainer(mcfg, device=dev).fit(mstate, bc_loss_fn, mem, max_epochs=FILE_EPOCHS)
        check(all(math.isfinite(r["train_loss"]) for r in bc["history"] + mfit.history),
              "bc: non-finite loss")
        res["bc"] = {
            "split": split, "png_read_frames_per_s": n / png_read_s, "png_read_s": png_read_s,
            "history": bc["history"], "test": bc["test"], "best_step": step,
            "wall_s": bc_wall, "fit_images_per_s": bc["throughput"]["images_per_sec"],
            "in_memory_fit_images_per_s": mfit.throughput["images_per_sec"],
            "checkpoint_mb": (best / ckpt_lib.PAYLOAD_NAME).stat().st_size / 1e6,
            "checkpoint_params_mb": (tmp / "ckpt_timing" / ckpt_lib.PAYLOAD_NAME)
            .stat().st_size / 1e6,
            "checkpoint_save_ms": save_ms, "checkpoint_restore_ms": restore_ms}
        del mem, mstate, mfit, val, back, trained, model

        # 3. closed_loop_eval from the best checkpoint
        torch.cuda.synchronize()
        reset_counts()
        ev = cli_run("closed_loop_eval", *base, "--checkpoint", str(best),
                     "-o", f"n_envs={FILE_EVAL_ENVS}", "-o", f"n_steps={FILE_EVAL_STEPS}")
        launches["closed_loop_eval"] = read_counts()
        check(launches["closed_loop_eval"]["B"] == 2 * (FILE_EVAL_STEPS + 1),
              "closed_loop_eval did not render every step of both rollouts with kernel B")
        for who in ("policy", "expert"):
            check(math.isfinite(ev[who]["driving_score"]), f"closed_loop_eval: {who} score")
        if keep is not None:
            shutil.copytree(best, keep / "best")
        res["closed_loop_eval"] = {
            "n_envs": FILE_EVAL_ENVS, "steps": FILE_EVAL_STEPS,
            "launches": launches["closed_loop_eval"],
            **{f"{who}_{k}": ev[who][k] for who in ("policy", "expert")
               for k in ("driving_score", "route_completion", "action_agreement",
                         "collisions_per_1k_steps")}}

        # 4. bc_streaming, both tiers; the collected store sharded
        res["streaming"] = {}
        for tier in ("direct", "host"):
            torch.cuda.synchronize()
            reset_counts()
            with Capture(cl, "collect_dataset", lambda a, k, out: out[0]) as cap:
                st = cli_run("bc_streaming", "-o", f"log_dir={tmp / tier}",
                             "-o", f"n_envs={FILE_STREAM_ENVS}",
                             "-o", f"n_steps={FILE_STREAM_STEPS}", "-o", f"tier={tier}",
                             "-o", f"epochs={FILE_EPOCHS}", "-o", f"BATCH_SIZE={FILE_BATCH}")
            launches[f"streaming_{tier}"] = read_counts()
            check(launches[f"streaming_{tier}"]["B"] == FILE_STREAM_STEPS + 1,
                  f"bc_streaming ({tier}) did not render every step with kernel B")
            check(math.isfinite(st["final_loss"]), f"bc_streaming ({tier}): loss")
            res["streaming"][tier] = {k: st[k] for k in (
                "frames", "final_loss", "images_per_sec_streaming", "images_per_sec_steady",
                "first_epoch_seconds")}
        stream_store = cap.calls[0]
        if profile:
            res["streaming"]["profile"] = profile_streaming(Path(st["framestore"]), dev)
        shards = save_sharded_framestore(tmp / "shards", stream_store,
                                         shard_frames=FILE_SHARD_FRAMES)
        res["streaming"]["coverage"] = sharded_coverage(stream_store, shards, dev)
        del stream_store, cap

        # 5. bc on an empty data_dir: the synthetic 256² log
        t0 = time.perf_counter()
        first = cli_run("bc", "-o", f"data_dir={tmp / 'empty'}", "-o", f"log_dir={tmp / 'l5'}",
                        "-o", f"synthetic_frames={FILE_SYNTHETIC_FRAMES}", "-o", "NUM_EPOCHS=1")
        first_wall = time.perf_counter() - t0
        for cam in ("camera", "semantic"):
            check(Path(first[cam]["best_path"]).is_dir(), f"bc from scratch: no {cam} checkpoint")
            check(math.isfinite(first[cam]["history"][0]["train_loss"]), "bc from scratch: loss")
        res["bc_from_empty"] = {
            "frames": FILE_SYNTHETIC_FRAMES, "hw": 256, "batch": int(mcfg["BATCH_SIZE"]),
            "wall_s": first_wall,
            **{f"{cam}_fit_images_per_s": first[cam]["throughput"]["images_per_sec"]
               for cam in ("camera", "semantic")},
            **{f"{cam}_train_loss": first[cam]["history"][0]["train_loss"]
               for cam in ("camera", "semantic")}}
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"file_io": res}))
    return {k: sum(v[k] for v in launches.values()) for k in launches["collect"]}


def scenario_fleets(dev):
    """name → (params, town, rollout render config) of every scenario, as
    ``scenario_eval`` composes it from the imitation preset (the render
    config forced onto kernel B at a 2 px LOD, as ``make_rollout`` does)."""
    from carla_imitation_learning_tpu_torch import experiments as ex
    from carla_imitation_learning_tpu_torch.config import compose

    cfg = compose("config", overrides=["model=imitation", f"render.max_triangles={SCENARIO_T}"])
    out = {}
    for name in ex.SCENARIOS:
        town, params, rcfg = ex._sim_bits(ex.scenario_config(cfg, name))
        rcfg = dataclasses.replace(rcfg, rgb=False, fast=True,
                                   lod_px=2.0 if rcfg.lod_px < 0 else rcfg.lod_px)
        out[name] = (params, town.to(dev), rcfg)
    return out


def route_changes(params, town, dev, n_envs: int, n_steps: int) -> dict:
    """A direct expert run of ``n_envs`` × ``n_steps`` (no rendering) with
    auto-resets from the rollout's spawn pool → route changes that were not
    resets: within a grid cell (lane changes) and across cells (turn-fan
    transfers), for the ego and the agents."""
    import torch

    from carla_imitation_learning_tpu_torch.sim import world
    from carla_imitation_learning_tpu_torch.training.closed_loop import rollout_spawn_pool

    states = world.reset_env(params, town, torch.Generator().manual_seed(5), n_envs)
    pool = rollout_spawn_pool(params, town)
    counts = torch.zeros(5, dtype=torch.int64, device=dev)
    for _ in range(n_steps):
        ctrl = world.autopilot_control(params, town, states)
        new, info = world.step_env(params, town, states, ctrl,
                                   world.pick_fresh_packed(pool, params, states))
        kept = ~info["done"]
        ego = (new.ego_route != states.ego_route) & kept
        ego_cell = new.ego_route // town.lanes == states.ego_route // town.lanes
        ag = (new.agents_route != states.agents_route) & kept[:, None]
        ag_cell = new.agents_route // town.lanes == states.agents_route // town.lanes
        counts += torch.stack([(ego & ego_cell).sum(), (ego & ~ego_cell).sum(),
                               (ag & ag_cell).sum(), (ag & ~ag_cell).sum(),
                               info["done"].sum()])
        states = new
    return dict(zip(("ego_lane_changes", "ego_transfers", "agent_lane_changes",
                     "agent_transfers", "resets"), counts.tolist()))


def scenarios_phase(dev, checkpoint: Path) -> dict:
    """Phase 6e: the scenario suite.
    1. ``run scenario_eval`` through the CLI on ``checkpoint`` at
       SCENARIO_ENVS × SCENARIO_STEPS, all eight scenarios, counts reset
       just before it: kernel B launched once per step and first frame of
       each of the 16 rollouts, no other kernel; each rollout timed on the
       host clock (synchronized) for its env-steps/s;
    2. kernel B bit for bit against its plain version on one frame of each
       scenario's SCENARIO_ENVS fleet, the arguments the render passes it;
    3. ``storm`` and ``night_rain``: SCENARIO_CROSS_ENVS envs at steps that
       put the streak phases below zero, rendered on the card and on the
       CPU (within ``b_tolerance``); the rain hash of every pixel and rain
       on the CPU frame, on both, bit for bit;
    4. ``route_changes`` on the ``turns`` and ``multilane`` worlds: ego
       transfers and agent transfers (turns), ego lane changes
       (multilane) and agent lane changes (both) must all be non-zero.
    Prints one ``scenarios`` line; returns the launches of step 1."""
    import math

    import torch

    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.render import weather
    from carla_imitation_learning_tpu_torch.render.pipeline import make_renderer
    from carla_imitation_learning_tpu_torch.sim.world import reset_env
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl

    walls = []
    orig = cl.evaluate_policy

    def evaluate(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        walls.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    cl.evaluate_policy = evaluate
    try:
        res = cli_run("scenario_eval", "--checkpoint", str(checkpoint),
                      "-o", f"n_envs={SCENARIO_ENVS}", "-o", f"n_steps={SCENARIO_STEPS}",
                      "-o", "scenarios=all", "-o", f"render.max_triangles={SCENARIO_T}")
    finally:
        cl.evaluate_policy = orig
    launches = read_counts()
    eval_s = time.perf_counter() - t0
    fleets = scenario_fleets(dev)
    per_rollout = SCENARIO_STEPS + 1
    check(launches["B"] == 2 * len(fleets) * per_rollout,
          f"scenario_eval launched kernel B {launches['B']} times, not "
          f"{2 * len(fleets)} rollouts × {per_rollout}")
    check(sum(launches.values()) == launches["B"], "scenario_eval launched a kernel it does not run")
    check(list(res["summary"]) == list(fleets), f"scenario_eval ran {list(res['summary'])}")
    check(len(walls) == 2 * len(fleets), "scenario_eval: not two rollouts a scenario")
    report = {}
    for i, (name, (params, town, rcfg)) in enumerate(fleets.items()):
        out = res["scenarios"][name]
        for who in ("policy", "expert"):
            check(all(math.isfinite(out[who][k]) for k in ("driving_score", "driving_score_arc",
                                                          "mean_speed", "route_km")),
                  f"scenario {name}: {who} metrics not finite")
            check(out[who]["env_steps"] == SCENARIO_ENVS * SCENARIO_STEPS,
                  f"scenario {name}: {who} env_steps")
        check(out["expert"]["km_driven"] > 0, f"scenario {name}: the expert did not drive")
        report[name] = {
            "T": rcfg.max_triangles, "fog": rcfg.fog_density, "rain": rcfg.rain,
            "sun": rcfg.sun, "lanes": town.lanes,
            **{f"{who}_{k}": out[who][k] for who in ("policy", "expert")
               for k in ("driving_score", "driving_score_arc", "collisions_per_1k_steps")},
            "policy_env_steps_per_s": SCENARIO_ENVS * SCENARIO_STEPS / walls[2 * i],
            "expert_env_steps_per_s": SCENARIO_ENVS * SCENARIO_STEPS / walls[2 * i + 1],
            "b_launches": 2 * per_rollout}
    t1 = time.perf_counter()

    # 2. kernel B vs its plain version on each scenario's fleet
    gen = torch.Generator().manual_seed(3)
    cross_t = torch.tensor([0, 7, 40, 99, 150, 300, 399, 5][:SCENARIO_CROSS_ENVS])
    for name, (params, town, rcfg) in fleets.items():
        states = reset_env(params, town, gen, SCENARIO_ENVS)
        render = make_renderer(params, town, rcfg, device=dev)
        with Capture(rf, "fast_bands", lambda a, k, out: a) as cap:
            render(states)
        args = cap.calls[0]
        check(args[0].shape[2] == rcfg.max_triangles, f"scenario {name}: table width")
        report[name]["b_max_abs_err"] = check_fast(args, f"kernel B, scenario {name}")[0]
        if rcfg.rain <= 0.0:
            continue
        # 3. rainy frames, card vs CPU
        few = dataclasses.replace(
            states, **{f.name: getattr(states, f.name)[:SCENARIO_CROSS_ENVS]
                       for f in dataclasses.fields(states)})
        few = few.replace(t=cross_t.to(dev))
        card = render(few)["gray"]
        cpu = make_renderer(params, town.to("cpu"), rcfg, device="cpu")(few.to("cpu"))["gray"]
        report[name]["card_vs_cpu_max_abs"] = b_tolerance(card.cpu(), cpu,
                                                          f"scenario {name}: card vs CPU")
        yy = torch.arange(HW)[:, None]
        x = ((torch.arange(HW)[None, :] + yy // 3) * 9173
             + torch.div(yy - 4 * cross_t[:, None, None], 24, rounding_mode="floor") * 271
             + few.rng[:, 0].cpu()[:, None, None])
        check(torch.equal(weather._hash_u32(x.to(dev)).cpu(), weather._hash_u32(x)),
              f"scenario {name}: the rain hash differs on the card")
        wet_cpu = weather.apply_rain(cpu, few.rng.cpu(), few.t.cpu(), rcfg.rain)
        wet_card = weather.apply_rain(cpu.to(dev), few.rng, few.t, rcfg.rain)
        check(torch.equal(wet_card.cpu(), wet_cpu), f"scenario {name}: rain differs on the card")
    t2 = time.perf_counter()

    # 4. route changes on the multi-lane worlds
    changes = {name: route_changes(*fleets[name][:2], dev, SCENARIO_ENVS, SCENARIO_STEPS)
               for name in ("turns", "multilane")}
    for key, name in (("ego_transfers", "turns"), ("agent_transfers", "turns"),
                      ("ego_lane_changes", "multilane"), ("agent_lane_changes", "turns"),
                      ("agent_lane_changes", "multilane")):
        check(changes[name][key] > 0, f"scenario {name}: no {key} in the direct expert run")
    log(json.dumps({"scenarios": {
        "n_envs": SCENARIO_ENVS, "steps": SCENARIO_STEPS, "per_scenario": report,
        "mean_driving_score": res["mean_driving_score"],
        "mean_driving_score_arc": res["mean_driving_score_arc"], "launches": launches,
        "route_changes": changes, "scenario_eval_s": eval_s, "kernel_checks_s": t2 - t1,
        "route_changes_s": time.perf_counter() - t2,
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}))
    return launches


def route_world():
    """The JAX route harness's world on the CPU → (params, town, rollout
    render config): ``make_town(blocks=3, n_buildings=24, n_lights=8,
    lanes_per_direction=2, superblocks=True, turn_fans=True)``,
    ``SimParams(n_agents=15, episode_len=2500, lane_change_period=160)``,
    128² on kernel B at a 2 px LOD, as ``make_rollout`` forces it."""
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams

    town = make_town(blocks=3, n_buildings=24, n_lights=8, lanes_per_direction=2,
                     superblocks=True, turn_fans=True)
    params = SimParams(n_agents=15, episode_len=2500, lane_change_period=160)
    return params, town, RenderConfig(height=HW, width=HW, rgb=False, fast=True, lod_px=2.0)


def arrival_run(params, town, dev) -> dict:
    """A direct expert run of ROUTE_ARRIVE_ENVS envs × ROUTE_ARRIVE_STEPS,
    env b driving to goal b mod G from rest on a node 15-40 m short of it
    (by the goal's table). At every step that reports an arrival the ego
    was, before the step, within ``arrive_radius`` plus the step's largest
    travel of its goal; arrivals keep their goal across the reset."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.sim import world
    from carla_imitation_learning_tpu_torch.sim.town import route_point
    from carla_imitation_learning_tpu_torch.training.closed_loop import rollout_spawn_pool

    n, G = ROUTE_ARRIVE_ENVS, town.nav_goals.shape[0]
    dist = town.nav_dist.cpu().numpy()
    goal = torch.arange(n, device=dev) % G
    route = torch.zeros(n, dtype=torch.int64)
    point = torch.zeros(n, dtype=torch.int64)
    for b in range(n):
        g = b % G
        r, p = np.nonzero((dist[g] > 15.0) & (dist[g] < 40.0))
        check(len(r) > 0, f"routes: no node 15-40 m short of goal {g}")
        k = (b // G) * 7 % len(r)
        route[b], point[b] = int(r[k]), int(p[k])
    route, point = route.to(dev), point.to(dev)
    states = world.reset_env(params, town, torch.Generator().manual_seed(41), n)
    s = town.route_arclen[route, point]
    pos, yaw = route_point(town, route, s)
    states = states.replace(ego_route=route, ego_s=s, ego_pos=pos, ego_yaw=yaw,
                            ego_v=torch.zeros_like(s), goal=goal)
    pool = rollout_spawn_pool(params, town)
    reach = params.arrive_radius + (params.max_accel * params.dt) * params.dt + 1e-3
    arrivals, farthest = 0, 0.0
    for _ in range(ROUTE_ARRIVE_STEPS):
        ctrl = world.autopilot_control(params, town, states)
        new, info = world.step_env(params, town, states, ctrl,
                                   world.pick_fresh_packed(pool, params, states))
        arr = info["arrived"]
        if bool(arr.any()):
            d = world.norm2(states.ego_pos - town.nav_goals[states.goal])[arr]
            farthest = max(farthest, float(d.max()))
            check(bool((d < reach + states.ego_v[arr] * params.dt).all()),
                  f"routes: an arrival {float(d.max()):.2f} m from its goal before the step")
            check(bool(info["done"][arr].all()), "routes: an arrival did not end its episode")
            arrivals += int(arr.sum())
        check(torch.equal(new.goal, goal), "routes: the goals did not survive the resets")
        states = new
    check(arrivals > 0, "routes: no arrival in the direct expert run")
    return {"n_envs": n, "steps": ROUTE_ARRIVE_STEPS, "arrivals": arrivals,
            "farthest_before_arrival_m": farthest}


def routes_phase(dev, profile: bool = False) -> dict:
    """Phase 6f: goal-directed driving and the two policy families on the
    JAX route harness's world (``route_world``), counts reset after the
    mirrored town's kernel check:
    1. route planning on the host (``sample_goals``, ``plan_to_goals``);
       the share of nodes with a path, the tables' bytes on the card;
       kernel B bit for bit against its plain version on one frame of the
       ROUTE_ENVS fleet on ``mirror_town`` (every turn mirrored);
    2. ``evaluate_routes`` of the expert at ROUTE_ENVS × ROUTE_STEPS:
       arrivals, counts that add up; ``arrival_run`` checks arrivals
       against the goal points;
    3. goal-directed ``collect_dataset`` on the town and on its mirror at
       ROUTE_ENVS × ROUTE_COLLECT_STEPS: all six commands collected;
    4. ``DeviceDataset(cil=True, balanced by action_command)``,
       ROUTE_TRAIN_STEPS bf16 ``cil_loss_fn`` steps at ROUTE_BATCH (CUDA
       events over the steps after ROUTE_TIMED_FROM): the loss falls; then
       ``evaluate_routes`` of the CIL policy through the rollout's extras;
    5. an fp32 copy of the CIL policy driving ROUTE_CROSS_ENVS ×
       ROUTE_CROSS_STEPS goal-directed on the card and on the CPU (TF32 off):
       integer state, actions, commands, arrivals and ends equal, floats as
       ``check_against_cpu`` holds them; one fp32 forward, card vs CPU;
    6. continuous BC: a noisy expert collection at CONT_ENVS × CONT_STEPS,
       CONT_TRAIN_STEPS ``continuous_bc_loss_fn`` steps, and
       ``evaluate_policy(control_space="continuous")`` at CONT_EVAL_ENVS ×
       CONT_EVAL_STEPS: executed controls in the unit square, the logged
       action the label of the executed control;
    7. ``run route_eval`` through the CLI on step 4's checkpoint with
       ``policy_family=cil`` at ROUTE_CLI_ENVS × ROUTE_CLI_STEPS.
    Kernel B runs once per rollout step and first frame, no other kernel.
    ``--profile`` adds a torch.profiler window of the CIL route rollout.
    Prints one ``routes`` line; returns the launches."""
    import math

    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data.actions import control_to_discrete_label
    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.models import BranchedCILPolicy, ContinuousPolicyCNN
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.render.pipeline import make_renderer
    from carla_imitation_learning_tpu_torch.sim import planner
    from carla_imitation_learning_tpu_torch.sim.town import mirror_town
    from carla_imitation_learning_tpu_torch.sim.world import reset_env
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import (
        cil_loss_fn, continuous_bc_loss_fn,
    )
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_fused_epoch,
    )
    from carla_imitation_learning_tpu_torch.utils.checkpoint import save_pytree

    res, secs = {}, {}
    params, town, rcfg = route_world()

    # 1. planning, and kernel B on the mirrored town
    t0 = time.perf_counter()
    goals = planner.sample_goals(town, 0, ROUTE_GOALS)
    town = planner.plan_to_goals(town, goals).to(dev)
    secs["plan"] = time.perf_counter() - t0
    finite = float(torch.isfinite(town.nav_dist).float().mean())
    check(finite > 0.5, f"routes: only {finite:.1%} of the nodes have a path to their goal")
    res["plan"] = {"goals": ROUTE_GOALS, "seconds": secs["plan"],
                   "nodes": int(town.nav_dist[0].numel()), "finite_share": finite,
                   "prescribed_share": float((town.nav_slot >= 0).float().mean()),
                   "table_bytes": sum(t.numel() * t.element_size()
                                      for t in (town.nav_slot, town.nav_dist, town.nav_goals))}
    mirrored = mirror_town(town)
    states = reset_env(params, mirrored, torch.Generator().manual_seed(40), ROUTE_ENVS)
    with Capture(rf, "fast_bands", lambda a, k, out: a) as cap:
        make_renderer(params, mirrored, rcfg, device=dev)(states)
    res["b_mirrored_max_abs_err"] = check_fast(cap.calls[0], "kernel B, mirrored route town")[0]
    del states, cap

    torch.cuda.synchronize()
    reset_counts()
    expect_b = 0

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    def counts_add_up(m, who):
        check(m["attempts"] == m["arrivals"] + m["crashes"] + m["timeouts"],
              f"routes: {who}'s counts do not add up: {m}")
        check(m["env_steps"] == ROUTE_ENVS * ROUTE_STEPS and math.isfinite(m["km_driven"]),
              f"routes: {who}'s rollout: {m}")

    # 2. the expert's A→B evaluation
    expert = timed("expert_eval", lambda: cl.evaluate_routes(
        params, town, rcfg, None, torch.Generator().manual_seed(42), n_envs=ROUTE_ENVS,
        n_steps=ROUTE_STEPS, device=dev))
    expect_b += ROUTE_STEPS + 1
    counts_add_up(expert, "the expert")
    check(expert["arrivals"] > 0, f"routes: the expert never arrived: {expert}")
    res["expert"] = {**expert, "env_steps_per_s": ROUTE_ENVS * ROUTE_STEPS / secs["expert_eval"]}
    res["arrival_run"] = timed("arrival_run", lambda: arrival_run(params, town, dev))

    # 3. goal-directed collection on the town and its mirror
    goal_ids = np.arange(ROUTE_ENVS) % ROUTE_GOALS
    stores = []
    for i, world_town in enumerate((town, mirrored)):
        store, _, traj = timed(f"collect_{i}", lambda w=world_town, i=i: cl.collect_dataset(
            params, w, rcfg, torch.Generator().manual_seed(43 + i), ROUTE_ENVS,
            ROUTE_COLLECT_STEPS, goal_ids=goal_ids, device=dev))
        expect_b += ROUTE_COLLECT_STEPS + 1
        check(bool((traj["done"] | ~traj["arrived"]).all()), "routes: an arrival did not end")
        stores.append(store)
        del traj
    store = FrameStore.concat(stores)
    del stores
    hist = np.bincount(store.commands, minlength=6)
    check(bool((hist > 0).all()), f"routes: a command was never collected: {hist.tolist()}")
    res["collect"] = {"n_envs": ROUTE_ENVS, "steps_per_world": ROUTE_COLLECT_STEPS,
                      "frames": len(store), "command_histogram": hist.tolist(),
                      "env_steps_per_s": 2 * ROUTE_ENVS * ROUTE_COLLECT_STEPS
                      / (secs["collect_0"] + secs["collect_1"])}

    # 4. CIL training, then the CIL policy on the routes
    ds = DeviceDataset(store, ROUTE_BATCH, shuffle=True, cil=True, balanced=True,
                       balance_key="action_command", device=dev)
    del store
    state = create_train_state(BranchedCILPolicy(n_commands=6),
                               AdamConfig(schedule=lambda count: 1e-3),
                               generator=torch.Generator().manual_seed(44), device=dev)
    epoch = make_fused_epoch(cil_loss_fn(), ds.pure_batch)
    order = torch.from_numpy(ds.epoch_indices()[:ROUTE_TRAIN_STEPS * ROUTE_BATCH]
                             .reshape(ROUTE_TRAIN_STEPS, ROUTE_BATCH)).to(dev)
    _, _, first = epoch(state, order[:ROUTE_TIMED_FROM])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _, _, rest = epoch(state, order[ROUTE_TIMED_FROM:])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (ROUTE_TRAIN_STEPS - ROUTE_TIMED_FROM)
    losses = torch.cat([first["loss"], rest["loss"]]).float().cpu().numpy()
    check(bool(np.isfinite(losses).all()), "routes: CIL loss not finite")
    check(losses[-10:].mean() < losses[:10].mean(),
          f"routes: CIL loss did not fall ({losses[:10].mean():.4f} → {losses[-10:].mean():.4f})")
    res["cil_train"] = {"steps": ROUTE_TRAIN_STEPS, "batch": ROUTE_BATCH, "dtype": "bfloat16",
                        "windows": ds.n_samples, "ms_per_step": ms,
                        "images_per_s": ROUTE_BATCH / ms * 1e3,
                        "loss_first10": float(losses[:10].mean()),
                        "loss_last10": float(losses[-10:].mean()),
                        "accuracy_last10": float(rest["accuracy"][-10:].float().mean())}
    del ds, epoch, order
    model = state.model.eval()
    cil = timed("cil_eval", lambda: cl.evaluate_routes(
        params, town, rcfg, model.as_policy_fn(), torch.Generator().manual_seed(45),
        n_envs=ROUTE_ENVS, n_steps=ROUTE_STEPS, device=dev))
    expect_b += ROUTE_STEPS + 1
    counts_add_up(cil, "the CIL policy")
    res["cil"] = {**cil, "env_steps_per_s": ROUTE_ENVS * ROUTE_STEPS / secs["cil_eval"]}
    if profile:
        res["profile"] = profile_route_rollout(params, town, rcfg, model, dev)
        expect_b += ROUTE_PROFILE_WARM + ROUTE_PROFILE_STEPS + 1

    # 5. the CIL rollout and forward, card vs CPU
    fp32 = BranchedCILPolicy(n_commands=6, dtype=torch.float32)
    fp32.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    res["card_vs_cpu"] = timed("card_vs_cpu", lambda: cil_card_vs_cpu(params, town, rcfg,
                                                                      fp32, dev))
    expect_b += ROUTE_CROSS_STEPS + 1

    # 6. continuous BC
    noise = cl.NoiseConfig(seed=6)
    cstore, log_, _ = timed("cont_collect", lambda: cl.collect_dataset(
        params, town, rcfg, torch.Generator().manual_seed(46), CONT_ENVS, CONT_STEPS,
        noise=noise, device=dev))
    expect_b += CONT_STEPS + 1
    labels = np.stack([np.asarray(log_.steer, np.float32),
                       np.asarray(log_.throttle, np.float32)
                       - np.asarray(log_.brake, np.float32)], axis=1)
    cds = DeviceDataset(cstore, ROUTE_BATCH, shuffle=True, continuous_labels=labels,
                        device=dev)
    del cstore
    cstate = create_train_state(ContinuousPolicyCNN(), AdamConfig(schedule=lambda count: 1e-3),
                                generator=torch.Generator().manual_seed(47), device=dev)
    cepoch = make_fused_epoch(continuous_bc_loss_fn(), cds.pure_batch)
    n_b = len(cds)
    rows = [cds.epoch_indices()[:n_b * ROUTE_BATCH].reshape(n_b, ROUTE_BATCH)
            for _ in range(-(-CONT_TRAIN_STEPS // n_b))]
    corder = torch.from_numpy(np.concatenate(rows)[:CONT_TRAIN_STEPS]).to(dev)
    _, _, cm = timed("cont_train", lambda: cepoch(cstate, corder))
    closs = cm["loss"].float().cpu().numpy()
    check(bool(np.isfinite(closs).all()) and closs[-10:].mean() < closs[:10].mean(),
          f"routes: continuous loss did not fall ({closs[:10].mean():.4f} → "
          f"{closs[-10:].mean():.4f})")
    del cds, cepoch, corder
    cmodel = cstate.model.eval()
    with Capture(cl, "driving_metrics", lambda a, k, out: a[1]) as cap:
        cmetrics = timed("cont_eval", lambda: cl.evaluate_policy(
            params, town, rcfg, lambda obs: cmodel(obs), torch.Generator().manual_seed(48),
            n_envs=CONT_EVAL_ENVS, n_steps=CONT_EVAL_STEPS, control_space="continuous",
            device=dev))
    expect_b += CONT_EVAL_STEPS + 1
    traj = cap.calls[0]
    steer, thr, brk = traj["steer"], traj["throttle"], traj["brake"]
    check(bool((steer.abs() <= 1).all() & (thr >= 0).all() & (thr <= 1).all()
               & (brk >= 0).all() & (brk <= 1).all() & (thr * brk == 0).all()),
          "routes: continuous controls left the unit square")
    check(torch.equal(traj["action"], control_to_discrete_label(steer, thr, brk)),
          "routes: the logged action is not the label of the executed control")
    res["continuous"] = {"collect_env_steps_per_s": CONT_ENVS * CONT_STEPS / secs["cont_collect"],
                         "train_steps": CONT_TRAIN_STEPS,
                         "ms_per_step": secs["cont_train"] / CONT_TRAIN_STEPS * 1e3,
                         "loss_first10": float(closs[:10].mean()),
                         "loss_last10": float(closs[-10:].mean()),
                         "eval": {k: cmetrics[k] for k in (
                             "driving_score", "mean_speed", "steer_rate", "action_agreement",
                             "collisions_per_1k_steps")},
                         "steer_range": [float(steer.min()), float(steer.max())],
                         "action_histogram": torch.bincount(traj["action"].reshape(-1),
                                                            minlength=9).tolist()}
    del traj, cap, cmodel, cstate

    # 7. the CLI on the CIL checkpoint
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cil_") as tmp:
        ckpt = Path(tmp) / "bc_cil"
        save_pytree(ckpt, {"params": {k: v.detach().cpu() for k, v in
                                      state.model.state_dict().items()}})
        cli = timed("cli", lambda: cli_run(
            "route_eval", "--checkpoint", str(ckpt), "-o", "experiment=route_eval",
            "-o", "policy_family=cil", "-o", f"n_envs={ROUTE_CLI_ENVS}",
            "-o", f"n_steps={ROUTE_CLI_STEPS}", "-o", f"n_goals={ROUTE_GOALS}",
            "-o", "sim.town.lanes_per_direction=2", "-o", "sim.lane_change_period=160"))
    expect_b += 2 * (ROUTE_CLI_STEPS + 1)
    for who in ("expert", "policy"):
        m = cli[who]
        check(m["attempts"] == m["arrivals"] + m["crashes"] + m["timeouts"]
              and m["env_steps"] == ROUTE_CLI_ENVS * ROUTE_CLI_STEPS,
              f"routes: run route_eval, {who}: {m}")
    res["cli"] = {"seconds": secs["cli"], "expert": cli["expert"], "policy": cli["policy"]}

    launches = read_counts()
    check(launches["B"] == expect_b,
          f"routes: kernel B launched {launches['B']} times, not once per rollout step "
          f"and first frame ({expect_b})")
    check(sum(launches.values()) == launches["B"], "routes: a kernel it does not run launched")
    res.update(launches=launches, seconds=secs,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(json.dumps({"routes": res}))
    del state, model, fp32
    torch.cuda.empty_cache()
    return launches


def cil_card_vs_cpu(params, town, rcfg, model, dev) -> dict:
    """The fp32 CIL ``model`` driving ROUTE_CROSS_ENVS goal-directed envs for
    ROUTE_CROSS_STEPS on the card and on the CPU (the plain versions), from
    the same reset draws and pool, half the envs 3 steps short of their
    episode limit, TF32 off: actions, commands, arrivals, ends and the
    integer state equal, sim floats within rtol 1e-5 / atol 1e-4, frames
    within the fast raster's tolerance; then one forward on the last window,
    logits within 1e-4. → the largest differences."""
    import copy
    import dataclasses as dc

    import torch

    from carla_imitation_learning_tpu_torch.training import closed_loop as cl

    cpu = torch.device("cpu")
    pool = cl.rollout_spawn_pool(params, town.to(cpu))
    runs = []
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for d in (dev, cpu):
            m = copy.deepcopy(model).to(d).eval()
            init_fn, rollout_fn = cl.make_rollout(params, town, rcfg, m.as_policy_fn(),
                                                  spawn_pool=pool, device=d)
            carry = init_fn(torch.Generator().manual_seed(49), ROUTE_CROSS_ENVS)
            states = carry[0]
            near_end = torch.arange(ROUTE_CROSS_ENVS, device=d) % 2 == 0
            states = states.replace(t=torch.where(near_end, params.episode_len - 3, states.t))
            carry = cl.assign_goals((states,) + carry[1:],
                                    torch.arange(ROUTE_CROSS_ENVS) % town.nav_goals.shape[0])
            (states, framebuf, _), traj = rollout_fn(carry, ROUTE_CROSS_STEPS)
            speed = states.ego_v
            cmd = cl.navigation_command(params, town.to(d), states)
            with torch.no_grad():
                logits, _ = m(framebuf.float() / 255, speed, cmd.clamp(0, 5))
            runs.append((states.to(cpu), {k: v.to(cpu) for k, v in traj.items()},
                         logits.to(cpu)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (s_k, tr_k, lg_k), (s_p, tr_p, lg_p) = runs
    check(bool(tr_p["done"].any()), "routes card vs CPU: no episode ended")
    for key in ("action", "expert_action", "command", "arrived", "done", "collision",
                "offroad", "traffic"):
        check(torch.equal(tr_k[key], tr_p[key]), f"routes card vs CPU: {key} differs")
    worst = {"sim": 0.0}
    for f in dc.fields(s_k):
        got, want = getattr(s_k, f.name), getattr(s_p, f.name)
        if got.dtype == torch.int64:
            check(torch.equal(got, want), f"routes card vs CPU: state {f.name} differs")
            continue
        excess = float(((got - want).abs() - 1e-5 * want.abs()).max()) if got.numel() else 0.0
        check(excess <= 1e-4, f"routes card vs CPU: {f.name} off by {excess:.3e}")
        if got.numel():
            worst["sim"] = max(worst["sim"], float((got - want).abs().max()))
    for key in ("speed", "sensor", "steer", "route_ds"):
        excess = float(((tr_k[key] - tr_p[key]).abs() - 1e-5 * tr_p[key].abs()).max())
        check(excess <= 1e-4, f"routes card vs CPU: {key} off by {excess:.3e}")
    worst["frames"] = b_tolerance(tr_k["gray"].float() / 255, tr_p["gray"].float() / 255,
                                  "routes card vs CPU frames")
    worst["logits"] = float((lg_k - lg_p).abs().max())
    check(worst["logits"] < 1e-4, f"routes card vs CPU: fp32 CIL logits off by "
          f"{worst['logits']:.3e}")
    worst["arrivals"] = int(tr_p["arrived"].sum())
    return worst


def sharded_coverage(store, shards, dev) -> dict:
    """One epoch of ``ShardedPrefetchReader`` and of ``DeviceShardStreamer``
    over ``shards`` against the windows ``DeviceDataset`` draws from
    ``store``: the same multiset of (window, label), compared as sorted
    keys (``window_keys``). The prefetcher's batch divides every shard's
    window count (the largest such divisor up to FILE_BATCH) and the
    streamer keeps its partial batches, so each covers every window once."""
    import math

    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset
    from carla_imitation_learning_tpu_torch.native import (
        DeviceShardStreamer, ShardedFrameStore, ShardedPrefetchReader,
    )

    fs = 4
    gen = torch.Generator().manual_seed(0)
    weights = torch.randint(0, 2 ** 20, (1, fs, HW, HW), generator=gen).to(dev)
    ds = DeviceDataset(store, FILE_BATCH, frame_skip=fs, device=dev)
    starts = ds.start_indices(np.arange(ds.n_samples))
    want = []
    for chunk in starts.split(2048):
        win = ds.frames[chunk[:, None] + torch.arange(fs, device=dev)]
        want.append(window_keys(win, ds.actions[chunk + fs], weights))
    want = torch.sort(torch.cat(want)).values
    sharded = ShardedFrameStore(shards)
    counts = []
    for i in range(sharded.n_shards):
        with sharded.open_shard(i) as nfs:
            counts.append(nfs.n_valid_windows(fs))
    g = math.gcd(*counts)
    batch = max(d for d in range(1, min(g, FILE_BATCH) + 1) if g % d == 0)
    t0 = time.perf_counter()
    got = [window_keys(torch.from_numpy(f).to(dev), torch.from_numpy(lab).to(dev), weights)
           for f, lab in ShardedPrefetchReader(sharded, batch, fs, n_threads=4, seed=1)]
    prefetch_s = time.perf_counter() - t0
    got = torch.sort(torch.cat(got)).values
    check(torch.equal(got, want), "ShardedPrefetchReader: the epoch's windows differ from "
          "DeviceDataset's")
    t0 = time.perf_counter()
    streamed = [window_keys(torch.round(x * 255).to(torch.uint8).permute(0, 3, 1, 2), y, weights)
                for x, y in DeviceShardStreamer(shards, FILE_BATCH, fs, seed=1,
                                                drop_last=False, device=dev)]
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    streamed = torch.sort(torch.cat(streamed)).values
    check(torch.equal(streamed, want), "DeviceShardStreamer: the epoch's windows differ from "
          "DeviceDataset's")
    return {"windows": int(want.numel()), "shards": sharded.n_shards,
            "aligned_to_starts": sharded.aligned_to_starts, "prefetch_batch": batch,
            "prefetch_epoch_s": prefetch_s, "streamer_epoch_s": stream_s}


def profile_streaming(path, dev) -> dict:
    """Device busy and idle share of 20 train steps of each streaming tier
    over the packed store at ``path`` (torch.profiler, after 5 warm-up
    steps): whether ``device_prefetch`` hides the host tier's copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.data.pipeline import device_prefetch
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.native import (
        DeviceShardStreamer, NativeFrameStore, PrefetchReader,
    )
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer, make_train_step,
    )

    cfg = compose("config", overrides=["model=imitation"])
    step = make_train_step(bc_loss_fn)
    out = {}
    with NativeFrameStore(path) as nfs:
        tiers = {
            "direct": lambda: DeviceShardStreamer(path, FILE_BATCH, 4, device=dev),
            "host": lambda: ((f.permute(0, 2, 3, 1).to(torch.float32) / 255.0, lab)
                             for f, lab in device_prefetch(
                                 PrefetchReader(nfs, FILE_BATCH, 4, shuffle=True), device=dev)),
        }

        def epochs(make):
            while True:
                yield from make()

        for tier, batches in tiers.items():
            state = create_train_state(PolicyCNN(), make_optimizer(cfg),
                                       generator=torch.Generator().manual_seed(0), device=dev)
            it = epochs(batches)
            for _ in range(5):
                step(state, next(it))
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(20):
                    _, m = step(state, next(it))
                float(m["loss"])
                wall = time.perf_counter() - t0
            events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            copies = [e for e in events if "Memcpy" in e.name or "memcpy" in e.name]
            busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
            out[tier] = {"steps": 20, "wall_ms": wall * 1e3, "ms_per_step": wall / 20 * 1e3,
                         "device_busy_ms": busy * 1e3,
                         "device_idle_share": 1.0 - busy / wall,
                         "h2d_copy_ms": sum(e.time_range.elapsed_us() for e in copies) / 1e3,
                         "device_launches": len(events)}
            del it
    return out


def dagger_phase(params, town, rcfg, dev, bc_state, profile: bool = False) -> dict:
    """Phase 6c: DAgger on the card, from the BC phase's trained state,
    counts reset just before it. A DAgger round (``dagger_iteration``, the
    trained policy driving) and a noisy expert collection at DAGGER_ENVS ×
    DAGGER_STEPS, each launching kernel B once per step plus the first
    frame; ``make_online_dagger`` from a copy of the trained state, which
    must have learned (the last round's agreement above
    ONLINE_MIN_AGREEMENT); a K-member ensemble round with its masked
    dataset and a few ensemble steps, and the ensemble against its members
    (``ensemble_card_vs_members``); one online-DAgger masked train step in
    fp32 on the card and on the CPU, each against float64. Prints one
    ``dagger`` line; → the phase's launch counts."""
    import copy

    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data.actions import continuous_to_discrete
    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training import dagger
    from carla_imitation_learning_tpu_torch.training import online_dagger as od
    from carla_imitation_learning_tpu_torch.training.steps import flax_init_, make_optimizer

    res = {}
    model = bc_state.model

    def policy_fn(obs):
        return model(obs).argmax(-1)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    store, _, traj = cl.dagger_iteration(params, town, rcfg, policy_fn,
                                         torch.Generator().manual_seed(31), DAGGER_ENVS,
                                         DAGGER_STEPS, device=dev)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check(launches["B"] == DAGGER_STEPS + 1,
          f"DAgger round launched kernel B {launches['B']} times for {DAGGER_STEPS} steps")
    check(store.frames.shape == (DAGGER_ENVS * DAGGER_STEPS, HW, HW) and store.frames.std() > 1,
          "DAgger round frames are blank or misshapen")
    check(bool(np.array_equal(store.actions, traj["expert_action"].T.reshape(-1).cpu().numpy())),
          "DAgger round: the store's labels are not the expert's actions")
    res["round"] = {"n_envs": DAGGER_ENVS, "steps": DAGGER_STEPS, "seconds": seconds,
                    "env_steps_per_s": DAGGER_ENVS * DAGGER_STEPS / seconds,
                    "launches_B": launches["B"],
                    "agreement": float((traj["action"] == traj["expert_action"])
                                       .float().mean()),
                    "policy_action_counts": torch.bincount(traj["action"].reshape(-1).long(),
                                                           minlength=9).tolist(),
                    "expert_action_counts": torch.bincount(
                        traj["expert_action"].reshape(-1).long(), minlength=9).tolist()}

    # masked online-DAgger windows from the round's trajectory (first
    # ONLINE_BATCH envs as a one-round buffer): the fp32 step on card and CPU
    buf = (traj["gray"][None, :, :ONLINE_BATCH], traj["expert_action"][None, :, :ONLINE_BATCH],
           traj["done"][None, :, :ONLINE_BATCH])
    windows = od.sample_windows(torch.Generator().manual_seed(32), *buf, 0, 1, 4)
    del traj, store

    def masked_loss(m, batch):
        obs, y, w = batch
        return od.masked_cross_entropy(m(obs), y, w), {}

    masked = step_card_vs_cpu("online_dagger_card_vs_cpu", masked_loss, windows, dev,
                              require_clip=False)
    res["masked_step_card_vs_cpu"] = {k: v for k, v in masked.items() if k != "tensors"}

    ncfg = cl.NoiseConfig(seed=5)
    init_fn, rollout_fn = cl.make_rollout(params, town, rcfg, None, noise=ncfg, device=dev)
    carry = init_fn(torch.Generator().manual_seed(33), DAGGER_ENVS)
    sched = cl._noise_schedule(cl.noise_generator(ncfg, carry[0]), DAGGER_STEPS, DAGGER_ENVS,
                               ncfg).to(dev)
    t0 = time.perf_counter()
    _, traj = rollout_fn(carry, DAGGER_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    clean, steer = traj["clean_steer"], traj["steer"]
    check(torch.equal(steer, torch.where(sched != 0, torch.clamp(clean + sched, -1, 1), clean)),
          "noisy collection: the executed steer is not the clean steer plus the schedule")
    labels = continuous_to_discrete(clean, traj["throttle"], traj["brake"]).to(torch.int64)
    check(torch.equal(traj["expert_action"], labels) and torch.equal(traj["action"], labels),
          "noisy collection: the labels are not the clean driver's")
    res["noisy_collection"] = {
        "n_envs": DAGGER_ENVS, "steps": DAGGER_STEPS, "prob": ncfg.prob,
        "env_steps_per_s": DAGGER_ENVS * DAGGER_STEPS / seconds,
        "perturbed_share": float((steer != clean).float().mean()),
        "schedule_active_share": float((sched != 0).float().mean()),
        "max_abs_noise": float((steer - clean).abs().max())}
    check(res["noisy_collection"]["perturbed_share"] > 0, "noisy collection: no noise fired")
    del traj, carry

    state = copy.deepcopy(bc_state)
    run = od.make_online_dagger(PolicyCNN.__call__, params, town, rcfg,
                                n_envs=ONLINE_ENVS, n_steps=ONLINE_STEPS,
                                rounds=ONLINE_ROUNDS, train_steps=ONLINE_TRAIN_STEPS,
                                batch=ONLINE_BATCH, device=dev)
    t0 = time.perf_counter()
    state, metrics = run(state, torch.Generator().manual_seed(34))
    seconds = time.perf_counter() - t0
    check(metrics["agreement"][0] == 1.0,
          f"online DAgger: round 0 agreement {metrics['agreement'][0]} is not 1")
    check(bool(np.isfinite(metrics["loss"]).all() and np.isfinite(metrics["valid_frac"]).all()),
          f"online DAgger: non-finite metrics {metrics}")
    check(metrics["agreement"][-1] > ONLINE_MIN_AGREEMENT,
          f"online DAgger: the last round's agreement {metrics['agreement'][-1]:.3f} is not "
          f"above {ONLINE_MIN_AGREEMENT:.3f}; the policy has not learned")
    # the train step alone: sampled masked steps on a one-round buffer
    frames = torch.zeros((1, ONLINE_STEPS, ONLINE_ENVS, HW, HW), dtype=torch.uint8, device=dev)
    labels = torch.zeros((1, ONLINE_STEPS, ONLINE_ENVS), dtype=torch.int64, device=dev)
    dones = torch.zeros((1, ONLINE_STEPS, ONLINE_ENVS), dtype=torch.bool, device=dev)
    n = min(DAGGER_STEPS, ONLINE_STEPS)
    for whole, part in zip((frames, labels, dones), buf):
        whole[0, :n] = part[0, :n, :ONLINE_ENVS]
    gen = torch.Generator().manual_seed(35)

    def train_step():
        obs, y, w = od.sample_windows(gen, frames, labels, dones, 0,
                                      ONLINE_BATCH // ONLINE_ENVS, 4)
        state.optimizer.zero_grad(set_to_none=True)
        od.masked_cross_entropy(state.model(obs), y, w).backward()
        state.apply_gradients()

    for _ in range(3):
        train_step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ONLINE_TIMED_STEPS):
        train_step()
    end.record()
    torch.cuda.synchronize()
    res["online"] = {
        "rounds": ONLINE_ROUNDS, "n_envs": ONLINE_ENVS, "steps": ONLINE_STEPS,
        "train_steps": ONLINE_TRAIN_STEPS, "batch": ONLINE_BATCH, "seconds": seconds,
        "env_steps_per_s_with_training": ONLINE_ROUNDS * ONLINE_STEPS * ONLINE_ENVS / seconds,
        "ms_per_train_step": start.elapsed_time(end) / ONLINE_TIMED_STEPS,
        "buffer_mib": ONLINE_ROUNDS * ONLINE_STEPS * ONLINE_ENVS * (HW * HW + 9) / 2 ** 20,
        **{k: v.tolist() for k, v in metrics.items()}}
    if profile:
        res["online"]["profile"] = profile_online_dagger(params, town, rcfg, dev, state)
    del state, run, frames, labels, dones, buf

    members = [copy.deepcopy(model)] + [
        flax_init_(PolicyCNN(dtype=torch.bfloat16), torch.Generator().manual_seed(40 + i))
        for i in range(ENSEMBLE_K - 1)]
    ens = dagger.Ensemble(members, make_optimizer({"LEARNING_RATE": BC_LR,
                                                   "gradient_clip_val": BC_CLIP}), device=dev)
    t0 = time.perf_counter()
    store, _, traj = cl.dagger_iteration(params, town, rcfg, dagger.ensemble_policy_from(ens),
                                         torch.Generator().manual_seed(36), ENSEMBLE_ENVS,
                                         ENSEMBLE_STEPS, device=dev)
    seconds = time.perf_counter() - t0
    unc = traj["policy_extra"]
    check(tuple(unc.shape) == (ENSEMBLE_STEPS, ENSEMBLE_ENVS)
          and float(unc.min()) >= 0.0 and float(unc.max()) <= 1.0 - 1.0 / ENSEMBLE_K,
          f"ensemble round: disagreement outside [0, {1.0 - 1.0 / ENSEMBLE_K}]")
    mask = unc.T.reshape(-1).cpu().numpy() >= ENSEMBLE_TAU
    kept_all = not mask.any()
    if kept_all:
        mask[:] = True
    ds = DeviceDataset(store, BC_BATCH, shuffle=True, sample_mask=mask, device=dev)
    losses = [ens.train_step(batch)["loss"] for _, batch in zip(range(ENSEMBLE_TRAIN_STEPS), ds)]
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), "ensemble steps: non-finite loss")
    res["ensemble"] = {"k": ENSEMBLE_K, "n_envs": ENSEMBLE_ENVS, "steps": ENSEMBLE_STEPS,
                       "env_steps_per_s": ENSEMBLE_ENVS * ENSEMBLE_STEPS / seconds,
                       "ms_per_step": seconds / ENSEMBLE_STEPS * 1e3,
                       "mean_disagreement": float(unc.mean()),
                       "max_disagreement": float(unc.max()), "tau": ENSEMBLE_TAU,
                       "kept_windows": ds.n_samples, "kept_whole_round": kept_all,
                       "member_losses": losses.tolist()}
    obs = windows[0][:ENSEMBLE_ENVS].to(dev, torch.bfloat16)
    if profile:
        res["ensemble"]["profile"] = profile_ensemble_forward(ens, members, obs)
    res["ensemble_vs_members"] = ensemble_card_vs_members(members, windows, dev)
    del windows, obs
    launches = read_counts()
    # one launch per rollout step plus each rollout's first frame
    want_b = (2 * (DAGGER_STEPS + 1) + ENSEMBLE_STEPS + 1 + ONLINE_ROUNDS * ONLINE_STEPS + 1
              + (2 * (2 * 8 + 1) if profile else 0))
    check(launches["B"] == want_b,
          f"the DAgger phase launched kernel B {launches['B']} times, not {want_b}")
    check(launches["A"] + launches["A-tex"] + launches["C"] + launches["D"] == 0,
          "the DAgger phase launched a kernel it does not run")
    res["launches"] = launches
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"dagger": res}))
    del ens, members, store, traj, ds
    torch.cuda.empty_cache()
    return launches


def ensemble_card_vs_members(members, windows, dev) -> dict:
    """The K-member ``Ensemble`` on the card in fp32 (TF32 off) against its
    members run one at a time on the card, from fp32 copies of
    ``members`` and on the windows ``(obs, labels, _)``:
    - the vmapped forward's logits and each member's own, each held against
      the member's forward in float64 on the CPU: the ensemble no further
      from float64 than 4× the single forward is, plus 1e-6 of the logits'
      scale;
    - two ``Ensemble.train_step``s (on the windows' halves) against two
      ``make_train_step`` steps of each member alone, with the global-norm
      clip set between the members' gradient norms, so that it triggers for
      some members and not for others: each member's loss within rtol 1e-5,
      and after the steps no more parameters off the single steps' by over
      1 % of the learning rate than 1 in 10,000 (Adam's first steps move a
      weight by about lr · sign(g), so a near-zero gradient may flip).
    Prints the ``ensemble_vs_members`` line; → its numbers."""
    import statistics

    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training import dagger
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer, make_train_step,
    )

    def copy_as(m, dtype, device):
        new = PolicyCNN(dtype=dtype).to(dtype)
        new.load_state_dict(m.state_dict())
        return new.to(device)

    cpu = torch.device("cpu")
    obs, y = windows[0].to(dev, torch.float32), windows[1].to(dev)
    half = len(y) // 2
    fp32 = [copy_as(m, torch.float32, dev) for m in members]
    res = {"k": len(fp32), "windows": len(y)}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ens = dagger.Ensemble(fp32, make_optimizer({}), device=dev)
        with torch.no_grad():
            got = ens.logits(obs).to(cpu, torch.float64)
            single = torch.stack([m(obs) for m in fp32]).to(cpu, torch.float64)
            want = torch.stack([copy_as(m, torch.float64, cpu)(obs.to(cpu, torch.float64))
                                for m in fp32])
        scale = float(want.abs().max())
        res["forward"] = {"logit_scale": scale,
                          "err_ensemble": float((got - want).abs().max()),
                          "err_single": float((single - want).abs().max()),
                          "ensemble_vs_single": float((got - single).abs().max())}
        norms = []
        for m in fp32:
            m.zero_grad(set_to_none=True)
            bc_loss_fn(m, (obs[:half], y[:half]))[0].backward()
            norms.append(float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                              for p in m.parameters()))))
            m.zero_grad(set_to_none=True)
        clip = statistics.median(norms)
        tx = make_optimizer({"LEARNING_RATE": BC_LR, "gradient_clip_val": clip})
        ens = dagger.Ensemble(fp32, tx, device=dev)
        singles = [create_train_state(copy_as(m, torch.float32, dev), tx, device=dev)
                   for m in fp32]
        step = make_train_step(bc_loss_fn)
        loss_err = 0.0
        for part in (slice(0, half), slice(half, 2 * half)):
            batch = (obs[part], y[part])
            ens_loss = ens.train_step(batch)["loss"].to(cpu, torch.float64)
            for i, s in enumerate(singles):
                single_loss = float(step(s, batch)[1]["loss"])
                loss_err = max(loss_err, abs(float(ens_loss[i]) - single_loss) / abs(single_loss))
        off, worst, n_params = 0, 0.0, 0
        for i, s in enumerate(singles):
            got_p = ens.member(i)
            for k, v in s.model.state_dict().items():
                d = (got_p[k] - v).abs()
                off += int((d > 0.01 * BC_LR).sum())
                worst = max(worst, float(d.max()))
                n_params += v.numel()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    res["step"] = {"grad_norms": norms, "clip": clip, "steps": 2, "loss_rel_err": loss_err,
                   "params": n_params, "params_off": off, "param_max_diff": worst}
    log(json.dumps({"ensemble_vs_members": res}))
    fwd = res["forward"]
    check(fwd["err_ensemble"] <= 4 * fwd["err_single"] + 1e-6 * scale,
          f"ensemble forward: {fwd['err_ensemble']:.3e} from float64, a single member "
          f"{fwd['err_single']:.3e} (scale {scale:.3e})")
    check(min(norms) < clip < max(norms), f"ensemble step: clip {clip} not between {norms}")
    check(loss_err <= 1e-5, f"ensemble step: member loss {loss_err:.3e} from the single step's")
    check(off <= n_params // 10000,
          f"ensemble step: {off} of {n_params} parameters off the single steps' by > 1 % of lr")
    return res


def profile_ensemble_forward(ens, members, obs) -> dict:
    """torch.profiler over one vmapped ensemble forward, one member's own
    forward and the K members' forwards one after another, on the same bf16
    windows: device launches and device busy ms of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    runs = {"ensemble": lambda: ens.logits(obs), "single": lambda: members[0](obs),
            "members_one_by_one": lambda: [m(obs) for m in members]}
    res = {"k": len(members), "batch": len(obs)}
    with torch.no_grad():
        for name, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            res[name] = {"device_launches": len(events),
                         "device_busy_ms": sum(e.time_range.elapsed_us() for e in events) / 1e3}
    return res


def profile_online_dagger(params, town, rcfg, dev, state) -> dict:
    """torch.profiler over one online-DAgger round of ONLINE_ENVS × 8 steps
    and 5 train steps: device launches, device busy ms and the idle share
    of the host-clock window, per rollout step and in all."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training import online_dagger as od

    run = od.make_online_dagger(PolicyCNN.__call__, params, town, rcfg, n_envs=ONLINE_ENVS,
                                n_steps=8, rounds=2, train_steps=5, batch=ONLINE_BATCH,
                                device=dev)
    run(copy.deepcopy(state), torch.Generator().manual_seed(37))
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(copy.deepcopy(state), torch.Generator().manual_seed(38))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    return {"rounds": 2, "steps": 8, "train_steps": 5, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3, "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_launches": len(events),
            "fast_kernel_launches": sum("fast_band_kernel" in e.name for e in events)}


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


def time_train_step(label: str, model, loss_fn, group: str, batch, dev) -> dict:
    """One model's train step alone, as ``run`` builds it (the optimizer of
    the ``model=<group>`` preset, flax init, the step's device generator),
    on ``batch`` (AUX_BATCH rows) moved to ``dev``: AUX_TIMED_WARM warm-up steps, then
    AUX_TIMED_REPEATS runs of AUX_TIMED_STEPS steps, each timed by CUDA
    events around it (ms per step) and by the host clock up to the last
    step's return before the sync (the host's ms to issue a step), then
    torch.profiler over AUX_PROFILED_STEPS steps: the kernels' busy ms per
    step, which the profiler's own host cost does not change, and
    launches. ``idle_share`` is 1 − busy / the median's ms: where it is
    large the card waits on the host's launches, and a spread of the runs
    with the busy ms unchanged is the host's. → the median, every run and
    the profile."""
    import torch

    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer, make_train_step,
    )

    def to_dev(b):
        return tuple(to_dev(x) for x in b) if isinstance(b, tuple) else b.to(dev)

    batch = to_dev(batch)
    state = create_train_state(model, make_optimizer(compose("config", overrides=[f"model={group}"])),
                               generator=torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(loss_fn)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(AUX_TIMED_WARM):
        step(state, batch, gen)
    device_ms, host_ms = [], []
    for _ in range(AUX_TIMED_REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(AUX_TIMED_STEPS):
            _, metrics = step(state, batch, gen)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3 / AUX_TIMED_STEPS)
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end) / AUX_TIMED_STEPS)
    check(bool(torch.isfinite(metrics["loss"])), f"{label} timed steps: loss not finite")
    prof = profile_train_step(lambda st, order: [step(st, batch, gen) for _ in order], state,
                              range(AUX_PROFILED_STEPS))
    ms = sorted(device_ms)[len(device_ms) // 2]
    out = {"batch": AUX_BATCH, "dtype": "bfloat16", "steps": AUX_TIMED_STEPS, "ms_per_step": ms,
           "ms_runs": device_ms, "host_issue_ms_runs": host_ms,
           "images_per_s": AUX_BATCH / ms * 1e3,
           "idle_share": 1.0 - prof["device_busy_ms_per_step"] / ms,
           "profile": {k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                            "device_idle_share", "device_launches_per_step",
                                            "groups")}}
    log(f"{label} train step: {ms:.3f} ms (runs {[round(t, 3) for t in device_ms]}, host issue "
        f"{[round(t, 3) for t in host_ms]}), busy {prof['device_busy_ms_per_step']:.3f} ms, "
        f"{prof['device_launches_per_step']:.0f} launches, idle {out['idle_share']:.3f}")
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def aux_vae_phase(dev) -> dict:
    """Phase 6g: the aux, dual-stream, augmentation and VAE experiments.

    1. ``run bc_aux -o aux_seg_weight=0.5`` through the CLI, counts reset
       just before it: an expert collection of AUX_ENVS × AUX_STEPS with
       ``record_semantic`` on the bench town at 128² (kernel B for the
       frames, kernel A for the class plane, every step), AuxNet with its
       seg decoder in bf16 at batch AUX_BATCH for AUX_EPOCHS epochs, then
       the closed loop at AUX_EVAL_ENVS × AUX_EVAL_STEPS (kernel B). The
       collection's env-steps/s on the host clock around it, the launches,
       the test mIoU against the share of the test split's most frequent
       class (it must be above it), the driving score; the loss falls;
       kernels A and B on the first call's inputs of the collection bit for
       bit against their plain versions; the AuxNet-seg train step alone
       (``time_train_step``);
    2. file-backed runs through the CLI on synthetic logs: ``bc_aux`` and
       ``bc_raw_segment`` at 256², ``bc -o augment=true``, ``vae_pooled``
       and ``vae_leave_one_out`` at 1×224×224: each loss falls; none
       launches a kernel; then each model's train step alone at the runs'
       shapes and batch (``time_train_step``; both VAE runs train the same
       model): ms per step and images/s (a run's own throughput is not a
       step time: its 7–8 steps an epoch share the epoch's validation,
       checkpoint and host syncs);
    3. one fp32 step (TF32 off) on the card and on the CPU, each against
       float64 (``step_card_vs_cpu``): the AuxNet seg loss at 128², the
       dual-stream loss at 256², the VAE loss at 224² with fixed noise and
       the augmented BC loss at 256² with fixed draws.
    Prints one ``aux_vae`` line; → the launch counts of part 1."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.models import AuxNet, ConvVAE, DualStreamCNN, PolicyCNN
    from carla_imitation_learning_tpu_torch.models import vae as vae_mod
    from carla_imitation_learning_tpu_torch.ops import augment
    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training import losses

    res: dict = {}
    t_phase = time.perf_counter()
    first: dict = {}

    def keep_first(name):
        def record(a, k, out):
            if name not in first:
                first[name] = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)
        return record

    collect: dict = {}
    orig_collect = cl.collect_dataset

    def timed_collect(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_collect(*a, **k)
        torch.cuda.synchronize()
        collect["seconds"] = time.perf_counter() - t0
        collect["launches"] = read_counts()
        return out

    def test_shares(a, k, sem):
        cut = int(0.9 * len(sem))
        counts = np.bincount(sem[cut:].reshape(-1), minlength=8)
        return counts / counts.sum()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_aux_") as tmp:
        tmp = Path(tmp)
        base = ["-o", f"data_dir={tmp / 'seg_data'}", "-o", f"log_dir={tmp / 'seg_logs'}"]
        torch.cuda.synchronize()
        reset_counts()
        cl.collect_dataset = timed_collect
        try:
            with Capture(ra, "raster_bands", keep_first("A")), \
                    Capture(rf, "fast_bands", keep_first("B")), \
                    Capture(cl, "semantic_stream", test_shares) as shares:
                t0 = time.perf_counter()
                out = cli_run("bc_aux", *base, "-o", "aux_seg_weight=0.5",
                              "-o", f"n_envs={AUX_ENVS}", "-o", f"n_steps={AUX_STEPS}",
                              "-o", f"eval_envs={AUX_EVAL_ENVS}",
                              "-o", f"eval_steps={AUX_EVAL_STEPS}",
                              "-o", f"BATCH_SIZE={AUX_BATCH}", "-o", f"NUM_EPOCHS={AUX_EPOCHS}")
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
        finally:
            cl.collect_dataset = orig_collect
        launches = read_counts()
        hist = out["history"]
        check(all(np.isfinite(v) for row in hist for v in row.values()),
              f"bc_aux seg: non-finite history {hist}")
        check(hist[-1]["train_loss"] < hist[0]["train_loss"],
              f"bc_aux seg: the train loss did not fall: {[r['train_loss'] for r in hist]}")
        share = float(shares.calls[0].max())
        miou = out["seg_miou_test"]
        check(miou is not None and miou > share,
              f"bc_aux seg: test mIoU {miou} not above the majority class share {share:.4f}")
        check(launches["A"] >= AUX_STEPS and collect["launches"]["A"] == launches["A"],
              f"bc_aux seg: kernel A launched {launches['A']} times for {AUX_STEPS} "
              "collection steps")
        check(launches["B"] >= AUX_STEPS + AUX_EVAL_STEPS
              and launches["B"] - collect["launches"]["B"] >= AUX_EVAL_STEPS,
              f"bc_aux seg: kernel B launched {launches['B']} times")
        check(launches["A-tex"] + launches["C"] + launches["D"] == 0,
              "bc_aux seg launched a kernel it does not run")
        ev = out["eval"]
        check(np.isfinite(ev["driving_score"]) and ev["env_steps"] == AUX_EVAL_ENVS
              * AUX_EVAL_STEPS, f"bc_aux seg: evaluation {ev}")
        err_a, _ = check_exact(first["A"], "kernel A on a bc_aux collection step")
        err_b, _ = check_fast(first["B"], "kernel B on a bc_aux collection step")
        res["bc_aux_seg"] = {
            "collect": {"n_envs": AUX_ENVS, "steps": AUX_STEPS, "seconds": collect["seconds"],
                        "env_steps_per_s": AUX_ENVS * AUX_STEPS / collect["seconds"],
                        "launches": collect["launches"]},
            "run_seconds": run_s, "launches": launches, "history": hist,
            "throughput": out["throughput"], "test": out["test"], "seg_miou_test": miou,
            "test_class_shares": shares.calls[0].tolist(), "majority_share": share,
            "driving_score": ev["driving_score"], "eval": ev,
            "kernel_max_abs_err": {"A": err_a, "B": err_b}}
        first.clear()

        # the AuxNet-seg train step alone, bf16 at AUX_BATCH
        gen = torch.Generator().manual_seed(4)
        res["aux_seg_train_step"] = time_train_step(
            "AuxNet-seg 128²", AuxNet(image_hw=HW, seg_classes=8, dtype=torch.bfloat16),
            losses.aux_seg_loss_fn(), "imitation",
            ((torch.rand(AUX_BATCH, HW, HW, 4, generator=gen), torch.rand(AUX_BATCH, 3, generator=gen)),
             torch.randint(0, 2, (AUX_BATCH, 2), generator=gen, dtype=torch.int32),
             torch.randint(0, 8, (AUX_BATCH, HW, HW), generator=gen, dtype=torch.int32)), dev)

        # 2. the file-backed runs
        res["file_runs"] = {}
        reset_counts()
        file_base = ["-o", f"data_dir={tmp / 'data'}", "-o", f"image_height={AUX_IMG}",
                     "-o", f"image_width={AUX_IMG}", "-o", f"synthetic_frames={AUX_FILE_FRAMES}",
                     "-o", f"NUM_EPOCHS={AUX_FILE_EPOCHS}", "-o", f"BATCH_SIZE={AUX_BATCH}"]
        vae_base = ["-o", f"data_dir={tmp / 'vae_data'}", "-o", f"synthetic_frames={AUX_VAE_FRAMES}",
                    "-o", f"NUM_EPOCHS={AUX_FILE_EPOCHS}"]
        for label, argv, pick in (
                ("bc_aux", ("bc_aux", *file_base), "camera"),
                ("bc_raw_segment", ("bc_raw_segment", *file_base), None),
                ("bc_augment", ("bc", *file_base, "-o", "augment=true",
                                "-o", "bc_cameras=['camera']"), "camera"),
                ("vae_pooled", ("vae_pooled", *vae_base), None),
                ("vae_leave_one_out", ("vae_leave_one_out", *vae_base), None)):
            t0 = time.perf_counter()
            out = cli_run(*argv, "-o", f"log_dir={tmp / 'logs' / label}")
            wall = time.perf_counter() - t0
            r = out[pick] if pick else out
            hist = r["history"]
            check(all(np.isfinite(v) for row in hist for v in row.values()),
                  f"{label}: non-finite history {hist}")
            check(hist[-1]["train_loss"] < hist[0]["train_loss"],
                  f"{label}: the train loss did not fall: {[x['train_loss'] for x in hist]}")
            res["file_runs"][label] = {
                "train_loss": [x["train_loss"] for x in hist], "test": r["test"],
                "run_seconds": wall}
            log(f"{label}: run {wall:.1f} s, train loss "
                f"{[round(x['train_loss'], 4) for x in hist]}")
        file_launches = read_counts()
        check(sum(file_launches.values()) == 0, f"the file-backed runs launched {file_launches}")

    # each file-backed model's bf16 train step alone at the runs' shapes and batch
    # (a run's own fit throughput also counts validation, checkpoints and host syncs)
    gen = torch.Generator().manual_seed(6)
    frames = lambda hw, c: torch.rand(AUX_BATCH, hw, hw, c, generator=gen)
    actions = lambda: torch.randint(0, 9, (AUX_BATCH,), generator=gen)
    bf16 = torch.bfloat16
    for label, model, loss_fn, group, batch in (
            ("bc_aux", AuxNet(image_hw=AUX_IMG, dtype=bf16), losses.aux_loss_fn(), "imitation",
             ((frames(AUX_IMG, 4), torch.rand(AUX_BATCH, 3, generator=gen)),
              torch.randint(0, 2, (AUX_BATCH, 2), generator=gen, dtype=torch.int32))),
            ("bc_raw_segment", DualStreamCNN(dtype=bf16), losses.dual_stream_loss_fn,
             "imitation", (frames(AUX_IMG, 4), frames(AUX_IMG, 4), actions())),
            ("bc_augment", PolicyCNN(dtype=bf16), losses.bc_augmented_loss_fn(), "imitation",
             (frames(AUX_IMG, 4), actions())),
            ("vae", ConvVAE(dtype=bf16), losses.vae_loss_fn(0.75, 0.1), "vae",
             frames(224, 1))):
        res["file_runs"].setdefault(label, {})["train_step"] = time_train_step(
            label, model, loss_fn, group, batch, dev)

    # 3. one fp32 step on the card and on the CPU, each against float64
    gen = torch.Generator().manual_seed(5)
    n = AUX_CROSS_BATCH
    cross = {}
    cross["aux_seg"] = step_card_vs_cpu(
        "aux_seg_card_vs_cpu", losses.aux_seg_loss_fn(0.2, 0.2, 1.0, 0.5),
        ((torch.rand(n, HW, HW, 4, generator=gen), torch.rand(n, 3, generator=gen)),
         torch.randint(0, 2, (n, 2), generator=gen, dtype=torch.int32),
         torch.randint(0, 8, (n, HW, HW), generator=gen, dtype=torch.int32)),
        dev, require_clip=False,
        model_fn=lambda dtype: AuxNet(image_hw=HW, seg_classes=8, dtype=dtype))
    cross["dual_stream"] = step_card_vs_cpu(
        "dual_stream_card_vs_cpu", losses.dual_stream_loss_fn,
        (torch.rand(n, AUX_IMG, AUX_IMG, 4, generator=gen), torch.rand(n, AUX_IMG, AUX_IMG, 4, generator=gen),
         torch.randint(0, 9, (n,), generator=gen)),
        dev, require_clip=False, model_fn=lambda dtype: DualStreamCNN(dtype=dtype))
    eps = torch.randn(n, 32, generator=gen)
    vae_loss = losses.vae_loss_fn(0.75, 0.1)
    orig_draw = vae_mod.draw_noise
    vae_mod.draw_noise = lambda g, shape, device, dtype: eps.to(device, dtype)
    try:
        cross["vae"] = step_card_vs_cpu(
            "vae_card_vs_cpu", lambda m, b, g=None: vae_loss(m, b, torch.Generator()),
            torch.rand(n, 224, 224, 1, generator=gen), dev, require_clip=False,
            model_fn=lambda dtype: ConvVAE(dtype=dtype))
    finally:
        vae_mod.draw_noise = orig_draw
    x = torch.rand(n, AUX_IMG, AUX_IMG, 4, generator=gen)
    draws = augment.augment_draws(gen, x)
    cross["bc_augment"] = step_card_vs_cpu(
        "bc_augment_card_vs_cpu",
        lambda m, b, g=None: losses.bc_loss_fn(m, augment.augment_with(draws, *b)),
        (x, torch.randint(0, 9, (n,), generator=gen)), dev, require_clip=False)
    res["card_vs_cpu"] = {k: {key: v[key] for key in (
        "loss_rel_err_card", "loss_rel_err_cpu", "grad_max_rel_err_card",
        "grad_max_rel_err_cpu", "params_off_card", "params_off_cpu")} for k, v in cross.items()}
    res["seconds"] = time.perf_counter() - t_phase
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"aux_vae": res}))
    torch.cuda.empty_cache()
    return launches


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
    summary = device_summary(prof, wall, 8)
    summary["rich_fast_render"] = profile_rich_render(params, town)
    (out / "profile_summary.json").write_text(json.dumps(summary, indent=1))
    log(json.dumps({"profile": summary}))


def device_summary(prof, wall: float, steps: int) -> dict:
    """A torch.profiler window of ``steps`` rollout steps that took ``wall``
    seconds: device busy ms, idle share and launches, and the device time by
    group (kernel B, the policy's convolutions, sorts, the rest)."""
    import torch

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
    return {"steps": steps, "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_launches": len(kernels),
            "groups": {k: {"device_ms": v[0] / 1e3, "launches": v[1]}
                       for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])}}


def profile_route_rollout(params, town, rcfg, model, dev) -> dict:
    """A torch.profiler window of ROUTE_PROFILE_STEPS steps of the
    goal-directed rollout at ROUTE_ENVS with the CIL ``model`` driving
    (after ROUTE_PROFILE_WARM steps): ``device_summary`` and the host ms a
    step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from carla_imitation_learning_tpu_torch.training import closed_loop as cl

    init_fn, rollout_fn = cl.make_rollout(params, town, rcfg, model.as_policy_fn(), device=dev)
    carry = cl.assign_goals(init_fn(torch.Generator().manual_seed(50), ROUTE_ENVS),
                            np.arange(ROUTE_ENVS) % town.nav_goals.shape[0])
    carry, _ = rollout_fn(carry, ROUTE_PROFILE_WARM)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout_fn(carry, ROUTE_PROFILE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = device_summary(prof, wall, ROUTE_PROFILE_STEPS)
    out["host_ms_per_step"] = wall / ROUTE_PROFILE_STEPS * 1e3
    return out


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
