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
   (registers, spills, shared memory, resident blocks per SM); then ``cli
   doctor`` (``doctor_phase``: every probe in its own subprocess on the
   card, all green, ``cuda_kernels`` among them); then kernels A (flat and
   textured, C = 1 and 3), B, C and D bit for bit against their plain
   versions on the synthetic edge cases of ``edge_case_tables``;
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
   ``run collect_data`` at 256 envs × 24 steps (PNG log, state.csv and a
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
   1024 envs × SCENARIO_STEPS (25) steps, all
   eight scenarios (kernel B once per step of
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
   × 120 steps that records the class plane (kernel A every step, B for
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
6h. PPO, the safety shield, the LIDAR and the s2d stem (``rl_safety_phase``),
   counts reset just before ``run rl_finetune -o experiment=rl_finetune``
   through the CLI, warm-started from 6d's ``bc`` checkpoint: the preset's
   256 envs × 128 steps and 8 minibatches of 4096 windows, cut to 4 of its
   20 iterations and evaluated at 128 envs × 100 of its 300 steps (every
   PPO metric finite; kernel B launched exactly 1 + 4 × 128 + 2 × 101
   times), per iteration rollout and update seconds; one PPO minibatch step
   in fp32 on the card and on the CPU against float64, for both actors;
   ``run closed_loop_eval -o safety_shield=true`` at 256 × 100 from the
   same checkpoint (interventions > 0, the expert unshielded), the labels
   unchanged by the shield, and its mask on the card equal to the CPU's on
   8 envs × 16 steps; the 360-beam LIDAR channel at 1024 envs (marginal ms
   per step with and without; card vs CPU within 1e-5 relative); the s2d
   stem's forward against the standard stem at 1024 × 128² (fp32 within
   1e-4, bf16 within 2 % of the logits' scale, both timed);
6i. the sequence, world-model and ViT families (``seq_wm_phase``), counts
   reset just before each run: ``run bc_rnn``, ``world_model_imagine``
   (``world_model`` itself runs 12 times in 6l's sweep, MSE and MS-SSIM
   among them), ``dream_policy`` (discrete and
   continuous) and ``bc -o experiment=bc_vit`` with ``closed_loop_eval``
   of its checkpoint at 128² through the CLI at the presets' widths
   (epochs, batches per epoch, rollout depths and updates cut; kernel B
   launched exactly once per rollout step plus each rollout's first frame,
   no other kernel); one fp32 step of ``RecurrentPolicy`` and of the LSTM
   and GRU world models, one imagination update and the ViT's forward on
   the card and on the CPU against float64, ``RecurrentPolicy.step``
   against its sequence; each model's bf16 step alone, ms per imagination
   update, and the recurrent rollout's marginal env-steps/s at 1024 envs;
6j. the camera rig, surround view and the episode recorder
   (``rigs_replay_phase``): kernels A (C = 3) and B bit for bit against
   their plain versions on the fleet seen from FL, SR and RR, and a 3-view
   rollout on 8 envs on the card against the CPU; then, counts reset just
   before each run, ``run collect_multicamera`` (16 envs × RIG_COLLECT_STEPS
   (25) of its 200 steps, 6 views on the exact path: A 150 times), ``run
   bc_surround`` (16 × 300
   with forward, FL and FR, A 900 times; 2 epochs of at most 40 batches;
   its closed loop at 64 × 200 with the rig, B 603 times) and ``run
   replay`` (16 × 120: B 121 times recording, A 120 re-rendering; the
   replay exact, and the record replayed on the CPU allclose), each launch
   count exact; the surround rollout's marginal env-steps/s at 1024 envs
   with 3 views, the surround train step alone, and dynamics-only replay
   at 1024 envs;
6k. the serving tier (``serving_phase``), on 6d's checkpoint, counts reset
   just before it: ``run export_policy`` through the CLI at 128² (bf16,
   int8, fp32) and at the preset's 256², each artifact within 1e-4 of its
   live model; the fp32 and int8 artifacts on the CPU against the card
   (fp32 within 1e-4 with TF32 off, int8 bit for bit) and every GEMM of the
   int8 program int8 × int8 → int32; ``run closed_loop_eval -o artifact=``
   at 256 × 50 equal to ``--checkpoint``'s (B exactly 3 × 2 × 51 with the
   int8 artifact's run); the latency ladder (1 to 1024 at 128²) of the
   bf16 and int8 artifacts and the live model, the engine at request size
   100, HTTP with 8 clients × 40 batch-1 requests at windows of 0 and 2 ms
   (every answer the engine's action); a reference ConvNet1 checkpoint
   through ``import_torch`` and export at 256², within 1e-5 of the module;
6l. hyperparameter search (``hpo_phase``), counts reset just before each
   run: ``run hpo`` at its preset (4 trials, 256², batch 64) serially and 4
   at a time (trial configs equal, accuracies within rtol 1e-5), ``run
   hpo_vmap`` (4 rates in one ``torch.func.vmap``; one trial in fp32 held
   against itself trained alone on the card and on the CPU; the vmapped
   sweep against its trials one after another in bf16: wall, launches,
   idle share), ``run hpo_pbt`` (8 × 4 generations; every exploit/explore
   bit for bit card vs CPU and equal to the run's next generation) and
   ``run world_model_sweep`` (16 × 128 a trial, 4 at a time, cut to the
   latent sizes HPO_WM_Z, the image losses HPO_WM_LOSSES and HPO_WM_EPOCHS
   epochs of at most HPO_WM_BATCHES batches: no trial fails, every
   reconstruction loss falls, kernel B exactly 2 × 129);
6m. data parallelism (``mesh_phase``): (a) one NCCL rank on the card
   (torchrun's variables for a world of one) runs ``run bc -o
   mesh.enabled=true -o trainer.profiler=trace`` through the CLI at 128²
   and the imitation preset's batch of 64 for MESH_BC_BATCHES steps, each
   all-reducing its gradient bucket and its metrics over NCCL, and its
   trace must hold CUDA kernel events, the train steps and NCCL's
   all-reduce kernel; (b) two gloo ranks spawned once on cuda:0 (the
   backend named: NCCL refuses two ranks on one card) run one fp32 BC step
   at batch 64, an expert rollout of 256 envs × 50 steps (kernel B on each
   rank's 128 envs), one round of online DAgger at the preset's 64 envs
   and batch 128 (150 of its 300 steps, 20 of its 400 train steps), one PPO iteration
   at ``rl_finetune``'s 256 envs × 128 steps with an fp32
   ``ActorCriticCNN``, and a sharded engine batch of 128 frames of a bf16
   artifact, all held against the same work in one process with TF32 off
   and cuDNN's deterministic algorithms (online DAgger's and PPO's model
   run over the ranks' two halves of each batch there, ``_in_halves``):
   speeds at rtol 1e-5, actions, windows and labels equal, step metrics at
   rtol 2e-5, every step's loss, advantages and PPO metrics at rtol 1e-6,
   parameters after the whole round and iteration within rtol 1e-5 and
   equal on both ranks, the served logits bit for bit
   against the bucket's two halves, kernel B's launches exact on each rank
   (paths ``mesh``, ``mesh_online_dagger``, ``mesh_ppo``); a rank's failure
   fails the script; every phase's seconds are printed (``phase_seconds``);
6n. the seven harnesses of ``benchmarks_torch/`` that port the JAX
   package's diagnostic and ViT harnesses (``harnesses_phase``): first
   kernels A (C = 3) and B on ``vit_crossover``'s evaluation fleet at 256²
   (128 envs, T = 512), each bit for bit against its plain version and
   timed (two more ``kernels`` entries); then, counts reset, each harness
   in process at a smoke size through the function its ``main`` runs:
   ``sim_ablation`` (eight variants, 64 envs) and ``rollout_breakdown``
   (five components, 256 envs) on marginal pairs of 2 and 6 steps,
   ``crash_forensics`` (32 × 200 on the route world; mode counts summing to
   the collision events), ``expert_envelope`` (four stages at 64 × 20),
   ``reference_control`` (96 JPEG frames at 256², two spawned workers),
   ``vit_ab`` (both architectures at batch 64, 256²) and ``vit_crossover``
   (a 16 × 40 collection at 256², the CNN and both ViTs, four evaluations
   at 16 × 20); kernel B launched exactly once per rollout step plus each
   rollout's first frame, C once per ``render_only`` step (path
   ``harnesses``). To pay for it, the quad / vec A/B's long run, the
   synthetic log of ``file_io``'s ``bc`` and ``bc_rnn``'s collection were
   cut (AB_LONG, FILE_SYNTHETIC_FRAMES, SEQ_RNN_STEPS);
6o. the headline benchmark and the demo's camera (``bench_phase``): kernel
   A in RGB on the bench gate's one-env scene (seeds 0-2) bit for bit
   against its plain version and timed; the gate in this process; ``python
   -m carla_imitation_learning_tpu_torch.cli bench`` as a subprocess (exit
   0, its last line the headline's JSON with ``vs_baseline`` null, its four
   figures and the card line on stderr, its launch counts exact: path
   ``bench``); the demo GIF's drive (``docs/make_demo_gif_torch.py``),
   DEMO_FRAMES frames with counts reset (kernel A-tex once a frame: path
   ``demo``), and A-tex in RGB at its 2048 triangles bit for bit on its
   first frames and timed;
6p. the dry run and the compile check (``graft_entry_phase``): kernel B at
   32² with a 192-triangle table on the dry run's fleet bit for bit and
   timed; ``dryrun_multichip(2)`` on two gloo ranks on cuda:0 (every loss
   finite, rank 0's ok line, the env axis split, kernel B launched
   DRYRUN_B times on each rank: path ``graft_entry``); ``entry()``'s bf16
   logits on the card against the CPU within 5e-2;
7. the rich fleet (same town and envs, the rich128 preset: facade bands,
   markings, shadows, textures, T=1408) from three seeds: kernel A's
   textured variant (C=1 and C=3), kernel B on the rich lists (2 px and 0
   px LOD), kernel C (fused quads) and kernel D (grouped band tables) vs
   their plain versions, C vs B within the quad contract, D vs B bit for bit
   at 0 px; each timed at those shapes;
7b. kernels B, C and D with coarse shared band lists (``list_band_factor``
   2) on seed 0's rich frame: each bit for bit against its plain version
   and against its factor-1 frame, timed beside the factor-1 run, and
   listed in the ``kernels`` line;
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
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ENVS, HW, T = 1024, 128, 512
BENCH_TOWN = {"blocks": 3, "n_buildings": 24, "n_lights": 8}   # make_town's, bench.py's
T_RICH = 1408            # the rich128 preset's table
DEVICE = "cuda"
ROLLOUT_SHORT, ROLLOUT_LONG = 16, 96   # marginal rollout pair
ROLLOUT_REPEATS = 3      # marginal pairs; the median is reported
# the quad / vec A/B's marginal pair (the long run cut from 64 steps to make
# room for the harnesses phase)
AB_SHORT, AB_LONG = 16, 40
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
# the file phase's PNG log, its depth cut from 48 to make room for the entry
# points' phases (its gates are counts, files and checkpoints bit for bit)
FILE_COLLECT_ENVS, FILE_COLLECT_STEPS = 256, 24
FILE_EVAL_ENVS, FILE_EVAL_STEPS = 256, 50            # closed_loop_eval of its checkpoint
FILE_STREAM_ENVS, FILE_STREAM_STEPS = 1024, 24       # bc_streaming's collection
FILE_BATCH, FILE_EPOCHS, FILE_SHARD_FRAMES = 256, 2, 4096
# the README's first command, bc on an empty data_dir: its synthetic log cut
# from 1024 frames to make room for the harnesses phase (its gates are a
# checkpoint per camera and a finite loss)
FILE_SYNTHETIC_FRAMES = 512
# scenario_eval: every scenario, policy and expert; its depth cut from 50 to
# make room for the entry points' phases (its gates are finite metrics,
# counts and the expert driving)
SCENARIO_ENVS, SCENARIO_STEPS = 1024, 25
SCENARIO_CHANGE_STEPS = 100      # the direct turns / multilane run: the ego's turns need 80+
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
# the record_semantic collection, its depth cut from 200 to make room for the
# entry points' phases (its fit's gates: the loss falls, mIoU above the
# majority class share)
AUX_ENVS, AUX_STEPS = 256, 120
AUX_EVAL_ENVS, AUX_EVAL_STEPS = 256, 100
AUX_BATCH, AUX_EPOCHS = 64, 2
# each model's train step alone: warm-up steps, steps a run, runs, profiled steps
AUX_TIMED = (3, 20, 3, 5)
AUX_IMG = 256                                 # the file-backed runs' frames (the reference's)
AUX_FILE_FRAMES, AUX_FILE_EPOCHS = 640, 3     # the synthetic log of the file runs (a gate)
AUX_VAE_FRAMES = 120                          # per log, six logs at 224²
AUX_CROSS_BATCH = 8                           # the card-vs-CPU steps
# The rl_safety phase: ``run rl_finetune -o experiment=rl_finetune`` (256 envs ×
# 128 steps, 4 epochs × 8 minibatches) cut to 4 of its 20 iterations and to
# 100 of its 300 evaluation steps
RL_ENVS, RL_STEPS, RL_EPOCHS, RL_MINIBATCHES = 256, 128, 4, 8   # the preset's (a check)
RL_ITERATIONS, RL_EVAL_ENVS, RL_EVAL_STEPS = 4, 128, 100
RL_CROSS_ENVS, RL_CROSS_STEPS = 32, 8          # the card-vs-CPU PPO step: 256 windows
SHIELD_ENVS, SHIELD_STEPS = 256, 100           # closed_loop_eval -o safety_shield=true
SHIELD_CROSS_ENVS, SHIELD_CROSS_STEPS = 8, 16  # the shield's mask on the card vs the CPU
LIDAR_BEAMS, LIDAR_SHORT, LIDAR_LONG, LIDAR_REPEATS = 360, 8, 24, 3
LIDAR_CROSS_ENVS = 8
S2D_BATCH, S2D_REPS = 1024, 20                 # the s2d stem's forward at 1024 × 128²
# The seq_wm phase: the presets bc_rnn, world_model, world_model_imagine,
# dream_policy and bc_vit at their widths (envs, sizes, batches); epochs,
# batches per epoch, rollout depths and updates cut
SEQ_EPOCHS, SEQ_BATCHES = 2, 40                # every fit (presets: 50 epochs; dream_policy 10)
# bc_rnn's collection and eval (preset 300, 200; the collection cut from 150
# to make room for the harnesses phase)
SEQ_RNN_STEPS, SEQ_RNN_EVAL_STEPS = 100, 100
# bc_vit: an expert log of SEQ_VIT_ENVS × SEQ_VIT_STEPS at 128² on disk, a fit
# of SEQ_VIT_EPOCHS epochs of at most SEQ_BATCHES batches of SEQ_VIT_BATCH,
# evaluations of the trained and the untrained ViT at 64 × SEQ_VIT_EVAL_STEPS
# (the preset's 64 envs; 100 of its 200 steps)
SEQ_VIT_ENVS, SEQ_VIT_STEPS, SEQ_VIT_EVAL_STEPS = 64, 100, 100
SEQ_VIT_EPOCHS, SEQ_VIT_BATCH = 6, 128
# dream_policy's depth, cut from 100, 50, 75 (and 100, 50, 50 for the
# continuous run) to make room for the doctor and the mesh phase's online
# DAgger, PPO and serving: its gates are finite metrics and scores
SEQ_DREAM_STEPS, SEQ_DREAM_UPDATES, SEQ_DREAM_EVAL_STEPS = 60, 25, 40   # (preset 200, 300, 150)
SEQ_CONT_STEPS, SEQ_CONT_UPDATES, SEQ_CONT_EVAL_STEPS = 60, 25, 30   # continuous dream_policy
SEQ_ROLL_SHORT, SEQ_ROLL_LONG, SEQ_ROLL_REPEATS = 16, 32, 3   # the recurrent rollout's rate
# each train step and the imagination update alone, as AUX_TIMED
SEQ_TIMED = (3, 10, 3, 5)        # runs cut from 20 steps to 10 likewise
SEQ_CROSS_BATCH = 2                            # card-vs-CPU steps: sequences of 8 at 128²
# The rigs_replay phase: collect_multicamera, bc_surround and replay at their
# presets' widths through the CLI (bc_surround's fit cut to RIG_EPOCHS
# epochs of at most RIG_BATCHES batches), then the surround rollout
RIG_CAMERAS = ("camera", "FL", "FR")           # bc_surround's rig
RIG_CHECK_CAMERAS = ("FL", "SR", "RR")         # A and B vs plain from these views
RIG_EPOCHS, RIG_BATCHES = 2, 40
RIG_ROLL_SHORT, RIG_ROLL_LONG, RIG_ROLL_REPEATS = 16, 64, 3   # surround rollout, replay
# collect_multicamera's depth (preset 16 × 200), cut from 100 to make room
# for the doctor and the mesh phase's online DAgger, PPO and serving, and
# from 50 for the entry points' phases: its gates are counts of frames,
# files and launches
RIG_COLLECT_STEPS = 25
# The serving phase: export_policy through the CLI (128² and the preset's
# 256²), closed_loop_eval of an artifact, the latency ladder, the engine and HTTP
SERVE_EVAL_ENVS, SERVE_EVAL_STEPS = 256, 50
SERVE_LADDER, SERVE_REPS = (1, 4, 16, 64, 256, 1024), 10
SERVE_ENGINE_REQUEST = 100                     # pads to the 128 bucket
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_WINDOWS = 8, 40, (0.0, 2.0)
# The hpo phase: hpo (4 trials, 256², batch 64) serially and 4 at a time,
# hpo_vmap (4 rates × 2 epochs), hpo_pbt (8 members × 4 generations) and
# world_model_sweep (trials of 16 envs × 128 steps, 4 at a time) at their
# presets through the CLI. The sweep is cut to fit the phase in about 90 s
# on an H100, where 4 trials at a time run about 3 times slower than one at
# a time (12 trials at 2 epochs of 20 batches took 139 s, 8 at 2 × 10 took
# 112-115 s): each fit from the vae group's 50 epochs to HPO_WM_EPOCHS
# epochs of at most HPO_WM_BATCHES batches, then the grid's latent sizes to
# HPO_WM_Z (both RNNs and both image losses kept: 4 of the 12 trials), then,
# to make room for the doctor and the mesh phase's online DAgger, PPO and
# serving, to the image loss HPO_WM_LOSSES (the seq_wm phase's world models
# train with MSE): 2 trials, LSTM and GRU
HPO_WM_EPOCHS, HPO_WM_BATCHES = 2, 6     # cut from 10 batches likewise
HPO_WM_Z = (64,)
HPO_WM_LOSSES = ("ms_ssim",)
HPO_CROSS_TRIAL = 0      # the vmapped trial held against itself alone and the CPU
# The mesh phase: a 1-rank NCCL ``run bc -o mesh.enabled=true`` (a synthetic
# 128² log, the imitation preset's batch of 64, MESH_BC_BATCHES batches), then
# two gloo ranks on cuda:0 against one process: one fp32 BC step at batch 64
# and an expert rollout of MESH_ENVS × MESH_STEPS (kernel B on each rank's rows)
MESH_BC_FRAMES, MESH_BC_BATCHES = 512, 4
MESH_BATCH, MESH_ENVS, MESH_STEPS = 64, 256, 50
# ... and on the same two ranks against one process: one round of online
# DAgger at the dagger_online preset's widths (64 envs, batch 128), cut to
# MESH_OD_STEPS of its 300 steps (from 300, to make room for the entry
# points' phases) and MESH_OD_TRAIN of its 400 train steps, one PPO iteration at
# rl_finetune's (256 envs × 128 steps, 4 epochs × 8 minibatches), and one
# sharded engine batch of a bf16 PolicyCNN artifact at 128²
MESH_OD_ENVS, MESH_OD_STEPS, MESH_OD_BATCH, MESH_OD_TRAIN = 64, 150, 128, 20
MESH_PPO_ENVS, MESH_PPO_STEPS, MESH_PPO_LR = 256, 128, 3e-4
MESH_SERVE_BATCH = 128
# The harnesses phase: the seven harnesses of benchmarks_torch/ that port the
# JAX package's diagnostic and ViT harnesses, in process at a smoke size
HARN_PAIR = (2, 6)              # rollout_breakdown's and sim_ablation's marginal pair, once
HARN_BREAKDOWN_ENVS = 256
HARN_SIM_ENVS = 64
HARN_CRASH = (32, 200)          # crash_forensics: envs × steps on the route world
HARN_ENVELOPE = (64, 20)        # expert_envelope: envs × steps a stage
HARN_REFERENCE = (96, 16, 2)    # reference_control: 256² JPEG frames, batch, workers
HARN_VIT_BATCH = 64             # vit_ab at 256², chains of 2 and 6 steps
HARN_VC_HW = 256                # vit_crossover's camera, and its evaluation fleet's
HARN_VC = (16, 20, 16, 40, 2, 32)   # its envs, steps, collect envs and steps, epochs, batch
HARN_KERNEL_ENVS = 128          # its evaluation fleet's width (kernels A, C = 3, and B)
HARN_VC_EVAL_SEED = 100         # the generator of its expert evaluation's fleet
# The entry points' phases: ``cli bench`` in a subprocess (its full protocol),
# the demo GIF's drive, and ``graft_entry``'s dry run on two gloo ranks
BENCH_TIMEOUT = 600      # s, cli bench's subprocess
DEMO_FRAMES = 8          # the demo's drive rendered with counts reset (kernel A-tex, C = 3)
DEMO_CHECK_FRAMES = 3    # its first frames, each held bit for bit against the plain version
DEMO_T = 2048            # the demo's triangle table
DRYRUN_RANKS = 2
DRYRUN_HW, DRYRUN_T, DRYRUN_ENVS = 32, 192, 4     # the dry run's fleet: 2 envs a rank
# kernel B on a rank of the dry run: the sharded fleet (first frame + 2 steps), the
# goal-directed one (likewise), PPO (first frame + 4) and online DAgger (first
# frame + 2 rounds × 6 steps)
DRYRUN_B = 2 * (1 + 2) + (1 + 4) + (1 + 2 * 6)
DOCTOR_TIMEOUT = 300     # cli doctor's per-probe bound (s)
HPO_TIMED_REPEATS = 3    # vmapped sweep vs its trials one after another: median of 3
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
    from carla_imitation_learning_tpu_torch.device import card_line

    return card_line()


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


def band_factor_kernels(params, town, dev, rows, rate, facts) -> list:
    """Phase 7b: kernels B, C and D with coarse shared band lists
    (``list_band_factor`` 2: one list over every two bands, render band r
    reading list row r // 2) on the rich fleet's seed-0 frame at 2 px LOD:
    each bit for bit against its plain version and against its own frame
    from the per-band lists, and timed beside that factor-1 run. Bounds
    count the pairs of the coarse lists that each band walks (its list row's
    entries in its own warp tiles). → their entries of the ``kernels``
    line."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.render.pipeline import make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    rich = rich_config(rgb=False, fast=True, quads=True)
    states = reset_env(params, town, torch.Generator().manual_seed(0), N_ENVS)
    s_q = make_scene_setup(params, town, rich, device=dev)(states)
    near, far = rich.near, rich.far
    a1 = fast_args(s_q, T_RICH, near, far, rows)
    a2 = fast_args(s_q, T_RICH, near, far, rows, factor=2)
    runs = {"B": (rf.fast_bands, rf.fast_bands_plain, a1, a2),
            "C": (rf.prim_bands, rf.prim_bands_plain, prim_args(s_q, T_RICH, near, far, rows),
                  prim_args(s_q, T_RICH, near, far, rows, factor=2)),
            "D": (rf.vec_bands, rf.vec_bands_plain, vec_args(a1), vec_args(a2))}
    del s_q
    lrow = torch.arange(HW // rows, device=dev) // 2     # each band's list row
    frame_px = N_ENVS * HW * HW
    spec = {"B": ("raster_fast (kernel B, list_band_factor 2)", "raster_fast.cu",
                  "carla_imitation_learning_tpu/ops/raster_fast.py:400", "main",
                  OPS_PER_PASS_B, 2, FAST_ENTRY_BYTES, 3),
            "C": ("raster_prim (kernel C, list_band_factor 2)", "raster_prim.cu",
                  "carla_imitation_learning_tpu/ops/raster_fast.py:265", "quad_vec_ab",
                  OPS_PER_PASS_C, 2, PRIM_ENTRY_BYTES, 4),
            "D": ("raster_vec (kernel D, list_band_factor 2)", "raster_vec.cu",
                  "carla_imitation_learning_tpu/ops/raster_fast.py:341", "quad_vec_ab",
                  OPS_PER_PASS_D, rf.VEC_P, VEC_ENTRY_BYTES, 3)}
    entries, report = [], {}
    for k, (fn, plain, args1, args2) in runs.items():
        out1, out2 = fn(*args1), fn(*args2)
        want2 = plain(*args2)
        err = float((out2 - want2).abs().max())
        check(torch.equal(out2, want2), f"kernel {k} at list_band_factor 2: max|d| vs plain "
                                        f"{err:.3e}")
        check(torch.equal(out2, out1), f"kernel {k} at list_band_factor 2: "
                                       f"{int((out2 != out1).sum())} pixels differ from factor 1")
        del out1, out2, want2
        name, src, replaces, path, ops_pass, group, entry_bytes, edges = spec[k]
        cnt2 = args2[1] if k == "D" else args2[2]
        cnt_band = cnt2[:, lrow]                         # what each band walks
        if k == "D":    # D walks B's coarse lists in whole groups
            tbl_b, idx_b = a2[0], a2[1][:, lrow]
        else:
            tbl_b, idx_b = args2[0], args2[1][:, lrow]
        tiles, kept = warp_tile_pairs(tbl_b, idx_b, cnt_band, HW, HW, rows, exact=False,
                                      edges=edges, group=group)
        k_wide = args2[0].shape[2] if k == "D" else args2[1].shape[2]
        ms_1 = cuda_ms(lambda: fn(*args1), reps=20)
        entries.append(kernel_entry(
            name, k, src, replaces, fn, plain, args2, err, rate,
            ops=kept * ops_pass + frame_px * OPS_PER_PIXEL_EPILOGUE_B,
            band_list_ops=listed(cnt_band, rows) * ops_pass,
            table_bytes=walked_bytes(cnt_band, group, k_wide, entry_bytes),
            out_bytes=frame_px * 4, path=path, rows=rows, count=cnt_band,
            warp_tile_pairs=tiles, kept_pairs=kept, list_band_factor=2, ms_factor_1=ms_1,
            list_rows=int(cnt2.shape[1]), **facts[k]))
        report[k] = {"ms": entries[-1]["ms"], "ms_factor_1": ms_1,
                     "walked_per_band": float(cnt_band.float().mean())}
        del args1, args2, cnt2, cnt_band, idx_b
        runs[k] = None
        torch.cuda.empty_cache()
    log(json.dumps({"band_factor": report}))
    return entries


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_shape(artifact: str | None = None) -> dict:
    """The sizes of phase 6m's work, handed to its spawned ranks, and the
    bf16 artifact that part (b) serves."""
    return {"hw": HW, "t": T, "batch": MESH_BATCH, "envs": MESH_ENVS, "steps": MESH_STEPS,
            "town": BENCH_TOWN, "od": (MESH_OD_ENVS, MESH_OD_STEPS, MESH_OD_BATCH,
                                       MESH_OD_TRAIN),
            "ppo": (MESH_PPO_ENVS, MESH_PPO_STEPS, MESH_PPO_LR),
            "serve_batch": MESH_SERVE_BATCH, "artifact": artifact}


def _flat_params(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()


def _flat_grads(a, k, out):
    """``Capture`` record of ``clip_by_global_norm_``: the step's gradient
    (reduced over the mesh, then clipped) flat on the host."""
    import torch

    return torch.cat([g.reshape(-1) for g in a[0]]).cpu()


def _in_halves(model):
    """``model`` (on the card) with every forward run as a mesh of two runs
    it: over the first and the second half of the batch apart, the outputs
    joined. The parameters stay ``model``'s, so a gradient is the sum of
    the halves' gradients, as the mesh's all-reduce sums the ranks'. The
    one-process reference of phase 6m's part (b): a forward of the whole
    batch rounds apart from its halves in the last bit (the kernels block
    by batch size), and Adam turns a last-bit difference of a gradient
    within rounding of zero into part of a step."""
    import torch

    whole = model.forward

    def join(a, b):
        if isinstance(a, torch.Tensor):
            return torch.cat([a, b])
        return type(a)(join(x, y) for x, y in zip(a, b))

    def forward(*args):
        n = args[0].shape[0]
        a, b = (whole(*(x[s].clone() for x in args))
                for s in (slice(0, n // 2), slice(n // 2, n)))
        return join(a, b)

    model.forward = forward
    return model


def _normalize_in_halves(adv, mesh=None):
    """``rl.normalize_advantages`` as a mesh of two computes it: the sums
    and the sums of squared deviations of the two halves of the fleet's
    columns, each half contiguous as on its rank, added."""
    import torch

    a, b = (h.contiguous() for h in adv.chunk(2, dim=1))
    n = adv.numel()
    mean = (a.sum() + b.sum()).reshape(1) / n
    var = (((a - mean) ** 2).sum() + ((b - mean) ** 2).sum()).reshape(1) / n
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def mesh_online_dagger(mesh, dev, shape: dict) -> dict:
    """One round of ``make_online_dagger`` (β = 0: the expert drives round
    0) at ``shape["od"]``'s envs, steps, batch and train steps on the bench
    town, fp32 ``PolicyCNN`` from a seed → per-round metrics, every train
    step's (labels, weights, the integer pixel sum of each window) of this
    rank's rows, the final parameters and kernel B's launches. Without a
    mesh the model runs ``_in_halves``."""
    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import online_dagger as od
    from carla_imitation_learning_tpu_torch.training import steps
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer,
    )

    n_envs, n_steps, batch, train_steps = shape["od"]
    state = create_train_state(PolicyCNN(dtype=torch.float32), make_optimizer(
        {"LEARNING_RATE": BC_LR, "gradient_clip_val": BC_CLIP}, 1),
        generator=torch.Generator().manual_seed(3), device=dev)
    if mesh is None:
        _in_halves(state.model)
    run = od.make_online_dagger(PolicyCNN.__call__, SimParams(n_agents=15),
                                make_town(**shape["town"]),
                                RenderConfig(height=shape["hw"], width=shape["hw"],
                                             max_triangles=shape["t"]),
                                n_envs=n_envs, n_steps=n_steps, rounds=1,
                                train_steps=train_steps, batch=batch, beta=0.0, mesh=mesh,
                                device=dev)

    def windows(a, k, out):
        obs, y, w = out[:3]
        pix = (obs * 255.0).round().to(torch.int64).sum(dim=(1, 2, 3))
        return torch.stack([y.to(torch.int64), w.to(torch.int64), pix]).cpu()

    reset_counts()
    t0 = time.perf_counter()
    with Capture(od, "gather_windows_at", windows) as seen, \
            Capture(od, "masked_cross_entropy", lambda a, k, out: float(out.detach())) as losses, \
            Capture(steps, "clip_by_global_norm_", _flat_grads) as grads:
        state, metrics = run(state, torch.Generator().manual_seed(4))
    return {"metrics": {k: v.tolist() for k, v in metrics.items()},
            "windows": torch.stack(seen.calls), "losses": losses.calls,
            "grad": grads.calls[0], "params": _flat_params(state.model),
            "launches": read_counts(), "seconds": time.perf_counter() - t0}


def mesh_ppo(mesh, dev, shape: dict) -> dict:
    """One ``ppo_train`` iteration at ``shape["ppo"]``'s envs and steps
    (PPOConfig's 4 epochs × 8 minibatches, the preset's rate) with an fp32
    ``ActorCriticCNN`` from a seed on the bench town → the rollout's actions
    and the normalised advantages (this rank's columns), the history, the
    parameters and kernel B's launches. Without a mesh the model runs
    ``_in_halves`` and the advantages ``_normalize_in_halves``."""
    import torch

    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import rl, steps
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, flax_init_,
    )

    n_envs, n_steps, lr = shape["ppo"]
    model = flax_init_(rl.ActorCriticCNN(dtype=torch.float32), torch.Generator().manual_seed(5))
    cfg = rl.PPOConfig(learning_rate=lr)
    state = create_train_state(model, AdamConfig(schedule=lambda c: cfg.learning_rate,
                                                 clip=cfg.max_grad_norm), device=dev)
    normalize = rl.normalize_advantages
    if mesh is None:
        _in_halves(state.model)
        rl.normalize_advantages = _normalize_in_halves
    reset_counts()
    t0 = time.perf_counter()
    try:
        with Capture(rl, "reward_from_traj", lambda a, k, out: a[0]["action"].cpu()) as actions, \
                Capture(rl, "normalize_advantages", lambda a, k, out: out.cpu()) as adv, \
                Capture(steps, "clip_by_global_norm_", _flat_grads) as grads:
            state, history = rl.ppo_train(
                SimParams(n_agents=15), make_town(**shape["town"]),
                RenderConfig(height=shape["hw"], width=shape["hw"], max_triangles=shape["t"]),
                state, torch.Generator().manual_seed(6), n_envs=n_envs, rollout_steps=n_steps,
                iterations=1, cfg=cfg, device=dev, mesh=mesh)
    finally:
        rl.normalize_advantages = normalize
    return {"actions": actions.calls[0], "adv": adv.calls[0], "history": history,
            "grad": grads.calls[0], "params": _flat_params(state.model),
            "launches": read_counts(), "seconds": time.perf_counter() - t0}


def mesh_serving(mesh, dev, shape: dict) -> dict:
    """One engine batch of ``shape["serve_batch"]`` seeded frames of the
    bf16 artifact: sharded over ``mesh`` (rank 0 serves and stops, rank 1
    follows), or whole in one process beside the two halves of the bucket
    run one after the other (what each rank runs) → logits."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.serving import InferenceEngine, load_policy

    policy = load_policy(shape["artifact"], dev)
    hw, n = shape["hw"], shape["serve_batch"]
    frames = np.random.default_rng(7).integers(0, 256, (n, hw, hw, 4), dtype=np.uint8)
    t0 = time.perf_counter()
    if mesh is None:
        whole = InferenceEngine(policy, max_batch=n, device=dev).infer_logits(frames)
        with torch.inference_mode():
            halves = torch.cat([policy(torch.from_numpy(f).to(dev)).float().cpu()
                                for f in np.split(frames, 2)]).numpy()
        return {"logits": whole, "halves": halves, "seconds": time.perf_counter() - t0}
    engine = InferenceEngine(policy, max_batch=n, mesh=mesh, device=dev)
    if mesh.rank() != 0:
        engine.follow()
        return {"seconds": time.perf_counter() - t0}
    logits = engine.infer_logits(frames)
    engine.stop()
    return {"logits": logits, "buckets": engine.buckets, "seconds": time.perf_counter() - t0}


def mesh_work(mesh, dev, shape: dict) -> dict:
    """Phase 6m's work, sharded over ``mesh`` or (None) whole in this
    process: one fp32 BC step of ``PolicyCNN`` at a batch of ``shape
    ["batch"]`` frames of ``shape["hw"]``² (a rank takes its rows, the
    state replicated), an expert rollout of ``shape["envs"]`` ×
    ``shape["steps"]`` on the bench town (a rank steps and renders its rows
    with kernel B), then ``mesh_online_dagger``, ``mesh_ppo`` and
    ``mesh_serving``. Inputs from fixed seeds; TF32 is the caller's."""
    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.parallel.mesh import shard_batch, shard_train_state
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer, make_train_step,
    )

    hw = shape["hw"]
    state = create_train_state(PolicyCNN(dtype=torch.float32), make_optimizer(
        {"LEARNING_RATE": BC_LR, "gradient_clip_val": BC_CLIP}, 1),
        generator=torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    batch = (torch.rand((shape["batch"], hw, hw, 4), generator=gen).to(dev),
             torch.randint(0, 9, (shape["batch"],), generator=gen).to(dev))
    if mesh is not None:
        state, batch = shard_train_state(mesh, state), shard_batch(mesh, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = make_train_step(bc_loss_fn)(state, batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    step_s = time.perf_counter() - t0
    params = _flat_params(state.model)
    rcfg = RenderConfig(height=hw, width=hw, max_triangles=shape["t"])
    init_fn, rollout_fn = make_rollout(SimParams(n_agents=15), make_town(**shape["town"]),
                                       rcfg, None, device=dev, mesh=mesh)
    reset_counts()
    t0 = time.perf_counter()
    _, traj = rollout_fn(init_fn(torch.Generator().manual_seed(2), shape["envs"]),
                         shape["steps"])
    speed, action = traj["speed"].cpu(), traj["action"].cpu()
    out = {"metrics": metrics, "params": params, "speed": speed, "action": action,
           "launches": read_counts(), "step_s": step_s,
           "rollout_s": time.perf_counter() - t0}
    del traj
    out["online_dagger"] = mesh_online_dagger(mesh, dev, shape)
    out["ppo"] = mesh_ppo(mesh, dev, shape)
    out["serving"] = mesh_serving(mesh, dev, shape)
    return out


def mesh_rank(rank: int, port: int, out_dir: str, device: str, shape: dict) -> None:
    """One of phase 6m's two gloo ranks on ``device`` (cuda:0 for both: NCCL
    will not put two ranks on one card): ``mesh_work`` over a ``data`` mesh
    of two, with TF32 off and cuDNN's deterministic algorithms; its result
    saved for the parent."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh, multihost_initialize

    multihost_initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                         process_id=rank, backend="gloo", device=device)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        mesh = make_mesh(axis_sizes={"data": 2}, devices=device)
        torch.save(mesh_work(mesh, mesh.device, shape), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _close(got: float, want: float, rtol: float, atol: float) -> bool:
    return abs(got - want) <= atol + rtol * abs(want)


def _trace_checks(trace_dir: Path) -> dict:
    """The torch.profiler trace that part (a)'s ``run bc`` wrote: its CUDA
    kernel events, its train steps and NCCL's all-reduce among them (the
    process group's ``nccl:all_reduce`` op; a world of one launches no
    NCCL kernel for it, so a kernel of that name counts where there is
    one)."""
    files = sorted(trace_dir.rglob("*.pt.trace.json"))
    check(len(files) == 1, f"mesh (a): {len(files)} trace files under {trace_dir}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in events if "nccl" in e.get("name", "").lower()
            and "allreduce" in e.get("name", "").lower().replace("_", "")]
    # the host's spans (the card's timeline repeats them as gpu_user_annotation)
    steps = [e for e in events if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]
    check(kernels, "mesh (a): the trace holds no CUDA kernel event")
    check(nccl, "mesh (a): the trace holds no NCCL all-reduce")
    check(len(steps) == MESH_BC_BATCHES, f"mesh (a): {len(steps)} train_step spans traced")
    return {"events": len(events), "kernel_events": len(kernels),
            "nccl_allreduce_events": len(nccl), "train_steps": len(steps),
            "nccl_names": sorted({e["name"][:80] for e in nccl}),
            "nccl_cats": sorted({str(e.get("cat")) for e in nccl}),
            "bytes": files[0].stat().st_size}


def _rel(a, b) -> float:
    """max |a − b| / max |b| of two tensors (0 for equal ones)."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale else float((a - b).abs().max())


def _mesh_od_checks(ranks: list, whole: dict, gate) -> dict:
    """Part (b)'s online DAgger round on two ranks against one process that
    runs the ranks' halves (``_in_halves``): windows, labels and weights
    equal (each rank's rows joined), agreement and valid_frac equal, every
    step's loss (the ranks' terms summed) and the round's loss rtol 1e-6,
    the first step's reduced gradient within 1e-5 of its largest element,
    the parameters after the round rtol 1e-5 / atol 1e-6 (the CPU test's),
    equal on both ranks; kernel B MESH_OD_STEPS + 1 times on each rank and
    in one process."""
    import torch

    r_od = [r["online_dagger"] for r in ranks]
    w_od = whole["online_dagger"]
    joined = torch.cat([r["windows"] for r in r_od], dim=2)
    gate(torch.equal(joined, w_od["windows"]),
         "mesh (b) online DAgger: windows, labels or weights differ from one process")
    for r in r_od:
        gate(r["metrics"]["agreement"] == w_od["metrics"]["agreement"] == [1.0],
             f"mesh (b) online DAgger: agreement {r['metrics']['agreement']}")
        gate(r["metrics"]["valid_frac"] == w_od["metrics"]["valid_frac"],
             "mesh (b) online DAgger: valid_frac differs")
        gate(r["launches"]["B"] == MESH_OD_STEPS + 1,
             f"mesh (b) online DAgger: kernel B launched {r['launches']['B']} times on a rank")
    losses = torch.tensor([sum(x) for x in zip(*(r["losses"] for r in r_od))], dtype=torch.float64)
    w_losses = torch.tensor(w_od["losses"], dtype=torch.float64)
    step_rel = ((losses - w_losses).abs() / w_losses.abs()).tolist()
    gate(len(step_rel) == MESH_OD_TRAIN and max(step_rel) <= 1e-6,
         f"mesh (b) online DAgger: step losses rel diff up to {max(step_rel):.3e}")
    got, want = r_od[0]["metrics"]["loss"][0], w_od["metrics"]["loss"][0]
    gate(_close(got, want, 1e-6, 0.0), f"mesh (b) online DAgger: loss {got} vs {want}")
    g_rel = _rel(r_od[0]["grad"], w_od["grad"])
    gate(g_rel <= 1e-5, f"mesh (b) online DAgger: first gradient max|d| {g_rel:.3e} of its max")
    d_par = float((r_od[0]["params"] - w_od["params"]).abs().max())
    gate(bool(torch.allclose(r_od[0]["params"], w_od["params"], rtol=1e-5, atol=1e-6)),
         f"mesh (b) online DAgger: parameters max|d| {d_par:.3e} from one process")
    gate(torch.equal(r_od[0]["params"], r_od[1]["params"]) and torch.equal(
        r_od[0]["grad"], r_od[1]["grad"]), "mesh (b) online DAgger: the ranks differ")
    gate(w_od["launches"]["B"] == MESH_OD_STEPS + 1, "mesh (b) online DAgger: B launches whole")
    return {"loss": r_od[0]["metrics"]["loss"], "one_process_loss": w_od["metrics"]["loss"],
            "valid_frac": r_od[0]["metrics"]["valid_frac"], "step_loss_rel_diff": step_rel,
            "first_grad_rel_diff": g_rel, "max_param_diff": d_par,
            "params_equal": torch.equal(r_od[0]["params"], w_od["params"]),
            "windows": int(joined.shape[0] * joined.shape[2]),
            "seconds": [r["seconds"] for r in r_od], "one_process_seconds": w_od["seconds"]}


def _mesh_ppo_checks(ranks: list, whole: dict, gate) -> dict:
    """Part (b)'s PPO iteration on two ranks against one process that runs
    the ranks' halves (``_in_halves``, ``_normalize_in_halves``): the
    rollout's actions equal, normalised advantages rtol 1e-6 / atol 1e-6,
    the first minibatch's reduced gradient within 1e-5 of its largest
    element, every metric of the iteration rtol 1e-6 / atol 1e-6 and the
    parameters after its 32 steps rtol 1e-5 / atol 1e-6 (the CPU test's),
    both equal on the two ranks and finite; kernel B MESH_PPO_STEPS + 1
    times on each rank and in one process."""
    import math

    import torch

    r_ppo = [r["ppo"] for r in ranks]
    w_ppo = whole["ppo"]
    gate(torch.equal(torch.cat([r["actions"] for r in r_ppo], dim=1), w_ppo["actions"]),
         "mesh (b) PPO: the rollout's actions differ from one process")
    adv = torch.cat([r["adv"] for r in r_ppo], dim=1)
    d_adv = float((adv - w_ppo["adv"]).abs().max())
    gate(bool(torch.allclose(adv, w_ppo["adv"], rtol=1e-6, atol=1e-6)),
         f"mesh (b) PPO: advantages max|d| {d_adv:.3e} from one process")
    g_rel = _rel(r_ppo[0]["grad"], w_ppo["grad"])
    gate(g_rel <= 1e-5, f"mesh (b) PPO: first gradient max|d| {g_rel:.3e} of its max")
    want = w_ppo["history"][0]
    got = r_ppo[0]["history"][0]
    untimed = [k for k in want if "seconds" not in k and "per_sec" not in k]
    gate(all(r_ppo[1]["history"][0][k] == got[k] and math.isfinite(got[k]) for k in untimed),
         "mesh (b) PPO: the ranks' metrics differ or are not finite")
    off = [k for k in untimed if not _close(got[k], want[k], 1e-6, 1e-6)]
    gate(not off, f"mesh (b) PPO: metrics {off} differ from one process")
    d_par = float((r_ppo[0]["params"] - w_ppo["params"]).abs().max())
    gate(bool(torch.allclose(r_ppo[0]["params"], w_ppo["params"], rtol=1e-5, atol=1e-6)),
         f"mesh (b) PPO: parameters max|d| {d_par:.3e} from one process")
    gate(torch.equal(r_ppo[0]["params"], r_ppo[1]["params"]),
         "mesh (b) PPO: the ranks' parameters differ")
    for r in r_ppo + [w_ppo]:
        gate(r["launches"]["B"] == MESH_PPO_STEPS + 1,
             f"mesh (b) PPO: kernel B launched {r['launches']['B']} times")
    return {"max_adv_diff": d_adv, "first_grad_rel_diff": g_rel, "max_param_diff": d_par,
            "params_equal": torch.equal(r_ppo[0]["params"], w_ppo["params"]),
            "metric_rel_diff": {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                                for k in untimed},
            "metrics": got, "one_process_metrics": want}


def _split_witness(dev) -> dict:
    """Why part (b)'s reference runs the halves: one fp32 ``PolicyCNN``
    gradient of a seeded batch of MESH_OD_BATCH 128² windows, whole and as
    ``_in_halves`` runs it, in this process with TF32 off, with cuDNN's
    deterministic algorithms and without → the gradients' largest gap as
    a share of their largest element."""
    import torch
    import torch.nn.functional as F

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.steps import flax_init_

    gen = torch.Generator().manual_seed(12)
    x = torch.rand((MESH_OD_BATCH, HW, HW, 4), generator=gen).to(dev)
    y = torch.randint(0, 9, (MESH_OD_BATCH,), generator=gen).to(dev)
    model = flax_init_(PolicyCNN(dtype=torch.float32), torch.Generator().manual_seed(3)).to(dev)

    def grad(m):
        m.zero_grad(set_to_none=True)
        F.cross_entropy(m(x), y).backward()
        return torch.cat([p.grad.reshape(-1) for p in m.parameters()])

    det = torch.backends.cudnn.deterministic
    out = {}
    try:
        for flag in (False, True):
            torch.backends.cudnn.deterministic = flag
            full = grad(model)
            halves = grad(_in_halves(model))
            del model.forward                       # the whole forward again
            again = grad(_in_halves(model))
            del model.forward
            key = "deterministic" if flag else "default"
            out[key] = {"whole_vs_halves": _rel(halves, full),
                        "halves_vs_halves": _rel(again, halves)}
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def _mesh_serving_checks(ranks: list, whole: dict, gate) -> dict:
    """Part (b)'s sharded engine batch against one process: the ladder in
    multiples of 2; rank 0's logits equal, bit for bit, the two halves of
    the bucket run one after the other in one process (what each rank
    runs); against the whole bucket in one call (another batch size, so
    cuDNN may pick another algorithm) the argmax of at least 99 % of the
    rows equal and the logits within 2 % of their scale (bf16)."""
    import numpy as np

    got = ranks[0]["serving"]["logits"]
    w = whole["serving"]
    gate(all(b % 2 == 0 for b in ranks[0]["serving"]["buckets"]),
         f"mesh (b) serving: ladder {ranks[0]['serving']['buckets']}")
    gate(got.shape == (MESH_SERVE_BATCH, 9) and np.array_equal(got, w["halves"]),
         f"mesh (b) serving: sharded logits differ from the halves, max|d| "
         f"{float(np.abs(got - w['halves']).max()):.3e}")
    agree = float((got.argmax(-1) == w["logits"].argmax(-1)).mean())
    scale = float(np.abs(w["logits"]).max())
    d_whole = float(np.abs(got - w["logits"]).max())
    gate(agree >= 0.99 and d_whole <= 0.02 * scale,
         f"mesh (b) serving: argmax agreement {agree}, max|d| {d_whole:.3e} (scale {scale:.3f})")
    return {"argmax_agreement_whole": agree, "max_diff_whole": d_whole, "scale": scale,
            "seconds": [r["serving"]["seconds"] for r in ranks],
            "one_process_seconds": w["seconds"]}


def mesh_phase(dev, smi: str) -> dict:
    """Phase 6m: data parallelism over ``torch.distributed``.

    a. One NCCL rank on the card: torchrun's variables for a world of one
       (RANK 0, WORLD_SIZE 1, MASTER_ADDR 127.0.0.1, a free port), then
       ``run bc -o mesh.enabled=true -o trainer.profiler=trace`` through the
       CLI, which joins the process group (``nccl``) and trains on a
       synthetic 128² log at the preset's batch for MESH_BC_BATCHES
       batches: every train step crosses NCCL's all-reduce (the gradient
       bucket, then the metrics); its torch.profiler trace must hold CUDA
       kernel events, one ``train_step`` span a step and NCCL's all-reduce
       kernel.
    b. Two gloo ranks spawned once on cuda:0, the backend named:
       ``mesh_work`` sharded over them against ``mesh_work`` whole in this
       process, TF32 off and cuDNN deterministic in both (``_split_witness``
       records why online DAgger and PPO run ``_in_halves`` here). The BC
       step and the expert rollout:
       speeds at rtol 1e-5, actions equal, the step's metrics at rtol 2e-5
       and equal on both ranks, the parameters equal on both ranks, kernel
       B launched MESH_STEPS + 1 times on each rank. Then online DAgger,
       PPO and serving with ``_mesh_od_checks``, ``_mesh_ppo_checks`` and
       ``_mesh_serving_checks``.
    A rank's failure fails the phase. → launch counts by path: ``mesh``
    (the rollout), ``mesh_online_dagger`` and ``mesh_ppo`` (this process
    and both ranks)."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.serving import export_policy
    from carla_imitation_learning_tpu_torch.training.steps import flax_init_

    t_phase = time.perf_counter()
    paths = {name: {k: 0 for k in counters()}
             for name in ("mesh", "mesh_online_dagger", "mesh_ppo")}
    res = {}
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp, \
                Capture(dist, "all_reduce", lambda a, k, out: (
                    dist.get_backend(), a[0].numel() * a[0].element_size())) as calls:
            t0 = time.perf_counter()
            out = cli_run("bc", "-o", f"data_dir={tmp}/data", "-o", f"log_dir={tmp}/logs",
                          "-o", f"image_height={HW}", "-o", f"image_width={HW}",
                          "-o", f"synthetic_frames={MESH_BC_FRAMES}", "-o", "NUM_EPOCHS=1",
                          "-o", f"BATCH_SIZE={MESH_BATCH}",
                          "-o", f"trainer.limit_train_batches={MESH_BC_BATCHES}",
                          "-o", "trainer.limit_val_batches=2",
                          "-o", "bc_cameras=['camera']", "-o", "mesh.enabled=true",
                          "-o", "trainer.profiler=trace",
                          "-o", f"trainer.trace_dir={tmp}/trace")
            nccl_s = time.perf_counter() - t0
            trace = _trace_checks(Path(tmp) / "trace")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(not dist.is_initialized(), "run bc left its process group up")
    loss = out["camera"]["history"][-1]["train_loss"]
    check(loss > 0 and loss == loss, f"1-rank NCCL run bc: train_loss {loss}")
    backends = {b for b, _ in calls.calls}
    bucket = max(n for _, n in calls.calls)
    check(backends == {"nccl"}, f"1-rank run bc all-reduced over {backends}")
    check(sum(n == bucket for _, n in calls.calls) == MESH_BC_BATCHES,
          f"1-rank run bc: {len(calls.calls)} all-reduces, not one bucket a step")
    res["nccl_one_rank"] = {"seconds": nccl_s, "all_reduces": len(calls.calls),
                            "bucket_bytes": bucket, "train_loss": loss, "trace": trace}
    log(f"mesh (a) 1 NCCL rank, run bc {MESH_BC_BATCHES} steps at batch {MESH_BATCH}, "
        f"{HW}², traced: {nccl_s:.1f} s; {smi}")

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
            t0 = time.perf_counter()
            model = flax_init_(PolicyCNN(dtype=torch.bfloat16), torch.Generator().manual_seed(8))
            shape = mesh_shape(str(export_policy(model.eval(), Path(tmp) / "policy_bf16",
                                                 height=HW, width=HW, device=dev)))
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                mp.spawn(mesh_rank, args=(_free_port(), tmp, DEVICE, shape), nprocs=2,
                         join=True)
            except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
                raise SmokeFailure(f"mesh (b): a gloo rank failed: {e}") from e
            ranks_s = time.perf_counter() - t0
            ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                     for r in range(2)]
            t0 = time.perf_counter()
            whole = mesh_work(None, dev, shape)
            whole_s = time.perf_counter() - t0
        witness = _split_witness(dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    speed = torch.cat([r["speed"] for r in ranks], dim=1)
    action = torch.cat([r["action"] for r in ranks], dim=1)
    check(speed.shape == whole["speed"].shape, f"sharded rollout shape {tuple(speed.shape)}")
    check(bool(torch.allclose(speed, whole["speed"], rtol=1e-5, atol=0.0)),
          f"mesh (b): speeds differ from one process, max|d| "
          f"{float((speed - whole['speed']).abs().max()):.3e}")
    check(torch.equal(action, whole["action"]), "mesh (b): actions differ from one process")
    check(ranks[0]["metrics"] == ranks[1]["metrics"], "mesh (b): the ranks' metrics differ")
    check(torch.equal(ranks[0]["params"], ranks[1]["params"]),
          "mesh (b): the ranks' parameters differ after the step")
    for k, v in whole["metrics"].items():
        got = ranks[0]["metrics"][k]
        check(abs(got - v) <= 2e-5 * abs(v), f"mesh (b): step {k} {got} vs one process {v}")
    for r in ranks:
        check(r["launches"]["B"] == MESH_STEPS + 1,
              f"mesh (b): kernel B launched {r['launches']['B']} times on a rank")
    for name, part in (("mesh", None), ("mesh_online_dagger", "online_dagger"),
                       ("mesh_ppo", "ppo")):
        for r in ranks + [whole]:
            counts = r["launches"] if part is None else r[part]["launches"]
            for k, v in counts.items():
                paths[name][k] += v
    res["gloo_two_ranks"] = {
        "seconds": ranks_s, "export_s": export_s, "one_process_s": whole_s,
        "step_s": [r["step_s"] for r in ranks],
        "rollout_s": [r["rollout_s"] for r in ranks], "one_process_step_s": whole["step_s"],
        "one_process_rollout_s": whole["rollout_s"], "metrics": ranks[0]["metrics"],
        "one_process_metrics": whole["metrics"],
        "param_bytes": int(ranks[0]["params"].numel() * 4),
        "max_speed_diff": float((speed - whole["speed"]).abs().max()),
        "split_witness": witness}
    # every comparison is made and logged before a failed one fails the phase
    failed = []

    def gate(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    res["gloo_two_ranks"].update(online_dagger=_mesh_od_checks(ranks, whole, gate),
                                 ppo=_mesh_ppo_checks(ranks, whole, gate),
                                 serving=_mesh_serving_checks(ranks, whole, gate))
    log(f"mesh (b) 2 gloo ranks on cuda:0, BC step at batch {MESH_BATCH}, a "
        f"{MESH_ENVS} × {MESH_STEPS} rollout, online DAgger {MESH_OD_ENVS} × {MESH_OD_STEPS}, "
        f"PPO {MESH_PPO_ENVS} × {MESH_PPO_STEPS}, a served batch of {MESH_SERVE_BATCH}: "
        f"{ranks_s:.1f} s with the ranks' start; {smi}")
    res["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"mesh": res}))
    check(not failed, "; ".join(failed))
    return paths


def doctor_phase() -> dict:
    """``cli doctor --json`` on the card (``utils/doctor.py``): every check
    green, ``cuda_kernels`` among them (the libraries are built by then, so
    its probe loads them and asks each kernel's ``raster_*_info``)."""
    from carla_imitation_learning_tpu_torch.utils.doctor import run_doctor

    t0 = time.perf_counter()
    report = run_doctor(timeout=DOCTOR_TIMEOUT)
    bad = {k: v for k, v in report["checks"].items() if not v.get("ok")}
    check(report["ok"] and not bad, f"doctor: failed checks {bad}")
    check("cuda_kernels" in report["checks"], "doctor: no cuda_kernels check")
    log(json.dumps({"doctor": {**report, "seconds": time.perf_counter() - t0}}))
    return report


def load_harness(name: str):
    """``benchmarks_torch/<name>.py`` imported under its own name, so that
    the workers ``reference_control`` starts by ``spawn`` import it too."""
    import importlib

    where = str(ROOT / "benchmarks_torch")
    if where not in sys.path:
        sys.path.insert(0, where)
    return importlib.import_module(name)


def crossover_kernels(dev, rate, facts) -> list:
    """Kernels A (C = 3) and B on ``vit_crossover``'s evaluation fleet at
    HARN_VC_HW² (the bench town, the expert evaluation's reset draws,
    HARN_KERNEL_ENVS envs, T = 512), each bit for bit against its plain
    version and timed; B on the lists the rollout builds there (2 px LOD).
    → two ``kernels`` entries: A's counts the main path's launches, B's the
    harnesses phase's, which runs B at this shape."""
    import torch

    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    params, town = bench_fleet(dev)
    hw, n = HARN_VC_HW, HARN_KERNEL_ENVS
    rcfg = RenderConfig(height=hw, width=hw)
    states = reset_env(params, town, torch.Generator().manual_seed(HARN_VC_EVAL_SEED), n)
    setup = make_scene_setup(params, town, rcfg, device=dev)(states)
    t, rows = rcfg.max_triangles, ra.band_rows(hw)
    args_a = (ra.pack_setup(setup), *ra.tile_lists(setup, hw, t, width=hw), hw, hw,
              rcfg.near, rcfg.far, 3, rows)
    err_a, hits = check_exact(args_a, f"kernel A C=3 at {hw}², the crossover's fleet")
    idx, cnt = rf.tile_lists_fast(setup, hw, t, width=hw, lod_px=2.0, rows_per_band=rows)
    args_b = (rf.pack_setup_fast(setup), idx, cnt, hw, hw, rcfg.near, rcfg.far, 0.0, rows)
    err_b, frame = check_fast(args_b, f"kernel B at {hw}², the crossover's fleet")
    check(bool(frame.std() > 0.01) and hits > 0, "the crossover's frames are blank")
    frame_px = n * hw * hw
    a_tiles, a_kept = warp_tile_pairs(*args_a[:5], rows, exact=True)
    b_tiles, b_kept = warp_tile_pairs(*args_b[:5], rows, exact=False)
    # per pass A does OPS_PER_PASS_A and a select per colour channel
    a_ops = OPS_PER_PASS_A + 3
    return [
        kernel_entry(f"raster_exact (kernel A, RGB, {hw}², the crossover's fleet)", "A",
                     "raster_exact.cu", "carla_imitation_learning_tpu/ops/raster.py:120",
                     ra.raster_bands, ra.raster_bands_plain, args_a, err_a, rate,
                     ops=a_kept * a_ops + frame_px * OPS_PER_PIXEL_EPILOGUE_A,
                     band_list_ops=float(args_a[2].sum()) * rows * hw * a_ops,
                     out_bytes=frame_px * 4 * 5, path="main", n_envs=n, hw=hw,
                     warp_tile_pairs=a_tiles, kept_pairs=a_kept, hit_pixels=hits,
                     launches_note=("the main path's luma launches at 128²: no path "
                                    "launches kernel A at C = 3 and 256²"),
                     **facts["A"]),
        kernel_entry(f"raster_fast (kernel B, {hw}², the crossover's fleet)", "B",
                     "raster_fast.cu", "carla_imitation_learning_tpu/ops/raster_fast.py:400",
                     rf.fast_bands, rf.fast_bands_plain, args_b, err_b, rate,
                     ops=b_kept * OPS_PER_PASS_B + frame_px * OPS_PER_PIXEL_EPILOGUE_B,
                     band_list_ops=float(cnt.sum()) * rows * hw * OPS_PER_PASS_B,
                     table_bytes=walked_bytes(cnt, 2, idx.shape[2], FAST_ENTRY_BYTES),
                     out_bytes=frame_px * 4, path="harnesses", n_envs=n, hw=hw,
                     warp_tile_pairs=b_tiles, kept_pairs=b_kept, **facts["B"]),
    ]


def harnesses_phase(dev, rate, facts, kernels) -> dict:
    """Phase 6n: kernels A (C = 3) and B on the crossover's fleet
    (``crossover_kernels``, appended to ``kernels``), then, counts reset, the
    seven harnesses in process at a smoke size, each through the function
    its ``main`` runs: ``sim_ablation.ablate`` (eight variants at
    HARN_SIM_ENVS) and ``rollout_breakdown.breakdown`` (five components at
    HARN_BREAKDOWN_ENVS; B in full and expert, C in render_only) on
    HARN_PAIR, ``crash_forensics``, ``expert_envelope``,
    ``reference_control`` and ``vit_crossover`` through ``main`` (reports
    in a temporary directory; the crossover renders B at HARN_VC_HW²), and
    ``vit_ab.bench_arch`` for both architectures. Every time finite, every
    report's keys the JAX report's, mode counts summing to the collision
    events, and B and C launched exactly as those runs' steps ask; →
    launch counts."""
    import math

    from carla_imitation_learning_tpu_torch.models import PolicyCNN, ViTPolicy

    kernels += crossover_kernels(dev, rate, facts)
    mods = {m: load_harness(m) for m in ("sim_ablation", "crash_forensics", "rollout_breakdown",
                                         "expert_envelope", "reference_control", "vit_ab",
                                         "vit_crossover")}
    small, big = HARN_PAIR
    res, seconds = {}, {}

    def finite(*xs) -> bool:
        return all(x is not None and math.isfinite(x) for x in xs)

    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_harnesses_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        sa = mods["sim_ablation"].ablate(HARN_SIM_ENVS, dev, n_small=small, n_big=big, reps=1)
        check(list(sa["ms"]) == list(mods["sim_ablation"].variants(bench_fleet(dev)[0]))
              and finite(*sa["ms"].values()), f"sim_ablation: {sa}")
        res["sim_ablation"], seconds["sim_ablation"] = sa, time.perf_counter() - t0

        t0 = time.perf_counter()
        rb_mod = mods["rollout_breakdown"]
        rb = rb_mod.report(HARN_BREAKDOWN_ENVS, False, -1.0, rb_mod.breakdown(
            HARN_BREAKDOWN_ENVS, False, -1.0, dev, n_small=small, n_big=big, reps=1))
        check(finite(*rb["ms_per_fleet_step"].values(), *rb["derived_ms"].values())
              and list(rb["ms_per_fleet_step"]) == list(rb_mod.COMPONENTS),
              f"rollout_breakdown: {rb}")
        res["rollout_breakdown"], seconds["rollout_breakdown"] = rb, time.perf_counter() - t0

        envs, steps = HARN_CRASH
        t0 = time.perf_counter()
        cf = mods["crash_forensics"].main(["--envs", str(envs), "--steps", str(steps),
                                           "--device", DEVICE, "--out", str(tmp / "cf.json")])
        check(sum(cf["modes"].values()) == cf["collision_events"]
              and list(cf["modes"]) == list(mods["crash_forensics"].MODES)
              and cf["km"] > 0 and finite(cf["wall_seconds"]), f"crash_forensics: {cf}")
        res["crash_forensics"], seconds["crash_forensics"] = cf, time.perf_counter() - t0

        envs, steps = HARN_ENVELOPE
        t0 = time.perf_counter()
        ee_mod = mods["expert_envelope"]
        ee = ee_mod.main(["--envs", str(envs), "--steps", str(steps), "--device", DEVICE,
                          "--out", str(tmp / "ee.json")])
        for stage in ee_mod.stages(4.0):
            check(set(ee[stage]) == set(ee_mod.KEEP)
                  and finite(*(ee[stage][k] for k in ("driving_score", "km_driven"))),
                  f"expert_envelope {stage}: {ee[stage]}")
        res["expert_envelope"] = {k: ee[k] for k in ee_mod.stages(4.0)}
        seconds["expert_envelope"] = time.perf_counter() - t0

        frames, batch, workers = HARN_REFERENCE
        t0 = time.perf_counter()
        rc = mods["reference_control"].main([
            "--frames", str(frames), "--batch", str(batch), "--workers", str(workers),
            "--device", DEVICE, "--data-dir", str(tmp / "reference_log"),
            "--out", str(tmp / "rc.json")])
        check(finite(rc["value"], rc["decode_only_images_per_sec"]) and rc["value"] > 0,
              f"reference_control: {rc}")
        res["reference_control"], seconds["reference_control"] = rc, time.perf_counter() - t0

        t0 = time.perf_counter()
        va_mod = mods["vit_ab"]
        va = {name: va_mod.bench_arch(name, model, HARN_VIT_BATCH, 256, va_mod.H100_BF16_DENSE_TFLOPS,
                                      dev, short=small, long=big, reps=1)
              for name, model in (("cnn", PolicyCNN()), ("vit", ViTPolicy()))}
        for name, r in va.items():
            check(finite(*r.values()) and r["gflops_per_step"] > 0
                  and 0 < r["mfu_pct"] < 100, f"vit_ab {name}: {r}")
        res["vit_ab"], seconds["vit_ab"] = va, time.perf_counter() - t0

        envs, steps, c_envs, c_steps, epochs, batch = HARN_VC
        t0 = time.perf_counter()
        vc_mod = mods["vit_crossover"]
        vc = vc_mod.main([
            "--obs-hw", str(HARN_VC_HW), "--envs", str(envs), "--steps", str(steps),
            "--collect-envs", str(c_envs), "--collect-steps", str(c_steps),
            "--epochs", str(epochs), "--batch", str(batch), "--device", DEVICE,
            "--out", str(tmp / "vc.json")])
        check(vc["dataset_frames"] == c_envs * c_steps and "reduced" in vc,
              f"vit_crossover: {vc.get('dataset_frames')} frames")
        for tier in ("cnn", "vit_2m", "vit_scaled"):
            check(finite(vc[tier]["final_loss"], vc[tier]["eval"]["driving_score"])
                  and vc[tier]["epochs"] >= (epochs if tier == "cnn" else 2),
                  f"vit_crossover {tier}: {vc[tier]}")
        res["vit_crossover"] = {k: vc[k] for k in ("dataset_frames", "wall_budget_seconds",
                                                   "expert", "cnn", "vit_2m", "vit_scaled")}
        seconds["vit_crossover"] = time.perf_counter() - t0
    launches = read_counts()
    breakdown_b = 2 * (1 + 2 * (small + big))            # full and expert: a warm pair, one pair
    envelope_b = len(mods["expert_envelope"].stages(4.0)) * (HARN_ENVELOPE[1] + 1)
    crossover_b = (HARN_VC[3] + 1) + 4 * (HARN_VC[1] + 1)   # its collection and four evaluations
    want = {"A": 0, "A-tex": 0, "B": breakdown_b + envelope_b + crossover_b,
            "C": 2 * (small + big), "D": 0}
    check(launches == want, f"harnesses: launches {launches}, expected {want}")
    res["seconds"], res["launches"] = seconds, launches
    log(json.dumps({"harnesses": res}))
    return launches


def load_demo():
    """``docs/make_demo_gif_torch.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_demo_gif_torch", ROOT / "docs" / "make_demo_gif_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def exact_rgb_entry(name, counter, replaces, args, err, hits, rate, facts, path, textured=False,
                    **extra) -> dict:
    """The ``kernels`` entry of kernel A (or A-tex) in RGB on ``args`` at
    HW²: per kept pass A's operations and a select per colour channel, per
    hit pixel of A-tex the texture and a multiply per channel; out: three
    colours, the class and the depth."""
    from carla_imitation_learning_tpu_torch.ops import raster as ra

    rows = args[-1]
    frame_px = args[0].shape[0] * HW * HW
    a_tiles, a_kept = warp_tile_pairs(*args[:5], rows, exact=True)
    a_ops = OPS_PER_PASS_A + 3
    tex_ops = hits * (OPS_PER_PIXEL_TEX + 3) if textured else 0
    return kernel_entry(name, counter, "raster_exact.cu", replaces, ra.raster_bands,
                        ra.raster_bands_plain, args, err, rate,
                        ops=a_kept * a_ops + frame_px * OPS_PER_PIXEL_EPILOGUE_A + tex_ops,
                        band_list_ops=listed(args[2], rows) * a_ops + tex_ops,
                        out_bytes=frame_px * 4 * 5, path=path, rows=rows,
                        warp_tile_pairs=a_tiles, kept_pairs=a_kept, hit_pixels=hits,
                        **extra, **facts[counter])


def bench_phase(dev, rate, facts, kernels) -> dict:
    """Phase 6o: the headline benchmark and the demo GIF's camera.

    a. Kernel A in RGB (C = 3) on the bench gate's scene (one env, 128²,
       512 triangles) from seeds 0-2, each bit for bit against its plain
       version, timed on seed 0's (a ``kernels`` entry); then, counts reset,
       ``bench.assert_kernel_parity`` in this process (its figures).
    b. ``python -m carla_imitation_learning_tpu_torch.cli bench`` in a
       subprocess, as a user runs it: exit 0, the last stdout line the
       headline's JSON (the metric's name, ``value`` > 0, ``vs_baseline``
       null), the gate's, the BC step, BC fused and closed-loop figures on
       stderr beside the card's name and power limit, and its wrappers'
       launch counts (printed by ``bench.main`` from a fresh process): A six
       times (RGB and luma, three seeds), B three times in the gate and once
       per rollout step plus the first frame (path ``bench``).
    c. The demo GIF's drive (``docs/make_demo_gif_torch.py``): DEMO_FRAMES
       frames rendered with counts reset, kernel A-tex once a frame (path
       ``demo``), and A-tex in RGB at the demo's 2048 triangles on its first
       DEMO_CHECK_FRAMES frames bit for bit against its plain version, timed
       on the first (a ``kernels`` entry).
    → launch counts by path."""
    import inspect
    import re

    import torch

    from carla_imitation_learning_tpu_torch import bench
    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.render import geometry as geo
    from carla_imitation_learning_tpu_torch.render.pipeline import make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import reset_env

    res, paths = {}, {}
    rows = ra.band_rows(HW)
    params, town = bench.bench_world(dev)
    static = geo.build_static_scene(town).to(dev)
    err, first = 0.0, None
    for seed in range(3):
        st = reset_env(params, town, torch.Generator().manual_seed(seed), 1)
        args = exact_args(bench.bench_setup(params, town, static, st, HW), T, 0.5, 300.0, 3, rows)
        e, hits = check_exact(args, f"kernel A C=3 on the bench gate's scene, seed {seed}")
        err = max(err, e)
        first = first or (args, hits)
    kernels.append(exact_rgb_entry(
        "raster_exact (kernel A, RGB, the bench gate's scene)", "A",
        "carla_imitation_learning_tpu/ops/raster.py:120", first[0], err, first[1], rate, facts,
        "bench", n_envs=1, hw=HW,
        launches_note="cli bench's: 3 at C = 3 and 3 luma (the gate), counted in its process"))
    reset_counts()
    res["gate"] = bench.assert_kernel_parity(device=dev)
    gate = read_counts()
    check(gate == {"A": 6, "A-tex": 0, "B": 3, "C": 0, "D": 0}, f"the gate's launches {gate}")
    paths["bench_gate"] = gate

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "carla_imitation_learning_tpu_torch.cli",
                           "bench"], cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    res["cli_bench_s"] = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines():
        log(f"  cli bench: {line}")
    check(proc.returncode == 0, f"cli bench exited {proc.returncode}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    check(list(last) == ["metric", "value", "unit", "vs_baseline"]
          and last["metric"] == bench.METRIC and last["value"] > 0
          and last["unit"] == "env-steps/sec" and last["vs_baseline"] is None,
          f"cli bench's last line {last}")
    res["headline"] = last
    err_lines = proc.stderr.splitlines()
    figures = {}
    for key, pattern in (("bc_step_images_per_s", r"BC training \(step path\): ([\d,]+)"),
                         ("bc_fused_images_per_s", r"BC training \(fused epoch.*?\): ([\d,]+)"),
                         ("closed_loop_env_steps_per_s", r"closed-loop: ([\d,]+)")):
        found = [re.search(pattern, ln) for ln in err_lines]
        found = [m for m in found if m]
        check(len(found) == 1, f"cli bench printed no {key} figure")
        figures[key] = float(found[0].group(1).replace(",", ""))
    check(any(ln.startswith("kernel parity: exact max|d|=") for ln in err_lines),
          "cli bench printed no gate figures")
    check(any(nvidia_smi() in ln for ln in err_lines), "cli bench printed no card line")
    res["figures"] = figures
    launches = json.loads(next(ln for ln in err_lines if ln.startswith('{"launches"')))["launches"]
    short, long = inspect.signature(bench.bench_closed_loop).parameters["lengths"].default
    repeats = inspect.signature(bench.bench_closed_loop).parameters["repeats"].default
    want = {"A": 6, "A-tex": 0, "B": 3 + 1 + (1 + repeats) * (short + long), "C": 0, "D": 0}
    check(launches == want, f"cli bench launched {launches}, expected {want}")
    paths["bench"] = launches

    demo = load_demo()
    reset_counts()
    t0 = time.perf_counter()
    frames, _ = demo.demo_frames(DEMO_FRAMES, dev)
    res["demo_s"] = time.perf_counter() - t0
    drawn = read_counts()
    check(drawn == {"A": 0, "A-tex": DEMO_FRAMES, "B": 0, "C": 0, "D": 0},
          f"the demo's drive launched {drawn}")
    check(len(frames) == DEMO_FRAMES and frames[0].shape == (HW, 2 * HW, 3)
          and float(frames[-1].std()) > 1.0, "the demo's frames are wrong or blank")
    paths["demo"] = drawn
    d_params, d_town, rcfg, states = demo.demo_drive(DEMO_CHECK_FRAMES, dev)
    check(rcfg.max_triangles == DEMO_T and rcfg.texture_detail and rcfg.rgb,
          "the demo's camera is not A-tex in RGB at 2048 triangles")
    setup_fn = make_scene_setup(d_params, d_town, rcfg, device=dev)
    err, first = 0.0, None
    for i, st in enumerate(states):
        args = exact_args(setup_fn(st), DEMO_T, rcfg.near, rcfg.far, 3, rows)
        check(args[0].shape[1] == ra.TEX_PACK_WIDTH, "the demo's table is not textured")
        e, hits = check_exact(args, f"kernel A-tex C=3 on the demo's frame {i}")
        err = max(err, e)
        first = first or (args, hits)
    kernels.append(exact_rgb_entry(
        "raster_exact textured (kernel A-tex, RGB, the demo's 2048 triangles)", "A-tex",
        "carla_imitation_learning_tpu/ops/raster.py:151", first[0], err, first[1], rate, facts,
        "demo", textured=True, n_envs=1, hw=HW))
    log(json.dumps({"bench": res}))
    return paths


def graft_entry_phase(dev, rate, facts, kernels) -> dict:
    """Phase 6p: the multi-device dry run and the compile check
    (``carla_imitation_learning_tpu_torch/graft_entry.py``).

    a. Kernel B at DRYRUN_HW² with the dry run's 192-triangle table on its
       fleet (the 2-block town, 2 agents, DRYRUN_ENVS envs, 2 px LOD) bit
       for bit against its plain version and timed (a ``kernels`` entry).
    b. ``dryrun_multichip(DRYRUN_RANKS)`` on the card: two gloo ranks on
       cuda:0 run every family; rank 0's line (printed to a captured stdout)
       has the JAX line's start, every loss is finite, each rank holds 2
       envs, and each launched kernel B DRYRUN_B times (path ``graft_entry``,
       the ranks' counts summed).
    c. ``entry()``'s bf16 forward on the card against the same module on the
       CPU, on its zero input and on a seeded frame stack: (8, 9) logits
       within 5e-2 (the bf16 scale of ``tests/test_torch_policy.py``).
    → launch counts."""
    import copy
    import math

    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch import graft_entry as ge
    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams, reset_env

    res = {}
    hw, t, n = DRYRUN_HW, DRYRUN_T, DRYRUN_ENVS
    params, town = SimParams(n_agents=2), make_town(blocks=2, n_buildings=4, n_lights=2).to(dev)
    rcfg = RenderConfig(hw, hw, max_triangles=t, rgb=False, fast=True, lod_px=2.0)
    states = reset_env(params, town, torch.Generator().manual_seed(2), n)
    setup = make_scene_setup(params, town, rcfg, device=dev)(states)
    rows = ra.band_rows(hw)
    idx, cnt = rf.tile_lists_fast(setup, hw, t, width=hw, lod_px=2.0, rows_per_band=rows)
    args_b = (rf.pack_setup_fast(setup), idx, cnt, hw, hw, rcfg.near, rcfg.far, 0.0, rows)
    err_b, frame = check_fast(args_b, f"kernel B at {hw}², the dry run's fleet")
    check(bool(frame.std() > 0.01), "the dry run's frames are blank")
    frame_px = n * hw * hw
    b_tiles, b_kept = warp_tile_pairs(*args_b[:5], rows, exact=False)
    kernels.append(kernel_entry(
        f"raster_fast (kernel B, {hw}², the dry run's fleet)", "B", "raster_fast.cu",
        "carla_imitation_learning_tpu/ops/raster_fast.py:400", rf.fast_bands,
        rf.fast_bands_plain, args_b, err_b, rate,
        ops=b_kept * OPS_PER_PASS_B + frame_px * OPS_PER_PIXEL_EPILOGUE_B,
        band_list_ops=float(cnt.sum()) * rows * hw * OPS_PER_PASS_B,
        table_bytes=walked_bytes(cnt, 2, idx.shape[2], FAST_ENTRY_BYTES),
        out_bytes=frame_px * 4, path="graft_entry", n_envs=n, hw=hw,
        warp_tile_pairs=b_tiles, kept_pairs=b_kept, **facts["B"]))

    t0 = time.perf_counter()
    with tempfile.TemporaryFile(mode="w+") as out:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(out.fileno(), 1)
        try:
            dry = ge.dryrun_multichip(DRYRUN_RANKS, device=DEVICE)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        out.seek(0)
        printed = out.read()
    res["dryrun_s"] = time.perf_counter() - t0
    log(printed.strip())
    check(f"dryrun_multichip({DRYRUN_RANKS}) ok: bc_loss=" in printed,
          "dryrun_multichip printed no ok line")
    losses = {k: dry[k] for k in ("bc_loss", "vae_loss", "fused_epoch_loss", "ppo_loss",
                                  "dagger_online_loss", "wm_loss", "imag_loss")}
    check(all(math.isfinite(v) for v in losses.values()), f"dry run losses {losses}")
    check(dry["rollout_steps"] == dry["goal_rollout_steps"] == 2 * DRYRUN_ENVS,
          f"dry run counts {dry['rollout_steps']}, {dry['goal_rollout_steps']}")
    launches = {k: 0 for k in counters()}
    for r in dry["ranks"]:
        check(r["local_envs"] == DRYRUN_ENVS // DRYRUN_RANKS, "the dry run's envs not sharded")
        check(r["launches"] == {"A": 0, "A-tex": 0, "B": DRYRUN_B, "C": 0, "D": 0},
              f"a dry-run rank launched {r['launches']}, expected B {DRYRUN_B}")
        for k, v in r["launches"].items():
            launches[k] += v
    res.update(losses=losses, backend=dry["backend"])

    fn, (model, x) = ge.entry(DEVICE)
    cpu_model = copy.deepcopy(model).cpu()
    frames = torch.from_numpy((np.random.default_rng(0).integers(0, 256, tuple(x.shape))
                               / 255.0).astype(np.float32))
    worst = 0.0
    for inp in (x.cpu(), frames):
        got = fn(model, inp.to(dev)).cpu()
        want = fn(cpu_model, inp)
        check(got.shape == (8, 9) and got.dtype == torch.float32, f"entry() gave {got.shape}")
        worst = max(worst, float((got - want).abs().max()))
    check(worst < 5e-2, f"entry(): card vs CPU logits max|d| {worst:.3e}")
    res["entry_card_vs_cpu_max_abs"] = worst
    log(json.dumps({"graft_entry": res}))
    return {"graft_entry": launches}


def bench_fleet(dev):
    """The bench town on ``dev`` and its sim parameters → (params, town)."""
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams

    return SimParams(n_agents=15), make_town(**BENCH_TOWN).to(dev)


def exact_args(setup, t: int, near: float, far: float, n_ch: int, rows: int, lists=None):
    """Kernel A's arguments for a fleet's scene setup at HW²: its table
    (luma only when ``n_ch`` = 1; textured when the setup has UV rows), the
    band lists of ``tile_lists`` (or ``lists``) and the frame."""
    from carla_imitation_learning_tpu_torch.ops import raster as ra

    idx, cnt = lists if lists is not None else ra.tile_lists(setup, HW, t, width=HW)
    return (ra.pack_setup(setup, luma_only=n_ch == 1), idx, cnt, HW, HW, near, far, n_ch, rows)


def fast_args(setup, t: int, near: float, far: float, rows: int, lod: float = 2.0,
              factor: int = 1):
    """Kernel B's arguments for a fleet's scene setup at HW²: its table, the
    band lists of ``tile_lists_fast`` at ``lod`` px, no fog; with ``factor``
    > 1 one coarse list per ``factor`` bands (``list_band_factor``)."""
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    idx, cnt = rf.tile_lists_fast(setup, HW, t, width=HW, lod_px=lod, rows_per_band=rows,
                                  list_band_factor=factor)
    args = (rf.pack_setup_fast(setup), idx, cnt, HW, HW, near, far, 0.0, rows)
    return args + (factor,) if factor > 1 else args


def prim_args(setup, t: int, near: float, far: float, rows: int, factor: int = 1):
    """Kernel C's arguments for a fleet's quad-ready setup at HW²: the fused
    primitives' table, their band lists at 2 px LOD, no fog (coarse lists
    with ``factor`` > 1)."""
    from carla_imitation_learning_tpu_torch.ops import raster_fast as rf

    prims = rf.fuse_prims(setup)
    idx, cnt = rf.tile_lists_fast(prims, HW, t, width=HW, lod_px=2.0, rows_per_band=rows,
                                  list_band_factor=factor)
    args = (rf.pack_setup_prims(prims), idx, cnt, HW, HW, near, far, 0.0, rows)
    return args + (factor,) if factor > 1 else args


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
    t_run = t0 = time.perf_counter()
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
    t0 = time.perf_counter()
    doctor_phase()
    doctor_s = time.perf_counter() - t0

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
    phase_s = {"to_main_path": time.perf_counter() - t_run, "doctor": doctor_s}
    prof = args.profile is not None

    def phase(name: str, fn, *a, **k):
        """Run phase ``fn`` and keep its seconds; its launch counts → ``paths``
        (a phase that drives several paths returns the counts of each)."""
        t0 = time.perf_counter()
        out = fn(*a, **k)
        paths.update(out if isinstance(next(iter(out.values())), dict) else {name: out})
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")

    t0 = time.perf_counter()
    bc_state = bc_training(params, town, rcfg, dev, profile=prof)
    phase_s["bc_training"] = time.perf_counter() - t0
    phase("dagger", dagger_phase, params, town, rcfg, dev, bc_state, profile=prof)
    del bc_state
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as keep:
        phase("file_io", file_io_phase, dev, profile=prof, keep=Path(keep))
        phase("scenarios", scenarios_phase, dev, Path(keep) / "best")
        phase("routes", routes_phase, dev, profile=prof)
        phase("aux_vae", aux_vae_phase, dev)
        phase("rl_safety", rl_safety_phase, dev, Path(keep) / "best", profile=prof)
        phase("serving", serving_phase, dev, Path(keep) / "best")
    phase("seq_wm", seq_wm_phase, dev)
    phase("rigs_replay", rigs_replay_phase, dev)
    phase("hpo", hpo_phase, dev)
    phase("mesh", mesh_phase, dev, smi)
    phase("harnesses", harnesses_phase, dev, rate, facts, kernels)
    phase("bench", bench_phase, dev, rate, facts, kernels)
    phase("graft_entry", graft_entry_phase, dev, rate, facts, kernels)
    # the rich phases allocate gigabytes of temporaries; they run after the
    # main path has been timed
    t0 = time.perf_counter()
    rich, b_rich_err = rich_kernels(params, town, dev, rows, rate, facts)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], b_rich_err)
    kernels += rich
    phase_s["rich_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels += band_factor_kernels(params, town, dev, rows, rate, facts)
    phase_s["band_factor"] = time.perf_counter() - t0
    phase("rich_collection", rich_collection, params, town, dev)
    phase("quad_vec_ab", quad_vec_ab, params, town, dev, kernels)
    log(json.dumps({"phase_seconds": phase_s}))
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
                     model_fn=None, cpu_refs: tuple = ("cpu",), floor: float = 1e-6) -> dict:
    """One fp32 train step of ``loss_fn`` from the same weights and batch on
    the card and on the CPU, TF32 off, with the global-norm clip (when
    ``require_clip``, checked to trigger), each held against the same step
    in float64 on the CPU. The loss within rtol 1e-5
    of float64; per tensor, the card's gradient no further from float64
    than 4× the CPU's fp32 gradient is, plus ``floor`` (default 1e-6) of
    the tensor's scale (a convolution's weight gradient sums hundreds of
    thousands of products that cancel, so fp32 rounding in either
    reduction order is visible at 1e-3 of the scale); after the step, no
    more parameters off float64's by over 1 % of the learning rate on the
    card than 4× the CPU's count plus 1 in 10,000 (Adam's first step moves
    each weight by about lr · sign(g), so a near-zero gradient may flip its
    step). Float tensors of
    ``batch`` (nested tuples allowed) take each run's dtype. The model is
    ``model_fn(dtype)`` (default a ``PolicyCNN``). ``cpu_refs`` names the
    CPU runs whose gradient error bounds the card's (the largest of them):
    by default the CPU as torch runs it (oneDNN convolutions where the
    build has them); ``("cpu", "cpu_no_mkldnn")`` also admits the CPU's
    native convolutions, whose reduction order differs. The line lists,
    under ``floor_set``, each tensor whose card error exceeds 4× the CPU's,
    so passes only by the floor. Prints the ``name`` line; → the
    errors."""
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
    for t in res["tensors"].values():
        t["grad_err_cpu_max"] = max(t[f"grad_err_{side}"] for side in cpu_refs)
    res["floor_set"] = {k: t for k, t in res["tensors"].items()
                        if t["grad_err_card"] > 4 * t["grad_err_cpu_max"]}
    log(json.dumps({name: res}))
    if require_clip:
        check(res["clip_triggered"],
              f"{name}: gradient norm {res['grad_norm']:.3f} does not trigger the clip")
    for side in ("card", "cpu"):
        check(res[f"loss_rel_err_{side}"] <= 1e-5,
              f"{name}: {side} loss {runs[side][0]} vs float64 {loss64}")
    for k, t in res["tensors"].items():
        check(t["grad_err_card"] <= 4 * t["grad_err_cpu_max"] + floor * t["grad_scale"],
              f"{name}: {k} gradient {t['grad_err_card']:.3e} from float64, "
              f"CPU {t['grad_err_cpu_max']:.3e} (scale {t['grad_scale']:.3e})")
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
    changes = {name: route_changes(*fleets[name][:2], dev, SCENARIO_ENVS, SCENARIO_CHANGE_STEPS)
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


def time_train_step(label: str, model, loss_fn, group: str, batch, dev,
                    counts: tuple | None = None) -> dict:
    """One model's train step alone, as ``run`` builds it (the optimizer of
    the ``model=<group>`` preset, flax init, the step's device generator),
    on ``batch`` moved to ``dev`` (its rows are its first tensor's first
    axis; a 5-D first tensor holds sequences, each of its frames an
    image): ``counts`` = (warm-up steps, steps a run, runs, profiled steps),
    default AUX_TIMED, the runs each timed by CUDA events around it (ms per
    step) and by the host clock up to the last step's return before the
    sync (the host's ms to issue a step), then torch.profiler over the
    profiled steps: the kernels' busy ms per step, which the profiler's own
    host cost does not change, and launches. ``idle_share`` is 1 − busy /
    the median's ms: where it is large the card waits on the host's
    launches, and a spread of the runs with the busy ms unchanged is the
    host's. → the median, every run and the profile."""
    import torch

    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer, make_train_step,
    )

    def to_dev(b):
        return tuple(to_dev(x) for x in b) if isinstance(b, tuple) else b.to(dev)

    warm, steps, repeats, profiled = counts or AUX_TIMED
    first = batch
    while isinstance(first, tuple):
        first = first[0]
    rows = first.shape[0]
    images = rows * first.shape[1] if first.dim() == 5 else rows
    batch = to_dev(batch)
    state = create_train_state(model, make_optimizer(compose("config", overrides=[f"model={group}"])),
                               generator=torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(loss_fn)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(warm):
        step(state, batch, gen)
    device_ms, host_ms = [], []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            _, metrics = step(state, batch, gen)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end) / steps)
    check(bool(torch.isfinite(metrics["loss"])), f"{label} timed steps: loss not finite")
    prof = profile_train_step(lambda st, order: [step(st, batch, gen) for _ in order], state,
                              range(profiled))
    ms = sorted(device_ms)[len(device_ms) // 2]
    out = {"batch": rows, "dtype": "bfloat16", "steps": steps, "ms_per_step": ms,
           "ms_runs": device_ms, "host_issue_ms_runs": host_ms,
           "images_per_s": images / ms * 1e3,
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


def _face_agent(states, town, env: int, gap: float, speed: float):
    """``states`` with env ``env``'s ego ``gap`` m west of its agent 0,
    facing it (+x) at ``speed`` m/s: inside the shield's envelope."""
    import torch

    from carla_imitation_learning_tpu_torch.sim.agents import agent_positions

    ap, _ = agent_positions(town, states.agents_route, states.agents_s)
    pos, yaw, v = states.ego_pos.clone(), states.ego_yaw.clone(), states.ego_v.clone()
    pos[env] = ap[env, 0] - torch.tensor([gap, 0.0], device=pos.device)
    yaw[env], v[env] = 0.0, speed
    return states.replace(ego_pos=pos, ego_yaw=yaw, ego_v=v)


def ppo_step_inputs(params, town, dev, continuous: bool, gen):
    """A PPO minibatch of RL_CROSS_ENVS × RL_CROSS_STEPS windows: the frames
    and resets of an expert rollout on the card (windows rebuilt by
    ``window_sources``), actions (the categorical's indices or raw Gaussian
    draws), old log-probabilities and values, advantages and returns drawn
    from ``gen`` — what ``ppo_loss_fn`` takes."""
    import torch

    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.training import rl
    from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout

    init_fn, rollout_fn = make_rollout(params, town, RenderConfig(height=HW, width=HW,
                                                                   max_triangles=T),
                                       None, device=dev)
    carry = init_fn(torch.Generator().manual_seed(21), RL_CROSS_ENVS)
    _, traj = rollout_fn(carry, RL_CROSS_STEPS)
    n = RL_CROSS_ENVS * RL_CROSS_STEPS
    obs = rl.gather_windows(traj["gray"], rl.window_sources(traj["done"]),
                            torch.arange(n, device=dev)).cpu()
    action = (torch.randn(n, 2, generator=gen) if continuous
              else torch.randint(0, 9, (n,), generator=gen))
    old_logp = -torch.rand(n, generator=gen) * 3.0
    value = torch.randn(n, generator=gen)
    adv = torch.randn(n, generator=gen)
    return obs, action, old_logp, adv, value + adv, value


def rl_safety_phase(dev, checkpoint: Path, profile: bool = False) -> dict:
    """Phase 6h: PPO fine-tuning, the safety shield, the LIDAR and the s2d
    stem on the card, counts reset just before part (a).

    a. ``run rl_finetune -o experiment=rl_finetune`` through the CLI,
       warm-started from ``checkpoint`` (6d's ``bc`` at 128²): the preset's
       256 envs × 128 steps, 4 epochs × 8 minibatches of 4096 windows, cut
       to RL_ITERATIONS of its 20 iterations and evaluated at RL_EVAL_ENVS
       × RL_EVAL_STEPS (the preset's 128 envs, 100 of its 300 steps). Every
       PPO metric finite; kernel B launched exactly 1 + iterations ×
       rollout steps + 2 × (evaluation steps + 1) times (the fleet's first
       frame, every rollout step, both evaluations and their first
       frames). Per iteration: rollout s and update s (each ended by a
       device sync), env-steps/s and ms per minibatch step; with
       ``profile``, one update under torch.profiler (launches, idle share);
    b. one PPO minibatch step in fp32 (TF32 off) on the card and on the CPU,
       each against float64 (``step_card_vs_cpu``), for the categorical and
       the Gaussian actor-critic;
    c. ``run closed_loop_eval -o safety_shield=true`` at SHIELD_ENVS ×
       SHIELD_STEPS from the same ``bc`` checkpoint: interventions > 0 on the
       policy's rollout, none reported for the expert's; from one carry the
       first step's labels are equal with the shield on and off; on
       SHIELD_CROSS_ENVS envs over SHIELD_CROSS_STEPS steps of a
       full-throttle policy (env 0 facing an agent 6 m away at 8 m/s) the
       shield's mask is equal on the card and on the CPU;
    d. ``make_rollout(lidar_beams=360)`` of the expert at N_ENVS envs:
       marginal ms per step with and without the scan (between LIDAR_SHORT
       and LIDAR_LONG steps, median of LIDAR_REPEATS pairs), and the scan of
       LIDAR_CROSS_ENVS envs on the card against the CPU within 1e-5
       relative;
    e. ``PolicyCNN(s2d_stem=True)`` with ``convert_params_to_s2d`` weights
       against the standard stem at S2D_BATCH × 128²: fp32 (TF32 off)
       logits within 1e-4, bf16 within 2 % of the largest |logit|, and
       both bf16 forwards timed with CUDA events.
    Prints one ``rl_safety`` line; → the phase's launch counts."""
    import math

    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.models.cnn import convert_params_to_s2d
    from carla_imitation_learning_tpu_torch.render.lidar import make_lidar
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.world import reset_env
    from carla_imitation_learning_tpu_torch.training import rl
    from carla_imitation_learning_tpu_torch.training.closed_loop import (
        make_rollout, rollout_spawn_pool,
    )
    from carla_imitation_learning_tpu_torch.training.shield import ShieldConfig
    from carla_imitation_learning_tpu_torch.utils.checkpoint import restore_params

    from carla_imitation_learning_tpu_torch.config import compose

    t_phase = time.perf_counter()
    res: dict = {"card": nvidia_smi()}
    preset = compose("config", overrides=["experiment=rl_finetune"])
    ppo = rl.PPOConfig()
    check((preset["n_envs"], preset["rollout_steps"], preset["eval_envs"], ppo.update_epochs,
           ppo.num_minibatches) == (RL_ENVS, RL_STEPS, RL_EVAL_ENVS, RL_EPOCHS, RL_MINIBATCHES),
          "the rl_safety phase no longer runs the rl_finetune preset's width")
    params, town = bench_fleet(dev)
    rcfg = RenderConfig(height=HW, width=HW, max_triangles=T)
    cpu = torch.device("cpu")

    # a. PPO fine-tuning through the CLI
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rl_") as tmp:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = cli_run("-o", "experiment=rl_finetune", "--checkpoint", str(checkpoint),
                      "-o", f"log_dir={tmp}", "-o", f"n_envs={RL_ENVS}",
                      "-o", f"rollout_steps={RL_STEPS}", "-o", f"iterations={RL_ITERATIONS}",
                      "-o", f"rl_update_epochs={RL_EPOCHS}",
                      "-o", f"rl_num_minibatches={RL_MINIBATCHES}",
                      "-o", f"eval_envs={RL_EVAL_ENVS}", "-o", f"eval_steps={RL_EVAL_STEPS}")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {"rl_finetune": read_counts()}
        check(Path(out["actor_checkpoint"]).is_dir(), "rl_finetune wrote no actor checkpoint")
    hist = out["history"]
    check(len(hist) == RL_ITERATIONS and all(math.isfinite(v) for h in hist for v in h.values()),
          f"rl_finetune: non-finite PPO metrics {hist}")
    for who in ("before", "after"):
        check(out[who]["env_steps"] == RL_EVAL_ENVS * RL_EVAL_STEPS
              and math.isfinite(out[who]["driving_score"]), f"rl_finetune {who}: {out[who]}")
    want_b = 1 + RL_ITERATIONS * RL_STEPS + 2 * (RL_EVAL_STEPS + 1)
    got = launches["rl_finetune"]
    check(got["B"] == want_b, f"rl_finetune: kernel B launched {got['B']} times, "
          f"the code implies {want_b}")
    check(got["A"] + got["A-tex"] + got["C"] + got["D"] == 0,
          f"rl_finetune launched a kernel it does not run: {got}")
    steps_per_update = RL_EPOCHS * RL_MINIBATCHES
    iters = []
    for h in hist:
        row = {"iteration": h["iteration"], "rollout_s": h["rollout_seconds"],
               "update_s": h["update_seconds"], "env_steps_per_s": h["env_steps_per_sec"],
               "ms_per_minibatch_step": h["update_seconds"] / steps_per_update * 1e3,
               "reward_per_step": h["reward_per_step"], "approx_kl": h["approx_kl"],
               "entropy": h["entropy"], "clip_frac": h["clip_frac"]}
        iters.append(row)
        log(f"ppo iter {row['iteration']}: rollout {row['rollout_s']:.3f} s, update "
            f"{row['update_s']:.3f} s ({row['ms_per_minibatch_step']:.2f} ms a minibatch step), "
            f"{row['env_steps_per_s']:.0f} env-steps/s, reward/step {row['reward_per_step']:+.4f}")
    res["rl_finetune"] = {
        "n_envs": RL_ENVS, "rollout_steps": RL_STEPS, "iterations": RL_ITERATIONS,
        "minibatch_windows": RL_ENVS * RL_STEPS // RL_MINIBATCHES,
        "eval": [RL_EVAL_ENVS, RL_EVAL_STEPS], "run_seconds": run_s, "iterations_detail": iters,
        "before": out["before"]["driving_score"], "after": out["after"]["driving_score"],
        "score_delta": out["score_delta"], "launches": got, "launches_b_expected": want_b}
    if profile:
        res["rl_finetune"]["update_profile"] = profile_ppo_update(params, town, rcfg, dev)

    # b. one PPO minibatch step, card and CPU against float64
    gen = torch.Generator().manual_seed(8)
    cross = {}
    for family in ("discrete", "continuous"):
        cont = family == "continuous"
        batch = ppo_step_inputs(params, town, dev, cont, gen)
        r = step_card_vs_cpu(f"ppo_{family}_card_vs_cpu", rl.ppo_loss_fn(rl.PPOConfig()),
                             batch, dev, require_clip=False,
                             model_fn=lambda dtype, c=cont: rl.ActorCriticCNN(dtype=dtype,
                                                                             continuous=c))
        cross[family] = {k: r[k] for k in (
            "loss_rel_err_card", "loss_rel_err_cpu", "grad_max_rel_err_card",
            "grad_max_rel_err_cpu", "params_off_card", "params_off_cpu", "grad_norm")}
    res["ppo_card_vs_cpu"] = cross

    # c. the shield
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ev = cli_run("closed_loop_eval", "--checkpoint", str(checkpoint), "-o", "safety_shield=true",
                 "-o", f"n_envs={SHIELD_ENVS}", "-o", f"n_steps={SHIELD_STEPS}")
    torch.cuda.synchronize()
    launches["closed_loop_eval_shield"] = read_counts()
    pm, em = ev["policy"], ev["expert"]
    check(pm["shield_active_frac"] > 0 and (pm["shield_interventions_per_km"] or 0) > 0,
          f"shielded closed_loop_eval: no intervention ({pm['shield_active_frac']})")
    check(not any(k.startswith("shield_") for k in em), "the expert's rollout was shielded")
    check(launches["closed_loop_eval_shield"]["B"] == 2 * (SHIELD_STEPS + 1),
          "shielded closed_loop_eval did not render every step with kernel B")
    model = PolicyCNN().to(dev)
    model.load_state_dict(restore_params(checkpoint, model.state_dict()))

    @torch.no_grad()
    def argmax_policy(obs):
        return model(obs).argmax(-1)

    first = []
    carry0 = None
    for sh in (ShieldConfig(), None):
        init_fn, rollout_fn = make_rollout(params, town, rcfg, argmax_policy, device=dev,
                                           shield=sh)
        if carry0 is None:
            carry0 = init_fn(torch.Generator().manual_seed(31), SHIELD_ENVS)
            carry0 = (_face_agent(carry0[0], town, 0, 6.0, 8.0),) + carry0[1:]
        _, traj = rollout_fn(carry0, 1)
        first.append(traj)
    check(bool(first[0]["shield"][0].any()), "the shield did not act on the first step")
    check(torch.equal(first[0]["action"], first[1]["action"]),
          "the shield changed the recorded labels")
    on = first[0]["shield"][0]
    check(bool((first[0]["brake"][0][on] == 1.0).all() and (first[0]["throttle"][0][on] == 0.0)
               .all()) and torch.equal(first[0]["steer"], first[1]["steer"]),
          "the shield's executed control is not full brake with the steer unchanged")
    pool = rollout_spawn_pool(params, town.to(cpu))
    masks = []

    def full_throttle(obs):
        return torch.full((obs.shape[0],), 7, dtype=torch.int64, device=obs.device)

    for d in (dev, cpu):
        init_fn, rollout_fn = make_rollout(params, town, rcfg, full_throttle, spawn_pool=pool,
                                           device=d, shield=ShieldConfig())
        states, framebuf, just_reset = init_fn(torch.Generator().manual_seed(32),
                                               SHIELD_CROSS_ENVS)
        carry = (_face_agent(states, town.to(d), 0, 6.0, 8.0), framebuf, just_reset)
        _, traj = rollout_fn(carry, SHIELD_CROSS_STEPS)
        masks.append((traj["shield"].cpu(), traj["speed"].cpu()))
    check(torch.equal(masks[0][0], masks[1][0]), "the shield's mask differs on the card and CPU")
    res["shield"] = {
        "closed_loop_eval": {"n_envs": SHIELD_ENVS, "steps": SHIELD_STEPS,
                             "policy_driving_score": pm["driving_score"],
                             "expert_driving_score": em["driving_score"],
                             "interventions_per_km": pm["shield_interventions_per_km"],
                             "active_frac": pm["shield_active_frac"],
                             "policy_collisions_per_km": pm["collisions_per_km"],
                             "launches": launches["closed_loop_eval_shield"]},
        "first_step_interventions": int(first[0]["shield"][0].sum()),
        "card_vs_cpu": {"envs": SHIELD_CROSS_ENVS, "steps": SHIELD_CROSS_STEPS,
                        "interventions": int(masks[0][0].sum()),
                        "speed_max_abs_diff": float((masks[0][1] - masks[1][1]).abs().max())}}
    del first, model

    # d. the LIDAR channel
    torch.cuda.synchronize()
    reset_counts()
    rates = {}
    for beams in (0, LIDAR_BEAMS):
        init_fn, rollout_fn = make_rollout(params, town, rcfg, None, device=dev,
                                           lidar_beams=beams)
        carry = init_fn(torch.Generator().manual_seed(41), N_ENVS)
        carry, deltas = marginal(rollout_fn, carry, LIDAR_SHORT, LIDAR_LONG, LIDAR_REPEATS)
        rates[beams] = sorted(deltas)[len(deltas) // 2] * 1e3
        if beams:
            _, traj = rollout_fn(carry, 1)
            check(tuple(traj["lidar"].shape) == (1, N_ENVS, beams)
                  and bool(torch.isfinite(traj["lidar"]).all()), "lidar channel")
        del carry
    launches["lidar"] = read_counts()
    scans = []
    for d in (dev, cpu):
        states = reset_env(params, town.to(d), torch.Generator().manual_seed(42),
                           LIDAR_CROSS_ENVS)
        scans.append(make_lidar(town.to(d), n_beams=LIDAR_BEAMS)(states).cpu())
    lidar_rel = float(((scans[0] - scans[1]).abs() / scans[1]).max())
    check(lidar_rel <= 1e-5, f"lidar card vs CPU: {lidar_rel:.3e} relative")
    res["lidar"] = {"n_envs": N_ENVS, "beams": LIDAR_BEAMS,
                    "ms_per_step_without": rates[0], "ms_per_step_with": rates[LIDAR_BEAMS],
                    "scan_ms_per_step": rates[LIDAR_BEAMS] - rates[0],
                    "card_vs_cpu_max_rel": lidar_rel,
                    "hits_below_range": float((scans[0] < 60.0).float().mean())}

    # e. the space-to-depth stem
    torch.manual_seed(0)
    std32 = PolicyCNN(dtype=torch.float32).to(dev).eval()
    s2d32 = PolicyCNN(dtype=torch.float32, s2d_stem=True).to(dev).eval()
    s2d32.load_state_dict(convert_params_to_s2d(std32.state_dict()))
    x = torch.randint(0, 256, (S2D_BATCH, HW, HW, 4), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(9)).to(dev).float() / 255
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            f32_err = float((s2d32(x) - std32(x)).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    std16, s2d16 = PolicyCNN().to(dev).eval(), PolicyCNN(s2d_stem=True).to(dev).eval()
    std16.load_state_dict(std32.state_dict())
    s2d16.load_state_dict(s2d32.state_dict())
    with torch.no_grad():
        ref = std16(x)
        bf16_err = float((s2d16(x) - ref).abs().max())
        scale = float(ref.abs().max())
        ms = {"standard": cuda_ms(lambda: std16(x), reps=S2D_REPS),
              "s2d": cuda_ms(lambda: s2d16(x), reps=S2D_REPS)}
    check(f32_err <= 1e-4, f"s2d stem fp32 logits off the standard stem's by {f32_err:.3e}")
    check(bf16_err <= 0.02 * scale, f"s2d stem bf16 logits off by {bf16_err:.3e} "
          f"(largest |logit| {scale:.3e})")
    res["s2d_stem"] = {"batch": S2D_BATCH, "hw": HW, "fp32_max_abs_err": f32_err,
                       "bf16_max_abs_err": bf16_err, "bf16_logit_scale": scale,
                       "forward_ms_bf16": ms}
    log(f"s2d stem: bf16 forward {ms['s2d']:.3f} ms vs standard {ms['standard']:.3f} ms at "
        f"{S2D_BATCH} × {HW}²; max|d| fp32 {f32_err:.2e}, bf16 {bf16_err:.2e}")
    del x, std16, s2d16, std32, s2d32

    total = {k: sum(c[k] for c in launches.values()) for k in counters()}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"rl_safety": res}))
    torch.cuda.empty_cache()
    return total


def profile_ppo_update(params, town, rcfg, dev) -> dict:
    """torch.profiler over one PPO update (RL_EPOCHS × RL_MINIBATCHES
    steps) on a rollout of RL_ENVS × RL_STEPS of a fresh bf16 actor:
    launches, device busy ms and idle share of the update's host-clock
    window, by kernel group (``profile_train_step``)."""
    import torch

    from carla_imitation_learning_tpu_torch.training import rl
    from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state,
    )

    cfg = rl.PPOConfig()
    state = create_train_state(rl.ActorCriticCNN(), AdamConfig(
        schedule=lambda c: cfg.learning_rate, clip=cfg.max_grad_norm),
        generator=torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    init_fn, rollout_fn = make_rollout(params, town, rcfg, rl.make_actor(state.model), device=dev,
                                       policy_rng=gen)
    carry, traj = rollout_fn(init_fn(torch.Generator().manual_seed(0), RL_ENVS), RL_STEPS,
                             policy_params=state.model)
    update = rl.make_ppo_update(state, cfg)
    last = rl.bootstrap_value(state.model, carry)
    prof = profile_train_step(lambda st, order: update(traj, last, gen), state,
                              range(RL_EPOCHS * RL_MINIBATCHES))
    del traj
    return {k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                 "device_idle_share", "device_launches_per_step", "groups")}


def seq_wm_phase(dev) -> dict:
    """Phase 6i: the sequence, world-model and ViT families (``seq_wm``),
    through the CLI at the presets' widths, counts reset just before each
    run and kernel B's launches checked against the rollouts each run makes
    (a rollout of n steps launches B n + 1 times: its first frame and every
    step); no other kernel runs.

    a. ``run bc_rnn`` (32 envs × SEQ_RNN_STEPS of the preset's 300 steps,
       sequences of 8, batch 64, hidden 128, closed loop 64 ×
       SEQ_RNN_EVAL_STEPS of its 200 with the hidden state in the rollout's
       carry); ``run world_model_imagine`` (its
       fit, then 8 envs × 9 steps imagined 8 steps ahead); ``run
       dream_policy`` (16 envs × SEQ_DREAM_STEPS of its 200 steps, GRU, 5
       reward heads, 300 reward steps, 400 latent-BC steps,
       SEQ_DREAM_UPDATES of its 300 imagination updates at batch 128 and
       horizon 15, three evaluations at 32 × SEQ_DREAM_EVAL_STEPS of its
       150) and its continuous family at a
       smaller depth (SEQ_CONT_STEPS steps, SEQ_CONT_UPDATES updates,
       evaluations of SEQ_CONT_EVAL_STEPS steps); ``run collect_data`` of
       an expert log at SEQ_VIT_ENVS × SEQ_VIT_STEPS, ``run split_folders``
       and ``run bc -o experiment=bc_vit`` on it at 128² (patch 16, dim 192,
       depth 4, heads 3; the 16² position grid resized to 8² with
       antialiasing), then ``closed_loop_eval`` of its checkpoint and of the
       untrained ViT. Every fit runs SEQ_EPOCHS epochs of at most
       SEQ_BATCHES batches (the ViT SEQ_VIT_EPOCHS at batch SEQ_VIT_BATCH);
       each metric is finite, the train loss of ``bc_rnn`` and of the ViT
       falls (the world models' reconstruction loss is held in 6l), scores lie in
       [0, 1] and the trained ViT agrees with the expert in its closed
       loop more often than the untrained ViT does (in this town the
       untrained ViT's near-constant action outscores the expert, 0.66
       against 0.58 at 64 × 200 on an H100, so the score cannot tell them
       apart);
    b. one fp32 step (TF32 off) on the card and on the CPU, each against
       float64 (``step_card_vs_cpu``): ``RecurrentPolicy`` on sequences and
       ``LatentWorldModel`` with the LSTM and the GRU; ``RecurrentPolicy.step``
       looped against the sequence on the card; one imagination update
       (``imagination_card_vs_cpu``); the ViT's forward at 128²
       (``vit_card_vs_cpu``);
    c. each model's bf16 train step alone at its preset's batch
       (``time_train_step`` with the SEQ_TIMED counts), ms per
       imagination update at the
       dream_policy preset's shape, and the recurrent rollout's marginal
       env-steps/s at N_ENVS envs.
    Prints one ``seq_wm`` line; → the launch counts of part (a) and of the
    recurrent rollout."""
    import math

    import torch

    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.models import (
        LatentWorldModel, RecurrentPolicy, ViTPolicy,
    )
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.training import losses
    from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
    from carla_imitation_learning_tpu_torch.training.steps import flax_init_

    t_phase = time.perf_counter()
    res: dict = {"card": nvidia_smi(), "runs": {}}
    launches: dict = {}
    pre = {n: compose("config", overrides=[f"experiment={n}"])
           for n in ("bc_rnn", "world_model_imagine", "dream_policy")}

    def counted(label: str, want_b: int, *argv) -> dict:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = cli_run(*argv)
        torch.cuda.synchronize()
        got = launches[label] = read_counts()
        check(got["B"] == want_b,
              f"{label}: kernel B launched {got['B']} times, the code implies {want_b}")
        check(got["A"] + got["A-tex"] + got["C"] + got["D"] == 0,
              f"{label} launched a kernel it does not run: {got}")
        res["runs"][label] = {"seconds": time.perf_counter() - t0, "launches_b": got["B"]}
        return out

    def falls(label: str, history: list, key: str = "train_loss") -> None:
        first, last = history[0][key], history[-1][key]
        check(all(math.isfinite(v) for row in history for v in row.values()) and last < first,
              f"{label}: {key} {first} → {last} (not finite or not falling)")
        res["runs"][label][key] = [first, last]

    def score(label: str, m: dict, envs: int, steps: int) -> float:
        check(m["env_steps"] == envs * steps and 0.0 <= m["driving_score"] <= 1.0,
              f"{label}: {m['env_steps']} env-steps, score {m['driving_score']}")
        return m["driving_score"]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as tmp:
        base = ("-o", f"log_dir={tmp}/logs", "-o", f"data_dir={tmp}/data",
                "-o", f"NUM_EPOCHS={SEQ_EPOCHS}",
                "-o", f"trainer.limit_train_batches={SEQ_BATCHES}")
        # a. the five presets through the CLI
        out = counted("bc_rnn", SEQ_RNN_STEPS + 1 + SEQ_RNN_EVAL_STEPS + 1,
                      "-o", "experiment=bc_rnn", *base, "-o", f"n_steps={SEQ_RNN_STEPS}",
                      "-o", f"eval_steps={SEQ_RNN_EVAL_STEPS}")
        falls("bc_rnn", out["history"])
        res["runs"]["bc_rnn"]["closed_loop"] = score("bc_rnn", out["closed_loop"],
                                                     pre["bc_rnn"]["eval_envs"],
                                                     SEQ_RNN_EVAL_STEPS)
        res["runs"]["bc_rnn"]["test_accuracy"] = out["test"]["test_accuracy"]
        p = pre["world_model_imagine"]
        out = counted("world_model_imagine", p["n_steps"] + 1 + p["horizon"] + 2,
                      "-o", "experiment=world_model_imagine", *base)
        check(len(out["mse_per_step"]) == p["horizon"]
              and all(math.isfinite(v) for v in out["mse_per_step"])
              and all(-1.0 <= v <= 1.0 for v in out["ssim_per_step"])
              and Path(out["strip_path"]).is_file(), f"world_model_imagine: {out}")
        res["runs"]["world_model_imagine"].update(
            {k: out[k] for k in ("mse_per_step", "ssim_per_step", "train_val_loss")})
        p = pre["dream_policy"]
        for label, n_steps, eval_steps, extra in (
                ("dream_policy", SEQ_DREAM_STEPS, SEQ_DREAM_EVAL_STEPS,
                 ("-o", f"n_steps={SEQ_DREAM_STEPS}", "-o", f"imag_updates={SEQ_DREAM_UPDATES}",
                  "-o", f"eval_steps={SEQ_DREAM_EVAL_STEPS}")),
                ("dream_policy_continuous", SEQ_CONT_STEPS, SEQ_CONT_EVAL_STEPS,
                 ("-o", "policy_family=continuous", "-o", f"n_steps={SEQ_CONT_STEPS}",
                  "-o", f"imag_updates={SEQ_CONT_UPDATES}",
                  "-o", f"eval_steps={SEQ_CONT_EVAL_STEPS}"))):
            out = counted(label, n_steps + 1 + 3 * (eval_steps + 1),
                          "-o", "experiment=dream_policy", *base, *extra)
            hist = out["imagination"]
            check(all(math.isfinite(v) for h in hist for v in h.values())
                  and all(math.isfinite(v) for v in out["reward_head_mse"] + out["latent_bc_loss"]),
                  f"{label}: non-finite training metrics")
            res["runs"][label].update({
                who: score(f"{label} {who}", out[who], p["eval_envs"], eval_steps)
                for who in ("eval", "latent_bc_eval", "expert")})
            res["runs"][label].update({
                "imagined_return": [out["imagined_return_first"], out["imagined_return_last"]],
                "reward_head_mse": [out["reward_head_mse"][0], out["reward_head_mse"][-1]],
                "latent_bc_loss": [out["latent_bc_loss"][0], out["latent_bc_loss"][-1]],
                "wm_val_loss": out["wm_val_loss"]})
        # the ViT learns from an expert log on disk, as a user's bc does
        vit = (*base, "-o", "train_logs=['SimLog1']", "-o", f"image_height={HW}",
               "-o", f"image_width={HW}")
        counted("collect_vit", SEQ_VIT_STEPS + 1, "collect_data", *vit,
                "-o", f"n_envs={SEQ_VIT_ENVS}", "-o", f"n_steps={SEQ_VIT_STEPS}")
        cli_run("split_folders", *vit)
        out = counted("bc_vit", 0, "-o", "experiment=bc_vit", *vit,
                      "-o", f"NUM_EPOCHS={SEQ_VIT_EPOCHS}",
                      "-o", f"BATCH_SIZE={SEQ_VIT_BATCH}")["camera"]
        falls("bc_vit", out["history"])
        check(math.isfinite(out["test"]["test_loss"]), f"bc_vit: test loss {out['test']}")
        res["runs"]["bc_vit"].update({k: out["test"][k] for k in ("test_loss", "test_accuracy")})
        for label, ckpt in (("closed_loop_eval_vit", ("--checkpoint", out["best_path"])),
                            ("closed_loop_eval_vit_untrained", ())):
            ev = counted(label, 2 * (SEQ_VIT_EVAL_STEPS + 1), "closed_loop_eval", *ckpt,
                         "-o", "policy_arch=vit", "-o", f"n_envs={SEQ_VIT_ENVS}",
                         "-o", f"n_steps={SEQ_VIT_EVAL_STEPS}")
            res["runs"][label].update({
                who: score(f"{label} {who}", ev[who], SEQ_VIT_ENVS, SEQ_VIT_EVAL_STEPS)
                for who in ("policy", "expert")})
            res["runs"][label]["action_agreement"] = ev["policy"]["action_agreement"]
        trained, untrained = (res["runs"][k]["action_agreement"] for k in
                              ("closed_loop_eval_vit", "closed_loop_eval_vit_untrained"))
        check(trained > untrained,
              f"bc_vit: the trained ViT agrees with the expert on {trained} of its closed "
              f"loop's steps, the untrained one on {untrained}")
    log(json.dumps({"seq_wm_runs": res["runs"]}))

    # b. card against CPU, each against float64
    gen = torch.Generator().manual_seed(10)
    seq = (torch.rand(SEQ_CROSS_BATCH, 8, HW, HW, 1, generator=gen),
           torch.randint(0, 9, (SEQ_CROSS_BATCH, 8), generator=gen))
    # the decoders' gradients are sums that cancel to 1e-7-1e-4 against the
    # model's largest, 1e-2: fp32 reduction order moves them by up to 2e-2
    # of their value, on the card as on the CPU (whose two convolution
    # paths differ by as much), so both CPU paths bound the card. The last
    # deconvolution's bias gradient sums 2 × 15 frames × 128² = 491,520
    # terms, whose fp32 tree sums stray by √N · 2⁻²⁴ ≈ 4e-5 of their size:
    # the world models' floor is 1e-4 of each tensor's own scale
    refs = ("cpu", "cpu_no_mkldnn")
    cross = {"rnn": step_card_vs_cpu("rnn_card_vs_cpu", losses.rnn_bc_loss_fn, seq, dev,
                                     require_clip=False, cpu_refs=refs,
                                     model_fn=lambda dt: RecurrentPolicy(dtype=dt))}
    for rnn in ("lstm", "gru"):
        cross[f"world_model_{rnn}"] = step_card_vs_cpu(
            f"world_model_{rnn}_card_vs_cpu", losses.world_model_loss_fn(), seq, dev,
            require_clip=False, cpu_refs=refs, floor=1e-4,
            model_fn=lambda dt, r=rnn: LatentWorldModel(rnn=r, height=HW, width=HW, dtype=dt))
    cross = {k: {f: v[f] for f in ("loss_rel_err_card", "loss_rel_err_cpu",
                                   "grad_max_rel_err_card", "grad_max_rel_err_cpu",
                                   "params_off_card", "params_off_cpu")}
             for k, v in cross.items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        net = flax_init_(RecurrentPolicy(dtype=torch.float32), gen).to(dev)
        frames = seq[0].to(dev)
        with torch.no_grad():
            want, h_seq = net(frames)
            h, got = net.initial_state(SEQ_CROSS_BATCH, dev), []
            for t in range(frames.shape[1]):
                h, logits = net.step(h, frames[:, t])
                got.append(logits)
        step_err = float((torch.stack(got, 1) - want).abs().max())
        check(step_err <= 1e-5 * max(1.0, float(want.abs().max()))
              and float((h - h_seq).abs().max()) <= 1e-5,
              f"RecurrentPolicy.step off the sequence by {step_err:.3e} on the card")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    cross["rnn_step_vs_sequence_max_abs_err"] = step_err
    cross["imagination"] = imagination_card_vs_cpu(dev)
    cross["vit"] = vit_card_vs_cpu(dev)
    res["card_vs_cpu"] = cross
    del net, frames

    # c. timings
    params, town = bench_fleet(dev)
    rcfg = RenderConfig(height=HW, width=HW, max_triangles=T)
    rnn_batch = (torch.rand(64, 8, HW, HW, 1, generator=gen),
                 torch.randint(0, 9, (64, 8), generator=gen))
    wm_batch = (rnn_batch[0][:16], rnn_batch[1][:16])
    vit_batch = (torch.rand(64, 256, 256, 4, generator=gen),
                 torch.randint(0, 9, (64,), generator=gen))
    res["train_step"] = {
        "RecurrentPolicy": time_train_step("RecurrentPolicy", RecurrentPolicy(),
                                           losses.rnn_bc_loss_fn, "imitation", rnn_batch, dev,
                                           SEQ_TIMED),
        "LatentWorldModel": time_train_step("LatentWorldModel (LSTM)", LatentWorldModel(
            height=HW, width=HW), losses.world_model_loss_fn(), "vae", wm_batch, dev, SEQ_TIMED),
        "ViTPolicy": time_train_step("ViTPolicy", ViTPolicy(), losses.bc_loss_fn, "imitation",
                                     vit_batch, dev, SEQ_TIMED)}
    del rnn_batch, wm_batch, vit_batch
    res["imagination_update"] = time_imagination_update(dev)

    model = flax_init_(RecurrentPolicy(), gen).to(dev)

    @torch.no_grad()
    def policy_fn(obs, h):
        h, logits = model.step(h, obs[..., -1:])
        return logits.argmax(-1), h

    torch.cuda.synchronize()
    reset_counts()
    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, device=dev,
                                       policy_carry_init=lambda b: model.initial_state(b, dev))
    carry, _ = rollout_fn(init_fn(torch.Generator().manual_seed(2), N_ENVS), SEQ_ROLL_SHORT)
    carry, deltas = marginal(rollout_fn, carry, SEQ_ROLL_SHORT, SEQ_ROLL_LONG, SEQ_ROLL_REPEATS)
    got = launches["recurrent_rollout"] = read_counts()
    want_b = 1 + SEQ_ROLL_SHORT + SEQ_ROLL_REPEATS * (SEQ_ROLL_SHORT + SEQ_ROLL_LONG)
    check(got["B"] == want_b, f"recurrent rollout: kernel B launched {got['B']} times, "
          f"the code implies {want_b}")
    check(bool(torch.isfinite(carry[3]).all()) and carry[3].dtype == torch.float32,
          "recurrent rollout: hidden state not finite float32")
    res["recurrent_rollout"] = {"n_envs": N_ENVS, "hw": HW, **rate_summary(deltas)}
    log(f"recurrent rollout: {res['recurrent_rollout']['env_steps_per_s']:.0f} env-steps/s "
        f"at {N_ENVS} envs")
    del carry, model

    total = {k: sum(c[k] for c in launches.values()) for k in counters()}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"seq_wm": res}))
    return total


def rigs_replay_phase(dev) -> dict:
    """Phase 6j: the camera rig, surround view and the episode recorder
    (``rigs_replay``). Kernels A and B run on new callers here; each is held
    bit for bit against its plain version first, on the bench town's fleet
    seen from FL, SR and RR (A at C = 3, B at 2 px LOD), and an 8-env
    rollout with 3 views on the card against the CPU (``check_against_cpu``).
    Then, counts reset just before each run and checked against what the
    code launches:

    a. ``run collect_multicamera`` at its preset's width (16 envs ×
       RIG_COLLECT_STEPS of its 200 steps, 6
       views in RGB on the exact path: A once a view a step, no B): PNG
       frames and a packed store per camera, the collection, PNG and
       packed seconds apart;
    b. ``run bc_surround`` at its preset's widths (16 × 300 collection with
       forward, FL and FR: A 3 × 300; bf16 ``PolicyCNN`` on 12 channels at
       batch 64, RIG_EPOCHS epochs of at most RIG_BATCHES batches; the
       closed loop at 64 × 200 with the rig: B 3 × 201), its train loss
       falling;
    c. ``run replay`` at its preset (16 × 120: the expert's rollout, B 121;
       two dynamics-only replays; the GIF's re-render of one env at 128² in
       RGB on the exact path, A 120), ``replay_speed_max_abs_diff`` 0.0,
       and the record it wrote loaded on the CPU and replayed there with
       the card's spawn pool, allclose to the card's replay (flags equal,
       floats within rtol 1e-5 + atol 1e-4);
    d. the surround rollout at N_ENVS envs with 3 views and a bf16
       ``PolicyCNN`` (marginal env-steps/s; B 3 × (1 + every step)), the
       ``bc_surround`` train step alone (``time_train_step``), and the
       dynamics-only replay of a N_ENVS-env record (marginal env-steps/s,
       no kernel) with the record's bytes.
    Prints one ``rigs_replay`` line; → the launch counts of a-d."""
    import math

    import torch

    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.ops import raster as ra
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_scene_setup
    from carla_imitation_learning_tpu_torch.sim.world import reset_env
    from carla_imitation_learning_tpu_torch.training import losses
    from carla_imitation_learning_tpu_torch.training import replay as rp
    from carla_imitation_learning_tpu_torch.training.closed_loop import (
        make_rollout, rollout_spawn_pool,
    )

    t_phase = time.perf_counter()
    res: dict = {"card": nvidia_smi(), "runs": {}}
    launches: dict = {}
    params, town = bench_fleet(dev)
    rcfg = RenderConfig(height=HW, width=HW, max_triangles=T)
    rows = ra.band_rows(HW)

    # kernels A and B from the side and rear views, against their plain versions
    states = reset_env(params, town, torch.Generator().manual_seed(13), N_ENVS)
    errs = {}
    for cam in RIG_CHECK_CAMERAS:
        setup = make_scene_setup(params, town, rcfg, device=dev, camera=cam)(states)
        errs[f"A_{cam}"] = check_exact(exact_args(setup, T, rcfg.near, rcfg.far, 3, rows),
                                       f"kernel A C=3 from {cam}")[0]
        errs[f"B_{cam}"] = check_fast(fast_args(setup, T, rcfg.near, rcfg.far, rows),
                                      f"kernel B from {cam}")[0]
    del states, setup
    res["kernels_vs_plain_max_abs_err"] = errs
    res["card_vs_cpu"] = check_against_cpu(params, town, rcfg, dev, cameras=RIG_CAMERAS)
    log(json.dumps({"rigs_card_vs_cpu": res["card_vs_cpu"]}))

    def counted(label: str, want: dict, *argv) -> dict:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = cli_run(*argv)
        torch.cuda.synchronize()
        got = launches[label] = read_counts()
        want = {k: want.get(k, 0) for k in got}
        check(got == want, f"{label}: launched {got}, the code implies {want}")
        res["runs"][label] = {"seconds": time.perf_counter() - t0, "launches": got}
        return out

    pre = {n: compose("config", overrides=[f"experiment={n}"])
           for n in ("collect_multicamera", "bc_surround", "replay")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rigs_") as tmp:
        base = ("-o", f"log_dir={tmp}/logs", "-o", f"data_dir={tmp}/data")
        # a. the rig's raw log
        envs, steps = pre["collect_multicamera"]["n_envs"], RIG_COLLECT_STEPS
        out = counted("collect_multicamera", {"A": 6 * steps}, "-o",
                      "experiment=collect_multicamera", *base, "-o", f"n_steps={steps}")
        sec = out["seconds"]
        check(out["frames_per_camera"] == envs * steps and len(out["framestores"]) == 6
              and all(Path(f).is_file() for f in out["framestores"].values())
              and len(list(Path(out["log"], "FL").iterdir())) == envs * steps,
              f"collect_multicamera: {out}")
        res["runs"]["collect_multicamera"].update({
            "seconds_split": sec, "env_steps_per_s": envs * steps / sec["collect"],
            "views_per_s": 6 * envs * steps / sec["collect"],
            "png_frames_per_s": 6 * envs * steps / sec["png_write"]})
        # b. surround BC
        p = pre["bc_surround"]
        cams = len(p["surround_cameras"])
        out = counted("bc_surround", {"A": cams * p["n_steps"],
                                      "B": cams * (p["eval_steps"] + 1)},
                      "-o", "experiment=bc_surround", *base, "-o", f"NUM_EPOCHS={RIG_EPOCHS}",
                      "-o", f"trainer.limit_train_batches={RIG_BATCHES}")
        first, last = out["history"][0]["train_loss"], out["history"][-1]["train_loss"]
        check(math.isfinite(last) and last < first,
              f"bc_surround: train loss {first} → {last} (not finite or not falling)")
        ev = out["eval"]
        check(ev["env_steps"] == p["eval_envs"] * p["eval_steps"]
              and 0.0 <= ev["driving_score"] <= 1.0 and out["cameras"] == p["surround_cameras"],
              f"bc_surround: eval {ev['env_steps']} env-steps, score {ev['driving_score']}")
        res["runs"]["bc_surround"].update({
            "train_loss": [first, last], "test": out["test"],
            "driving_score": ev["driving_score"], "action_agreement": ev["action_agreement"]})
        # c. record and replay
        p = pre["replay"]
        out = counted("replay", {"A": p["n_steps"], "B": p["n_steps"] + 1},
                      "-o", "experiment=replay", *base)
        check(out["replay_speed_max_abs_diff"] == 0.0 and Path(out["gif"]).is_file(),
              f"replay: {out}")
        res["runs"]["replay"].update({k: out[k] for k in (
            "env_index", "env_collisions", "replay_speed_max_abs_diff", "record_bytes")})
        rec = rp.load_record(out["record"])
        card = rp.replay_record(rec, render=False, device=dev)
        # the card's pool: a reset then draws the same row on both sides
        rparams, rtown = rp.rebuild_world(rec)
        pool = rollout_spawn_pool(rparams, rtown.to(dev)).cpu()
        cpu = rp.replay_record(rec, render=False, device="cpu", spawn_pool=pool)
        worst = 0.0
        for k, v in card.items():
            v = v.cpu()
            if v.is_floating_point():
                excess = float(((v - cpu[k]).abs() - 1e-5 * cpu[k].abs()).max())
                check(excess <= 1e-4, f"replay card vs CPU: {k} off by {excess:.3e}")
                worst = max(worst, float((v - cpu[k]).abs().max()))
            else:
                check(torch.equal(v, cpu[k]), f"replay card vs CPU: {k} differs")
        res["runs"]["replay"]["card_vs_cpu_max_abs_err"] = worst
    log(json.dumps({"rigs_replay_runs": res["runs"]}))

    # d. the surround rollout, the surround step alone, dynamics-only replay
    torch.manual_seed(0)
    model = PolicyCNN(obs_size=4 * len(RIG_CAMERAS)).to(dev).eval()

    def policy_fn(obs):
        return model(obs).argmax(-1)

    torch.cuda.synchronize()
    reset_counts()
    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, device=dev,
                                       cameras=RIG_CAMERAS)
    carry, _ = rollout_fn(init_fn(torch.Generator().manual_seed(3), N_ENVS), RIG_ROLL_SHORT)
    carry, deltas = marginal(rollout_fn, carry, RIG_ROLL_SHORT, RIG_ROLL_LONG, RIG_ROLL_REPEATS)
    got = launches["surround_rollout"] = read_counts()
    steps = 1 + RIG_ROLL_SHORT + RIG_ROLL_REPEATS * (RIG_ROLL_SHORT + RIG_ROLL_LONG)
    want = {k: len(RIG_CAMERAS) * steps if k == "B" else 0 for k in got}
    check(got == want, f"surround rollout: launched {got}, the code implies {want}")
    check(tuple(carry[1].shape) == (N_ENVS, HW, HW, 4 * len(RIG_CAMERAS)),
          "surround rollout: frame window has the wrong shape")
    res["surround_rollout"] = {"n_envs": N_ENVS, "cameras": list(RIG_CAMERAS),
                               **rate_summary(deltas)}
    log(f"surround rollout: {res['surround_rollout']['env_steps_per_s']:.0f} env-steps/s "
        f"at {N_ENVS} envs × {len(RIG_CAMERAS)} views")
    del carry, model
    gen = torch.Generator().manual_seed(14)
    batch = (torch.rand(64, HW, HW, 4 * len(RIG_CAMERAS), generator=gen),
             torch.randint(0, 9, (64,), generator=gen))
    res["train_step"] = time_train_step("bc_surround PolicyCNN (12 channels)",
                                        PolicyCNN(obs_size=4 * len(RIG_CAMERAS)),
                                        losses.bc_loss_fn, "imitation", batch, dev)
    del batch

    states = reset_env(params, town, torch.Generator().manual_seed(15), N_ENVS)
    ctrl = torch.rand(RIG_ROLL_LONG, N_ENVS, 3, generator=gen) * torch.tensor([0.6, 1.0, 0.1]) \
        - torch.tensor([0.3, 0.0, 0.0])
    rec = rp.EpisodeRecord(states0=states.to("cpu"), controls=ctrl.numpy(),
                           sim=dataclasses.asdict(params), town=dict(BENCH_TOWN),
                           render=dataclasses.asdict(rcfg), meta={"driver": "random"})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as tmp:
        res["record_bytes_fleet"] = Path(rp.save_record(Path(tmp) / "fleet.npz", rec)).stat().st_size
    replay_fn = rp.make_replay(params, town, None, device=dev)
    reset_counts()

    _, deltas = marginal(lambda st, n: replay_fn(st, ctrl[:n]), states, RIG_ROLL_SHORT,
                         RIG_ROLL_LONG, RIG_ROLL_REPEATS)
    check(sum(read_counts().values()) == 0, "dynamics-only replay launched a raster kernel")
    res["replay_dynamics"] = {"n_envs": N_ENVS, **rate_summary(deltas)}
    log(f"dynamics-only replay: {res['replay_dynamics']['env_steps_per_s']:.0f} env-steps/s "
        f"at {N_ENVS} envs; a {N_ENVS}-env × {RIG_ROLL_LONG}-step record "
        f"{res['record_bytes_fleet']} bytes")

    total = {k: sum(c[k] for c in launches.values()) for k in counters()}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"rigs_replay": res}))
    return total


def hpo_phase(dev) -> dict:
    """Phase 6l: the hyperparameter search (``hpo``) through the CLI at the
    presets, counts reset just before each run:

    a. ``run hpo`` (4 random-search trials of the BC recipe on a synthetic
       256² log, batch 64, 2 epochs) serially and 4 at a time: the trial
       configs equal and each trial's mean accuracy within rtol 1e-5;
    b. ``run hpo_vmap`` (4 rates, 2 epochs, one ``torch.func.vmap``); then
       its trainable in fp32 with both TF32 flags off: trial HPO_CROSS_TRIAL
       of the vmapped sweep against the same trial trained alone on the
       card and on the CPU (``trial_gap``), and in bf16 the vmapped sweep
       against its four trials one after another (wall s, median of
       HPO_TIMED_REPEATS; launches and idle share from a profiled run of
       each);
    c. ``run hpo_pbt`` (8 members, 4 generations): for every generation
       but the last, ``exploit_explore`` on its recorded scores and rates
       with the run's explore key, on the card and on the CPU: the members
       copied and the perturbed rates bit for bit equal, and equal to the
       run's next generation;
    d. ``run world_model_sweep`` (16 envs × 128 steps a trial, 4 at a
       time; latent sizes HPO_WM_Z × LSTM and GRU × HPO_WM_LOSSES, fits
       cut to HPO_WM_EPOCHS epochs of at most HPO_WM_BATCHES batches): no
       trial fails, each trial's reconstruction loss falls and its model is
       the trial's (z, RNN, loss); kernel B exactly 129 times a trial (its
       collection: the first frame and 128 steps).
    a-c launch no kernel. Prints one ``hpo`` line with the sweep's table
    beside the JAX package's TPU table (``reports/wm_sweep_results.json``);
    → the launch counts of each run."""
    import math

    import torch

    from carla_imitation_learning_tpu_torch import experiments as ex
    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.parallel import hpo
    from carla_imitation_learning_tpu_torch.sim import prng

    t_phase = time.perf_counter()
    res: dict = {"card": nvidia_smi(), "runs": {}}
    launches: dict = {}

    def counted(label: str, want_b: int, *argv) -> dict:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = cli_run(*argv)
        torch.cuda.synchronize()
        got = launches[label] = read_counts()
        check(got["B"] == want_b and sum(got.values()) == want_b,
              f"{label}: kernels launched {got}, the code implies B {want_b} and nothing else")
        res["runs"][label] = {"seconds": time.perf_counter() - t0, "launches_b": got["B"]}
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_hpo_") as tmp:
        data = ("-o", f"data_dir={tmp}/data")
        # a. hpo, serially and concurrently
        trials = {}
        for label, conc in (("hpo_serial", 1), ("hpo_concurrent", 4)):
            out = counted(label, 0, "-o", "experiment=hpo", *data, "-o", f"log_dir={tmp}/{label}",
                          "-o", f"max_concurrent={conc}")
            check(out["n_trials"] == 4 and out["n_failed"] == 0, f"{label}: {out}")
            trials[label] = json.loads(Path(tmp, label, "hpo", "trials.json").read_text())
        serial, conc = trials["hpo_serial"], trials["hpo_concurrent"]
        check([t["config"] for t in serial] == [t["config"] for t in conc],
              "hpo: the concurrent sweep's trial configs differ from the serial one's")
        for a, b in zip(serial, conc):
            x, y = a["metrics"]["mean_accuracy"], b["metrics"]["mean_accuracy"]
            check(abs(x - y) <= 1e-5 * abs(y),
                  f"hpo trial {a['trial_id']}: serial accuracy {x}, concurrent {y}")
        res["hpo"] = {"trials": [{**t["config"], **t["metrics"]} for t in conc],
                      "serial_s": res["runs"]["hpo_serial"]["seconds"],
                      "concurrent_s": res["runs"]["hpo_concurrent"]["seconds"]}

        # b. hpo_vmap, then its trainable: one trial vmapped, alone, on the CPU
        out = counted("hpo_vmap", 0, "-o", "experiment=hpo_vmap", *data,
                      "-o", f"log_dir={tmp}/vmap")
        check(len(out["accuracies"]) == 4 and all(math.isfinite(v) for v in out["val_losses"]),
              f"hpo_vmap: {out}")
        res["hpo_vmap"] = {k: out[k] for k in ("lrs", "accuracies", "val_losses", "best_lr")}
        res["hpo_vmap"].update(hpo_vmap_checks(dev, f"{tmp}/data"))

        # c. hpo_pbt, and its selections on the card against the CPU
        out = counted("hpo_pbt", 0, "-o", "experiment=hpo_pbt", *data, "-o", f"log_dir={tmp}/pbt")
        hist = json.loads(Path(out["history_path"]).read_text())
        pre = compose("config", overrides=["model=imitation", "experiment=hpo_pbt"])
        population = int(pre["population"])
        check(len(hist) == int(pre["generations"]) and out["population"] == population,
              f"hpo_pbt: {len(hist)} generations of {out['population']}")
        key = prng.key(int(pre.get("seed", 0)))
        copied = []
        for g in range(len(hist) - 1):
            key, _, k_explore = prng.split(key, 3).unbind(0)
            scores = torch.tensor(hist[g]["mean_accuracy"], dtype=torch.float32)
            h = torch.tensor(hist[g]["hparams"], dtype=torch.float32)
            picks = []
            for d in (dev, torch.device("cpu")):
                _, new_h, src = hpo.exploit_explore(
                    {"member": torch.arange(population, device=d)}, h.to(d), scores.to(d),
                    k_explore.to(d), max(1, int(population * 0.25)))
                picks.append((src.cpu(), new_h.cpu(),
                              prng.uniform(k_explore.to(d), (population,)).cpu()))
            (src_card, h_card, u_card), (src_cpu, h_cpu, u_cpu) = picks
            check(torch.equal(src_card, src_cpu) and torch.equal(h_card, h_cpu)
                  and torch.equal(u_card, u_cpu),
                  f"hpo_pbt generation {g}: exploit/explore differs card vs CPU")
            check(torch.equal(h_card, torch.tensor(hist[g + 1]["hparams"], dtype=torch.float32)),
                  f"hpo_pbt generation {g}: the recomputed rates differ from the run's")
            copied.append(src_card.tolist())
        res["hpo_pbt"] = {k: out[k] for k in ("mean_accuracy_per_gen", "final_lrs", "best_lr",
                                              "best_accuracy")}
        res["hpo_pbt"]["copied_from"] = copied

        # d. world_model_sweep, every trial's fit recorded as it returns
        wm = compose("config", overrides=["experiment=world_model_sweep"])
        n_trials = 2 * len(HPO_WM_Z) * len(HPO_WM_LOSSES)
        with Capture(ex, "world_model",
                     lambda a, k, r: (k, r["history"], r["wm_config"])) as cap:
            out = counted("world_model_sweep", n_trials * (int(wm["n_steps"]) + 1),
                          *wm_sweep_args(f"{tmp}/data", f"{tmp}/wm"))
        check(out["n_trials"] == n_trials and out["n_failed"] == 0
              and len(cap.calls) == n_trials,
              f"world_model_sweep: {out['n_trials']} trials, {out['n_failed']} failed")
        for k, history, cfg in cap.calls:
            label = f"world_model_sweep {k['rnn']} z {k['z_size']} {k['image_loss']}"
            first, last = history[0]["train_recon_loss"], history[-1]["train_recon_loss"]
            check(all(math.isfinite(v) for row in history for v in row.values()) and last < first,
                  f"{label}: train_recon_loss {first} → {last} (not finite or not falling)")
            check((cfg["z_size"], cfg["rnn"], cfg["image_loss"], cfg["height"])
                  == (k["z_size"], k["rnn"], k["image_loss"], int(wm.get_dotted("render.height"))),
                  f"{label}: {cfg}")
        tpu = json.loads((ROOT / "reports" / "wm_sweep_results.json").read_text())
        res["world_model_sweep"] = {
            "table": out["table"], "best_config": out["best_config"],
            "best_metrics": out["best_metrics"],
            "tpu_table": [r for r in tpu["table"]
                          if r["z"] in HPO_WM_Z and r["loss"] in HPO_WM_LOSSES],
            "tpu_best_config": tpu["best_config"], "z_sizes": HPO_WM_Z,
            "losses": HPO_WM_LOSSES,
            "epochs": HPO_WM_EPOCHS, "batches_per_epoch": HPO_WM_BATCHES}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"hpo": res}))
    return {k: sum(c[k] for c in launches.values()) for k in counters()}


def trial_gap(stacked: dict, i: int, other: dict, lr: float) -> dict:
    """Trial ``i`` of a stacked ``_bc_vmap_trainable`` state against the
    state ``other`` of the same trial: Adam's moments' largest gap as a
    share of each tensor's largest moment (``moments_rel``), the
    parameters' largest gap beyond rtol 1e-4 in steps of size ``lr``
    (``params_steps``) and the share of parameters more than 2e-2 of a step
    apart (``params_far_share``)."""
    moments, steps, far, n = 0.0, 0.0, 0, 0
    for k, want in other["params"].items():
        want = want.cpu()
        gap = ((stacked["params"][k][i].cpu() - want).abs() - 1e-4 * want.abs()) / lr
        steps = max(steps, float(gap.max()))
        far += int((gap > 2e-2).sum())
        n += want.numel()
        for m in ("mu", "nu"):
            x, y = stacked["opt"][m][k][i].cpu(), other["opt"][m][k].cpu()
            moments = max(moments, float((x - y).abs().max() / y.abs().max().clamp_min(1e-30)))
    return {"moments_rel": moments, "params_steps": steps, "params_far_share": far / n}


def first_step_grads_f64(data_dir: str, params: dict) -> dict:
    """The gradient of ``_bc_vmap_trainable``'s first step (the first batch
    of the train split in order, the cross-entropy of a ``PolicyCNN`` at
    ``params``) in float64 on the CPU."""
    import numpy as np
    import torch
    from torch.func import functional_call, grad

    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.data import pipeline as pipe
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.losses import cross_entropy

    cfg = compose("config", overrides=["model=imitation", "experiment=hpo_vmap",
                                       f"data_dir={data_dir}", "camera=camera"])
    ds = pipe.sequential_train_val_test_iterator(cfg, device="cpu")["train_dataloader"]
    x, y = ds.make_batch(np.arange(min(ds.batch_size, ds.n_samples)))
    with torch.device("meta"):
        net = PolicyCNN(obs_size=int(cfg["obs_size"]), n_actions=int(cfg["n_actions"]),
                        dtype=torch.float64)
    p64 = {k: v.detach().cpu().double() for k, v in params.items()}
    return grad(lambda p: cross_entropy(functional_call(net, p, (x.double(),)), y))(p64)


def wm_sweep_args(data_dir: str, log_dir: str, max_concurrent: int | None = None) -> tuple:
    """``cli_run`` arguments of the phase's cut ``world_model_sweep``."""
    extra = ("-o", f"max_concurrent={max_concurrent}") if max_concurrent else ()
    return ("-o", "experiment=world_model_sweep", "-o", f"data_dir={data_dir}",
            "-o", f"log_dir={log_dir}", "-o", f"z_sizes={list(HPO_WM_Z)}",
            "-o", f"losses={list(HPO_WM_LOSSES)}",
            "-o", f"NUM_EPOCHS={HPO_WM_EPOCHS}",
            "-o", f"trainer.limit_train_batches={HPO_WM_BATCHES}", *extra)


def hpo_vmap_checks(dev, data_dir: str) -> dict:
    """``hpo_vmap``'s trainable on the synthetic log in ``data_dir``, in fp32
    with TF32 off: trial HPO_CROSS_TRIAL of the vmapped sweep against the
    same trial trained alone on the card and on the CPU (its convolutions
    without oneDNN, whose fp32 gradients on the card's machine are 1e-3 of
    scale off float64; the native ones 1e-6), from one initial state (each
    trial's weights are drawn on the CPU), for one epoch (one step at the
    preset's 120 frames) and for the preset's epochs. Adam moves a weight
    by about lr · sign(g) early on, so a gradient within rounding of zero
    steps either way, and the flipped weights then move every later
    gradient. So the gradient is compared after one step, through Adam's
    moments (0.1 · g and 0.001 · g²): the trial alone within 1e-4 of each
    tensor's scale (the same convolutions, batched or not), the CPU within
    1e-2 (a convolution's weight gradient sums some 10⁵ products that
    cancel, so fp32 rounding in another reduction order shows at 1e-3 of
    the scale; each side's error against the same gradient in float64 is
    recorded), and at most 1 % of the parameters more than 2e-2 of a step
    apart; at both depths the validation loss within rtol 1e-4 and no
    parameter more than 2 steps apart a step taken (``trial_gap``). In
    bf16, the vmapped sweep against its trials one after another, timed
    and profiled."""
    import inspect

    import torch
    from torch.func import vmap

    from carla_imitation_learning_tpu_torch import experiments as ex
    from carla_imitation_learning_tpu_torch.config import compose
    from carla_imitation_learning_tpu_torch.parallel import hpo
    from carla_imitation_learning_tpu_torch.sim import prng

    sig = inspect.signature(ex.hpo_vmap).parameters
    lrs, epochs = sig["lrs"].default, sig["epochs"].default
    i = HPO_CROSS_TRIAL

    def trainable(device: str, dtype: str, n_epochs: int = epochs):
        cfg = compose("config", overrides=["model=imitation", "experiment=hpo_vmap",
                                           f"data_dir={data_dir}", f"device={device}",
                                           f"compute_dtype={dtype}"])
        return ex._bc_vmap_trainable(cfg, n_epochs)

    def trial(states, j):
        return hpo.tree_map(lambda x: x[j], states)

    lr_card, lr_cpu = torch.tensor(lrs, device=dev), torch.tensor(lrs)
    out: dict = {"cross_trial_lr": lrs[i], "gaps": {}, "grad_rel_err_f64": {}}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for n_epochs in (1, epochs):
            init_card, train_card = trainable(dev.type, "float32", n_epochs)
            init_cpu, train_cpu = trainable("cpu", "float32", n_epochs)
            states = hpo.init_trials(init_card, lr_card, prng.key(0))
            vmapped, m_vmapped = vmap(train_card)(states, lr_card)
            alone, m_alone = train_card(trial(states, i), lr_card[i])
            with torch.backends.mkldnn.flags(enabled=False):
                cpu, m_cpu = train_cpu(trial(hpo.init_trials(init_cpu, lr_cpu, prng.key(0)), i),
                                       lr_cpu[i])
            taken = int(vmapped["opt"]["count"][i])
            want_loss = float(m_vmapped["val_loss"][i])
            if n_epochs == 1:
                g64 = first_step_grads_f64(data_dir, trial(states, i)["params"])
                for label, mu in (("card", trial(vmapped, i)["opt"]["mu"]),
                                  ("cpu", cpu["opt"]["mu"])):
                    out["grad_rel_err_f64"][label] = max(
                        float((mu[k].cpu().double() / 0.1 - g).abs().max() / g.abs().max())
                        for k, g in g64.items())
            for label, other, m in (("alone", alone, m_alone), ("cpu", cpu, m_cpu)):
                gap = trial_gap(vmapped, i, other, lrs[i])
                gap.update(steps=taken, val_loss=float(m["val_loss"]),
                           val_loss_rel=abs(float(m["val_loss"]) - want_loss) / abs(want_loss))
                out["gaps"][f"{label}_{n_epochs}_epochs"] = gap
            del states, vmapped, alone, cpu
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(json.dumps({"hpo_vmap_fp32_gaps": out["gaps"],
                    "grad_rel_err_f64": out["grad_rel_err_f64"]}))
    for key, gap in out["gaps"].items():
        check(gap["val_loss_rel"] <= 1e-4 and gap["params_steps"] <= 2 * gap["steps"],
              f"hpo_vmap trial {i}: vmapped vs {key}: {gap}")
        if key.endswith("_1_epochs"):
            bound = 1e-4 if key.startswith("alone") else 1e-2
            check(gap["steps"] == 1 and gap["moments_rel"] <= bound
                  and gap["params_far_share"] <= 1e-2,
                  f"hpo_vmap trial {i}: vmapped vs {key} after one step: {gap}")

    # bf16, the preset's dtype: the vmapped sweep against its trials in turn
    init_b, train_b = trainable(dev.type, "bfloat16")
    states = hpo.init_trials(init_b, lr_card, prng.key(0))
    runs = {"vmapped": lambda: vmap(train_b)(states, lr_card),
            "serial": lambda: [train_b(trial(states, j), lr_card[j]) for j in range(len(lrs))]}
    for label, fn in runs.items():
        fn()
        walls = []
        for _ in range(HPO_TIMED_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[len(walls) // 2]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        summary = device_summary(prof, wall, 1)
        out[f"{label}_bf16"] = {"wall_s": wall, "wall_s_runs": walls,
                                "device_busy_ms": summary["device_busy_ms"],
                                "launches": summary["device_launches"],
                                "idle_share": summary["device_idle_share"]}
    log(f"hpo_vmap: vmapped {out['vmapped_bf16']['wall_s']:.3f} s "
        f"({out['vmapped_bf16']['launches']} launches) against serial "
        f"{out['serial_bf16']['wall_s']:.3f} s ({out['serial_bf16']['launches']} launches)")
    return out


def convnet1(obs_size: int = 4, n_actions: int = 9):
    """The reference system's ConvNet1 (nets.py:17-33) as plain torch
    modules: ``cnn_base`` and ``fc`` Sequentials, NCHW in."""
    from torch import nn

    net = nn.Module()
    net.cnn_base = nn.Sequential(
        nn.Conv2d(obs_size, 16, 7, stride=3), nn.ReLU(), nn.MaxPool2d(3),
        nn.Conv2d(16, 32, 5), nn.ReLU(), nn.MaxPool2d(2),
        nn.Conv2d(32, 64, 4), nn.ReLU(), nn.MaxPool2d(2),
        nn.Conv2d(64, 128, 3), nn.ReLU(), nn.MaxPool2d(2))
    net.fc = nn.Sequential(nn.Linear(128, 64), nn.ReLU(), nn.Linear(64, 32), nn.ReLU(),
                           nn.Linear(32, n_actions))
    return net


def latency_rows(fn, dev, hw: int, batches, reps: int, seed: int = 0) -> dict:
    """Per-call wall latency of ``fn(frames_u8 on dev) -> logits`` with the
    result fetched to the host (what a serving client sees), at each batch
    size: distinct uint8 inputs per repetition (a base draw plus the
    repetition's index, mod 256), copied from the host each call, one
    warm-up call first. → {batch: {latency_ms_p50, latency_ms_p95,
    images_per_sec}}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows = {}
    for b in batches:
        base = rng.integers(0, 256, (b, hw, hw, 4), dtype=np.uint8)
        xs = [base + np.uint8(i) for i in range(reps)]
        with torch.inference_mode():
            fn(torch.from_numpy(base).to(dev)).cpu()
            lat = []
            for x in xs:
                t0 = time.perf_counter()
                out = fn(torch.from_numpy(x).to(dev)).cpu()
                lat.append(time.perf_counter() - t0)
                check(tuple(out.shape) == (b, 9), f"latency ladder: logits {tuple(out.shape)}")
        lat_ms = np.asarray(lat) * 1e3
        rows[b] = {"latency_ms_p50": float(np.percentile(lat_ms, 50)),
                   "latency_ms_p95": float(np.percentile(lat_ms, 95)),
                   "images_per_sec": b / float(np.median(lat))}
    return rows


def http_case(servable, *, window_ms: float, clients: int, requests: int, hw: int,
              max_batch: int, device=None, check_actions: bool = False) -> dict:
    """``clients`` threads each posting ``requests`` batch-1 requests of one
    frame of their own to ``/v1/infer`` of a ``PolicyServer`` on a free
    localhost port (coalescing window ``window_ms``), every bucket warmed
    first: requests/s, client latency percentiles, device calls and mean
    coalesced rows. With ``check_actions`` every answer must equal the
    engine's action for that frame."""
    import concurrent.futures
    import urllib.request

    import numpy as np

    from carla_imitation_learning_tpu_torch.serving import PolicyServer

    frames = [np.random.default_rng(100 + i).integers(0, 256, (1, hw, hw, 4), dtype=np.uint8)
              for i in range(clients)]

    def post(url, x):
        req = urllib.request.Request(
            url + "/v1/infer", data=x.tobytes(), method="POST",
            headers={"Content-Type": "application/octet-stream",
                     "X-Shape": ",".join(str(s) for s in x.shape)})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())["actions"]

    with PolicyServer(servable, window_ms=window_ms, max_batch=max_batch,
                      device=device) as srv:
        srv.engine.warmup(hw, hw, 4)
        lat_ms: list[float] = []
        answers: list[list] = [[] for _ in range(clients)]

        def client(i: int) -> None:
            for _ in range(requests):
                t0 = time.perf_counter()
                answers[i].append(post(srv.url, frames[i]))
                lat_ms.append((time.perf_counter() - t0) * 1e3)

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=clients) as ex:
            list(ex.map(client, range(clients)))
        wall = time.perf_counter() - t0
        b = srv._batcher
        res = {"window_ms": window_ms, "requests_per_sec": clients * requests / wall,
               "client_latency_ms_p50": float(np.percentile(lat_ms, 50)),
               "client_latency_ms_p95": float(np.percentile(lat_ms, 95)),
               "device_calls": b.batches_total,
               "mean_coalesced_rows": b.rows_total / b.batches_total if b.batches_total else 0.0,
               "engine": srv.engine.stats()}
        if check_actions:
            for i, x in enumerate(frames):
                want = srv.engine.infer(x).tolist()
                check(all(a == want for a in answers[i]),
                      f"http window {window_ms} ms: an answer differs from the engine's action")
    return res


def int8_gemms(servable) -> list:
    """The ``_int_mm`` nodes of a loaded int8 artifact's program, each as
    (operand dtypes, result dtype); a GEMM on other types raises."""
    import torch

    out = []
    for node in servable.program.graph.nodes:
        if node.op == "call_function" and node.target is torch.ops.aten._int_mm.default:
            dts = tuple(str(a.meta["val"].dtype) for a in node.args)
            out.append((dts, str(node.meta["val"].dtype)))
    check(bool(out), "the int8 artifact holds no int8 GEMM")
    check(all(d == ("torch.int8", "torch.int8") and r == "torch.int32" for d, r in out),
          f"an int8 artifact GEMM runs on other types: {out}")
    return out


def serving_phase(dev, checkpoint: Path) -> dict:
    """Phase 6k: the serving tier (``serving``) on ``checkpoint`` (6d's
    ``bc`` at 128²), counts reset just before it; kernel B renders the
    closed loops (2 × (1 + SERVE_EVAL_STEPS) each), nothing else launches:

    a. ``run export_policy --checkpoint`` through the CLI at 128² in bf16,
       with ``-o quantize=int8``, in fp32, and at the preset's 256²: each
       loaded artifact within 1e-4 of its live model (int8: the int8 copy),
       its export seconds and blob bytes (int8 smaller than float);
    b. the fp32 and int8 artifacts loaded on the CPU against the card on
       the same frames: fp32 (TF32 off) within 1e-4, int8 bit for bit; every
       GEMM of the int8 program int8 × int8 → int32 (``int8_gemms``), with
       the kernel names the profiler sees for one int8 call;
    c. ``run closed_loop_eval -o artifact=`` of the bf16 artifact at
       SERVE_EVAL_ENVS × SERVE_EVAL_STEPS: the policy's and the expert's
       metrics equal to ``--checkpoint``'s on the same fleet; the int8
       artifact's driving score beside them;
    d. the latency ladder (SERVE_LADDER at 128², SERVE_REPS distinct inputs
       each) of the bf16 artifact, the int8 artifact and the live bf16
       model; the engine on the bf16 artifact at request size
       SERVE_ENGINE_REQUEST (ladder to 1024); HTTP with SERVE_CLIENTS ×
       SERVE_REQUESTS batch-1 requests on the int8 artifact (batch
       invariant, so every answer must equal the engine's action) at each
       of SERVE_WINDOWS, more than one row a device call at 2 ms;
    e. ``import_torch`` of a seeded reference ConvNet1 checkpoint, exported
       at 256² in fp32: logits within 1e-5 (relative to their largest) of
       the ConvNet1 module's own on the card, TF32 off.
    Prints one ``serving`` line; → the phase's launch counts."""
    import contextlib
    import io

    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch import cli
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.serving import (
        InferenceEngine, load_policy, quantize_params,
    )
    from carla_imitation_learning_tpu_torch.utils.checkpoint import restore_params

    t_phase = time.perf_counter()
    res: dict = {"card": nvidia_smi()}
    cpu = torch.device("cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        tmp = Path(tmp)
        torch.cuda.synchronize()
        reset_counts()
        ck = ("--checkpoint", str(checkpoint), "-o", f"log_dir={tmp}")
        at128 = ("-o", f"height={HW}", "-o", f"width={HW}")
        arts, exports = {}, {}
        for name, extra in (("bf16", at128), ("int8", at128 + ("-o", "quantize=int8")),
                            ("fp32", at128 + ("-o", "compute_dtype=float32")),
                            ("bf16_256", ("-o", "experiment=export_policy"))):
            out = cli_run("export_policy", *ck, *extra, "-o", f"artifact_dir={tmp / name}")
            check(out["roundtrip_max_abs_err"] <= 1e-4,
                  f"export {name}: round trip {out['roundtrip_max_abs_err']:.3e} > 1e-4")
            check(out["engine"]["count"] == 1 and out["platforms"] == [dev.type],
                  f"export {name}: engine {out['engine']}, platforms {out['platforms']}")
            arts[name] = Path(out["artifact"])
            exports[name] = {k: out[k] for k in ("blob_bytes", "export_seconds",
                                                 "roundtrip_max_abs_err", "engine")}
            if "vs_float_max_abs_err" in out:
                exports[name]["vs_float_max_abs_err"] = out["vs_float_max_abs_err"]
        check(exports["int8"]["blob_bytes"] < exports["bf16"]["blob_bytes"],
              "the int8 artifact is not smaller than the float one")
        res["exports"] = exports
        log(json.dumps({"serving_exports": exports}))

        # b. card vs CPU, and the int8 GEMMs
        x = torch.from_numpy(np.random.default_rng(5).integers(
            0, 256, (16, HW, HW, 4), dtype=np.uint8))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            cross = {}
            for name in ("fp32", "int8"):
                card = load_policy(arts[name], dev)
                got = card.call(x.to(dev)).to(cpu)
                want = load_policy(arts[name], cpu).call(x)
                cross[name] = float((got - want).abs().max())
            check(cross["fp32"] < 1e-4, f"fp32 artifact card vs CPU {cross['fp32']:.3e}")
            check(cross["int8"] == 0.0, f"int8 artifact card vs CPU {cross['int8']:.3e}")
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        q_card = load_policy(arts["int8"], dev)
        gemms = int8_gemms(q_card)
        xb = x.to(dev)
        q_card.call(xb)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            q_card.call(xb)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if getattr(e, "device_time_total", 0) > 0 and "gemm" in e.key.lower()})
        if dev.type == "cuda":
            check(bool(names) and all(any(t in n.lower() for t in ("s8", "i8", "imma"))
                                      for n in names),
                  f"the int8 program's GEMM kernels are not int8 ones: {names}")
        res["card_vs_cpu"] = cross
        res["int8_gemms"] = {"count": len(gemms), "types": sorted(set(map(str, gemms))),
                             "profiler_kernels": names}
        log(json.dumps({"serving_card_vs_cpu": cross, "int8_gemms": res["int8_gemms"]}))

        # c. the artifact drives the closed loop as the checkpoint does
        ev = ("-o", f"n_envs={SERVE_EVAL_ENVS}", "-o", f"n_steps={SERVE_EVAL_STEPS}")
        by_art = cli_run("closed_loop_eval", "-o", f"artifact={arts['bf16']}", *ev,
                         "-o", f"log_dir={tmp}")
        by_ckpt = cli_run("closed_loop_eval", *ck, *ev)
        check(by_art["policy"] == by_ckpt["policy"],
              "closed_loop_eval: the artifact's policy metrics differ from the checkpoint's")
        check(by_art["expert"] == by_ckpt["expert"], "closed_loop_eval: the expert differs")
        by_int8 = cli_run("closed_loop_eval", "-o", f"artifact={arts['int8']}", *ev,
                          "-o", f"log_dir={tmp}")
        res["closed_loop"] = {k: {"driving_score": r["policy"]["driving_score"],
                                  "route_completion": r["policy"]["route_completion"],
                                  "action_agreement": r["policy"]["action_agreement"]}
                              for k, r in (("artifact_bf16", by_art), ("checkpoint", by_ckpt),
                                           ("artifact_int8", by_int8))}
        res["closed_loop"]["expert_driving_score"] = by_ckpt["expert"]["driving_score"]
        torch.cuda.synchronize()
        launches = read_counts()
        want_b = 3 * 2 * (1 + SERVE_EVAL_STEPS)
        check(launches["B"] == want_b and sum(launches.values()) == want_b,
              f"serving launched {launches}, expected B {want_b} and nothing else")
        log(json.dumps({"serving_closed_loop": res["closed_loop"], "launches": launches}))

        # d. the latency ladder, the engine, HTTP
        bf16, int8 = load_policy(arts["bf16"], dev), q_card
        live = PolicyCNN().to(dev).eval()
        live.load_state_dict(restore_params(checkpoint, live.state_dict()))

        def live_fn(frames):
            return live(frames.to(torch.float32) * (1.0 / 255.0))

        ladder = {}
        for name, fn in (("artifact_bf16", bf16.call), ("artifact_int8", int8.call),
                         ("live_bf16", live_fn)):
            ladder[name] = latency_rows(fn, dev, HW, SERVE_LADDER, SERVE_REPS)
            log(f"{name}: " + ", ".join(
                f"b={b} p50 {r['latency_ms_p50']:.3f} ms {r['images_per_sec']:.0f} img/s"
                for b, r in ladder[name].items()))
        res["ladder"] = ladder
        eng = InferenceEngine(bf16, max_batch=SERVE_LADDER[-1])
        eng.warmup(HW, HW)
        rng = np.random.default_rng(6)
        for _ in range(SERVE_REPS):
            eng.infer(rng.integers(0, 256, (SERVE_ENGINE_REQUEST, HW, HW, 4), dtype=np.uint8))
        res["engine_b100"] = eng.stats()
        check(abs(res["engine_b100"]["pad_waste_frac"] - (1 - SERVE_ENGINE_REQUEST / 128)) < 1e-12,
              f"engine pad waste {res['engine_b100']['pad_waste_frac']}")
        http = {}
        for w in SERVE_WINDOWS:
            http[f"window_{w:g}ms"] = http_case(
                int8, window_ms=w, clients=SERVE_CLIENTS, requests=SERVE_REQUESTS, hw=HW,
                max_batch=64, device=dev, check_actions=True)
        check(http["window_2ms"]["mean_coalesced_rows"] > 1.0,
              f"no coalescing at 2 ms: {http['window_2ms']['mean_coalesced_rows']}")
        res["http"] = http
        log(json.dumps({"serving_engine_b100": res["engine_b100"], "serving_http": http}))

        # e. a reference ConvNet1 checkpoint through import_torch and export
        torch.manual_seed(0)
        net = convnet1().to(dev).eval()
        ref = tmp / "convnet1.ckpt"
        torch.save({"state_dict": {f"net.{k}": v.cpu() for k, v in net.state_dict().items()}}, ref)
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["import_torch", str(ref), "--out", str(tmp / "imported")])
        check(rc == 0, f"import_torch exited {rc}")
        out = cli_run("export_policy", "--checkpoint", str(tmp / "imported"),
                      "-o", "experiment=export_policy", "-o", "compute_dtype=float32",
                      "-o", f"log_dir={tmp}", "-o", f"artifact_dir={tmp / 'ref_art'}")
        x256 = torch.from_numpy(np.random.default_rng(7).integers(
            0, 256, (8, 256, 256, 4), dtype=np.uint8)).to(dev)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                want = net.fc(torch.flatten(net.cnn_base(
                    x256.permute(0, 3, 1, 2).to(torch.float32) * (1.0 / 255.0)), 1))
                got = load_policy(out["artifact"], dev).call(x256)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        rel = float((got - want).abs().max() / want.abs().max())
        check(rel <= 1e-5, f"imported ConvNet1 artifact off by {rel:.3e} of its scale")
        res["convnet1_import_rel_err"] = rel
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps({"serving": res}))
    return launches


def imagination_setup(gen, dtype=None):
    """The dream_policy preset's imagination update, flax-initialised from
    ``gen`` on the CPU: a GRU world model (z 64, at 128², in ``dtype``,
    default the model's bf16), 5 reward heads with the disagreement
    penalty, the latent policy and its anchor (KL 0.3), horizon 15, γ
    0.98, entropy 3e-3, Adam at 3e-4 with optax's constants; → (the
    modules, ``make(wm, heads, policy, anchor)`` → the update)."""
    import torch

    from carla_imitation_learning_tpu_torch.models import LatentWorldModel
    from carla_imitation_learning_tpu_torch.training import imagination as imag
    from carla_imitation_learning_tpu_torch.training.steps import (
        ADAM_BETAS, ADAM_EPS, flax_init_,
    )

    kw = {} if dtype is None else {"dtype": dtype}
    wm = flax_init_(LatentWorldModel(rnn="gru", height=HW, width=HW, **kw), gen)
    heads = imag.HeadEnsemble([flax_init_(imag.RewardHead(64), gen) for _ in range(5)])
    policy, anchor = (flax_init_(imag.LatentPolicy(64), gen) for _ in range(2))

    def make(wm, heads, policy, anchor):
        opt = torch.optim.Adam(policy.parameters(), lr=3e-4, betas=ADAM_BETAS, eps=ADAM_EPS)
        return imag.make_imagination_update(wm, heads, policy, opt, horizon=15, gamma=0.98,
                                            entropy_coef=3e-3, disagree_coef=1.0,
                                            anchor=anchor, anchor_coef=0.3)

    return (wm, heads, policy, anchor), make


def imagination_card_vs_cpu(dev) -> dict:
    """One imagination update at the dream_policy preset's shape (a GRU
    world model, z 64, at 128²; 5 reward heads with the disagreement
    penalty; the anchor; horizon 15; 128 start rows) in fp32 (TF32 off) on
    the card and on the CPU, each against float64, from the same weights,
    start latents and Gumbel draws (fed through ``draw_gumbel``): every
    metric within rtol 1e-5 of float64 (atol 1e-6), and after the Adam step
    no more of the policy's parameters off float64's by over 1 % of the
    rate on the card than 4× the CPU's count plus 1 in 10,000."""
    import copy

    import torch

    from carla_imitation_learning_tpu_torch.training import imagination as imag

    cpu, lr, rows, horizon = torch.device("cpu"), 3e-4, 128, 15
    gen = torch.Generator().manual_seed(11)
    modules, make = imagination_setup(gen, torch.float32)
    z0 = torch.rand(rows, 64, generator=gen) * 2 - 1
    draws = imag.draw_gumbel(gen, (horizon, rows, 9), cpu)
    orig = imag.draw_gumbel
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    runs = {}
    try:
        for side, d, dt in (("card", dev, torch.float32), ("cpu", cpu, torch.float32),
                            ("f64", cpu, torch.float64)):
            w, h, p, a = (copy.deepcopy(m).to(d, dt) for m in modules)
            it = iter(draws.to(d, dt))
            imag.draw_gumbel = lambda g, shape, device, it=it: next(it)
            m = make(w, h, p, a)(z0.to(d, dt), None)
            runs[side] = ({k: float(v) for k, v in m.items()},
                          {k: v.to(cpu, torch.float64) for k, v in p.state_dict().items()})
    finally:
        imag.draw_gumbel = orig
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    m64, p64 = runs["f64"]
    out = {"metrics_f64": m64}
    for side in ("card", "cpu"):
        m, p = runs[side]
        out[f"metric_max_rel_err_{side}"] = max(
            abs(m[k] - m64[k]) / max(abs(m64[k]), 1e-30) for k in m64 if abs(m64[k]) > 1e-6)
        for k in m64:
            check(abs(m[k] - m64[k]) <= 1e-5 * abs(m64[k]) + 1e-6,
                  f"imagination update {side}: {k} {m[k]} vs float64 {m64[k]}")
        out[f"params_off_{side}"] = sum(int(((p[k] - p64[k]).abs() > 0.01 * lr).sum())
                                        for k in p64)
    n = sum(v.numel() for v in p64.values())
    check(out["params_off_card"] <= 4 * out["params_off_cpu"] + n // 10000 + 1,
          f"imagination update: {out['params_off_card']} parameters off float64's step "
          f"(CPU {out['params_off_cpu']})")
    log(json.dumps({"imagination_card_vs_cpu": out}))
    return out


def vit_card_vs_cpu(dev) -> dict:
    """The ``bc_vit`` preset's ViT (patch 16, dim 192, depth 4, heads 3,
    16² position grid) forward on 8 frames at 128², where the grid is
    resized to 8² with antialiasing, in fp32 (TF32 off) on the card and on
    the CPU, each against float64: the card's logits no further from
    float64 than 4× the CPU's are, plus 1e-6 of the logits' scale."""
    import torch

    from carla_imitation_learning_tpu_torch.models import ViTPolicy
    from carla_imitation_learning_tpu_torch.training.steps import flax_init_

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(12)
    ref = flax_init_(ViTPolicy(dtype=torch.float32), gen)
    x = torch.rand(8, HW, HW, 4, generator=gen)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    logits = {}
    try:
        for side, d, dt in (("card", dev, torch.float32), ("cpu", cpu, torch.float32),
                            ("f64", cpu, torch.float64)):
            m = ViTPolicy(dtype=dt).to(dt)
            m.load_state_dict(ref.state_dict())
            with torch.no_grad():
                logits[side] = m.to(d)(x.to(d, dt)).to(cpu, torch.float64)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    want = logits["f64"]
    out = {"scale": float(want.abs().max()),
           "err_card": float((logits["card"] - want).abs().max()),
           "err_cpu": float((logits["cpu"] - want).abs().max())}
    check(out["err_card"] <= 4 * out["err_cpu"] + 1e-6 * out["scale"],
          f"ViT forward at {HW}²: card {out['err_card']:.3e} from float64, CPU "
          f"{out['err_cpu']:.3e} (scale {out['scale']:.3e})")
    log(json.dumps({"vit_card_vs_cpu": out}))
    return out


def time_imagination_update(dev) -> dict:
    """ms per imagination update at the dream_policy preset's shape (bf16
    GRU world model, z 64, 128²; 5 reward heads; the anchor; batch 128;
    horizon 15): with SEQ_TIMED's (warm-up, updates a run, runs, profiled),
    the warm-up updates, then the runs of updates timed by CUDA events, the
    median; then torch.profiler over the profiled updates (busy ms,
    launches)."""
    import torch

    gen = torch.Generator().manual_seed(13)
    modules, make = imagination_setup(gen)
    update = make(*(m.to(dev) for m in modules))
    z0 = (torch.rand(128, 64, generator=gen) * 2 - 1).to(dev)
    draws = torch.Generator(device=dev).manual_seed(0)
    warm, timed, repeats, profiled = SEQ_TIMED
    for _ in range(warm):
        update(z0, draws)
    runs = []
    for _ in range(repeats):
        runs.append(cuda_ms(lambda: update(z0, draws), reps=timed, warmup=0))
    m = update(z0, draws)
    check(all(bool(torch.isfinite(v)) for v in m.values()), "imagination update: not finite")
    ms = sorted(runs)[len(runs) // 2]
    prof = profile_train_step(lambda st, order: [update(z0, draws) for _ in order], None,
                              range(profiled))
    log(f"imagination update: {ms:.3f} ms (runs {[round(r, 3) for r in runs]}), busy "
        f"{prof['device_busy_ms_per_step']:.3f} ms, {prof['device_launches_per_step']:.0f} "
        f"launches")
    return {"batch": 128, "horizon": 15, "heads": 5, "ms_per_update": ms, "ms_runs": runs,
            "idle_share": 1.0 - prof["device_busy_ms_per_step"] / ms,
            "profile": {k: prof[k] for k in ("device_busy_ms_per_step", "device_launches_per_step",
                                             "groups")}}


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


def check_against_cpu(params, town, rcfg, dev, cameras=("camera",)) -> dict:
    """The main path on a small fleet, on the card and on the CPU (where the
    wrappers run the plain versions), from the same reset draws and pool:
    an expert rollout of CROSS_STEPS steps in which half the envs auto-reset,
    and an fp32 ``PolicyCNN`` forward on its last frame window with TF32
    off. Flags and actions must be equal, sim floats within rtol 1e-5 /
    atol 1e-4, frames (every view of a ``cameras`` rig) within the
    fast-raster tolerance, logits within 1e-4. → the largest differences
    seen."""
    import torch

    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.closed_loop import (
        make_rollout, rollout_spawn_pool,
    )

    cpu = torch.device("cpu")
    pool = rollout_spawn_pool(params, town.to(cpu))
    runs = []
    for d in (dev, cpu):
        init_fn, rollout_fn = make_rollout(params, town, rcfg, None, spawn_pool=pool, device=d,
                                           cameras=cameras)
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
    frames = "views" if len(cameras) > 1 else "gray"
    worst["frames"] = b_tolerance(tr_k[frames].float() / 255, tr_p[frames].float() / 255,
                                  "card vs CPU frames")

    torch.manual_seed(0)
    model = PolicyCNN(obs_size=fb_p.shape[-1], dtype=torch.float32).eval()
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
    t0 = time.perf_counter()
    try:
        res = run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": res["kernels"]}), flush=True)
    print(res["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": res["kind"],
                                             "count": res["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
