#!/usr/bin/env python3
"""Weak-scaling curve of the port's data parallelism (the JAX package's
``benchmarks/scaling.py``, its curve; the collective audit is
``tests/test_torch_mesh.py``'s).

At fixed work per rank, for 1, 2 and 4 ranks (``--ranks``), each rank
runs, at the sizes of ``SIZES["full"]`` (``--tiny``: ``SIZES["tiny"]``,
a toy run for the CPU):

- an expert rollout of ``envs_per_rank`` envs of the bench town's fleet
  (``make_town()``'s, 15 agents, ``hw``², RenderConfig's T = 512) sharded
  over a ``data`` mesh: marginal ms per fleet step between rollouts of
  ``steps_short`` and ``steps_long`` steps (median of ``repeats`` pairs),
  each ended by a device sync and a barrier;
- a fused BC epoch of ``PolicyCNN`` (bf16 on a card, fp32 on the CPU, a
  core a rank) at ``batch_per_rank`` rows a rank of a synthetic ``hw``²
  store: marginal ms per step between epochs of 2 and 8 batches (median
  as above).

Rank layouts: gloo ranks on the CPU (``--device cpu``); on a card, gloo
ranks sharing ``cuda:0`` (NCCL refuses two ranks on one card) and, where
the machine has more than one card, NCCL ranks one a card for every rank
count the cards cover. On one card the curve measures each rank's overhead
and the contention between ranks sharing the card, not scaling: ideal weak
scaling keeps the ms per step flat, and one card shared by n ranks can at
best keep the work per second flat.

Every record names its layout, backend and device; the report carries the
card's ``nvidia-smi`` name and power limit. Writes ``--out`` (default
``reports/torch_scaling.json``; a CPU run may not write under
``reports/``).

    python3 benchmarks_torch/scaling.py [--ranks 1 2 4] [--out F]
    python3 benchmarks_torch/scaling.py --device cpu --tiny --out /tmp/s.json
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_TOWN = {"blocks": 3, "n_buildings": 24, "n_lights": 8}   # make_town's defaults
TRIANGLES = 512                   # RenderConfig's table at the bench town
SIZES = {"full": {"envs_per_rank": 256, "steps_short": 8, "steps_long": 24,
                  "batch_per_rank": 64, "hw": 128, "repeats": 3},
         "tiny": {"envs_per_rank": 4, "steps_short": 2, "steps_long": 4,
                  "batch_per_rank": 4, "hw": 32, "repeats": 1}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _marginal(run, short: int, long: int, repeats: int) -> float:
    """Median over ``repeats`` pairs of (run(long) − run(short)) / (long −
    short) seconds, after one warm pair."""
    import numpy as np

    run(short)
    run(long)
    return float(np.median([(run(long) - run(short)) / (long - short)
                            for _ in range(repeats)]))


def rank_work(mesh, dev, size: dict) -> dict:
    """This rank's part of one point of the curve at ``size`` (an entry of
    ``SIZES``) → its timings."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.parallel.mesh import (
        batch_sharding, shard_train_state,
    )
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_fused_epoch, make_optimizer,
    )

    n = mesh.size()

    def done():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mesh.barrier()

    rcfg = RenderConfig(height=size["hw"], width=size["hw"], max_triangles=TRIANGLES)
    init_fn, rollout_fn = make_rollout(SimParams(n_agents=15), make_town(**BENCH_TOWN), rcfg,
                                       None, device=dev, mesh=mesh)
    carry = [init_fn(torch.Generator().manual_seed(0), size["envs_per_rank"] * n)]

    def roll(steps: int) -> float:
        done()
        t0 = time.perf_counter()
        carry[0], traj = rollout_fn(carry[0], steps)
        float(traj["speed"].sum())
        done()
        return time.perf_counter() - t0

    roll_s = _marginal(roll, size["steps_short"], size["steps_long"], size["repeats"])
    del carry[0]

    batch = size["batch_per_rank"] * n
    store = FrameStore.synthetic(n=max(8 * batch + 8, 64), height=size["hw"], width=size["hw"])
    ds = DeviceDataset(store, batch, frame_skip=4, sharding=batch_sharding(mesh), device=dev)
    model = PolicyCNN(dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    state = shard_train_state(mesh, create_train_state(
        model, make_optimizer({"LEARNING_RATE": 1e-3, "gradient_clip_val": 0.5}, 1),
        generator=torch.Generator().manual_seed(0), device=dev))
    epoch = make_fused_epoch(bc_loss_fn, ds.pure_batch, ds.sharding)
    rng = np.random.default_rng(1)

    def fit(n_batches: int) -> float:
        order = torch.from_numpy(rng.integers(0, ds.n_samples, (n_batches, batch))).to(dev)
        done()
        t0 = time.perf_counter()
        _, _, stacked = epoch(state, order)
        float(stacked["loss"].sum())
        done()
        return time.perf_counter() - t0

    bc_s = _marginal(fit, 2, 8, size["repeats"])
    return {"rollout_s_per_step": roll_s, "bc_s_per_step": bc_s}


def _rank_main(rank: int, world: int, port: int, layout: dict, size: dict,
               out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from carla_imitation_learning_tpu_torch.parallel.mesh import make_mesh, multihost_initialize

    if layout["device"] == "cpu":
        torch.set_num_threads(1)       # a core a rank
    os.environ["LOCAL_RANK"] = str(rank)
    multihost_initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                         process_id=rank, backend=layout["backend"], device=layout["device"])
    try:
        device = "cpu" if layout["device"] == "cpu" else (
            "cuda:0" if layout["backend"] == "gloo" else f"cuda:{rank}")
        mesh = make_mesh(axis_sizes={"data": world}, devices=device)
        if mesh.device.type == "cuda":      # gloo ranks share cuda:0
            torch.cuda.set_device(mesh.device)
        out = rank_work(mesh, mesh.device, size)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_point(world: int, layout: dict, size: dict) -> dict:
    """One point of the curve: ``world`` ranks in ``layout`` → its record."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="torch_scaling_") as tmp:
        t0 = time.perf_counter()
        mp.spawn(_rank_main, args=(world, _free_port(), layout, size, tmp), nprocs=world,
                 join=True)
        wall = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(world)]
    roll = max(r["rollout_s_per_step"] for r in ranks)     # the slowest rank sets the pace
    bc = max(r["bc_s_per_step"] for r in ranks)
    n_envs, batch = size["envs_per_rank"] * world, size["batch_per_rank"] * world
    return {"ranks": world, "layout": layout["name"], "backend": layout["backend"],
            "device": layout["device_name"], "n_envs": n_envs,
            "rollout_ms_per_fleet_step": roll * 1e3,
            "rollout_env_steps_per_sec": n_envs / roll,
            "bc_batch": batch, "bc_ms_per_step": bc * 1e3,
            "bc_images_per_sec": batch / bc,
            "per_rank": ranks, "wall_s_with_start": wall}


def layouts(device: str) -> list[dict]:
    """The rank layouts this machine offers."""
    import torch

    if device == "cpu":
        return [{"name": "gloo ranks on the CPU", "backend": "gloo", "device": "cpu",
                 "device_name": "cpu", "cards": 0}]
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu for the CPU curve")
    name = torch.cuda.get_device_name(0)
    out = [{"name": "gloo ranks sharing cuda:0", "backend": "gloo", "device": "cuda",
            "device_name": name, "cards": 1}]
    if torch.cuda.device_count() > 1:
        out.append({"name": "NCCL ranks, one card a rank", "backend": "nccl",
                    "device": "cuda", "device_name": name,
                    "cards": torch.cuda.device_count()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--tiny", action="store_true",
                    help="the toy sizes of SIZES['tiny'] (a CPU run)")
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_scaling.json"))
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if args.device == "cpu" and (ROOT / "reports") in out.parents:
        raise SystemExit("a CPU run does not write under reports/: pass --out")
    sys.path.insert(0, str(ROOT))
    report = {"note": ("fixed work per rank; on one card the ranks share it, so the curve "
                       "measures each rank's overhead and the contention between ranks, "
                       "not scaling (ideal weak scaling keeps ms per step flat)"),
              "smi": None, "records": []}
    size = SIZES["tiny" if args.tiny else "full"]
    report["config"] = {"device": args.device, "ranks": args.ranks, **size,
                        "triangles": TRIANGLES, "out": str(out)}
    if args.device == "cuda":
        from carla_imitation_learning_tpu_torch.device import card_line
        from carla_imitation_learning_tpu_torch.native import framestore
        from carla_imitation_learning_tpu_torch.ops import cuda_lib

        report["smi"] = card_line()
        print(report["smi"], flush=True)
        cuda_lib.build()               # once, before the ranks load it
        framestore.build_library()
    for layout in layouts(args.device):
        base = None
        for world in args.ranks:
            if world > max(layout["cards"], 1) and layout["backend"] == "nccl":
                continue
            rec = run_point(world, layout, size)
            base = base or rec
            rec["rollout_ms_vs_1_rank"] = rec["rollout_ms_per_fleet_step"] / \
                base["rollout_ms_per_fleet_step"]
            rec["bc_ms_vs_1_rank"] = rec["bc_ms_per_step"] / base["bc_ms_per_step"]
            report["records"].append(rec)
            print(json.dumps({k: v for k, v in rec.items() if k != "per_rank"}), flush=True)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
