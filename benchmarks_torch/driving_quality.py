#!/usr/bin/env python3
"""End-to-end driving quality of the PyTorch port: expert vs untrained vs BC.

The rungs of the JAX package's ``benchmarks/driving_quality.py`` that the
port can run: the expert's closed-loop driving score, an untrained
``PolicyCNN``'s, and a ``PolicyCNN`` trained by behaviour cloning on data
the expert collected on the card. Per seed, the whole pipeline runs anew:

1. expert: ``evaluate_policy`` with the autopilot driving;
2. untrained: a bf16 ``PolicyCNN`` drawn as flax draws it
   (``create_train_state`` with a generator), evaluated on its own fleet;
3. BC: ``collect_dataset`` with the expert (kernel B renders every step),
   a shuffled ``DeviceDataset``, ``--epochs`` epochs of Adam(1e-3) without
   clipping through the fused epoch, then ``evaluate_policy``.

Defaults are the JAX harness's: eval 256 envs × 300 steps, collection 64 ×
500, 8 epochs, batch 256, the bench town, 128², bf16 ``PolicyCNN``. Each
rung and seed draws from its own ``torch.Generator`` (eval fleets
1000·seed + 100, 101, 102; init 1000·seed + 1; collection 1000·seed + 2),
so the streams differ from the JAX package's: compare ranges across seeds,
not values.

    python3 benchmarks_torch/driving_quality.py --out REPORT.json
        [--seeds 3] [--device cuda]

The report is written to ``--out`` after every rung (never under
``reports/``, which holds the JAX package's records); the last line of
standard output is one JSON summary. On the card the report carries the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEEP = ("driving_score", "route_completion", "clean_episode_rate", "collisions_per_km",
        "red_violations_per_km", "mean_speed", "action_agreement", "km_driven",
        "steer_rate", "driving_score_arc", "route_completion_arc", "route_km")
TIERS = ("expert", "untrained", "bc")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def summarize(runs: dict) -> dict:
    """Per tier and metric: mean, min, max and the values over seeds."""
    import numpy as np

    summary = {}
    for tier in TIERS:
        if not all(tier in r for r in runs.values()):
            continue
        summary[tier] = {}
        for k in KEEP:
            vals = [r[tier][k] for r in runs.values() if r[tier][k] is not None]
            if vals:
                summary[tier][k] = {"mean": float(np.mean(vals)), "min": float(np.min(vals)),
                                    "max": float(np.max(vals)), "values": vals}
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=256, help="eval fleet size")
    ap.add_argument("--steps", type=int, default=300, help="eval horizon")
    ap.add_argument("--collect-envs", type=int, default=64)
    ap.add_argument("--collect-steps", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0, help="base seed")
    ap.add_argument("--seeds", type=int, default=1,
                    help="full pipeline repetitions (seed, seed + 1, ...)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="report path (not under reports/)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if (ROOT / "reports") in out.parents:
        raise SystemExit("--out must not be under reports/ (the JAX package's records)")

    sys.path.insert(0, str(ROOT))
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset
    from carla_imitation_learning_tpu_torch.device import resolve_device
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_fused_epoch,
    )

    dev = resolve_device(args.device)
    params = SimParams(n_agents=15)
    town = make_town(blocks=3, n_buildings=24, n_lights=8)
    rcfg = RenderConfig(height=128, width=128)
    result: dict = {"config": vars(args), "device": str(dev), "runs": {}}
    if dev.type == "cuda":
        result["card"] = card_line()
    out.parent.mkdir(parents=True, exist_ok=True)

    def save():
        out.write_text(json.dumps(result, indent=2) + "\n")

    def gen(seed: int) -> torch.Generator:
        return torch.Generator().manual_seed(seed)

    def policy_from(model):
        return lambda obs: model(obs).argmax(-1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run_seed(seed: int) -> None:
        r: dict = {}
        result["runs"][str(seed)] = r

        def ev(policy_fn, key: int) -> dict:
            m = cl.evaluate_policy(params, town, rcfg, policy_fn, gen(1000 * seed + key),
                                   n_envs=args.envs, n_steps=args.steps, device=dev)
            return {k: m[k] for k in KEEP}

        r["expert"] = ev(None, 100)
        print(f"[seed {seed}] expert: {r['expert']}", flush=True)
        save()

        state = create_train_state(PolicyCNN(dtype=torch.bfloat16),
                                   AdamConfig(schedule=lambda count: 1e-3),
                                   generator=gen(1000 * seed + 1), device=dev)
        r["untrained"] = ev(policy_from(state.model), 101)
        print(f"[seed {seed}] untrained: {r['untrained']}", flush=True)
        save()

        tc = time.perf_counter()
        store, _, traj = cl.collect_dataset(params, town, rcfg, gen(1000 * seed + 2),
                                            args.collect_envs, args.collect_steps,
                                            device=dev)
        del traj
        r["collect_seconds"] = time.perf_counter() - tc
        r["dataset_frames"] = len(store)

        ds = DeviceDataset(store, args.batch, shuffle=True, seed=seed, device=dev)
        epoch = make_fused_epoch(bc_loss_fn, ds.pure_batch)
        sync()
        tt = time.perf_counter()
        metrics, images = None, 0
        for _ in range(args.epochs):
            nb = len(ds)
            order = ds.epoch_indices()[:nb * args.batch].reshape(nb, -1)
            state, _, metrics = epoch(state, torch.from_numpy(order).to(dev))
            images += order.size
        sync()
        r["train_seconds"] = time.perf_counter() - tt
        r["train_steps"] = state.step
        r["train_images_per_s"] = images / r["train_seconds"]
        if metrics is not None:
            r["bc_final_loss"] = float(metrics["loss"][-1])
            r["bc_final_accuracy"] = float(metrics["accuracy"][-1])
        save()
        r["bc"] = ev(policy_from(state.model), 102)
        print(f"[seed {seed}] bc: {r['bc']}", flush=True)
        save()

    t0 = time.perf_counter()
    for seed in range(args.seed, args.seed + max(1, args.seeds)):
        ts = time.perf_counter()
        run_seed(seed)
        result["runs"][str(seed)]["seed_seconds"] = time.perf_counter() - ts
        save()
    result["summary"] = summarize(result["runs"])
    result["wall_seconds"] = time.perf_counter() - t0
    save()
    line = {"metric": "closed_loop_driving_score_bc", "seeds": args.seeds,
            "device": str(dev), "card": result.get("card"),
            **{t: result["summary"][t]["driving_score"]["mean"] for t in TIERS},
            "spread": {t: [result["summary"][t]["driving_score"]["min"],
                           result["summary"][t]["driving_score"]["max"]] for t in TIERS}}
    print(json.dumps(line), flush=True)
    return result


if __name__ == "__main__":
    main()
