#!/usr/bin/env python3
"""Discrete vs continuous action space, on the driving score, in the
PyTorch port.

The port of the JAX package's ``benchmarks/continuous_ab.py``. The
reference discretizes the autopilot's controls into 9 classes and trains a
classifier; ``bc_continuous`` regresses the raw (steer, accel) instead.
Everything else is held equal: per seed, one expert collection (kernel B
renders every step) is shared by both families, each trains the same
bf16 trunk (``PolicyCNN`` or ``ContinuousPolicyCNN``, drawn from one
generator, so the trunks start from the same weights) for the same epochs
and batches with Adam(1e-3), and each tier drives the same evaluation
fleet. Tiers: ``expert``, ``bc_discrete``, ``bc_continuous`` and, with
``--dagger`` rounds, ``dagger_discrete`` and ``dagger_continuous``: the
policy drives in its own control space and the expert labels both ways
(``store.actions`` discrete, ``store.controls`` continuous); each round
trains ``max(2, epochs // 2)`` epochs on every store so far.

Each tier and seed draws from its own ``torch.Generator``: eval fleets
1000·seed + 100 (expert), 102 (BC), 103 (DAgger); init 1000·seed + 1;
collection 1000·seed + 2; DAgger round r 1000·seed + 10 + r; shuffles
seed and 1000 + 17·seed + r. The streams differ from the JAX package's, so
only driving scores compare across the packages.

    python3 benchmarks_torch/continuous_ab.py [--envs 256] [--steps 300]
        [--collect-envs 64] [--collect-steps 500] [--epochs 8] [--dagger 1]
        [--batch 256] [--seeds 2] [--noise] [--device cuda] [--out PATH]

Defaults are the JAX harness's. The report (``runs`` per seed, ``summary``
with mean/min/max per tier and metric, ``wall_seconds``; on the card the
card's name and power limit) is written after every tier to ``--out``,
by default ``reports/torch_continuous_ab.json`` beside the JAX package's
``reports/continuous_ab.json``; the last line of standard output is one
JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEEP = ("driving_score", "route_completion", "clean_episode_rate", "collisions_per_km",
        "red_violations_per_km", "mean_speed", "action_agreement", "km_driven",
        "steer_rate", "driving_score_arc", "route_completion_arc")


def trim(metrics: dict) -> dict:
    return {k: None if metrics[k] is None else round(float(metrics[k]), 4) for k in KEEP}


def summarize(runs: dict, tiers) -> dict:
    """Per tier and metric: mean, min, max and the values over seeds."""
    import numpy as np

    summary = {}
    for tier in tiers:
        if not all(tier in r for r in runs.values()):
            continue
        summary[tier] = {}
        for k in KEEP:
            vals = [r[tier][k] for r in runs.values() if r[tier][k] is not None]
            if vals:
                summary[tier][k] = {"mean": round(float(np.mean(vals)), 4),
                                    "min": round(float(np.min(vals)), 4),
                                    "max": round(float(np.max(vals)), 4), "values": vals}
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=256, help="eval fleet size")
    ap.add_argument("--steps", type=int, default=300, help="eval horizon")
    ap.add_argument("--collect-envs", type=int, default=64)
    ap.add_argument("--collect-steps", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--dagger", type=int, default=1, help="DAgger rounds per family (0 to skip)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="full-pipeline repetitions (seed, seed + 1, ...)")
    ap.add_argument("--noise", action="store_true",
                    help="steering noise on the expert collection (labels stay clean)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_continuous_ab.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device
    from carla_imitation_learning_tpu_torch.models import ContinuousPolicyCNN, PolicyCNN
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import (
        bc_loss_fn, continuous_bc_loss_fn,
    )
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_fused_epoch,
    )

    dev = resolve_device(args.device)
    town = make_town(blocks=3, n_buildings=24, n_lights=8)
    params = SimParams(n_agents=15)
    rcfg = RenderConfig(height=128, width=128)
    out = Path(args.out)
    result: dict = {"config": vars(args), "device": str(dev), "runs": {}}
    if dev.type == "cuda":
        result["card"] = card_line()
    out.parent.mkdir(parents=True, exist_ok=True)

    def save():
        out.write_text(json.dumps(result, indent=2) + "\n")

    def gen(seed: int) -> torch.Generator:
        return torch.Generator().manual_seed(seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    families = {
        "discrete": (lambda: PolicyCNN(dtype=torch.bfloat16), bc_loss_fn,
                     lambda store: None),
        "continuous": (lambda: ContinuousPolicyCNN(dtype=torch.bfloat16),
                       continuous_bc_loss_fn(), lambda store: store.controls),
    }

    def policy_from(model, name: str):
        @torch.no_grad()
        def policy_fn(obs):
            y = model(obs)
            return y if name == "continuous" else y.argmax(-1)
        return policy_fn

    def train(state, loss, store, labels, shuffle_seed: int, epochs: int):
        """``epochs`` fused epochs → (state, seconds, the last batch's metrics)."""
        ds = DeviceDataset(store, args.batch, shuffle=True, seed=shuffle_seed,
                           continuous_labels=labels, device=dev)
        epoch = make_fused_epoch(loss, ds.pure_batch)
        sync()
        t0 = time.perf_counter()
        metrics = None
        for _ in range(epochs):
            nb = len(ds)
            order = ds.epoch_indices()[:nb * args.batch].reshape(nb, -1)
            state, _, metrics = epoch(state, torch.from_numpy(order).to(dev))
        sync()
        return state, time.perf_counter() - t0, {k: round(float(v[-1]), 4)
                                                  for k, v in metrics.items()}

    def run_seed(seed: int) -> None:
        r: dict = {}
        result["runs"][str(seed)] = r

        def ev(policy_fn, tier_key: int, space: str) -> dict:
            return trim(cl.evaluate_policy(params, town, rcfg, policy_fn,
                                           gen(1000 * seed + tier_key), n_envs=args.envs,
                                           n_steps=args.steps, control_space=space,
                                           device=dev))

        r["expert"] = ev(None, 100, "discrete")
        print(f"[seed {seed}] expert: {r['expert']}", flush=True)
        save()
        tc = time.perf_counter()
        noise = cl.NoiseConfig(seed=seed) if args.noise else None
        store, _, traj = cl.collect_dataset(params, town, rcfg, gen(1000 * seed + 2),
                                            args.collect_envs, args.collect_steps,
                                            noise=noise, device=dev)
        del traj
        sync()
        r["collect_seconds"] = time.perf_counter() - tc
        r["dataset_frames"] = len(store)
        save()

        for name, (make_model, loss, labels) in families.items():
            state = create_train_state(make_model(), AdamConfig(schedule=lambda count: 1e-3),
                                       generator=gen(1000 * seed + 1), device=dev)
            state, seconds, last = train(state, loss, store, labels(store), seed, args.epochs)
            r[f"bc_{name}_train_seconds"] = seconds
            r[f"bc_{name}_final"] = last
            r[f"bc_{name}"] = ev(policy_from(state.model, name), 102, name)
            print(f"[seed {seed}] bc_{name}: {r[f'bc_{name}']}", flush=True)
            save()
            stores = [store]
            for rnd in range(args.dagger):
                dstore, _, traj = cl.dagger_iteration(
                    params, town, rcfg, policy_from(state.model, name),
                    gen(1000 * seed + 10 + rnd), args.collect_envs, args.collect_steps,
                    control_space=name, device=dev)
                del traj
                stores.append(dstore)
                merged = FrameStore.concat(stores)
                state, seconds, last = train(state, loss, merged, labels(merged),
                                             1000 + 17 * seed + rnd, max(2, args.epochs // 2))
                r[f"dagger_{name}_r{rnd + 1}_train_seconds"] = seconds
            if args.dagger:
                r[f"dagger_{name}"] = ev(policy_from(state.model, name), 103, name)
                print(f"[seed {seed}] dagger_{name}: {r[f'dagger_{name}']}", flush=True)
                save()

    t0 = time.perf_counter()
    seeds = [args.seed + i for i in range(max(1, args.seeds))]
    for seed in seeds:
        ts = time.perf_counter()
        run_seed(seed)
        result["runs"][str(seed)]["seed_seconds"] = time.perf_counter() - ts
        save()
    tiers = ["expert", "bc_discrete", "bc_continuous"]
    if args.dagger:
        tiers += ["dagger_discrete", "dagger_continuous"]
    summary = summarize(result["runs"], tiers)
    result["summary"] = summary
    for t in summary:
        result[t] = result["runs"][str(seeds[0])][t]
    result["wall_seconds"] = time.perf_counter() - t0
    save()

    def line(t):
        s = summary.get(t, {}).get("driving_score")
        return None if s is None else s["mean"]

    print(json.dumps({
        "metric": "continuous_vs_discrete_driving_score", "seeds": len(seeds),
        "device": str(dev), "card": result.get("card"),
        **{t: line(t) for t in ("bc_discrete", "bc_continuous", "dagger_discrete",
                                "dagger_continuous", "expert")},
        "spread": {t: [summary[t]["driving_score"]["min"], summary[t]["driving_score"]["max"]]
                   for t in summary if "driving_score" in summary[t]},
    }), flush=True)
    return result


if __name__ == "__main__":
    main()
