#!/usr/bin/env python3
"""Seg A/B of the PyTorch port: does the auxiliary segmentation decoder
make the AuxNet drive better?

The port of the JAX package's ``benchmarks/seg_ab.py``. Per seed, one
expert collection (``record_semantic``: kernel B renders the frames,
kernel A the class plane) is shared by four arms, each trained from
scratch and driven on the same evaluation fleet:

- ``bc``: ``PolicyCNN`` with the BC loss, the quality ladder's control;
- ``plain``: ``AuxNet`` trained on the action head only, with speed
  dropout on the sensor vector;
- ``nosensor``: ``AuxNet`` with the sensor vector zeroed in training and
  in the closed loop;
- ``seg``: ``AuxNet`` plus the seg decoder (``aux_seg_loss_fn``) on the
  recorded class plane, through ``AuxSegDataset`` with speed dropout.

Defaults are the JAX harness's budget: collection 64 × 500, 8 epochs,
batch 256, evaluation 256 × 300, the bench town at 128², bf16, Adam(1e-3).
Each arm draws from its own ``torch.Generator`` (collection 1000·seed + 2,
init 1000·seed + 1, eval fleet 1000·seed + 102), so the streams differ
from the JAX package's: only driving scores compare across the packages.

    python3 benchmarks_torch/seg_ab.py --out REPORT.json [--seeds 3]
        [--arms bc,plain,nosensor,seg] [--device cuda]

The report is written to ``--out`` after every arm (never under
``reports/``); the last line of standard output is one JSON summary. On
the card the report carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--collect-envs", type=int, default=64)
    ap.add_argument("--collect-steps", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--eval-envs", type=int, default=256)
    ap.add_argument("--eval-steps", type=int, default=300)
    ap.add_argument("--seg-weight", type=float, default=0.5)
    ap.add_argument("--speed-dropout", type=float, default=0.3,
                    help="train-time probability of zeroing the sensor's speed columns")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--arms", default="bc,plain,nosensor,seg")
    ap.add_argument("--town-blocks", type=int, default=3)
    ap.add_argument("--size", type=int, default=128, help="camera side")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="report path (not under reports/)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if (ROOT / "reports") in out.parents:
        raise SystemExit("--out must not be under reports/ (the JAX package's records)")

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data import pipeline as pipe
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device
    from carla_imitation_learning_tpu_torch.models import AuxNet, PolicyCNN
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import (
        aux_loss_fn, aux_seg_loss_fn, bc_loss_fn,
    )
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_train_step,
    )

    dev = resolve_device(args.device)
    town = make_town(blocks=args.town_blocks, n_buildings=24, n_lights=8)
    params = SimParams(n_agents=15)
    rcfg = RenderConfig(height=args.size, width=args.size)
    fs = 4
    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
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

    t0 = time.perf_counter()

    def run_seed(seed: int) -> None:
        r: dict = {}
        result["runs"][str(seed)] = r
        tc = time.perf_counter()
        store, _, traj = cl.collect_dataset(params, town, rcfg, gen(1000 * seed + 2),
                                            args.collect_envs, args.collect_steps,
                                            frame_skip=fs, record_semantic="seg" in arms,
                                            device=dev)
        sem = cl.semantic_stream(traj) if "seg" in arms else None
        del traj
        sync()
        r["dataset_frames"] = len(store)
        r["collect_seconds"] = time.perf_counter() - tc
        save()

        def evaluate(policy_fn) -> dict:
            m = cl.evaluate_policy(params, town, rcfg, policy_fn, gen(1000 * seed + 102),
                                   n_envs=args.eval_envs, n_steps=args.eval_steps,
                                   frame_skip=fs, device=dev)
            return {k: (None if v is None else float(v)) for k, v in m.items()}

        def train(model, loss, batches) -> tuple:
            state = create_train_state(model, AdamConfig(schedule=lambda count: 1e-3),
                                       generator=gen(1000 * seed + 1), device=dev)
            step = make_train_step(loss)
            last = {}
            tt = time.perf_counter()
            for _ in range(args.epochs):
                for batch in batches():
                    state, last = step(state, batch)
            metrics = {k: float(v) for k, v in last.items()}
            sync()
            metrics["train_seconds"] = time.perf_counter() - tt
            return state.model, metrics

        def aux_batches(zero_all: bool):
            base = pipe.DeviceDataset(store, args.batch, frame_skip=fs, shuffle=True,
                                      aux=True, seed=seed, device=dev)
            drop = np.random.default_rng(seed)

            def batches():
                for (frames, sensor), y in base:
                    if zero_all:
                        sensor = torch.zeros_like(sensor)
                    elif args.speed_dropout > 0.0:
                        keep = drop.random(sensor.shape[0]) >= args.speed_dropout
                        mask = np.concatenate([np.ones((sensor.shape[0], 1)),
                                               np.repeat(keep[:, None], 2, axis=1)], axis=1)
                        sensor = sensor * torch.from_numpy(mask.astype(np.float32)).to(dev)
                    yield (frames, sensor), y
            return batches

        def arm(name: str) -> tuple:
            if name == "bc":
                ds = pipe.DeviceDataset(store, args.batch, frame_skip=fs, shuffle=True,
                                        seed=seed, device=dev)
                model, metrics = train(PolicyCNN(obs_size=fs), bc_loss_fn, lambda: iter(ds))
                return (lambda obs: model(obs).argmax(-1)), metrics
            seg = name == "seg"
            net = AuxNet(obs_size=fs, image_hw=rcfg.height, seg_classes=8 if seg else 0)
            if seg:
                ds = pipe.AuxSegDataset(pipe.DeviceDataset(
                    store, args.batch, frame_skip=fs, shuffle=True, aux=True, seed=seed,
                    device=dev), sem, speed_dropout=args.speed_dropout, seed=seed)
                model, metrics = train(net, aux_seg_loss_fn(0.0, 0.0, 1.0, args.seg_weight),
                                       lambda: iter(ds))
            else:
                model, metrics = train(net, aux_loss_fn(0.0, 0.0, 1.0),
                                       aux_batches(name == "nosensor"))
            if name == "nosensor":
                def policy_fn(obs, extras):
                    return model(obs, torch.zeros_like(extras["sensor"]))[2].argmax(-1)
                return policy_fn, metrics
            return model.as_policy_fn(), metrics

        for name in arms:
            policy_fn, metrics = arm(name)
            with torch.no_grad():
                r[name] = {"train": metrics, "eval": evaluate(policy_fn)}
            print(f"[seed {seed}] {name}: score={r[name]['eval']['driving_score']:.4f} "
                  f"train={metrics}", file=sys.stderr, flush=True)
            save()

    seeds = [args.seed + i for i in range(max(1, args.seeds))]
    for seed in seeds:
        ts = time.perf_counter()
        run_seed(seed)
        result["runs"][str(seed)]["seed_seconds"] = time.perf_counter() - ts
        save()

    summary: dict = {}
    for name in arms:
        vals = [result["runs"][str(s)][name]["eval"]["driving_score"] for s in seeds]
        summary[name] = {"mean": float(np.mean(vals)), "min": float(np.min(vals)),
                         "max": float(np.max(vals)), "values": vals}
    result["summary"] = summary
    result["wall_seconds"] = time.perf_counter() - t0
    save()
    line = {"metric": "seg_aux_driving_score_delta",
            "value": (summary["seg"]["mean"] - summary["plain"]["mean"]
                      if {"seg", "plain"} <= set(summary) else None),
            "unit": "driving score (seg - plain)", "seeds": len(seeds),
            **{name: summary[name]["mean"] for name in arms}}
    if "seg" in arms:
        line["seg_miou"] = [result["runs"][str(s)]["seg"]["train"]["seg_miou"] for s in seeds]
    print(json.dumps(line))
    return result


if __name__ == "__main__":
    main()
