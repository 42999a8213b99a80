#!/usr/bin/env python3
"""ViT crossover hunt in the PyTorch port: does the transformer convert a
fixed wall-clock training budget into a better driving score than the CNN
at 256² observations?

The port of the JAX package's ``benchmarks/vit_crossover.py``. Protocol:
one expert collection at ``--obs-hw``² (``--collect-envs`` ×
``--collect-steps``); the bf16 ``PolicyCNN`` trains ``--epochs`` epochs and
its wall after the first epoch sets the budget; each ViT (the stock 192d /
4-layer ``vit_2m`` and ``vit_scaled`` at ``--vit-dim`` / ``--vit-depth`` /
``--vit-heads``) then trains whole epochs until that wall has passed after
its own first epoch, or 64 epochs (``train_until``). Every model starts
from the same seed's flax-distributed draws and trains with Adam 1e-3 on
``DeviceDataset`` batches of ``--batch``. The expert and all three
policies drive the same ``--envs`` × ``--steps`` evaluation fleet at
``--obs-hw``² (generators 100 for the expert, 102–104 for the policies).

Every rollout step renders its frame with kernel B at ``--obs-hw``²: the
port's ``make_rollout`` forces the fast grayscale path, as the JAX
package's does on its Pallas backend.

    python3 benchmarks_torch/vit_crossover.py [--obs-hw 256] [--envs 128]
        [--steps 300] [--collect-envs 32] [--collect-steps 500] [--epochs 8]
        [--batch 128] [--vit-dim 384] [--vit-depth 6] [--vit-heads 6]
        [--seed 0] [--device cuda] [--out PATH]

Writes ``--out`` (default ``reports/torch_vit_crossover.json``, beside the
JAX package's ``reports/vit_crossover.json``) after every stage, with the
JAX report's keys, ``device``, on a card its ``nvidia-smi`` name and power
limit, and ``reduced``: each depth argument (``--collect-steps``,
``--epochs``, ``--steps``) set below its default, with both values. The
last line of standard output is one JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_TOWN = {"blocks": 3, "n_buildings": 24, "n_lights": 8}
KEEP = ("driving_score", "route_completion", "clean_episode_rate", "collisions_per_km",
        "red_violations_per_km", "mean_speed", "action_agreement")
MAX_EPOCHS = 64
DEPTH_ARGS = ("collect_steps", "epochs", "steps")   # the depth a run may cut


def train_until(run_epoch, budget_s: float | None, epochs: int,
                clock=time.perf_counter) -> tuple[int, float]:
    """Run ``run_epoch()`` for whole epochs → (epochs run, seconds after the
    first). The first epoch pays the warm-up, so the clock starts after it.
    With ``budget_s`` None: exactly ``epochs`` epochs (at least one).
    Otherwise: until ``budget_s`` seconds have passed after the first epoch,
    or ``MAX_EPOCHS`` epochs (at least two)."""
    done, t_start = 0, None
    while True:
        run_epoch()
        done += 1
        if t_start is None:
            t_start = clock()
            if budget_s is None and done >= epochs:
                break
        elif budget_s is None:
            if done >= epochs:
                break
        elif clock() - t_start >= budget_s or done >= MAX_EPOCHS:
            break
    return done, clock() - t_start


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--obs-hw", type=int, default=256,
                    help="rendered observation resolution (camera + policy)")
    ap.add_argument("--envs", type=int, default=128, help="eval fleet size")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--collect-envs", type=int, default=32)
    ap.add_argument("--collect-steps", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=8,
                    help="CNN epochs; sets the shared wall-clock budget")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--vit-dim", type=int, default=384)
    ap.add_argument("--vit-depth", type=int, default=6)
    ap.add_argument("--vit-heads", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_vit_crossover.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from carla_imitation_learning_tpu_torch.data import pipeline as pipe
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device
    from carla_imitation_learning_tpu_torch.models import PolicyCNN, ViTPolicy
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_train_step,
    )

    dev = resolve_device(args.device)
    town = make_town(**BENCH_TOWN).to(dev)
    params = SimParams(n_agents=15)
    hw = args.obs_hw
    rcfg = RenderConfig(height=hw, width=hw)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator().manual_seed(seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    result: dict = {"config": vars(args), "device": str(dev)}
    if dev.type == "cuda":
        result["card"] = card_line()
    reduced = {k: {"default": ap.get_default(k), "run": getattr(args, k)}
               for k in DEPTH_ARGS if getattr(args, k) != ap.get_default(k)}
    if reduced:
        result["reduced"] = reduced
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def save():
        out.write_text(json.dumps(result, indent=2) + "\n")

    def trim(m: dict) -> dict:
        return {k: None if m[k] is None else float(m[k]) for k in KEEP}

    def ev(model, tier_key: int) -> dict:
        model.eval()

        @torch.no_grad()
        def policy_fn(obs):
            return model(obs).argmax(-1)

        return trim(cl.evaluate_policy(params, town, rcfg, policy_fn, gen(tier_key),
                                       n_envs=args.envs, n_steps=args.steps, device=dev))

    tc = time.perf_counter()
    store, _, traj = cl.collect_dataset(params, town, rcfg, gen(args.seed),
                                        args.collect_envs, args.collect_steps, device=dev)
    del traj
    result["dataset_frames"] = len(store)
    result["collect_seconds"] = time.perf_counter() - tc
    result["expert"] = trim(cl.evaluate_policy(params, town, rcfg, None, gen(100),
                                               n_envs=args.envs, n_steps=args.steps,
                                               device=dev))
    save()

    def train_arch(name: str, model, budget_s: float | None, tier_key: int) -> dict:
        state = create_train_state(model, AdamConfig(schedule=lambda count: 1e-3),
                                   generator=gen(args.seed), device=dev)
        step = make_train_step(bc_loss_fn)
        ds = pipe.DeviceDataset(store, args.batch, shuffle=True, seed=args.seed, device=dev)
        last: dict = {}
        steps_done = 0

        def run_epoch():
            nonlocal last, steps_done
            for batch in ds:
                _, last = step(state, batch)
                steps_done += 1
            sync()

        epochs_done, wall = train_until(run_epoch, budget_s, args.epochs)
        r = {
            "params": sum(p.numel() for p in state.model.parameters()),
            "epochs": epochs_done,
            "train_steps": steps_done,
            "train_seconds_post_compile": wall,
            "final_loss": float(last["loss"]),
            "final_accuracy": float(last["accuracy"]),
        }
        r["eval"] = ev(state.model, tier_key)
        result[name] = r
        print(f"{name}: params={r['params']:,} epochs={epochs_done} "
              f"score={r['eval']['driving_score']} acc={r['final_accuracy']:.4f}", flush=True)
        save()
        del state, ds
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return r

    cnn = train_arch("cnn", PolicyCNN(dtype=torch.bfloat16), None, 102)
    budget = cnn["train_seconds_post_compile"]
    result["wall_budget_seconds"] = budget
    train_arch("vit_2m", ViTPolicy(dtype=torch.bfloat16), budget, 103)
    train_arch("vit_scaled", ViTPolicy(dim=args.vit_dim, depth=args.vit_depth,
                                       heads=args.vit_heads, dtype=torch.bfloat16),
               budget, 104)
    result["wall_seconds"] = time.perf_counter() - t0
    save()
    print(json.dumps({
        "metric": "vit_crossover_driving_score",
        "obs_hw": hw,
        "wall_budget_seconds": budget,
        "cnn": result["cnn"]["eval"]["driving_score"],
        "vit_2m": result["vit_2m"]["eval"]["driving_score"],
        "vit_scaled": result["vit_scaled"]["eval"]["driving_score"],
        "expert": result["expert"]["driving_score"],
        "unit": "driving score at matched wall-clock",
        "device": str(dev), "card": result.get("card"),
    }), flush=True)
    return result


if __name__ == "__main__":
    main()
