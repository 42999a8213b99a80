#!/usr/bin/env python3
"""End-to-end driving quality of the PyTorch port: expert vs untrained vs BC
vs DAgger vs PPO.

The rungs of the JAX package's ``benchmarks/driving_quality.py`` that the
port can run: the expert's closed-loop driving score, an untrained
``PolicyCNN``'s, a ``PolicyCNN`` trained by behaviour cloning on data the
expert collected on the card, that policy behind the safety shield, refined
by DAgger, and fine-tuned by PPO. Per seed, the whole pipeline runs anew:

1. expert: ``evaluate_policy`` with the autopilot driving;
2. untrained: a bf16 ``PolicyCNN`` drawn as flax draws it
   (``create_train_state`` with a generator), evaluated on its own fleet;
3. BC: ``collect_dataset`` with the expert (kernel B renders every step;
   with ``--noise`` the executed steer carries ``NoiseConfig(seed=seed)``),
   a shuffled ``DeviceDataset``, ``--epochs`` epochs of Adam(1e-3) without
   clipping through the fused epoch, then ``evaluate_policy``;
4. DAgger, ``--dagger`` rounds (default 2): each collects at the BC
   collection's size with the current policy driving and the expert
   labelling (``dagger_iteration``), trains ``max(2, epochs // 2)`` epochs
   on ``FrameStore.concat`` of every store so far (shuffle seed 1000 +
   17·seed + round), and is evaluated on one fleet (key 103) for every
   round: the rungs ``dagger_r1``, ``dagger_r2``, ... and ``dagger`` (the
   last); the report carries ``dagger_frames``;
5. with ``--shield``, ``bc_shield``: the BC policy behind the emergency
   brake (``training.shield.ShieldConfig()``) on the BC rung's fleet, with
   its interventions per km and active share;
6. with ``--rl N``, ``rl``: an ``ActorCriticCNN`` warm-started from the
   last imitation policy (BC or BC + DAgger), ``N`` PPO iterations of
   ``--rl-envs`` × ``--rl-steps`` (``ppo_train``, ``PPOConfig()`` with
   ``--rl-w-red`` as its red-light penalty when given; generator 1000·seed
   + 3), then the deterministic actor on fleet 104; the report carries
   ``rl_seconds``, the first and last three iterations and the median
   env-steps/s of the iterations after the first.

``--arch vit`` trains and evaluates the ``bc_vit`` preset's ``ViTPolicy``
(patch 16, dim 192, depth 4, heads 3, bf16) in place of the ``PolicyCNN``
on every rung (it has no PPO warm start, so it refuses ``--rl``);
``--balanced`` samples the BC and DAgger datasets by inverse action
frequency (``DeviceDataset(balanced=True)``). The JAX package's records of
these are ``reports/driving_quality_vit.json`` and
``reports/driving_quality_balanced.json``.

Defaults are the JAX harness's: eval 256 envs × 300 steps, collection 64 ×
500, 8 epochs, batch 256, the bench town, 128², bf16 ``PolicyCNN``. Each
rung and seed draws from its own ``torch.Generator`` (eval fleets
1000·seed + 100, 101, 102, 103, 104; init 1000·seed + 1; collection
1000·seed + 2, DAgger round r's 1000·seed + 10 + r),
so the streams differ from the JAX package's: compare ranges across seeds,
not values.

    python3 benchmarks_torch/driving_quality.py --out REPORT.json
        [--seeds 3] [--dagger 2] [--noise] [--shield] [--rl 12]
        [--arch cnn|vit] [--balanced]
        [--rl-envs 256] [--rl-steps 128] [--rl-w-red W] [--device cuda]

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


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


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
    ap.add_argument("--dagger", type=int, default=2,
                    help="DAgger rounds on top of BC (0 to skip)")
    ap.add_argument("--noise", action="store_true",
                    help="steering noise on the BC expert collection (labels stay clean)")
    ap.add_argument("--shield", action="store_true",
                    help="add the bc_shield rung: the BC policy behind the safety shield")
    ap.add_argument("--arch", choices=["cnn", "vit"], default="cnn",
                    help="the trained rungs' network: PolicyCNN or the ViT")
    ap.add_argument("--balanced", action="store_true",
                    help="inverse-frequency action sampling of the training sets")
    ap.add_argument("--rl", type=int, default=0,
                    help="PPO iterations on top of the imitation policy (0 to skip)")
    ap.add_argument("--rl-envs", type=int, default=256)
    ap.add_argument("--rl-steps", type=int, default=128, help="PPO rollout horizon")
    ap.add_argument("--rl-w-red", type=float, default=None,
                    help="PPOConfig.w_red (the red-light crossing penalty)")
    ap.add_argument("--seed", type=int, default=0, help="base seed")
    ap.add_argument("--seeds", type=int, default=1,
                    help="full pipeline repetitions (seed, seed + 1, ...)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="report path (not under reports/)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if (ROOT / "reports") in out.parents:
        raise SystemExit("--out must not be under reports/ (the JAX package's records)")
    if args.arch == "vit" and args.rl:
        raise SystemExit("--arch vit has no PPO warm start (ActorCriticCNN's trunk): drop --rl")

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.device import resolve_device
    from carla_imitation_learning_tpu_torch.models import PolicyCNN, ViTPolicy
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.rl import (
        ActorCriticCNN, PPOConfig, ppo_train, warm_start_from_policy,
    )
    from carla_imitation_learning_tpu_torch.training.shield import ShieldConfig
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, flax_init_, make_fused_epoch,
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

    def train(state, ds, epochs: int):
        """``epochs`` fused epochs → (state, images, seconds, last metrics)."""
        epoch = make_fused_epoch(bc_loss_fn, ds.pure_batch)
        sync()
        t0 = time.perf_counter()
        metrics, images = None, 0
        for _ in range(epochs):
            nb = len(ds)
            order = ds.epoch_indices()[:nb * args.batch].reshape(nb, -1)
            state, _, metrics = epoch(state, torch.from_numpy(order).to(dev))
            images += order.size
        sync()
        return state, images, time.perf_counter() - t0, metrics

    def run_seed(seed: int) -> None:
        r: dict = {}
        result["runs"][str(seed)] = r

        def ev(policy_fn, key: int, shield=None) -> dict:
            m = cl.evaluate_policy(params, town, rcfg, policy_fn, gen(1000 * seed + key),
                                   n_envs=args.envs, n_steps=args.steps, device=dev,
                                   shield=shield)
            extra = ("shield_interventions_per_km", "shield_active_frac") if shield else ()
            return {k: m[k] for k in KEEP + extra}

        r["expert"] = ev(None, 100)
        print(f"[seed {seed}] expert: {r['expert']}", flush=True)
        save()

        net = (ViTPolicy(dtype=torch.bfloat16) if args.arch == "vit"
               else PolicyCNN(dtype=torch.bfloat16))
        state = create_train_state(net,
                                   AdamConfig(schedule=lambda count: 1e-3),
                                   generator=gen(1000 * seed + 1), device=dev)
        r["untrained"] = ev(policy_from(state.model), 101)
        print(f"[seed {seed}] untrained: {r['untrained']}", flush=True)
        save()

        tc = time.perf_counter()
        noise = cl.NoiseConfig(seed=seed) if args.noise else None
        store, _, traj = cl.collect_dataset(params, town, rcfg, gen(1000 * seed + 2),
                                            args.collect_envs, args.collect_steps,
                                            noise=noise, device=dev)
        del traj
        r["collect_seconds"] = time.perf_counter() - tc
        r["dataset_frames"] = len(store)

        ds = DeviceDataset(store, args.batch, shuffle=True, seed=seed, device=dev,
                           balanced=args.balanced)
        state, images, r["train_seconds"], metrics = train(state, ds, args.epochs)
        del ds
        r["train_steps"] = state.step
        r["train_images_per_s"] = images / r["train_seconds"]
        if metrics is not None:
            r["bc_final_loss"] = float(metrics["loss"][-1])
            r["bc_final_accuracy"] = float(metrics["accuracy"][-1])
        save()
        r["bc"] = ev(policy_from(state.model), 102)
        print(f"[seed {seed}] bc: {r['bc']}", flush=True)
        save()
        if args.shield:
            r["bc_shield"] = ev(policy_from(state.model), 102, shield=ShieldConfig())
            print(f"[seed {seed}] bc_shield: {r['bc_shield']}", flush=True)
            save()

        stores = [store]
        for rnd in range(args.dagger):
            tc = time.perf_counter()
            dstore, _, traj = cl.dagger_iteration(
                params, town, rcfg, policy_from(state.model), gen(1000 * seed + 10 + rnd),
                args.collect_envs, args.collect_steps, device=dev)
            del traj
            stores.append(dstore)
            ds = DeviceDataset(FrameStore.concat(stores), args.batch, shuffle=True,
                               seed=1000 + 17 * seed + rnd, device=dev, balanced=args.balanced)
            state, images, seconds, metrics = train(state, ds, max(2, args.epochs // 2))
            del ds
            tier = f"dagger_r{rnd + 1}"
            r[f"{tier}_collect_seconds"] = time.perf_counter() - tc - seconds
            r[f"{tier}_train_seconds"] = seconds
            r[f"{tier}_final_loss"] = float(metrics["loss"][-1])
            r[tier] = ev(policy_from(state.model), 103)
            print(f"[seed {seed}] {tier}: {r[tier]}", flush=True)
            save()
        if args.dagger:
            r["dagger_frames"] = sum(len(s) for s in stores)
            r["dagger"] = r[f"dagger_r{args.dagger}"]
            save()
        if args.rl:
            ac = flax_init_(ActorCriticCNN(dtype=torch.bfloat16), gen(1000 * seed + 3))
            warm_start_from_policy(ac, state.model)
            pcfg = PPOConfig() if args.rl_w_red is None else PPOConfig(w_red=args.rl_w_red)
            ac_state = create_train_state(
                ac, AdamConfig(schedule=lambda count: pcfg.learning_rate,
                               clip=pcfg.max_grad_norm), device=dev)
            tr = time.perf_counter()
            _, hist = ppo_train(params, town, rcfg, ac_state, gen(1000 * seed + 3),
                                n_envs=args.rl_envs, rollout_steps=args.rl_steps,
                                iterations=args.rl, cfg=pcfg, device=dev)
            r["rl_seconds"] = time.perf_counter() - tr
            r["rl_history"] = hist[:3] + hist[-3:] if len(hist) > 6 else hist
            r["rl_env_steps_per_sec"] = (float(np.median([h["env_steps_per_sec"]
                                                          for h in hist[1:]]))
                                         if len(hist) > 1 else None)
            save()
            r["rl"] = ev(lambda obs: ac(obs)[0].argmax(-1), 104)
            print(f"[seed {seed}] rl: {r['rl']}", flush=True)
            save()

    t0 = time.perf_counter()
    for seed in range(args.seed, args.seed + max(1, args.seeds)):
        ts = time.perf_counter()
        run_seed(seed)
        result["runs"][str(seed)]["seed_seconds"] = time.perf_counter() - ts
        save()
    tiers = ["expert", "untrained", "bc"] + (["bc_shield"] if args.shield else [])
    tiers += [f"dagger_r{i + 1}" for i in range(args.dagger)]
    tiers += (["dagger"] if args.dagger else []) + (["rl"] if args.rl else [])
    result["summary"] = summarize(result["runs"], tiers)
    result["wall_seconds"] = time.perf_counter() - t0
    save()
    line = {"metric": "closed_loop_driving_score_dagger" if args.dagger
            else "closed_loop_driving_score_bc", "seeds": args.seeds, "noise": args.noise,
            "shield": args.shield, "rl_iterations": args.rl, "arch": args.arch,
            "balanced": args.balanced,
            "device": str(dev), "card": result.get("card"),
            **{t: result["summary"][t]["driving_score"]["mean"] for t in tiers},
            "spread": {t: [result["summary"][t]["driving_score"]["min"],
                           result["summary"][t]["driving_score"]["max"]] for t in tiers}}
    print(json.dumps(line), flush=True)
    return result


if __name__ == "__main__":
    main()
