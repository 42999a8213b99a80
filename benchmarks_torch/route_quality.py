#!/usr/bin/env python3
"""A→B route quality of the PyTorch port: expert vs untrained vs
goal-trained CIL vs DAgger-CIL.

The CARLA leaderboard's task is destination-based: drive from A to B along
a planned route. This harness runs the port's whole route stack, as the
JAX package's ``benchmarks/route_quality.py`` does: the route planner
(``sim/planner.py``, host Dijkstra baked into tables on the card) →
goal-directed expert collection (the commands announce the planner's
turns) → ``BranchedCILPolicy`` training → ``evaluate_routes`` (arrival
rate, steps to arrival, infractions per km), with the expert as the
ceiling. Its world is the JAX harness's: a 3 × 3-block town with 2 lanes
per direction, super-blocks and turn fans, ``SimParams(n_agents=15,
episode_len=2500, lane_change_period=160)``, 128², a bf16 CIL policy with
6 commands. Half the collection runs on the mirrored town (every left turn
a right) and epoch sampling balances the joint (action, command) key,
unless ``--no-mirror`` / ``--no-balance``.

Per seed (the town and the goals stay fixed, drawn from ``--seed``):

1. expert: ``evaluate_routes`` with the autopilot;
2. untrained: the policy drawn as flax draws it, evaluated on its own fleet;
3. cil: ``collect_dataset(goal_ids=...)`` on each world, ``--epochs``
   epochs of Adam(1e-3) on ``DeviceDataset(cil=True)`` of their
   concatenation, then ``evaluate_routes``;
4. dagger_cil (``--dagger-rounds`` rounds, ``--dagger-epochs`` > 0): the
   policy drives to the goals on each world and the expert labels
   (``dagger_iteration``), then ``--dagger-epochs`` epochs on every store so
   far, then ``evaluate_routes``.

Each tier and seed draws from its own ``torch.Generator`` (eval fleets
1000·seed + 100 to 103, init 1000·seed + 1, collection 1000·seed + 2 + w,
DAgger 1000·seed + 20 + 2·round + w), so the streams differ from the JAX
package's: compare ranges across seeds, not values.

    python3 benchmarks_torch/route_quality.py --out REPORT.json [--seeds 3]
        [--dagger-rounds 1] [--device cuda]

The report is written to ``--out`` after every tier (never under
``reports/``, which holds the JAX package's records); the last line of
standard output is one JSON summary. On the card the report carries the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AGG_KEYS = ("arrival_rate", "arrivals", "attempts", "crashes", "timeouts",
            "infractions_per_km", "mean_steps_to_arrival", "km_driven")
TIERS = ("expert", "untrained", "cil", "dagger_cil")
N_COMMANDS = 6


def summarize(runs: dict) -> dict:
    """Per tier and key: mean, min, max and the values over seeds."""
    import numpy as np

    summary = {}
    for tier in TIERS:
        if not all(tier in r for r in runs.values()):
            continue
        summary[tier] = {}
        for k in AGG_KEYS:
            vals = [r[tier][k] for r in runs.values() if r[tier][k] is not None]
            if vals:
                summary[tier][k] = {"mean": float(np.mean(vals)), "min": float(np.min(vals)),
                                    "max": float(np.max(vals)), "values": vals}
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=64, help="eval fleet size")
    ap.add_argument("--steps", type=int, default=2500, help="eval horizon")
    ap.add_argument("--goals", type=int, default=8)
    ap.add_argument("--collect-envs", type=int, default=64)
    ap.add_argument("--collect-steps", type=int, default=800,
                    help="total collection budget, split across the town and its mirror "
                         "unless --no-mirror")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--dagger-epochs", type=int, default=4,
                    help="epochs on the aggregated store after each DAgger round "
                         "(0 skips the tier)")
    ap.add_argument("--dagger-rounds", type=int, default=1)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--episode-len", type=int, default=2500,
                    help="step budget of one route attempt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="collection / training / eval repetitions (town and goals fixed)")
    ap.add_argument("--no-mirror", action="store_true")
    ap.add_argument("--no-balance", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="report path (not under reports/)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if (ROOT / "reports") in out.parents:
        raise SystemExit("--out must not be under reports/ (the JAX package's records)")

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device
    from carla_imitation_learning_tpu_torch.models import BranchedCILPolicy
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.planner import goal_setup
    from carla_imitation_learning_tpu_torch.sim.town import make_town, mirror_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import cil_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_fused_epoch,
    )

    dev = resolve_device(args.device)
    town = make_town(blocks=3, n_buildings=24, n_lights=8, lanes_per_direction=2,
                     superblocks=True, turn_fans=True, seed=args.seed)
    t_plan = time.perf_counter()
    town, goals, goal_ids = goal_setup(town, args.goals, args.collect_envs, seed=args.seed)
    plan_seconds = time.perf_counter() - t_plan
    params = SimParams(n_agents=15, episode_len=args.episode_len, lane_change_period=160)
    rcfg = RenderConfig(height=128, width=128)
    worlds = [town] if args.no_mirror else [town, mirror_town(town)]
    per = args.collect_steps // len(worlds)
    balance = {} if args.no_balance else dict(balanced=True, balance_key="action_command")
    loss_fn = cil_loss_fn()

    result: dict = {"config": vars(args), "device": str(dev), "goals": goals.tolist(),
                    "plan_seconds": plan_seconds, "runs": {}}
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

    def fit(store, state, epochs: int, fit_seed: int):
        """``epochs`` fused epochs on ``DeviceDataset(cil=True)`` → (state,
        last metrics)."""
        ds = DeviceDataset(store, args.batch, shuffle=True, seed=fit_seed, cil=True,
                           device=dev, **balance)
        epoch = make_fused_epoch(loss_fn, ds.pure_batch)
        metrics = None
        for _ in range(epochs):
            nb = len(ds)
            order = ds.epoch_indices()[:nb * args.batch].reshape(nb, -1)
            state, _, metrics = epoch(state, torch.from_numpy(order).to(dev))
        sync()
        return state, metrics

    def run_seed(seed: int) -> None:
        r: dict = {}
        result["runs"][str(seed)] = r

        def ev(policy_fn, key: int) -> dict:
            t0 = time.perf_counter()
            m = cl.evaluate_routes(params, town, rcfg, policy_fn, gen(1000 * seed + key),
                                   n_envs=args.envs, n_steps=args.steps, device=dev)
            m["seconds"] = time.perf_counter() - t0
            return m

        r["expert"] = ev(None, 100)
        print(f"[seed {seed}] expert: {r['expert']}", flush=True)
        save()

        state = create_train_state(BranchedCILPolicy(n_commands=N_COMMANDS),
                                   AdamConfig(schedule=lambda count: 1e-3),
                                   generator=gen(1000 * seed + 1), device=dev)
        r["untrained"] = ev(state.model.as_policy_fn(), 101)
        print(f"[seed {seed}] untrained: {r['untrained']}", flush=True)
        save()

        tc = time.perf_counter()
        stores = [cl.collect_dataset(params, w, rcfg, gen(1000 * seed + 2 + i),
                                     args.collect_envs, per, goal_ids=goal_ids,
                                     device=dev)[0] for i, w in enumerate(worlds)]
        store = FrameStore.concat(stores)
        r["collect_seconds"] = time.perf_counter() - tc
        r["dataset_frames"] = len(store)
        hist = np.bincount(store.commands, minlength=N_COMMANDS)
        r["command_histogram"] = hist.tolist()
        r["command_min_frac"] = float(hist.min() / hist.sum())
        print(f"[seed {seed}] command histogram: {hist.tolist()}", flush=True)
        save()

        tt = time.perf_counter()
        state, metrics = fit(store, state, args.epochs, 31 * seed + 7)
        if metrics is not None:
            r["cil_final_loss"] = float(metrics["loss"][-1])
            r["cil_final_accuracy"] = float(metrics["accuracy"][-1])
        r["train_seconds"] = time.perf_counter() - tt
        r["train_steps"] = state.step
        save()
        r["cil"] = ev(state.model.as_policy_fn(), 102)
        print(f"[seed {seed}] cil: {r['cil']}", flush=True)
        save()

        if args.dagger_epochs > 0 and args.dagger_rounds > 0:
            td = time.perf_counter()
            agg = [store]
            for rnd in range(args.dagger_rounds):
                for i, w in enumerate(worlds):
                    s, _, _ = cl.dagger_iteration(
                        params, w, rcfg, state.model.as_policy_fn(),
                        gen(1000 * seed + 20 + 2 * rnd + i), args.collect_envs, per,
                        goal_ids=goal_ids, device=dev)
                    agg.append(s)
                state, metrics = fit(FrameStore.concat(agg), state, args.dagger_epochs,
                                     31 * seed + 13 + rnd)
            r["dagger_frames"] = sum(len(s) for s in agg)
            if metrics is not None:
                r["dagger_final_loss"] = float(metrics["loss"][-1])
            r["dagger_seconds"] = time.perf_counter() - td
            r["dagger_cil"] = ev(state.model.as_policy_fn(), 103)
            print(f"[seed {seed}] dagger_cil: {r['dagger_cil']}", flush=True)
            save()

    t0 = time.perf_counter()
    seeds = list(range(args.seed, args.seed + max(1, args.seeds)))
    for seed in seeds:
        ts = time.perf_counter()
        run_seed(seed)
        result["runs"][str(seed)]["seed_seconds"] = time.perf_counter() - ts
        save()
    summary = summarize(result["runs"])
    result["summary"] = summary
    result["command_histogram"] = result["runs"][str(seeds[0])].get("command_histogram")
    result["wall_seconds"] = time.perf_counter() - t0
    save()
    tiers = [t for t in TIERS if "arrival_rate" in summary.get(t, {})]
    best = "dagger_cil" if "dagger_cil" in tiers else "cil"
    line = {"metric": "route_arrival_rate_cil", "seeds": len(seeds), "device": str(dev),
            "card": result.get("card"),
            **{t: summary[t]["arrival_rate"]["mean"] for t in tiers},
            "value": summary.get(best, {}).get("arrival_rate", {}).get("mean"),
            "command_histogram": result["command_histogram"],
            "spread": {t: [summary[t]["arrival_rate"]["min"], summary[t]["arrival_rate"]["max"]]
                       for t in tiers}}
    print(json.dumps(line), flush=True)
    return result


if __name__ == "__main__":
    main()
