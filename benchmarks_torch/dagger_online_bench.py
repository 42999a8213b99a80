#!/usr/bin/env python3
"""A/B: online DAgger (``make_online_dagger``) against host-mediated DAgger,
at matched compute, in the PyTorch port (the JAX package's
``benchmarks/dagger_online_bench.py``).

Both run ``--rounds`` rounds of ``--envs`` × ``--steps`` rollouts (round 0
the expert, then the policy) and ``--train-steps`` train steps per round
at ``--batch``, from a fresh bf16 ``PolicyCNN`` with Adam(1e-3):
- online: the aggregation buffer stays on the card, every round writes its
  trajectory into it and each train step gathers its windows from it;
  nothing is read back until the per-round metrics at the end;
- host-mediated: each round goes through ``collect_dataset`` /
  ``dagger_iteration`` (one host copy per field), ``FrameStore.concat`` of
  every round's store and a new ``DeviceDataset`` (one upload of the whole
  aggregate), then the train steps over its shuffled epochs.

Each path runs twice: "cold" is its first run in the process (the first
launch builds kernel B's library), "warm" its second, from fresh weights
and a fresh fleet. Wall clock on the host, with the card synchronized.

    python3 benchmarks_torch/dagger_online_bench.py --out REPORT.json
        [--rounds 3] [--envs 64] [--steps 300] [--train-steps 400]
        [--batch 128] [--device cuda]

The report goes to ``--out`` (never under ``reports/``, the JAX package's
records); the last line of standard output is one JSON summary.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="report path (not under reports/)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if (ROOT / "reports") in out.parents:
        raise SystemExit("--out must not be under reports/ (the JAX package's records)")

    sys.path.insert(0, str(ROOT))
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.device import resolve_device
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.online_dagger import make_online_dagger
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_train_step,
    )

    dev = resolve_device(args.device)
    params = SimParams(n_agents=15)
    town = make_town(blocks=3, n_buildings=24, n_lights=8)
    rcfg = RenderConfig(height=128, width=128)
    result: dict = {"config": vars(args), "device": str(dev)}
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

    def fresh_state():
        return create_train_state(PolicyCNN(dtype=torch.bfloat16),
                                  AdamConfig(schedule=lambda count: 1e-3),
                                  generator=gen(args.seed), device=dev)

    run = make_online_dagger(PolicyCNN.__call__, params, town, rcfg, n_envs=args.envs,
                             n_steps=args.steps, rounds=args.rounds,
                             train_steps=args.train_steps, batch=args.batch, device=dev)
    for name, seed in (("cold", 1), ("warm", 2)):
        state = fresh_state()
        sync()
        t0 = time.perf_counter()
        _, m = run(state, gen(seed))
        result[f"online_{name}_s"] = time.perf_counter() - t0
    result["online_loss_per_round"] = [float(x) for x in m["loss"]]
    result["online_agreement"] = [float(x) for x in m["agreement"]]
    result["online_valid_frac"] = [float(x) for x in m["valid_frac"]]
    result["buffer_mib"] = args.rounds * args.steps * args.envs * (128 * 128 + 9) / 2 ** 20
    save()
    print(f"online: cold {result['online_cold_s']:.2f} s, warm {result['online_warm_s']:.2f} s",
          flush=True)

    def policy_from(model):
        return lambda obs: model(obs).argmax(-1)

    def host_dagger(seed: int) -> tuple[float, list]:
        generator = gen(seed)
        state = fresh_state()
        step = make_train_step(bc_loss_fn)
        stores, losses = [], []
        sync()
        t0 = time.perf_counter()
        for rnd in range(args.rounds):
            if rnd == 0:
                store, _, _ = cl.collect_dataset(params, town, rcfg, generator, args.envs,
                                                 args.steps, device=dev)
            else:
                store, _, _ = cl.dagger_iteration(params, town, rcfg, policy_from(state.model),
                                                  generator, args.envs, args.steps, device=dev)
            stores.append(store)
            ds = DeviceDataset(FrameStore.concat(stores), args.batch, shuffle=True, seed=rnd,
                               device=dev)
            done, last = 0, None
            while done < args.train_steps:
                for batch in ds:
                    state, last = step(state, batch)
                    done += 1
                    if done >= args.train_steps:
                        break
            losses.append(float(last["loss"]))
        return time.perf_counter() - t0, losses

    result["host_cold_s"], _ = host_dagger(1)
    result["host_warm_s"], result["host_final_loss_per_round"] = host_dagger(2)
    save()
    print(f"host: cold {result['host_cold_s']:.2f} s, warm {result['host_warm_s']:.2f} s",
          flush=True)
    result["speedup_warm"] = result["host_warm_s"] / max(result["online_warm_s"], 1e-9)
    save()
    print(json.dumps({"metric": "dagger_online_speedup_warm", "value": result["speedup_warm"],
                      "unit": "x vs host-mediated dagger (matched compute)",
                      "online_warm_s": result["online_warm_s"],
                      "host_warm_s": result["host_warm_s"], "card": result.get("card")}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
