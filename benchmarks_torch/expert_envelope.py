#!/usr/bin/env python3
"""Expert safety-envelope ablation in the PyTorch port: what each
longitudinal-control lever buys the label source.

The port of the JAX package's ``benchmarks/expert_envelope.py``. It
scores the same evaluation fleet of the bench town (15 agents, a 128²
camera) with the expert under each envelope stage, a set of
``SimParams`` overrides (``stages``):

    none                    — headway_gap=0, yield_gap=0
    headway                 — corridor time-headway braking only
    headway_yield           — headway + first-come junction right-of-way
                              (the default)
    headway_yield_turnspeed — the above + the slow-for-turn cruise cap

Each stage is one ``evaluate_policy`` of the expert at ``--envs`` ×
``--steps`` from one generator (seed 100 + ``--seed``). The rollout takes
its frames from kernel B, whatever the camera's config asks: the port's
``make_rollout`` forces the fast grayscale path, as the JAX package's does
on its Pallas backend.

    python3 benchmarks_torch/expert_envelope.py [--envs 256] [--steps 300]
        [--turn-speed 4.0] [--seed 0] [--device cuda] [--out PATH]

Writes ``--out`` (default ``reports/torch_expert_envelope.json``, beside
the JAX package's ``reports/expert_envelope.json``) after every stage:
``config``, ``device``, on a card its ``nvidia-smi`` name and power limit,
each stage's ``KEEP`` metrics and ``wall_seconds``. The last line of
standard output is one JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_TOWN = {"blocks": 3, "n_buildings": 24, "n_lights": 8}
KEEP = ("driving_score", "route_completion", "collisions_per_km",
        "red_violations_per_km", "mean_speed", "clean_episode_rate", "km_driven")


def stages(turn_speed: float) -> dict:
    """stage name → its ``SimParams`` overrides."""
    return {
        "none": dict(headway_gap=0.0, yield_gap=0.0),
        "headway": dict(yield_gap=0.0),
        "headway_yield": dict(),
        "headway_yield_turnspeed": dict(turn_speed=turn_speed),
    }


def score_stage(town, rcfg, overrides: dict, n_envs: int, n_steps: int, seed: int,
                dev) -> dict:
    """The expert's ``KEEP`` metrics under one stage's overrides."""
    import torch

    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl

    params = SimParams(n_agents=15, **overrides)
    m = cl.evaluate_policy(params, town, rcfg, None, torch.Generator().manual_seed(100 + seed),
                           n_envs=n_envs, n_steps=n_steps, device=dev)
    return {k: None if m[k] is None else float(m[k]) for k in KEEP}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--turn-speed", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_expert_envelope.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town

    dev = resolve_device(args.device)
    town = make_town(**BENCH_TOWN).to(dev)
    rcfg = RenderConfig(height=128, width=128)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    result: dict = {"config": vars(args), "device": str(dev)}
    if dev.type == "cuda":
        result["card"] = card_line()
    t0 = time.perf_counter()
    for name, overrides in stages(args.turn_speed).items():
        result[name] = score_stage(town, rcfg, overrides, args.envs, args.steps, args.seed,
                                   dev)
        print(f"{name}: {result[name]}", flush=True)
        out.write_text(json.dumps(result, indent=2) + "\n")
    result["wall_seconds"] = time.perf_counter() - t0
    out.write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps({
        "metric": "expert_collisions_per_km",
        "value": result["headway_yield"]["collisions_per_km"],
        "unit": "collisions/km (default envelope)",
        "r3_no_envelope": result["none"]["collisions_per_km"],
        "driving_score": result["headway_yield"]["driving_score"],
        "turnspeed_score": result["headway_yield_turnspeed"]["driving_score"],
        "device": str(dev), "card": result.get("card"),
    }), flush=True)
    return result


if __name__ == "__main__":
    main()
