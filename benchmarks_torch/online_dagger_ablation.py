#!/usr/bin/env python3
"""What moves online DAgger's per-round agreement, in the PyTorch port.

``make_online_dagger`` (beta 0: an expert round 0, then the policy alone)
runs here from one starting policy under several settings, each from a
copy of the same state and a generator of the same seed, and the report
holds each run's per-round loss, agreement and valid_frac beside the
policy's and the expert's action histograms per round. The settings:

- ``init``: ``bc``, a bf16 ``PolicyCNN`` trained by behaviour cloning at
  the size of ``chip_smoke.py``'s BC phase (an expert ``collect_dataset``
  at ``--bc-envs`` × ``--bc-steps``, Adam 1e-3 with the global-norm clip
  0.5, ``--bc-epochs`` fused epochs of at most ``--bc-batches`` batches of
  256), whose optimizer state the online run continues; or ``fresh``, a new bf16
  ``PolicyCNN`` with a new Adam 1e-3 and the same clip;
- ``lod``: the renderer's LOD in pixels, 0 (what the online loop renders by
  default) or 2 (what ``make_rollout``, and so ``dagger_iteration``,
  forces);
- ``train``: ``frozen`` (the run's train steps at learning rate 0, so the
  loss is the starting policy's masked CE on the buffer), or the number
  of train steps a round.

The policy's histogram counts the argmax of every rollout forward (a
wrapper of ``model_apply``); the expert's counts the labels the rollout
stores (the script wraps the module's discretizer). Alongside, each
starting policy drives one ``evaluate_policy`` run at the online fleet's
size from fresh states at 2 px LOD, as the host-mediated loop's first
policy round drives: its ``action_agreement``.

    python3 benchmarks_torch/online_dagger_ablation.py --out REPORT.json
        [--rounds 5] [--envs 256] [--steps 32] [--train-steps 20 200]
        [--batch 256] [--seeds 2] [--device cuda]

The report goes to ``--out`` (never under ``reports/``); the last line of
standard output is one JSON summary of the last round's agreement per run.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_ACTIONS = 9


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--train-steps", type=int, nargs="+", default=[20, 200])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--bc-envs", type=int, default=1024)
    ap.add_argument("--bc-steps", type=int, default=24)
    ap.add_argument("--bc-epochs", type=int, default=2)
    ap.add_argument("--bc-batches", type=int, default=40)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=2, help="online runs per setting")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True, help="report path (not under reports/)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if (ROOT / "reports") in out.parents:
        raise SystemExit("--out must not be under reports/ (the JAX package's records)")

    sys.path.insert(0, str(ROOT))
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training import online_dagger as od
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_fused_epoch, make_optimizer,
    )

    dev = resolve_device(args.device)
    params = SimParams(n_agents=15)
    town = make_town(blocks=3, n_buildings=24, n_lights=8)
    tx = make_optimizer({"LEARNING_RATE": 1e-3, "gradient_clip_val": 0.5})
    result: dict = {"config": vars(args), "device": str(dev), "runs": []}
    if dev.type == "cuda":
        result["card"] = card_line()
    out.parent.mkdir(parents=True, exist_ok=True)

    def save():
        out.write_text(json.dumps(result, indent=2) + "\n")

    def gen(seed: int) -> torch.Generator:
        return torch.Generator().manual_seed(seed)

    rcfg = RenderConfig(height=args.hw, width=args.hw)
    store, _, _ = cl.collect_dataset(params, town, rcfg, gen(21), args.bc_envs, args.bc_steps,
                                     device=dev)
    ds = DeviceDataset(store, 256, shuffle=True, device=dev)
    del store
    bc = create_train_state(PolicyCNN(dtype=torch.bfloat16), tx, generator=gen(0), device=dev)
    epoch = make_fused_epoch(bc_loss_fn, ds.pure_batch)
    for _ in range(args.bc_epochs):
        nb = min(len(ds), args.bc_batches)
        order = ds.epoch_indices()[:nb * 256].reshape(nb, -1)
        bc, _, metrics = epoch(bc, torch.from_numpy(order).to(dev))
    result["bc"] = {"steps": bc.step, "final_loss": float(metrics["loss"][-1])}
    del ds, epoch

    def starting(init: str, frozen: bool):
        if init == "bc":
            state = copy.deepcopy(bc)
        else:
            state = create_train_state(PolicyCNN(dtype=torch.bfloat16), tx, generator=gen(1),
                                       device=dev)
        if frozen:
            state = create_train_state(state.model, AdamConfig(schedule=lambda count: 0.0),
                                       device=dev)
        return state

    for init in ("bc", "fresh"):
        policy = starting(init, False).model
        m = cl.evaluate_policy(params, town, RenderConfig(height=args.hw, width=args.hw),
                               lambda obs: policy(obs).argmax(-1), gen(50), n_envs=args.envs,
                               n_steps=args.steps, device=dev)
        result[f"{init}_closed_loop_agreement"] = m["action_agreement"]

    # per-round histograms: the rollout calls the discretizer once a step
    # (the expert's labels) and the policy once a step from round 1 on
    hist: dict = {}
    expert_discrete = od.continuous_to_discrete

    def count(key: str, first_round: int, labels):
        calls = hist.setdefault(key + "_calls", 0)
        rows = hist.setdefault(key, [])
        r = first_round + calls // args.steps
        while len(rows) <= r:
            rows.append(torch.zeros(N_ACTIONS, dtype=torch.int64, device=labels.device))
        rows[r] += torch.bincount(labels.to(torch.int64), minlength=N_ACTIONS)
        hist[key + "_calls"] = calls + 1

    def counting_expert(*a, **kw):
        labels = expert_discrete(*a, **kw)
        count("expert", 0, labels)
        return labels

    def counting_apply(model, obs):
        logits = PolicyCNN.__call__(model, obs)
        if not torch.is_grad_enabled():
            count("policy", 1, logits.argmax(-1))
        return logits

    od.continuous_to_discrete = counting_expert
    try:
        for init in ("bc", "fresh"):
            for lod in (0.0, 2.0):
                rcfg = RenderConfig(height=args.hw, width=args.hw, lod_px=lod)
                for train in ["frozen"] + list(args.train_steps):
                    frozen = train == "frozen"
                    run = od.make_online_dagger(
                        counting_apply, params, town, rcfg, n_envs=args.envs,
                        n_steps=args.steps, rounds=args.rounds,
                        train_steps=args.train_steps[0] if frozen else int(train),
                        batch=args.batch, device=dev)
                    for seed in range(args.seed, args.seed + args.seeds):
                        hist.clear()
                        state = starting(init, frozen)
                        t0 = time.perf_counter()
                        _, metrics = run(state, gen(100 + seed))
                        r = {"init": init, "lod_px": lod, "train": train, "seed": seed,
                             "seconds": time.perf_counter() - t0,
                             **{k: [float(x) for x in v] for k, v in metrics.items()},
                             "policy_actions": [h.tolist() for h in hist.get("policy", [])],
                             "expert_actions": [h.tolist() for h in hist["expert"]]}
                        result["runs"].append(r)
                        print(f"{init} lod {lod} train {train} seed {seed}: agreement "
                              f"{[round(a, 3) for a in r['agreement']]} loss "
                              f"{[round(v, 3) for v in r['loss']]}", flush=True)
                        save()
    finally:
        od.continuous_to_discrete = expert_discrete
    save()
    print(json.dumps({"metric": "online_dagger_last_round_agreement",
                      "card": result.get("card"),
                      "runs": [{k: r[k] for k in ("init", "lod_px", "train", "seed")}
                               | {"last": r["agreement"][-1]} for r in result["runs"]]}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
