#!/usr/bin/env python3
"""``chip_smoke.py``'s ``serving`` phase alone, on one NVIDIA GPU.

Builds the kernels as the smoke script does, trains a warm-start policy
(an expert collection of 256 envs × 100 steps on the bench town at 128²,
then ``--bc-steps`` bf16 BC steps at batch 256) and saves it as a
checkpoint, then runs ``chip_smoke.serving_phase`` on it: exports through
the CLI (bf16, int8, fp32, the preset's 256²), artifacts on the CPU
against the card, ``closed_loop_eval`` of an artifact against its
checkpoint, the latency ladder, the engine, HTTP and a reference ConvNet1
through ``import_torch``, each with the script's gates. The phase prints
its ``{"serving": ...}`` line; the script exits nonzero when a gate fails.

    python3 benchmarks_torch/serving_phase.py [--bc-steps 200]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bc-steps", type=int, default=200, help="BC steps of the warm start")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.native import framestore
    from carla_imitation_learning_tpu_torch.ops import cuda_lib
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        AdamConfig, create_train_state, make_train_step,
    )
    from carla_imitation_learning_tpu_torch.utils.checkpoint import save_pytree

    t0 = time.perf_counter()
    cs.log(cs.nvidia_smi())
    host_lib = threading.Thread(target=framestore.build_library)
    host_lib.start()
    cuda_lib.build()
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)
    host_lib.join()
    framestore.build_library()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    params, town = cs.bench_fleet(dev)
    store, _, _ = cl.collect_dataset(params, town, RenderConfig(cs.HW, cs.HW, max_triangles=cs.T),
                                     torch.Generator().manual_seed(0), 256, 100, device=dev)
    state = create_train_state(PolicyCNN(), AdamConfig(schedule=lambda count: 1e-3, clip=0.5),
                               generator=torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(bc_loss_fn)
    ds = DeviceDataset(store, 256, shuffle=True, device=dev)
    done = 0
    while done < args.bc_steps:
        for batch in ds:
            state, metrics = step(state, batch)
            done += 1
            if done == args.bc_steps:
                break
    cs.log(f"warm start: {done} BC steps, loss {float(metrics['loss']):.4f}")
    with tempfile.TemporaryDirectory(prefix="serving_") as tmp:
        save_pytree(Path(tmp) / "best", {"params": state.model.state_dict()})
        del state, ds, store
        torch.cuda.empty_cache()
        try:
            t1 = time.perf_counter()
            launches = cs.serving_phase(dev, Path(tmp) / "best")
        except cs.SmokeFailure as e:
            print(f"serving_phase: FAILED: {e}", file=sys.stderr, flush=True)
            return 1
    cs.log(f"serving phase: {time.perf_counter() - t1:.1f} s, launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
