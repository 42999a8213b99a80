#!/usr/bin/env python3
"""``chip_smoke.py``'s ``rl_safety`` phase alone, on one NVIDIA GPU.

Builds the kernels as the smoke script does, trains a bf16 ``PolicyCNN``
for ``--bc-steps`` steps (Adam 1e-3, clip 0.5, batch 256) on an expert
collection of 256 envs × 100 steps of the bench town at 128², saves it as
a checkpoint, and runs ``chip_smoke.rl_safety_phase`` from it with the PPO
update's torch.profiler summary: PPO fine-tuning through the CLI, the
card-vs-CPU PPO steps, the shielded ``closed_loop_eval``, the LIDAR
channel and the s2d stem, each with the script's gates. The phase prints
its ``{"rl_safety": ...}`` line; the script exits nonzero when a gate
fails.

    python3 benchmarks_torch/rl_safety_phase.py [--bc-steps 300]
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
    ap.add_argument("--bc-steps", type=int, default=300, help="BC steps of the warm start")
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
    with tempfile.TemporaryDirectory(prefix="rl_safety_") as tmp:
        save_pytree(Path(tmp) / "best", {"params": state.model.state_dict()})
        del state, ds, store
        torch.cuda.empty_cache()
        try:
            t1 = time.perf_counter()
            launches = cs.rl_safety_phase(dev, Path(tmp) / "best", profile=True)
        except cs.SmokeFailure as e:
            print(f"rl_safety_phase: FAILED: {e}", file=sys.stderr, flush=True)
            return 1
    cs.log(f"launches {launches}; phase {time.perf_counter() - t1:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
