#!/usr/bin/env python3
"""CNN-vs-ViT BC training A/B in the PyTorch port (marginal protocol).

The port of the JAX package's ``benchmarks/vit_ab.py``. Both
architectures run in one process: ``PolicyCNN`` and ``ViTPolicy`` (192d,
4 layers, patch 16), each from a flax-distributed init (seed 0), Adam 1e-3
with the global-norm clip 0.5 and ``bc_loss_fn``, on 16 fixed batches of
a bf16 ``DeviceDataset`` over ``FrameStore.synthetic`` at ``--batch`` ×
``--hw``². ms per step is the marginal Δwall/32 between chains of 8 and
40 steps (median of 3 pairs, after a warm chain of 4), each chain ended by
one host read of its last loss.

FLOPs per step come from ``torch.utils.flop_counter.FlopCounterMode``
over one train step's forward and backward (the optimizer's update is
elementwise and not counted): it counts the convolutions, matrix products
and attention products, where the JAX harness read XLA's
``cost_analysis()`` of its compiled step, which also counts elementwise
work. MFU divides those FLOPs by ms per step and ``--peak-tflops``,
by default the H100 SXM's dense bf16 rate of 989 TFLOP/s (the TPU v5e's
197 is the JAX harness's).

    python3 benchmarks_torch/vit_ab.py [--batch 256] [--hw 256]
        [--peak-tflops 989] [--device cuda] [--out PATH]

Writes ``--out`` (default ``reports/torch_vit_ab.json``, beside the JAX
package's ``reports/vit_ab.json``): ``batch``, ``hw``, ``peak_tflops``,
``flop_count`` (the method), ``device``, on a card its ``nvidia-smi`` name
and power limit, and per architecture ``images_per_sec``, ``ms_per_step``,
``gflops_per_step``, ``mfu_pct`` and ``params``; the same JSON is the last
line of standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H100_BF16_DENSE_TFLOPS = 989.0
FLOP_COUNT = ("torch.utils.flop_counter.FlopCounterMode over one train step's forward "
              "and backward: convolutions, matrix and attention products")


def fixture(model, batch: int, hw: int, dev, n_batches: int = 16):
    """→ (train state, step, ``n_batches`` fixed batches) on ``dev``."""
    import numpy as np
    import torch

    from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer, make_train_step,
    )

    store = FrameStore.synthetic(n=max(2 * batch, 512), height=hw, width=hw, seed=0)
    ds = DeviceDataset(store, batch_size=batch, frame_skip=4, shuffle=True,
                       dtype="bfloat16", device=dev)
    tx = make_optimizer({"LEARNING_RATE": 1e-3, "gradient_clip_val": 0.5}, 1)
    state = create_train_state(model, tx, generator=torch.Generator().manual_seed(0),
                               device=dev)
    batches = [ds.make_batch(np.random.default_rng(i).integers(0, ds.n_samples, batch))
               for i in range(n_batches)]
    return state, make_train_step(bc_loss_fn), batches


def step_flops(model, batch: int, hw: int, dev) -> float:
    """FLOPs of one train step's forward and backward at ``batch`` ×
    ``hw``² (zero inputs in bf16), by ``FlopCounterMode``. The gradients
    it leaves are cleared."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn

    x = torch.zeros((batch, hw, hw, 4), dtype=torch.bfloat16, device=dev)
    y = torch.zeros((batch,), dtype=torch.int64, device=dev)
    with FlopCounterMode(display=False) as counter:
        loss, _ = bc_loss_fn(model, (x, y))
        loss.backward()
    model.zero_grad(set_to_none=True)
    return float(counter.get_total_flops())


def bench_arch(name: str, model, batch: int, hw: int, peak_tflops: float, dev,
               short: int = 8, long: int = 40, reps: int = 3) -> dict:
    import numpy as np
    import torch

    state, step, batches = fixture(model, batch, hw, dev)

    def chain(n):
        t0 = time.perf_counter()
        for i in range(n):
            _, m = step(state, batches[i % len(batches)])
        float(m["loss"])
        return time.perf_counter() - t0

    chain(4)  # warm: cuDNN's first calls
    deltas = []
    for _ in range(reps):
        t_small = chain(short)
        t_big = chain(long)
        deltas.append((t_big - t_small) / (long - short))
    per = float(np.median(deltas))
    flops = step_flops(state.model, batch, hw, dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    out = {
        "images_per_sec": batch / per,
        "ms_per_step": per * 1e3,
        "gflops_per_step": flops / 1e9,
        "mfu_pct": 100.0 * flops / per / (peak_tflops * 1e12),
        "params": n_params,
    }
    print(f"{name}: {out['images_per_sec']:,.0f} img/s ({out['ms_per_step']:.3f} ms/step, "
          f"{out['gflops_per_step']:.2f} GF/step, MFU {out['mfu_pct']:.2f}%, "
          f"{n_params:,} params)", flush=True)
    del state, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--peak-tflops", type=float, default=H100_BF16_DENSE_TFLOPS,
                    help="the card's dense bf16 peak for the MFU column (H100 SXM: 989)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_vit_ab.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device
    from carla_imitation_learning_tpu_torch.models import PolicyCNN, ViTPolicy

    dev = resolve_device(args.device)
    result = {"device": str(dev), "batch": args.batch, "hw": args.hw,
              "peak_tflops": args.peak_tflops, "flop_count": FLOP_COUNT}
    if dev.type == "cuda":
        result["card"] = card_line()
    result["cnn"] = bench_arch("cnn", PolicyCNN(), args.batch, args.hw, args.peak_tflops, dev)
    result["vit"] = bench_arch("vit (192d/4L p16)", ViTPolicy(), args.batch, args.hw,
                               args.peak_tflops, dev)
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
