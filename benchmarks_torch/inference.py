#!/usr/bin/env python3
"""Serving-tier latency on one NVIDIA GPU: batch-1 latency and the bucket
sweep of the exported policy (float and int8 artifacts) against the live
model (the JAX package's ``benchmarks/inference.py``).

A serving client sees a request's wall time with the device round trip,
so latency is per call, the input copied from the host and the result
fetched back (``chip_smoke.latency_rows``: distinct inputs per
repetition); batches 1, 4, 16, ... up to ``--max-batch``. Then the engine
end to end on requests of 100 frames through the bucket ladder. The report
(written after every step) carries the card's name and power limit.

    python3 benchmarks_torch/inference.py [--height 128] [--width 128]
        [--out reports/torch_inference.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default="reports/torch_inference.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.height != args.width:
        ap.error("the ladder takes square frames")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from carla_imitation_learning_tpu_torch.device import resolve_device
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.serving import (
        InferenceEngine, export_policy, load_policy,
    )
    from carla_imitation_learning_tpu_torch.training.steps import flax_init_

    dev = resolve_device(args.device)
    hw = args.height
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    report: dict = {"device": dev.type, "height": hw, "width": hw, "reps": args.reps}
    if dev.type == "cuda":
        report["card"] = cs.nvidia_smi()

    def save():
        out_path.write_text(json.dumps(report, indent=1))

    model = flax_init_(PolicyCNN(), torch.Generator().manual_seed(0)).to(dev).eval()
    buckets, b = [], 1
    while b <= args.max_batch:
        buckets.append(b)
        b *= 4
    with tempfile.TemporaryDirectory(prefix="inference_bench_") as tmp:
        t0 = time.perf_counter()
        export_policy(model, Path(tmp) / "f", height=hw, width=hw, device=dev)
        report["export_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        export_policy(model, Path(tmp) / "q", height=hw, width=hw, device=dev, quantize="int8")
        report["export_seconds_int8"] = time.perf_counter() - t0
        report["blob_bytes"] = (Path(tmp) / "f" / "policy.pt2").stat().st_size
        report["blob_bytes_int8"] = (Path(tmp) / "q" / "policy.pt2").stat().st_size
        save()
        servable = load_policy(Path(tmp) / "f", dev)
        servable_int8 = load_policy(Path(tmp) / "q", dev)

    def live(frames_u8):
        return model(frames_u8.to(torch.float32) * (1.0 / 255.0))

    for name, fn in (("servable", servable.call), ("servable_int8", servable_int8.call),
                     ("live", live)):
        report[name] = cs.latency_rows(fn, dev, hw, buckets, args.reps)
        for bsz, row in report[name].items():
            print(f"{name} b={bsz}: p50 {row['latency_ms_p50']:.3f} ms, "
                  f"{row['images_per_sec']:.1f} img/s", flush=True)
        save()

    eng = InferenceEngine(servable, max_batch=args.max_batch)
    eng.warmup(hw, hw)
    rng = np.random.default_rng(1)
    for _ in range(args.reps):
        eng.infer(rng.integers(0, 256, (100, hw, hw, 4), dtype=np.uint8))
    report["engine_b100"] = eng.stats()
    save()
    print(json.dumps(report["engine_b100"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
