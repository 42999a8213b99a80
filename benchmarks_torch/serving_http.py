#!/usr/bin/env python3
"""HTTP serving on one NVIDIA GPU: does cross-request micro-batching pay?
(the JAX package's ``benchmarks/serving_http.py``).

K concurrent clients send batch-1 requests to ``/v1/infer`` of a
``PolicyServer`` on a localhost port, at coalescing windows of 0, 2 and
10 ms (``chip_smoke.http_case``): requests/s, client latency percentiles,
device calls and mean coalesced rows; and an engine-only batch-1 baseline
without HTTP or threads. The report (written after every case) carries the
card's name and power limit.

    python3 benchmarks_torch/serving_http.py [--clients 8] [--requests 40]
        [--height 128] [--out reports/torch_serving_http.json] [--device cuda]
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
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--out", default="reports/torch_serving_http.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
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
    result: dict = {"device": dev.type,
                    "config": {"clients": args.clients, "requests": args.requests,
                               "height": hw, "width": hw, "max_batch": args.max_batch}}
    if dev.type == "cuda":
        result["card"] = cs.nvidia_smi()

    def flush():
        out_path.write_text(json.dumps(result, indent=1))

    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    model = flax_init_(PolicyCNN(dtype=dtype), torch.Generator().manual_seed(0)).to(dev).eval()
    with tempfile.TemporaryDirectory(prefix="serving_http_") as tmp:
        servable = load_policy(export_policy(model, Path(tmp) / "policy", height=hw, width=hw,
                                             device=dev), dev)

    eng = InferenceEngine(servable, max_batch=args.max_batch)
    eng.warmup(hw, hw)
    frames1 = np.random.default_rng(0).integers(0, 256, (1, hw, hw, 4), dtype=np.uint8)
    n_base = 50
    t0 = time.perf_counter()
    for _ in range(n_base):
        eng.infer(frames1)
    result["engine_only_b1_ms"] = (time.perf_counter() - t0) / n_base * 1e3
    flush()

    for window_ms in (0.0, 2.0, 10.0):
        key = f"window_{window_ms:g}ms"
        result[key] = cs.http_case(servable, window_ms=window_ms, clients=args.clients,
                                   requests=args.requests, hw=hw, max_batch=args.max_batch,
                                   device=dev)
        flush()
        print(key, json.dumps(result[key]), flush=True)
    result["coalescing_speedup"] = (result["window_10ms"]["requests_per_sec"]
                                    / result["window_0ms"]["requests_per_sec"])
    flush()
    print(json.dumps({"metric": "serving_http_requests_per_sec",
                      "value": result["window_10ms"]["requests_per_sec"],
                      "coalescing_speedup": result["coalescing_speedup"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
