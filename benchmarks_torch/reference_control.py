#!/usr/bin/env python3
"""Measured control run of the reference's BC input recipe, in the PyTorch
port.

The port of the JAX package's ``benchmarks/reference_control.py``: the
reference's hot loop shape, so "BC images/s against the reference" has a
measured denominator.

- per sample: decode the window's 4 image files from disk, luminance dot
  [0.299, 0.587, 0.114] / 255 → float32 (4, H, W) (``_decode_window``: the
  reference reads the window's files inside DataLoader worker processes);
- batch 64, sequential order, ``--workers`` worker processes (4);
- each batch feeds a train step of ``PolicyCNN`` (4 × 256² → 9 logits,
  bf16, Adam 1e-3 with the global-norm clip 0.5, ``bc_loss_fn``) on the
  device; the device works on a batch while the workers decode the next,
  as the reference's asynchronous dispatch would. Labels are the state
  log's discretized controls at window start + 4, as in the JAX harness.

The log is the reference contract's raw log of ``--frames`` synthetic
frames (``write_synthetic_log``), in ``--data-dir`` (kept, and reused when
it already holds enough frames) or in a temporary directory. The workers
are started with the ``spawn`` method and import only numpy and PIL; PIL
decodes faster than the reference's skimage, so the control is generous
to the reference. One warm epoch, then two timed ones (the median rate),
all within ``--max-seconds`` of the first; then a decode-only rate over
512 windows.

    python3 benchmarks_torch/reference_control.py [--frames 1200] [--hw 256]
        [--batch 64] [--workers 4] [--format jpeg] [--max-seconds 120]
        [--device cuda] [--data-dir DIR] [--out PATH]

Writes ``--out`` (default ``reports/torch_reference_control.json``, beside
the JAX package's ``reports/reference_control.json``) with the JAX
report's keys, ``device`` and, on a card, its ``nvidia-smi`` name and
power limit; the same JSON is the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LUMA = np.array([0.299, 0.587, 0.114])
_DIR = None  # worker-process state


def _init_worker(directory: str):
    global _DIR
    _DIR = Path(directory)


def _decode_window(start: int) -> np.ndarray:
    """The reference's per-sample work: 4 file decodes + luminance dot
    (files are 1-based ``<idx>.<ext>``) → (4, H, W) float32."""
    from PIL import Image

    frames = []
    for i in range(start, start + 4):
        path = next(_DIR.glob(f"{i + 1}.*"))
        with Image.open(path) as im:
            arr = np.asarray(im)
        if arr.ndim == 3:
            arr = arr[..., :3] @ LUMA
        frames.append(arr / 255.0)
    return np.stack(frames).astype(np.float32)


def window_labels(state_log) -> np.ndarray:
    """The state log's controls as 9-class actions (int32)."""
    import torch

    from carla_imitation_learning_tpu_torch.data.actions import continuous_to_discrete

    return continuous_to_discrete(torch.as_tensor(state_log.steer),
                                  torch.as_tensor(state_log.throttle),
                                  torch.as_tensor(state_log.brake)).numpy().astype(np.int32)


def control_run(root: Path, args, dev) -> dict:
    """The timed recipe on the log under ``root`` → the report's numbers."""
    import torch

    from carla_imitation_learning_tpu_torch.data import frame_log as fl
    from carla_imitation_learning_tpu_torch.models import PolicyCNN
    from carla_imitation_learning_tpu_torch.training.losses import bc_loss_fn
    from carla_imitation_learning_tpu_torch.training.steps import (
        create_train_state, make_optimizer, make_train_step,
    )

    cam_dir = root / "raw" / "Log1" / "camera"
    n_have = len(list(cam_dir.glob(f"*.{args.format}"))) if cam_dir.is_dir() else 0
    if n_have < args.frames:
        print(f"writing {args.frames} synthetic {args.format} frames...", file=sys.stderr)
        fl.write_synthetic_log(root, log="Log1", cameras=("camera",), n_frames=args.frames,
                               height=args.hw, width=args.hw, image_format=args.format)
    labels = window_labels(fl.load_state_csv(root / "raw" / "state.csv"))
    n_samples = args.frames - 4
    window_starts = np.arange(n_samples)  # sequential, shuffle=False

    # the pool starts before the first CUDA call, its workers by spawn
    pool = mp.get_context("spawn").Pool(args.workers, initializer=_init_worker,
                                        initargs=(str(cam_dir),))
    with pool:
        tx = make_optimizer({"LEARNING_RATE": 1e-3, "gradient_clip_val": 0.5}, 1)
        tstate = create_train_state(PolicyCNN(), tx, generator=torch.Generator().manual_seed(0),
                                    device=dev)
        step = make_train_step(bc_loss_fn)

        def epoch(budget_t0):
            """One epoch of the recipe → (images, wall seconds)."""
            n_img = 0
            t0 = time.perf_counter()
            batch_x, m = [], None
            for k, x in enumerate(pool.imap(_decode_window, window_starts, chunksize=8)):
                batch_x.append(x)
                if len(batch_x) == args.batch:
                    xb = torch.from_numpy(np.stack(batch_x).transpose(0, 2, 3, 1)).to(dev)
                    yb = torch.from_numpy(
                        labels[window_starts[k - args.batch + 1:k + 1] + 4]).to(dev).long()
                    _, m = step(tstate, (xb, yb))
                    n_img += args.batch
                    batch_x = []
                    if time.perf_counter() - budget_t0 > args.max_seconds:
                        break
            if m is not None:
                float(m["loss"])  # the device's work is done
            return n_img, time.perf_counter() - t0

        budget_t0 = time.perf_counter()
        epoch(budget_t0)   # warm: cuDNN's first calls, the page cache
        rates = []
        for _ in range(2):
            n_img, wall = epoch(budget_t0)
            if n_img:
                rates.append(n_img / wall)
        probe = window_starts[:512]
        t0 = time.perf_counter()
        for _ in pool.imap(_decode_window, probe, chunksize=8):
            pass
        decode_rate = len(probe) / (time.perf_counter() - t0)
    return {"rate": float(np.median(rates)) if rates else float("nan"),
            "decode_rate": decode_rate}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--format", default="jpeg", choices=["jpeg", "png"])
    ap.add_argument("--max-seconds", type=float, default=120.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out", default=str(ROOT / "reports" / "torch_reference_control.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from carla_imitation_learning_tpu_torch.device import card_line, resolve_device

    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else None
    if args.data_dir:
        measured = control_run(Path(args.data_dir), args, dev)
    else:
        with tempfile.TemporaryDirectory(prefix="reference_control_") as tmp:
            measured = control_run(Path(tmp), args, dev)
    result = {
        "metric": "reference_recipe_bc_images_per_sec",
        "value": measured["rate"],
        "unit": "images/sec",
        "decode_only_images_per_sec": measured["decode_rate"],
        "config": {"frames": args.frames, "hw": args.hw, "batch": args.batch,
                   "workers": args.workers, "format": args.format,
                   "decoder": "PIL (faster than reference's skimage)"},
        "device": str(dev),
    }
    if card is not None:
        result["card"] = card
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
