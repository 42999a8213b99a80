#!/usr/bin/env python3
"""Where the time of the port's frame-log IO goes: the frames of one expert
collection (``collect_dataset`` at ``--envs`` × ``--steps``, 128², the
``file_io`` phase of ``chip_smoke.py``), encoded and written as PNG, read
back, and written and mapped as a packed store, in each ``--dir``.

Per directory, host wall clock of each stage (frames/s or GB/s):
- ``png_encode_memory``: PIL PNG encode (level 1) into memory, no file, on
  1 and on ``--workers`` threads: the encoder alone;
- ``raw_files``: each frame's raw bytes written to its own file: the file
  system's per-file cost alone;
- ``png_write``: ``save_frames`` on 1 and on ``--workers`` threads;
- ``png_read``: ``FrameLog.read_all_gray_u8`` of the written folder;
- ``packed_write`` / ``packed_read``: ``save_framestore`` (its library
  built before) and a copy out of ``NativeFrameStore``'s map.

    python3 benchmarks_torch/file_io_bench.py --dir DIR [--dir DIR2 ...]
        [--envs 256] [--steps 48] [--workers 8] [--device cuda] --out REPORT.json

Each directory is created and emptied by the script; pass directories the
script may own. The last line of standard output is the JSON report.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rate(n: float, seconds: float) -> float:
    return n / seconds if seconds > 0 else float("inf")


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _pool_map(fn, n: int, workers: int) -> None:
    if workers <= 1:
        for i in range(n):
            fn(i)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(fn, range(n)))


def bench_dir(frames, store, directory: Path, workers: int) -> dict:
    from PIL import Image

    from carla_imitation_learning_tpu_torch.data import frame_log as fl
    from carla_imitation_learning_tpu_torch.native import (
        NativeFrameStore, build_library, save_framestore,
    )

    build_library()  # built once, outside the timed write
    n = len(frames)
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    out = {"dir": str(directory), "frames": n, "raw_mb": frames.nbytes / 1e6}

    def encode(i):
        Image.fromarray(frames[i]).save(io.BytesIO(), format="png", compress_level=1)

    encode(0)  # PIL loads its PNG plugin on first use

    for w in (1, workers):
        out[f"png_encode_memory_frames_per_s_{w}"] = _rate(n, _timed(
            lambda: _pool_map(encode, n, w)))

    raw = directory / "raw"
    raw.mkdir()

    def write_raw(i):
        with open(raw / f"{i + 1}.bin", "wb") as f:
            f.write(frames[i].tobytes())

    out["raw_files_per_s"] = _rate(n, _timed(lambda: _pool_map(write_raw, n, 1)))
    for w in (1, workers):
        target = directory / f"png_{w}"
        out[f"png_write_frames_per_s_{w}"] = _rate(n, _timed(
            lambda: fl.save_frames(target, frames, workers=w)))
    out["png_mb"] = sum(p.stat().st_size for p in target.iterdir()) / 1e6
    read = {}
    out["png_read_frames_per_s"] = _rate(n, _timed(
        lambda: read.setdefault("x", fl.FrameLog(target).read_all_gray_u8())))
    if not (read["x"] == frames).all():
        raise SystemExit("PNG read-back differs from the frames written")
    path = directory / "frames.tpuilfs"
    out["packed_write_gb_per_s"] = _rate(frames.nbytes / 1e9, _timed(
        lambda: save_framestore(path, store)))
    with NativeFrameStore(path) as nfs:
        out["packed_read_gb_per_s"] = _rate(frames.nbytes / 1e9, _timed(
            lambda: nfs.frames.copy()))
    shutil.rmtree(directory)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dir", action="append", required=True, type=Path)
    parser.add_argument("--envs", type=int, default=256)
    parser.add_argument("--steps", type=int, default=48)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", type=Path, required=True)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from carla_imitation_learning_tpu_torch.device import card_line
    from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
    from carla_imitation_learning_tpu_torch.sim.town import make_town
    from carla_imitation_learning_tpu_torch.sim.world import SimParams
    from carla_imitation_learning_tpu_torch.training.closed_loop import collect_dataset

    store, _, _ = collect_dataset(SimParams(), make_town(), RenderConfig(),
                                  torch.Generator().manual_seed(0), args.envs, args.steps,
                                  device=args.device)
    report = {"cpu_count": os.cpu_count(), "workers": args.workers,
              "device": args.device, "dirs": []}
    if args.device != "cpu":
        report["card"] = card_line()
    for d in args.dir:
        report["dirs"].append(bench_dir(store.frames, store, d, args.workers))
        print(json.dumps(report["dirs"][-1]), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
