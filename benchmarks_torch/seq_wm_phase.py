#!/usr/bin/env python3
"""``chip_smoke.py``'s ``seq_wm`` phase alone, on one NVIDIA GPU.

Builds the kernels as the smoke script does, then runs
``chip_smoke.seq_wm_phase``: ``bc_rnn``, ``world_model`` (MSE and
MS-SSIM), ``world_model_imagine``, ``dream_policy`` (discrete and
continuous) and ``bc_vit`` with ``closed_loop_eval`` of its checkpoint
through the CLI at the presets' widths, the fp32 card-vs-CPU checks
against float64, each model's train step, the imagination update and the
recurrent rollout, each with the script's gates. The phase prints its
``{"seq_wm": ...}`` line; the script exits nonzero when a gate fails.

    python3 benchmarks_torch/seq_wm_phase.py
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from carla_imitation_learning_tpu_torch.native import framestore
    from carla_imitation_learning_tpu_torch.ops import cuda_lib

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
    try:
        t1 = time.perf_counter()
        launches = cs.seq_wm_phase(torch.device("cuda"))
    except cs.SmokeFailure as e:
        print(f"seq_wm_phase: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    cs.log(f"seq_wm phase: {time.perf_counter() - t1:.1f} s, launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
