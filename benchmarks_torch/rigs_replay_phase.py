#!/usr/bin/env python3
"""``chip_smoke.py``'s ``rigs_replay`` phase alone, on one NVIDIA GPU.

Builds the kernels as the smoke script does, then runs
``chip_smoke.rigs_replay_phase``: kernels A and B against their plain
versions from the side and rear views, the 3-view rollout on the card
against the CPU, ``collect_multicamera``, ``bc_surround`` and ``replay``
through the CLI at their presets' widths with exact launch counts, the
surround rollout, the surround train step and dynamics-only replay at 1024
envs, each with the script's gates. The phase prints its
``{"rigs_replay": ...}`` line; the script exits nonzero when a gate fails.

    python3 benchmarks_torch/rigs_replay_phase.py
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
        launches = cs.rigs_replay_phase(torch.device("cuda"))
    except cs.SmokeFailure as e:
        print(f"rigs_replay_phase: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    cs.log(f"rigs_replay phase: {time.perf_counter() - t1:.1f} s, launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
