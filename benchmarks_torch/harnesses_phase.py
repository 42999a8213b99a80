#!/usr/bin/env python3
"""``chip_smoke.py``'s ``harnesses`` phase (6n) alone, on one NVIDIA GPU,
from a cold kernel build.

Builds every kernel from ``csrc/``, then runs ``chip_smoke.harnesses_phase``:
kernels A (C = 3) and B on ``vit_crossover``'s evaluation fleet at 256², each
bit for bit against its plain version and timed, then the seven harnesses
of ``benchmarks_torch/`` (``sim_ablation``, ``rollout_breakdown``,
``crash_forensics``, ``expert_envelope``, ``reference_control``,
``vit_ab``, ``vit_crossover``) at the phase's smoke size with its gates
and launch counts. Prints the card's nvidia-smi name and power limit
first, the phase's ``{"harnesses": ...}`` line, the two ``kernels``
entries, and its seconds. Exits nonzero when a gate fails.

    python3 benchmarks_torch/harnesses_phase.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from carla_imitation_learning_tpu_torch.ops import cuda_lib

    cs.log(cs.nvidia_smi())
    t0 = time.perf_counter()
    try:
        cuda_lib.build()
        for name in cuda_lib.SOURCES:
            cuda_lib.load(name)
        cs.log(f"build: {time.perf_counter() - t0:.1f} s")
        facts = {"A": cs.launch_facts("raster_exact", 1, 0), "B": cs.launch_facts("raster_fast")}
        kernels: list = []
        t1 = time.perf_counter()
        launches = cs.harnesses_phase(torch.device("cuda"), cs.issue_rate(), facts, kernels)
        phase_s = time.perf_counter() - t1
    except cs.SmokeFailure as e:
        print(f"harnesses_phase: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    for k in kernels:
        k.pop("counter")
        k["launches_path"] = k.pop("path")
    cs.log(json.dumps({"kernels": kernels}))
    cs.log(json.dumps({"harnesses_phase": {"seconds": phase_s, "launches": launches,
                                           "total_s": time.perf_counter() - t0}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
