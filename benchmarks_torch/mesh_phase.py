#!/usr/bin/env python3
"""``chip_smoke.py``'s ``doctor`` step, its ``mesh`` phase (6m) and its
coarse-band-list kernel checks (7b) alone, on one NVIDIA GPU, from a cold
kernel build.

Builds every kernel from ``csrc/`` and the frame store's library, runs
``chip_smoke.doctor_phase`` (``cli doctor`` on the card, every check
green; its ``{"doctor": ...}`` line), then
``chip_smoke.band_factor_kernels`` (kernels B, C and D at
``list_band_factor`` 2 on the rich fleet, bit for bit against their plain
versions and their factor-1 frames, timed beside the factor-1 run; one
``{"band_factor": ...}`` line and the three entries of the ``kernels``
line) and ``chip_smoke.mesh_phase`` (one NCCL rank's traced ``run bc -o
mesh.enabled=true``; two gloo ranks on cuda:0 against one process: the BC
step, the rollout, online DAgger, PPO and a served batch; its ``{"mesh":
...}`` line), each with the script's gates. Prints the card's
nvidia-smi name and power limit first. Exits nonzero when a gate fails.

    python3 benchmarks_torch/mesh_phase.py
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
    from carla_imitation_learning_tpu_torch.native import framestore
    from carla_imitation_learning_tpu_torch.ops import cuda_lib
    from carla_imitation_learning_tpu_torch.ops import raster as ra

    smi = cs.nvidia_smi()
    cs.log(smi)
    t0 = time.perf_counter()
    try:
        framestore.build_library()
        cuda_lib.build()
        for name in cuda_lib.SOURCES:
            cuda_lib.load(name)
        cs.log(f"build: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        cs.doctor_phase()
        doctor_s = time.perf_counter() - t1
        facts = {"B": cs.launch_facts("raster_fast"), "C": cs.launch_facts("raster_prim"),
                 "D": cs.launch_facts("raster_vec")}
        dev = torch.device("cuda")
        params, town = cs.bench_fleet(dev)
        t1 = time.perf_counter()
        entries = cs.band_factor_kernels(params, town, dev, ra.band_rows(cs.HW),
                                         cs.issue_rate(), facts)
        band_s = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        launches = cs.mesh_phase(dev, smi)
        mesh_s = time.perf_counter() - t1
    except cs.SmokeFailure as e:
        print(f"mesh_phase: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    cs.log(json.dumps({"kernels": entries}))
    cs.log(f"doctor: {doctor_s:.1f} s, band_factor: {band_s:.1f} s, mesh: {mesh_s:.1f} s, "
           f"launches {launches}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
