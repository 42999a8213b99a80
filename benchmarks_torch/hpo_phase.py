#!/usr/bin/env python3
"""``chip_smoke.py``'s ``hpo`` phase alone, on one NVIDIA GPU, from a cold
kernel build.

Builds only the frame store's library, not the kernels: kernel B's first
use comes from the four threads of ``world_model_sweep``'s first trials at
once, so ``ops/cuda_lib.py`` must compile it once and hand every thread one
handle. Then runs ``chip_smoke.hpo_phase``: ``hpo`` serially and 4 at a
time, ``hpo_vmap`` with its vmapped-vs-alone-vs-CPU check and timing,
``hpo_pbt`` with its exploit/explore card-vs-CPU check, and
``world_model_sweep`` (the phase's cut grid, 4 at a time), each with the script's
gates. The phase prints its ``{"hpo": ...}`` line. Then the sweep runs
once more one trial at a time (``max_concurrent=1``, the same cut fits,
kernel B's launches checked again) and prints ``{"wm_sweep_serial":
...}`` with its wall seconds beside the phase's 4-at-a-time run. The
script exits nonzero when a gate fails.

    python3 benchmarks_torch/hpo_phase.py
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from carla_imitation_learning_tpu_torch.native import framestore
    from carla_imitation_learning_tpu_torch.ops import cuda_lib

    cs.log(cs.nvidia_smi())
    built_before = sorted(p.name for p in cuda_lib.BUILD_DIR.glob("libraster_fast-*"))
    framestore.build_library()
    try:
        t0 = time.perf_counter()
        launches = cs.hpo_phase(torch.device("cuda"))
        lib = cuda_lib.library_path("raster_fast")
        built = sorted(p.name for p in cuda_lib.BUILD_DIR.glob("libraster_fast-*"))
        cs.check(built == sorted([lib.name, lib.with_suffix(".log").name]),
                 f"kernel B's build left {built}")
        with tempfile.TemporaryDirectory(prefix="hpo_phase_wm_") as tmp:
            torch.cuda.synchronize()
            cs.reset_counts()
            t1 = time.perf_counter()
            out = cs.cli_run(*cs.wm_sweep_args(f"{tmp}/data", f"{tmp}/wm", max_concurrent=1))
            torch.cuda.synchronize()
            serial_s = time.perf_counter() - t1
            got = cs.read_counts()
            cs.check(out["n_failed"] == 0 and got["B"] == launches["B"],
                     f"serial sweep: {out['n_failed']} failed, kernel B {got['B']} times")
        cs.log(json.dumps({"wm_sweep_serial": {"seconds": serial_s, "launches_b": got["B"],
                                               "table": out["table"]}}))
    except cs.SmokeFailure as e:
        print(f"hpo_phase: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    cs.log(f"hpo phase: {time.perf_counter() - t0:.1f} s, launches {launches}; kernel B "
           f"built {'before' if built_before else 'by the sweep threads'}: {built}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
