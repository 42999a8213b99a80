"""Readings for the limits of a cell's correctness check, on the chip at
the cell's own size: the compared numbers of sound runs, of the control
(the plain reference in the nearest lower precision in the program's
place), of a witness (a correct implementation that rounds otherwise, in
the program's place, where the cell's kind has one) and of runs with a
fault planted in the port, one JSON line a seed.

    python3 perfbench/control.py --workload <cell> --seeds <n,n,...>
        [--control | --witness | --fault <name>] [--seconds <s>]

The benchmark's own runs never run this; the limits in ``limits/<cell>.json``
lie between what it reads for sound runs and for the control and faults.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, "cuda", t0,
                             fault=args.fault, control=args.control, witness=args.witness)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "witness": args.witness, "fault": args.fault, "correct": r["correct"],
                          "checks": {k: c["value"] for k, c in r["checks"].items()},
                          "rate": {k: m["value"] for k, m in r["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
