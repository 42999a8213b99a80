#!/usr/bin/env python3
"""SASS loop sizes of the port's built kernels.

    python3 benchmarks_torch/kernel_report.py [--build DIR] [--out FILE]

Reads every library ``DIR/lib*.so`` that the package has already built
(default: ``carla_imitation_learning_tpu_torch/build/``, filled by the first
kernel call, e.g. by ``chip_smoke.py``) and, for every kernel function in
it, lists the loops of ``cuobjdump -sass`` (a backward branch and the body
it closes): each one's instruction count, and how many of those
instructions a forward branch inside the body can jump over
(``conditional``; predicated instructions count as issued). The pass loop
is the largest loop that holds no loop of ``SMALL_LOOP`` instructions or
more (the argument reduction of ``sinf`` is a small loop inside the
textured pass); ``pass_loop_per_pixel`` divides it by the 8 pixels a
thread owns in every kernel of the port. Registers, spills and resident
blocks come from ``chip_smoke.py`` (the kernels' ``_info`` entry points).

Needs ``cuobjdump`` from the CUDA toolkit, not a GPU. Prints one JSON
object and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PIXELS_PER_THREAD = 8
SMALL_LOOP = 64
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRANCH = re.compile(r"\bBRA(?:\.\S+)?\s+0x([0-9a-f]+)")


def sass_functions(text: str) -> dict:
    """cuobjdump -sass → {mangled function: [(address, instruction)]}."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and (m := INSTR.search(line)):
            out[name].append((int(m[1], 16), m[2]))
    return out


def loops(instrs: list) -> list:
    """Every loop of one function, largest first: {start, end,
    instructions, conditional, largest_inner} (the instruction count of the
    largest loop nested in it, 0 if none)."""
    addr = [a for a, _ in instrs]
    branches = []
    for a, text in instrs:
        m = BRANCH.search(text)
        if m:
            branches.append((a, int(m.group(1), 16)))
    back = [(t, a) for a, t in branches if t <= a]
    size = {lp: sum(1 for a in addr if lp[0] <= a <= lp[1]) for lp in back}
    out = []
    for start, end in back:
        body = [a for a in addr if start <= a <= end]
        skipped = set()
        for a, t in branches:
            if start <= a < t <= end:
                skipped.update(x for x in body if a < x < t)
        inner = [size[lp] for lp in back
                 if start <= lp[0] and lp[1] <= end and lp != (start, end)]
        out.append({"start": hex(start), "end": hex(end), "instructions": len(body),
                    "conditional": len(skipped), "largest_inner": max(inner, default=0)})
    return sorted(out, key=lambda lp: -lp["instructions"])


def report(build: Path) -> dict:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        raise SystemExit("cuobjdump not found: the CUDA toolkit is needed")
    libs = sorted(p for p in build.glob("lib*.so") if not p.name.endswith(".partial.so"))
    if not libs:
        raise SystemExit(f"no built library in {build}: run a kernel (chip_smoke.py) first")
    res = {"build": str(build), "kernels": {}}
    for lib in libs:
        sass = sass_functions(subprocess.run([cuobjdump, "-sass", str(lib)],
                                             capture_output=True, text=True, check=True).stdout)
        for name, instrs in sass.items():
            found = loops(instrs)
            entry = {"library": lib.name, "sass_instructions": len(instrs), "loops": found[:6]}
            passes = [lp for lp in found if lp["largest_inner"] < SMALL_LOOP]
            if passes:
                pass_loop = entry["pass_loop"] = passes[0]
                entry["pass_loop_per_pixel"] = {
                    "all": pass_loop["instructions"] / PIXELS_PER_THREAD,
                    "unconditional": (pass_loop["instructions"] - pass_loop["conditional"])
                    / PIXELS_PER_THREAD}
            res["kernels"][name] = entry
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--build", type=Path,
                        default=ROOT / "carla_imitation_learning_tpu_torch" / "build",
                        help="the directory of the built kernel libraries")
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = parser.parse_args()
    text = json.dumps(report(args.build.resolve()), indent=1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
