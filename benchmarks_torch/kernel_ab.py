#!/usr/bin/env python3
"""Time alternative sources of one kernel against each other, in turns, on
the fleet inputs that ``chip_smoke.py`` times it on.

    python3 benchmarks_torch/kernel_ab.py --kernel B \\
        --variant base=carla_imitation_learning_tpu_torch/csrc/raster_fast.cu \\
        --variant other=path/to/raster_fast.cu [--variant name=path:-DFLAG,...]

``--kernel``: A (flat, luma, T = 512), A-tex (textured, luma, rich128
preset, T = 1408), B (T = 512), B-rich (B on the rich128 fast lists), C (the
rich128 fused quads) or D (B-rich's lists as band tables), at 1024 envs,
128², seed 0's fleet (``chip_smoke.kernel_inputs``). Each variant is a
source with the same C entry point as the kernel's own
(``raster_exact_launch``, ``raster_fast_launch``, ``raster_prim_launch``
or ``raster_vec_launch``), compiled with the port's nvcc flags (plus the
``-D`` flags after a colon) by ``cuda_lib.build_variant``, then called
through the port's own wrapper. Every variant's output is compared with the
plain version's (``equal``), and the variants are timed with CUDA events (20
launches after warm-up) in ``--rounds`` rounds, in turns, on one card.
Prints one JSON object: per variant the median and each round's ms, and
whether it equals the plain version.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (imports only the standard library at module level)

LIBRARIES = {"A": "raster_exact", "A-tex": "raster_exact", "B": "raster_fast",
             "B-rich": "raster_fast", "C": "raster_prim", "D": "raster_vec"}


def equal(got, want) -> bool:
    import torch

    if isinstance(got, tuple):
        return all(torch.equal(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=tuple(LIBRARIES), required=True)
    parser.add_argument("--variant", action="append", required=True, metavar="NAME=PATH[:FLAGS]")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    import torch

    from carla_imitation_learning_tpu_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    lib = LIBRARIES[args.kernel]
    variants = {}
    for item in args.variant:
        name, _, spec = item.partition("=")
        path, _, flags = spec.partition(":")
        variants[name] = cuda_lib.build_variant(Path(path), [f for f in flags.split(",") if f])
    wrapper, plain, inputs = chip_smoke.kernel_inputs(args.kernel, torch.device("cuda"))
    want = plain(*inputs)

    res = {"kernel": args.kernel, "card": chip_smoke.nvidia_smi(), "variants": {}}
    for name, path in variants.items():
        cuda_lib.use_library(lib, path)
        res["variants"][name] = {"equal": equal(wrapper(*inputs), want), "ms": []}
    for rnd in range(args.rounds):
        order = list(variants) if rnd % 2 == 0 else list(variants)[::-1]
        for name in order:
            cuda_lib.use_library(lib, variants[name])
            res["variants"][name]["ms"].append(chip_smoke.cuda_ms(lambda: wrapper(*inputs), reps=20))
    for v in res["variants"].values():
        v["median_ms"] = sorted(v["ms"])[len(v["ms"]) // 2]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
