"""Tiny sizes at which the tests drive whole runs of each cell on the CPU.

The configurations run in float32 there, and a transformer at depth 2:
bfloat16 convolutions of the CPU's PyTorch build are not exact enough for
a check (a stride-16 patch convolution comes out off by more than its
values), and the card's bfloat16 path at full depth is what the chip runs
measure."""

import json
import time

from perfbench import harness

TRAFFIC = {
    "closed_loop": {"n_envs": 8, "chunk_steps": 3, "sample_envs": 6, "warm_calls": 1,
                    "trace_calls": 2,
                    "render": {"height": 64, "width": 64, "max_triangles": 512, "lod_px": 2.0}},
    "bc_epoch": {"n_frames": 64, "height": 64, "width": 64, "batch": 8, "batches_per_call": 2,
                 "warm_calls": 1, "trace_calls": 1},
}
DEPTH = 2
SEED = 2 ** 31 + 12345


def cells(root=harness.REPO) -> list:
    with open(root / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"] if w["chips"] == 1]


def config_overrides(cfg: dict) -> dict:
    """float32, and depth ``DEPTH`` where the configuration has a depth."""
    out = {"compute_dtype": "float32"}
    if "depth" in cfg["port"]["kwargs"]:
        out["port"] = {**cfg["port"], "kwargs": {**cfg["port"]["kwargs"], "depth": DEPTH}}
        out["reference"] = {**cfg["reference"],
                            "sizes": {**cfg["reference"]["sizes"], "depth": DEPTH}}
    return out


def run(cell: str, root=harness.REPO, trace: bool = False, **kw) -> dict:
    spec = harness.load_cell(cell, root)
    return harness.run_cell(cell, SEED, 0.2, trace, "cpu", time.perf_counter(), root=root,
                            overrides=TRAFFIC[spec["traffic"]["kind"]],
                            config_overrides=config_overrides(spec["config"]),
                            log=lambda msg: None, **kw)
