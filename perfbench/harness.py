"""Run one cell of BENCHMARK.json once: set-up, the timed or traced window,
the correctness check against the plain reference, the metrics.

``run_cell`` does all of it and returns the result line as a dict; it
takes the device as given, so the tests drive it on the CPU at a tiny
size. ``run.py`` is the command-line entry, which also refuses to run
without the cards the cell asks for.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "carla_imitation_learning_tpu")


def set_cache_dirs(root: Path = BENCH_DIR) -> None:
    """Every compile cache the port could use, at fixed paths inside the
    checkout (the port's own nvcc builds go to its ``build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(root / ".cache" / sub)


def forbidden_modules(names=None) -> list:
    """Top-level names of the loaded modules (or of ``names``) that are
    JAX's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = REPO) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic mix, limits and metric entries, found by their names."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    bench = root / "perfbench"

    def mine(entries):
        return [m for m in entries if "workloads" not in m or name in m["workloads"]]

    return {"cell": cell, "config": _json(root / config["file"]),
            "traffic": _json(bench / "traffic" / f"{cell['traffic']}.json"),
            "limits": _json(bench / "limits" / f"{name}.json"),
            "end_to_end": mine(spec["end_to_end"]), "per_layer": mine(spec["per_layer"]),
            "root": root}


def metric_reader(name: str, root: Path = REPO):
    """``read`` of ``perfbench/metrics/<name>.py``, or, where there is no
    such file, of the file named by the part of ``name`` before its first
    dot (one reader for metrics of one definition)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def peaks(root: Path = REPO) -> dict:
    return _json(root / "perfbench" / "peaks.json")


def judge(checks: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(not math.isnan(v) and v <= limits[k] for k, v in checks.items())


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: Path = REPO, overrides: dict | None = None,
             config_overrides: dict | None = None, fault: str | None = None,
             control: bool = False, witness: bool = False,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> dict:
    """One run of cell ``name`` → the result line (a dict) with the
    compared numbers last, under ``checks``. ``t_start`` is the process's
    start on ``time.perf_counter``'s clock. For the tests and the control
    runs only: ``overrides`` and ``config_overrides`` replace keys of the
    traffic mix and of the configuration (tiny sizes), ``fault`` plants
    one of the faults of ``kinds/<kind>.FAULTS`` in the port, and
    ``control`` puts the reference in lower precision in the program's
    place for the check, ``witness`` a correct implementation that rounds
    differently (``kinds/<kind>`` says which, where it has one)."""
    import torch

    spec = load_cell(name, root)
    spec["config"] = {**spec["config"], **(config_overrides or {})}
    traffic = {**spec["traffic"], **(overrides or {})}
    kind = importlib.import_module(f"perfbench.kinds.{traffic['kind']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    bench = kind.setup(spec["config"], traffic, seed, dev, fault=fault, log=log)

    def barrier():
        if cuda:
            torch.cuda.synchronize(dev)

    barrier()
    t_setup = time.perf_counter() - t_start
    summary, units, calls = None, 0, 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from perfbench.trace import summarize

        # the metrics' window records device activity alone, which costs the
        # host little; one more call with the host's operations recorded too
        # labels the idle gaps
        device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=device_only) as prof:
            barrier()
            t0 = time.perf_counter()
            for _ in range(traffic["trace_calls"]):
                units += bench.call()
                calls += 1
            barrier()
            window = time.perf_counter() - t0
        summary = summarize(prof)
        labelled = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=labelled) as prof:
            bench.call()
            barrier()
        summary["idle_gaps"] = summarize(prof)["idle_gaps"]
        del prof
    else:
        t0 = time.perf_counter()
        while True:
            units += bench.call()
            calls += 1
            if time.perf_counter() - t0 >= seconds and calls >= bench.min_calls:
                break
        barrier()
        window = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bench.release()
    t_check = time.perf_counter()
    found = bench.check(control=control, **({"witness": True} if witness else {}))
    missing = set(spec["limits"]) - set(found)
    if missing:
        raise KeyError(f"limits/{name}.json names numbers the check does not give: {missing}")
    checks = {k: v for k, v in found.items() if k in spec["limits"]}
    log(f"check took {time.perf_counter() - t_check:.1f}s")
    correct = judge(checks, spec["limits"])

    metrics, breakdown = {}, None
    if trace:
        ctx = {"trace": summary, "window_s": window, "units": units, "calls": calls,
               "facts": bench.facts(), "peaks": peaks(root), "chips": spec["cell"]["chips"]}
        for m in spec["per_layer"]:
            value = metric_reader(m["name"], root)(ctx)
            if value is None:
                continue
            extra = value if isinstance(value, dict) else {"value": value}
            metrics[m["name"]] = {"value": extra.pop("value"), "unit": m["unit"], **extra}
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": t_setup, "unit": m["unit"]}
            elif m["name"] == bench.rate_metric:
                metrics[m["name"]] = {"value": units / window, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": spec["cell"]["chips"], "memory_peak_bytes": int(memory_peak)}
    if trace:
        device_info.update(busy_s=summary["busy_s"], window_s=window)
    out = {"correct": bool(correct), "attempted": calls, "failed": 0, "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": spec["limits"][k]} for k, v in checks.items()}
    return out
