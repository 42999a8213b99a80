"""``cli doctor``: environment and device diagnostics (the JAX package's
``utils/doctor.py``).

A card can hang a process (a launch that never returns, a wedged driver),
the toolkit can be missing, or the native library may not build. Every
check that touches a device or the toolkit therefore runs in a fresh
subprocess bounded by a timeout: the doctor itself never hangs, and a hang
is reported as a failed check with its symptom. The subprocesses run side
by side (each reaching the card takes seconds), so the doctor takes about
as long as its slowest probe, and a probe's timings include its
neighbours' load.

Checks:
  torch_import      — torch's version, its CUDA build, whether a card is
                      visible, its name and the device count (subprocess)
  device_compute    — a reduction on the device, fetched back (subprocess)
  compile_smoke     — a convolution (cuDNN on the card): its first call
                      and a second one, timed (subprocess)
  cpu_mesh          — two gloo ranks on the CPU all-reduce (subprocess)
  cuda_kernels      — nvcc builds the four ``csrc`` libraries and each
                      kernel's ``raster_*_info`` entry point answers
                      (subprocess; not with ``force_cpu``)
  native_framestore — the C++ frame store library builds and loads
  configs           — the package's config tree composes

The device probes run on the card. Without one they fail, and so does the
doctor: it never passes by running on the CPU. ``force_cpu`` pins them to
the CPU instead (a subprocess that sees no CUDA device) and drops
``cuda_kernels``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]


def _probe(code: str, timeout: float, force_cpu: bool = False) -> dict:
    """Run a python snippet in a fresh subprocess with ``DEVICE`` set to
    "cpu" or "cuda"; the snippet prints one JSON object on its last stdout
    line. → {ok, seconds, ...payload}, or {ok: False, error or symptom}."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO_ROOT), env.get("PYTHONPATH", "")) if p)
    if force_cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    code = f"DEVICE = {'cpu' if force_cpu else 'cuda'!r}\n" + code
    t0 = time.time()
    try:
        proc = subprocess.run([sys.executable, "-c", code], timeout=timeout,
                              capture_output=True, text=True, env=env)
    except subprocess.TimeoutExpired:
        return {"ok": False, "seconds": round(time.time() - t0, 1),
                "symptom": f"probe hung past {timeout:.0f} s (device or driver wedged)"}
    secs = round(time.time() - t0, 2)
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().splitlines()[-3:]
        return {"ok": False, "seconds": secs, "error": " | ".join(tail)}
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        return {"ok": False, "seconds": secs,
                "error": f"unparseable probe output: {proc.stdout[-200:]!r}"}
    out.setdefault("ok", True)
    out["seconds"] = secs
    return out


_NEED_DEVICE = """
import torch
if DEVICE == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device is available")
"""

_TORCH_IMPORT = """
import json, torch
cuda = torch.cuda.is_available()
print(json.dumps({"version": torch.__version__, "cuda_build": torch.version.cuda,
                  "cuda_available": cuda,
                  "device_name": torch.cuda.get_device_name(0) if cuda else None,
                  "device_count": torch.cuda.device_count()}))
"""

_DEVICE_COMPUTE = _NEED_DEVICE + """
import json, time
t0 = time.time()
v = float(torch.arange(4096, dtype=torch.float32, device=DEVICE).sum())  # fetch = completion
assert v == 4096 * 4095 / 2, v
print(json.dumps({"device": DEVICE, "fetch_seconds": round(time.time() - t0, 3)}))
"""

_COMPILE_SMOKE = _NEED_DEVICE + """
import json, time
import torch.nn.functional as F
x = torch.ones((8, 4, 32, 32), device=DEVICE)
k = torch.full((16, 4, 3, 3), 0.01, device=DEVICE)
def conv():
    y = F.conv2d(x, k, padding=1)
    return float(y[0, 0, 16, 16])          # fetch = completion
t0 = time.time(); first = conv(); t1 = time.time(); second = conv(); t2 = time.time()
assert abs(first - 0.36) < 1e-4 and first == second, (first, second)
print(json.dumps({"device": DEVICE, "cudnn": torch.backends.cudnn.is_available(),
                  "first_call_seconds": round(t1 - t0, 3),
                  "second_call_seconds": round(t2 - t1, 4)}))
"""

_CPU_MESH_RANK = """
import sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                        rank=rank)
t = torch.tensor([float(rank + 1)])
dist.all_reduce(t)
assert float(t) == 3.0, float(t)
dist.destroy_process_group()
"""

_CPU_MESH = f"""
import json, socket, subprocess, sys
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
procs = [subprocess.Popen([sys.executable, "-c", {_CPU_MESH_RANK!r}, str(r), port])
         for r in range(2)]
codes = [p.wait() for p in procs]
assert codes == [0, 0], codes
print(json.dumps({{"ranks": 2, "backend": "gloo"}}))
"""

_CUDA_KERNELS = _NEED_DEVICE + """
import ctypes, json, time
from carla_imitation_learning_tpu_torch.ops import cuda_lib
t0 = time.time()
cuda_lib.build()
build_s = time.time() - t0
facts = {}
for name, variant in (("raster_exact", (1, 0)), ("raster_fast", ()), ("raster_prim", ()),
                      ("raster_vec", ())):
    fn = cuda_lib.entry_point(name, f"{name}_info",
                              [ctypes.c_int] * len(variant) + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 5)()
    cuda_lib.raise_on_error(fn(*variant, out), f"{name}_info")
    facts[name] = dict(zip(("registers", "spill_bytes", "smem_bytes", "threads",
                            "blocks_per_sm"), out))
print(json.dumps({"build_seconds": round(build_s, 2), "kernels": facts}))
"""

PROBES = {"torch_import": _TORCH_IMPORT, "device_compute": _DEVICE_COMPUTE,
          "compile_smoke": _COMPILE_SMOKE, "cpu_mesh": _CPU_MESH,
          "cuda_kernels": _CUDA_KERNELS}


def run_doctor(timeout: float = 90.0, force_cpu: bool = False) -> dict:
    """Run every check → {ok, checks: {name: result}}. ``force_cpu`` pins
    the device probes to the CPU and leaves ``cuda_kernels`` out."""
    # a first cuDNN call and an nvcc build take longer than a probe's default
    bounds = {"compile_smoke": timeout if force_cpu else max(timeout, 120.0),
              "cuda_kernels": max(timeout, 300.0)}
    names = [n for n in PROBES if not (force_cpu and n == "cuda_kernels")]
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(_probe, PROBES[n], bounds.get(n, timeout),
                                  force_cpu or n == "cpu_mesh") for n in names}
        checks: dict = {n: f.result() for n, f in futures.items()}

    t0 = time.time()
    try:
        from carla_imitation_learning_tpu_torch.native.framestore import _load

        _load()
        checks["native_framestore"] = {"ok": True, "seconds": round(time.time() - t0, 2),
                                       "backend": "cpp"}
    except (OSError, RuntimeError) as e:
        checks["native_framestore"] = {"ok": False, "error": str(e)}

    t0 = time.time()
    try:
        from carla_imitation_learning_tpu_torch.config import compose

        cfg = compose("config", overrides=["model=imitation"])
        checks["configs"] = {"ok": bool(cfg.get("BATCH_SIZE")),
                             "seconds": round(time.time() - t0, 2)}
    except (OSError, ValueError, KeyError) as e:
        checks["configs"] = {"ok": False, "error": str(e)}

    return {"ok": all(c.get("ok") for c in checks.values()), "checks": checks}


def print_report(report: dict) -> None:
    for name, c in report["checks"].items():
        line = f"{name:<18} " + ", ".join(f"{k}={v}" for k, v in c.items() if k != "ok")
        print(("ok   " if c.get("ok") else "FAIL ") + line,
              file=sys.stdout if c.get("ok") else sys.stderr)
