"""``cli doctor`` of the port (``utils/doctor.py``): the JAX package's
``tests/test_cli.py::test_cli_doctor_cpu`` under the port's check names,
and the doctor's refusal to pass on a host without a card.

- ``--cpu --json``: every check green, the device probes on the CPU
  (``torch_import`` sees no CUDA device, ``device_compute`` and
  ``compile_smoke`` report ``cpu``), two gloo ranks all-reduced, the frame
  store's library loaded, the configs composed, and no ``cuda_kernels``.
- without ``--cpu`` here (no card): exit code 1, ``device_compute`` and
  ``compile_smoke`` failed with "no CUDA device", the CPU-only checks
  still green.
"""

import contextlib
import io
import json

import pytest
import torch

from carla_imitation_learning_tpu_torch import cli

CPU_CHECKS = ("torch_import", "device_compute", "compile_smoke", "cpu_mesh",
              "native_framestore", "configs")


def _doctor(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["doctor", "--timeout", "300", "--json", *argv])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_cli_doctor_cpu():
    rc, report = _doctor("--cpu")
    assert rc == 0 and report["ok"], report
    assert tuple(report["checks"]) == CPU_CHECKS
    for name in CPU_CHECKS:
        assert report["checks"][name]["ok"], (name, report["checks"][name])
    checks = report["checks"]
    assert checks["torch_import"]["cuda_available"] is False
    assert checks["torch_import"]["version"] == torch.__version__
    assert checks["device_compute"]["device"] == checks["compile_smoke"]["device"] == "cpu"
    assert checks["cpu_mesh"]["ranks"] == 2 and checks["native_framestore"]["backend"] == "cpp"


def test_cli_doctor_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (chip_smoke.py runs the doctor on it)")
    rc, report = _doctor()
    assert rc == 1 and not report["ok"]
    checks = report["checks"]
    for name in ("device_compute", "compile_smoke"):
        assert not checks[name]["ok"] and "no CUDA device" in checks[name]["error"], name
    assert not checks["cuda_kernels"]["ok"]
    for name in ("torch_import", "cpu_mesh", "native_framestore", "configs"):
        assert checks[name]["ok"], name
