"""Whole runs of each cell on the CPU at a tiny size, the chip's look
skipped: a sound run is correct, and each fault the cell can have,
planted in the port's timed path, makes ``correct`` come out false, as
does the control (the reference in lower precision in the program's
place)."""

import pytest

from perfbench import harness
from perfbench.tests import tiny


def _faults():
    import importlib

    out = []
    for cell in tiny.cells():
        kind = harness.load_cell(cell)["traffic"]["kind"]
        out += [(cell, f) for f in importlib.import_module(f"perfbench.kinds.{kind}").FAULTS]
    return out


@pytest.mark.parametrize("cell", tiny.cells())
def test_sound_run_is_correct(cell):
    result = tiny.run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell,fault", _faults())
def test_fault_is_caught(cell, fault):
    result = tiny.run(cell, fault=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", tiny.cells())
def test_control_is_caught(cell):
    result = tiny.run(cell, control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", [c for c in tiny.cells()
                                  if harness.load_cell(c)["traffic"]["kind"] == "closed_loop"])
def test_witness_run_is_correct(cell):
    """The witness (the reference's simulator on the CPU in the
    simulator's place) runs the whole check; on the CPU it rounds as the
    reference does."""
    result = tiny.run(cell, witness=True)
    assert result["correct"], result["checks"]
    assert result["checks"]["state_gap_max"]["value"] == 0.0


@pytest.mark.parametrize("cell", tiny.cells())
def test_traced_run_reads_per_layer_metrics(cell):
    """On the CPU the trace holds no device time: the readers of device
    shares return nothing rather than 0, and the run still checks."""
    result = tiny.run(cell, trace=True)
    assert result["correct"]
    assert "idle_share.rollout" not in result["metrics"]
    assert result["device"]["busy_s"] == 0.0
