"""On the card (marker ``card``; skipped elsewhere): each cell at its own
size comes out correct, and with the control in the program's place comes
out not correct. Run on a machine with an NVIDIA GPU:

    python -m pytest perfbench/tests -m card
"""

import time

import pytest

from perfbench import harness
from perfbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("cell", tiny.cells())
def test_cell_at_its_size_is_correct(cell, cuda_device):
    result = harness.run_cell(cell, tiny.SEED, 2.0, False, cuda_device, time.perf_counter(),
                              log=lambda msg: None)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", tiny.cells())
def test_control_at_its_size_is_caught(cell, cuda_device):
    result = harness.run_cell(cell, tiny.SEED + 1, 2.0, False, cuda_device, time.perf_counter(),
                              control=True, log=lambda msg: None)
    assert not result["correct"], result["checks"]
