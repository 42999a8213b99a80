"""Caps torch's intra-op threads in each pytest-xdist worker.

torch starts with one intra-op thread per core, so N workers on C cores
run N · C threads that fight for the cores. Every xdist worker imports
every test module when it collects, so this module's import sets the cap
in each worker before any test runs: ``cpu_count // workers`` threads (at
least one). A run without xdist is left as it is."""

import os

import pytest
import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
CAP = max(1, (os.cpu_count() or 1) // int(_WORKERS)) if _WORKERS else None
if CAP is not None:
    torch.set_num_threads(CAP)


def test_threads_capped_under_xdist():
    if CAP is None:
        pytest.skip("not an xdist worker: torch keeps its default threads")
    assert torch.get_num_threads() == CAP
