"""pytest settings of the benchmark's own tests (``python -m pytest
perfbench/tests``): the ``card`` marker of tests that need an NVIDIA GPU,
and the fixture that skips them elsewhere."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (CUDA); skips without one")


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test on a machine without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
