"""pytest settings of the benchmark's own tests (``python -m pytest portbench/tests``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device at the cell's own size; skips without one")


@pytest.fixture
def cuda_device():
    """'cuda', or a skip where this machine has no CUDA device (decided here,
    when the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip")
    return "cuda"
