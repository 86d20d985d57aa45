"""The benchmark's CPU tests; those that need the card carry
``requires_cuda`` and skip without one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: runs only on a CUDA device; skips "
        "elsewhere")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
