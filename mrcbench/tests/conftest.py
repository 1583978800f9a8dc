"""The benchmark's tests: CPU tests at tiny sizes, and tests that need a
CUDA card (marked `cuda`, skipped without one).

    python -m pytest mrcbench/tests -q
"""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The first card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
