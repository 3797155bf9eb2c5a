"""Settings of the benchmark's own tests.  Run them from the repository's
root: ``python -m pytest port_bench/tests`` (on the card, add
``-m cuda`` for those that need it)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, not while
    the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
