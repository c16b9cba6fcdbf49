"""The benchmark's own tests: run with `python -m pytest benchmark/tests -q`.

Tests that need a CUDA card carry the `card` marker and skip without one,
deciding inside the test."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE.parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return "cuda"
