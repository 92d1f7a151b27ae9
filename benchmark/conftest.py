"""Tests of the benchmark itself: ``python -m pytest benchmark/tests``.

Tests marked ``card`` run on an NVIDIA card (the cell's own size) and skip
without one; the decision is made inside the ``card`` fixture, never at
import or collection.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (runs on the chip)")
    return torch.device("cuda")
