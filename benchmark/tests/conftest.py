"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need a CUDA card; each decides inside the test (the
``card`` fixture), never at import, and skips here with its reason. On the
card: ``python -m pytest benchmark/tests -q -m card``.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs the cell at its own size)")


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    return "cuda:0"
