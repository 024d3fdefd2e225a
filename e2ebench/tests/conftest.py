"""The benchmark's own tests: ``python -m pytest e2ebench/tests -q`` from
the repository's root. Tests marked ``card`` need a CUDA card and skip
without one; on the card they read the control at the cells' sizes."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control is read on the card")
    return torch.device("cuda", 0)
