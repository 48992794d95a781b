"""CPU tests of the benchmark (``python -m pytest -q portbench/tests``).

Tests marked ``cuda`` need a card and skip in their fixture without one
(``python -m pytest -q portbench/tests -m cuda`` on the card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"
