"""Tests of the benchmark's harness and reference (``perfbench/tests``).

Run here with ``python -m pytest perfbench/tests -q``; the tests marked
``chip`` need a CUDA device and skip without one (on the card:
``python -m pytest perfbench/tests -q -m chip``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
