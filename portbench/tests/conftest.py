"""CPU tests of the benchmark (``python -m pytest portbench/tests``); the
tests marked ``chip`` need a CUDA device and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (the card)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return "cuda"
