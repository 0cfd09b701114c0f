"""Tests of the benchmark itself (``python -m pytest gpubench/tests``).

Tests marked ``gpu`` need a CUDA card and skip without one; each decides
inside the test, never at import.  The rest run on the CPU at tiny
scales, the program's kernels through their plain versions.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and nvcc; skips without a card")


@pytest.fixture
def card():
    """The CUDA card, or a skip.  Afterwards the test's cached blocks go
    back to the card, so that a run this process starts next has it."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda", 0)
    torch.cuda.empty_cache()
