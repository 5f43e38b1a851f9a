"""Test set-up of the benchmark's own tests (``python -m pytest
benchmark/tests``): the benchmark's modules and the checkout's root on the
path, one intra-op thread, and the card's marker."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="session")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest benchmark/tests -m cuda)")
