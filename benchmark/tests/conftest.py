"""The benchmark's tests: its harness, traffic, metrics, rooflines and plain
reference on the CPU, and (marked ``gpu``) its control and broken-path
checks on the card.  Run from the repository's root:

    python -m pytest benchmark/tests -q                 # CPU; gpu tests skip
    python -m pytest benchmark/tests -m gpu -q          # on the card
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
