"""The benchmark's own tests: CPU at tiny sizes, and (marked ``cuda``) a
run on the card. Run from the repository root:

    python -m pytest mil_bench/tests -q            # CPU
    python -m pytest mil_bench/tests -q -m cuda    # on the card
"""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
