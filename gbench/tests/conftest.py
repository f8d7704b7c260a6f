"""Tests of the benchmark itself, on the CPU at tiny sizes:
``python -m pytest gbench/tests -q`` from the repo root. Tests marked
``cuda`` need the card and skip here (the decision is made in the
``cuda`` fixture)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
