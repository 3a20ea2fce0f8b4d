"""Tests of the benchmark harness (gpu_bench/). Run from the repo root:

    python -m pytest gpu_bench/tests -q

On a host without a CUDA device the tests marked `card` skip; on the card
machine the same command runs them too. Whether there is a card is decided
inside the `card` fixture, never while a module is imported.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    return torch.device("cuda", 0)
