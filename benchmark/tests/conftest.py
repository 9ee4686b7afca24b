"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the checkout (on the CPU; the tests marked ``cuda`` skip there)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def one_thread():
    """Small torch ops on a shared CPU run up to 100x faster on one thread, so
    a short window holds the requests a test needs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
