"""The benchmark's own tests: ``python -m pytest perfbench/tests``.

CPU tests run the harness at tiny sizes. Tests marked ``card`` need a CUDA
device and skip without one; they decide that inside the ``card``
fixture, never while the module is imported."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
