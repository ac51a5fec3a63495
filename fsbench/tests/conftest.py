"""Settings of the benchmark's own tests (``python -m pytest fsbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and ask for the
``card`` fixture, which skips them where torch sees no card: the decision
is made when the test runs, never when a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)
