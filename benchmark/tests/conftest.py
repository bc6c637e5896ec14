"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``).

Tests that need a CUDA card take the ``cuda`` fixture, which decides when
the test runs, never at import, and skips on a machine without one.
"""

import gc

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _collector_restored():
    """A run freezes the collector (``harness.quiet_collector``); the next
    test gets it back."""
    yield
    gc.unfreeze()
