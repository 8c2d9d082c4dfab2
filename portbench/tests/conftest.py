"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Tests marked ``card`` need an NVIDIA card (the chip): each asks for the
``card`` fixture, which skips it where there is none. Whether a card is
there is decided inside the fixture, never while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (runs on the chip)")
    from portbench import harness
    harness.set_caches()
    return "cuda"
