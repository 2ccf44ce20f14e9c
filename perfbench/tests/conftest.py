"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that need a CUDA card (they skip here; run them on the card with
``python3 -m pytest perfbench/tests -m card``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _babe_env():
    """The port reads BABE_* knobs from the environment: put them back as
    they were after each test."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("BABE_")}
    yield
    for k in [k for k in os.environ if k.startswith("BABE_")]:
        del os.environ[k]
    os.environ.update(saved)
