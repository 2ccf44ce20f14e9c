"""The port's informed ``BABE.enhance`` against the JAX package's: a
44.1 kHz input of 2.5 model segments with a given filter, with and without
``denoise=True``, on the checkpoints and the key replay of
``tests/test_torch_enhance.py``.  Tolerance 1e-3 relative to the largest
value."""

import pytest
import torch

from test_torch_enhance import check_enhance, models

__all__ = ["models"]  # the fixture, shared with the blind requests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("denoise", [False, True])
def test_informed_enhance_matches_jax(models, monkeypatch, denoise):
    check_enhance(models, monkeypatch, (900.0, -25.0), denoise)
