"""The blind sampler's trajectories and diagnostics, and the guidance norms,
against the JAX package, on the tiny reseeded weights of
``tests/test_torch_sampling.py`` (T = 3, Schurn = 0): ``predict_blind_bwe``
with ``rid=True`` (the restored signal, the filter, and per step the
denoised estimate, the filter and the score, with t), ``predict_bwe`` with
``test_filter_fit`` and ``compute_sweep`` (the informed run, the filters
fitted to its denoised estimates and the (fc, A) landscape at every step),
and informed BWE guided by the STFT-magnitude distance.

Noise and tolerance as ``tests/test_torch_restoration.py``: each port run
starts from the JAX sampler's first draw for the same key (``x_init``), and
every output is held at 1e-3 relative to its largest value.  The guidance
by the log-magnitude STFT distance is not run here: its gradient is 1/|X|
at spectral nulls, so its direction is set by rounding (the port's own run
moves by 3.6e-4 under a change of one part in 1e7 of its start, against
about 1e-5 under the L2 norm with the compressive-sensing mask or the
STFT magnitude); ``tests/test_torch_dsp.py`` holds that norm and
its gradient on equal inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.sampling import heun as jheun
from babe_tpu_torch.sampling import heun as theun
from test_torch_restoration import _first_draw
from test_torch_sampling import L, _close, _observation, testers

__all__ = ["testers"]  # the fixture, shared with the sampler tests
FILT = np.asarray([[800.0], [-30.0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers (these shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_blind_rid_matches(testers, rng):
    """(x, params, denoised [T, B, L], t [T + 1], params [T, 2, K],
    score [T, B, L])."""
    jt, tt = testers
    y = _observation(rng)
    key = jax.random.PRNGKey(23)
    js = jt.sampler()
    ref = jax.jit(lambda k, yy: js.predict_blind_bwe(k, yy, rid=True))(
        key, jnp.asarray(y))
    out = tt.sampler().predict_blind_bwe(
        None, torch.as_tensor(y), rid=True,
        x_init=_first_draw(jt, key, y.shape, y))
    T = jt.scfg.T
    assert [tuple(o.shape) for o in out] == [
        (1, L), (2, 2), (T, 1, L), (T + 1,), (T, 2, 2), (T, 1, L)]
    for a, b in zip(out, ref):
        _close(a.numpy(), b, 1e-3)


def test_filter_fit_and_sweep_match(testers, rng):
    jt, tt = testers
    y = _observation(rng)
    key = jax.random.PRNGKey(24)
    js = jt.sampler()
    ref = jax.jit(lambda k, yy: js.predict_bwe(
        k, yy, FILT, "fc_A", test_filter_fit=True, compute_sweep=True))(
        key, jnp.asarray(y))
    out = tt.sampler().predict_bwe(
        None, torch.as_tensor(y), FILT, "fc_A", test_filter_fit=True,
        compute_sweep=True, x_init=_first_draw(jt, key, y.shape, y))
    T = jt.scfg.T
    assert [tuple(o.shape) for o in out] == [
        (1, L), (T, 1, L), (T + 1,), (T, 2, 2), (T, 15, 12), (T, 15, 12, 2)]
    for a, b in zip(out, ref):
        _close(a.numpy(), b, 1e-3)


def test_stft_guidance_matches(testers, rng, monkeypatch):
    """Informed BWE guided by the frequency-weighted STFT-magnitude
    distance (``make_norm_fn``; every norm's value and gradient is held in
    ``tests/test_torch_dsp.py``)."""
    jt, tt = testers
    ps = {"norm": 2, "freq_weighting": "sqrt",
          "stft_distance": {"use": True, "mag": True, "nfft": 256}}
    for t_, mod in ((jt, jheun), (tt, theun)):
        monkeypatch.setattr(t_, "scfg", dataclasses.replace(
            t_.scfg, norm_fn=mod.make_norm_fn(ps)))
    y = _observation(rng)
    key = jax.random.PRNGKey(26)
    js = jt.sampler()
    x0 = _first_draw(jt, key, y.shape, y)
    ref = jax.jit(lambda k, yy: js.predict_conditional(
        k, yy, lambda v: js.degradation_fcA(v, jnp.asarray(FILT)),
        x_init=jnp.asarray(x0.numpy())))(key, jnp.asarray(y))
    out = tt.sampler().predict_bwe(None, torch.as_tensor(y), FILT, "fc_A",
                                   x_init=x0)
    _close(out.numpy(), ref, 1e-3)
