"""The port's restoration samplers against the JAX package's, on the tiny
reseeded weights of ``tests/test_torch_sampling.py`` (T = 3, Schurn = 0):
the ``predict_*`` entry points of ``sampling/heun.py`` new to the port
(compressive sensing through ``predict_inpainting``, declipping, phase
retrieval through ``predict_resample`` with its ``rid`` trajectory,
informed BWE through the FIR lowpass and through resampling, and
autoregressive continuation).  ``tests/test_torch_restoration_diag.py``
holds the blind sampler's ``rid`` trajectory, its filter-fit diagnostics
and the guidance norms; ``tests/test_torch_dsp.py`` the degradations and
their gradients.

Noise: each port run starts from the JAX sampler's own first draw for the
same key, given as ``x_init`` (the warm start y + N(0, 1) t[0] where the
observation has the signal's shape, else N(0, 1) sigma_max); with Schurn
= 0 the rest of the run draws nothing that matters.

Tolerance: 1e-3 relative to the largest value, as the sampler tests (each
Heun stage feeds the next, and the guidance divides by a norm).  Declipping
is held for one guided evaluation, not a run: the clip's gradient jumps
where a denoised sample crosses the clip level, and the two packages'
denoised estimates differ by up to about 1e-4 of their largest value, so a
sample that close to the level takes the gradient in one package and not
in the other (on ``default_rng(0)``'s signal two samples do at the first
stage, and whole runs part by 1.8e-2).  The test sets the level in the
widest gap of the JAX denoised estimate's magnitudes near the SDR level,
and asserts that the gap is wider than the two estimates' difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.ops.fir import get_FIR_lowpass
from babe_tpu.sampling import degradations as jdeg
from babe_tpu_torch.sampling import degradations as tdeg
from test_torch_sampling import L, _close, testers

__all__ = ["testers"]  # the fixture, shared with the sampler tests
FIR = (101, 1500.0, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers (these shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _first_draw(jt, key, shape, y=None):
    """The JAX sampler's first draw for ``key``: y + N(0,1) t[0] when the
    observation y has the signal's shape (the warm start), else N(0,1)
    t[0] of the full schedule."""
    _, k0 = jax.random.split(key)
    warm = y is not None and tuple(y.shape) == tuple(shape)
    t = (jt.edm.create_schedule_from_initial_t(jt.scfg.start_sigma,
                                               jt.scfg.T) if warm
         else jt.edm.create_schedule(jt.scfg.T))
    x = jax.random.normal(k0, shape) * t[0]
    return torch.as_tensor(np.array(x + y if warm else x))


def _signal(rng):
    """Tones plus a little noise at the model's rate."""
    t = np.arange(L) / 22050
    x = sum(np.sin(2 * np.pi * f * t + p) for f, p in
            ((220.0, 0.3), (660.0, 1.0), (2500.0, 2.0))) / 3
    return (0.05 * x + 0.005 * rng.standard_normal(L)).astype(
        np.float32)[None]


def _cs_mask(rng):
    """Compressive sensing's random mask: 20% of the samples observed."""
    return (rng.uniform(size=(1, L)) < 0.2).astype(np.float32)


def _cases(rng):
    """name -> (JAX predict call, port predict call, observation, signal
    shape) of the Heun entry points new to the port; each call takes rid
    as its last argument."""
    x = _signal(rng)
    m = _cs_mask(rng)
    win, hop = 256, 64
    y_mag = np.array(jdeg.make_stft_mag(win, hop)(jnp.asarray(x)))
    return {
        "comp_sens": (
            lambda s, k, y, rid: s.predict_compsens(k, y, jnp.asarray(m),
                                                    rid=rid),
            lambda s, y, xi, rid: s.predict_compsens(
                None, y, torch.as_tensor(m), rid=rid, x_init=xi),
            x * m, x.shape),
        "phase_retrieval": (
            lambda s, k, y, rid: s.predict_phase_retrieval(k, y, win, hop,
                                                           rid=rid),
            lambda s, y, xi, rid: s.predict_phase_retrieval(
                None, y, win, hop, rid=rid, x_init=xi),
            y_mag, x.shape),
    }


@pytest.mark.parametrize("name,rid", [("comp_sens", False),
                                      ("phase_retrieval", True)])
def test_restoration_predicts_match(testers, rng, name, rid):
    """One run each; with rid also the denoised estimates and t."""
    jt, tt = testers
    jcall, tcall, y, shape = _cases(rng)[name]
    key = jax.random.PRNGKey(21)
    js = jt.sampler()
    ref = jax.jit(lambda k, yy: jcall(js, k, yy, rid))(key, jnp.asarray(y))
    out = tcall(tt.sampler(), torch.as_tensor(y),
                _first_draw(jt, key, shape, y), rid)
    ref, out = (ref, out) if rid else ((ref,), (out,))
    assert out[0].shape == shape and np.isfinite(out[0].numpy()).all()
    if rid:
        assert out[1].shape == (jt.scfg.T, *shape)
        assert out[2].shape == (jt.scfg.T + 1,)
    for a, b in zip(out, ref):
        _close(a.numpy(), b, 1e-3)


def test_declipping_matches(testers, rng):
    """One guided evaluation of declipping (the score, its guidance
    gradient included) at t[0], then a whole port run with rid."""
    jt, tt = testers
    x = _signal(rng)
    key = jax.random.PRNGKey(27)
    x0 = _first_draw(jt, key, x.shape, x)
    t = float(jt.edm.create_schedule_from_initial_t(jt.scfg.start_sigma,
                                                    jt.scfg.T)[0])
    js, ts = jt.sampler(), tt.sampler()
    den_j = np.asarray(jax.jit(lambda v: js._denoise(v, t))(
        jnp.asarray(x0.numpy())))
    with torch.no_grad():
        den_t = ts._denoise(x0, t).numpy()
    # the clip level: the middle of the widest gap between the sorted
    # magnitudes of the denoised estimate, within 20% of the SDR-3 level
    target = float(np.std(x) * 10 ** (-3 / 20) * 2)
    mags = np.sort(np.abs(den_j).ravel())
    gaps = np.diff(mags)
    near = (mags[:-1] > 0.8 * target) & (mags[1:] < 1.2 * target)
    i = int(np.argmax(np.where(near, gaps, 0.0)))
    level = float(mags[i] + mags[i + 1]) / 2
    assert gaps[i] / 2 > np.abs(den_t - den_j).max()
    y = np.clip(x, -level, level)
    ref = jax.jit(lambda v: js._score(v, t, y=jnp.asarray(y),
                                      degradation=jdeg.make_clip(level)))(
        jnp.asarray(x0.numpy()))
    out = ts._score(x0, t, y=torch.as_tensor(y),
                    degradation=tdeg.make_clip(level))
    _close(out.numpy(), ref, 1e-3)
    run = ts.predict_declipping(None, torch.as_tensor(y), level, rid=True,
                                x_init=x0)
    assert [tuple(o.shape) for o in run] == [
        x.shape, (jt.scfg.T, *x.shape), (jt.scfg.T + 1,)]
    assert all(np.isfinite(o.numpy()).all() for o in run)


@pytest.mark.parametrize("ftype", ["firwin", "resample"])
def test_informed_bwe_degradations_match(testers, rng, ftype):
    """Informed BWE through the FIR lowpass, and through resampling (an
    observation shorter than the signal: predict_resample)."""
    jt, tt = testers
    filt = (get_FIR_lowpass(*FIR, 22050) if ftype == "firwin"
            else 22050 / 4000.0)
    x = _signal(rng)
    y = np.array(jdeg.degradation_from_filter(filt, ftype)(jnp.asarray(x)))
    key = jax.random.PRNGKey(22)
    js = jt.sampler()
    ref = jax.jit(lambda k, yy: js.predict_bwe(k, yy, filt, ftype))(
        key, jnp.asarray(y))
    out = tt.sampler().predict_bwe(None, torch.as_tensor(y), filt, ftype,
                                   x_init=_first_draw(jt, key, x.shape, y))
    assert out.shape == x.shape
    _close(out.numpy(), ref, 1e-3)


def test_predict_autoregressive_matches(testers, monkeypatch):
    """Two unconditional chunks, the second continuing the first's last
    quarter: the JAX key stream is replayed into the port's two entry
    points."""
    jt, tt = testers
    key = jax.random.PRNGKey(25)
    js, ts = jt.sampler(), tt.sampler()
    ref = jax.jit(lambda k: js.predict_autoregressive(k, (1, L), 2, 0.25))(
        key)
    stream = {"key": key}

    def draw(y=None):
        stream["key"], k = jax.random.split(stream["key"])
        return _first_draw(jt, k, (1, L), y)

    uncond, cond = ts.predict_unconditional, ts.predict_conditional
    monkeypatch.setattr(ts, "predict_unconditional", lambda g, s: uncond(
        g, s, x_init=draw()))
    monkeypatch.setattr(ts, "predict_conditional", lambda g, y, d: cond(
        g, y, d, x_init=draw(np.asarray(y))))
    out = ts.predict_autoregressive(None, (1, L), 2, 0.25)
    assert out.shape == (1, 2 * L - int(0.25 * L))
    _close(out.numpy(), ref, 1e-3)
