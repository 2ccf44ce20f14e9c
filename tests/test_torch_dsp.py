"""The port's DSP for the degradations against the JAX package's, on the
same numpy inputs: FIR design and filtering (``ops/fir.py``), IIR
filtering (``ops/iir.py``: lfilter, biquad, cheby1 and RBJ design), the
rest of ``ops/filters.py`` (the gain filter, the parametric lowpass, the
STFT-distance norms with their gradients, the dB-MSE metric) and every
degradation of ``sampling/degradations.py`` (each branch of
``degradation_from_filter`` through ``prepare_filter`` on the shared
configs).

Tolerances: filter taps and coefficients exact (both are the same host
scipy or float64 arithmetic); fp32 filtering within l2_rel 1e-6 of JAX
(FIR: 'same' correlation sums of up to 500 terms; the STFT paths: FFT
rounding).  The IIR recursion is held to scipy's float64 ``lfilter``: the
port within twice the JAX package's own error there, and the two packages
within that of each other (a 4th-order cheby1 at 1 kHz has poles so near
the unit circle that both fp32 recursions sit about 1.4e-5 from float64).
The degradations' gradients within l2_rel 1e-6, 1e-5 through the STFT
magnitude (FFT rounding, as the norms).  The guidance norms' values within
1e-5 relative, their gradients within l2_rel 1e-5, the log-magnitude
norm's within 1e-4 (its gradient 1/|X| is
ill-conditioned at spectral nulls: either package's fp32 gradient is about
7e-5 from a float64 one there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.ops import filters as jfilt
from babe_tpu.ops import fir as jfir
from babe_tpu.ops import iir as jiir
from babe_tpu.sampling import degradations as jdeg
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.ops import filters as tfilt
from babe_tpu_torch.ops import fir as tfir
from babe_tpu_torch.ops import iir as tiir
from babe_tpu_torch.sampling import degradations as tdeg

FS = 22050


def _l2_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def _signal(rng, B=2, L=4096):
    t = np.arange(L) / FS
    x = sum(np.sin(2 * np.pi * f * t) / (k + 1)
            for k, f in enumerate((220.0, 1500.0, 4400.0, 9000.0)))
    x = x[None] + 0.1 * rng.standard_normal((B, L))
    return (0.05 * x).astype(np.float32)


@pytest.mark.parametrize("order,fc,beta", [(500, 1000.0, 1.0),
                                           (102, 3000.0, 4.0)])
def test_fir_taps_exact(order, fc, beta):
    lo = tfir.get_FIR_lowpass(order, fc, beta, FS)
    hi = tfir.get_FIR_highpass(order, fc, beta, FS)
    assert lo.shape == (order,) and hi.shape == (order - 1,)
    np.testing.assert_array_equal(lo, jfir.get_FIR_lowpass(order, fc, beta,
                                                           FS))
    np.testing.assert_array_equal(hi, jfir.get_FIR_highpass(order, fc, beta,
                                                            FS))


@pytest.mark.parametrize("k", [500, 499, 31, 2])
def test_apply_fir_matches(rng, k):
    """Odd and even kernels: an even one pads one more sample on the
    left."""
    x = _signal(rng)
    taps = rng.standard_normal(k).astype(np.float32) / k
    out = tfir.apply_fir(torch.as_tensor(x), taps).numpy()
    ref = np.asarray(jfir.apply_fir(jnp.asarray(x), taps))
    assert out.shape == ref.shape == x.shape
    assert _l2_rel(out, ref) <= 1e-6
    # a 1-D input keeps its shape
    one = tfir.apply_fir(torch.as_tensor(x[0]), taps).numpy()
    assert _l2_rel(one, ref[0]) <= 1e-6


def test_iir_design_exact():
    b, a = tiir.get_cheby1_ba(4, 0.05, 2 * 1000.0 / FS)
    jb, ja = jiir.get_cheby1_ba(4, 0.05, 2 * 1000.0 / FS)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)
    assert tiir.design_biquad_lpf(1000.0, FS, 0.707) == \
        jiir.design_biquad_lpf(1000.0, FS, 0.707)


def _iir_close(out, ref, x, b, a):
    """out (the port) and ref (JAX) against scipy's float64 lfilter: each
    within twice the JAX package's own error there."""
    f64 = scipy.signal.lfilter(np.asarray(b, np.float64),
                               np.asarray(a, np.float64),
                               np.asarray(x, np.float64))
    bar = 2 * _l2_rel(ref, f64) + 1e-7
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _l2_rel(out, f64) <= bar and _l2_rel(out, ref) <= bar


def test_lfilter_and_biquad_match(rng):
    x = _signal(rng, L=2048)
    b, a = jiir.get_cheby1_ba(4, 0.05, 2 * 1000.0 / FS)
    out = tiir.lfilter(torch.as_tensor(x), a, b).numpy()
    _iir_close(out, np.asarray(jiir.lfilter(jnp.asarray(x), a, b)), x, b, a)
    c = jiir.design_biquad_lpf(2000.0, FS, 0.707)
    out = tiir.biquad(torch.as_tensor(x), *c).numpy()
    _iir_close(out, np.asarray(jiir.biquad(jnp.asarray(x), *c)), x,
               np.float32(c[:3]) / np.float32(c[3]),
               np.float32(c[3:]) / np.float32(c[3]))
    # a lowpass: at least 10 dB less energy above 6 kHz
    band = np.fft.rfftfreq(x.shape[-1], 1.0 / FS) > 6000.0
    e_out, e_in = (float((np.abs(np.fft.rfft(v[0]))[band] ** 2).sum())
                   for v in (out, x))
    assert e_out < 0.1 * e_in


def test_lfilter_gradient_matches(rng):
    """The recursion is differentiable: d sum(lfilter(x)^2) / dx."""
    x = _signal(rng, B=1, L=512)
    b, a = jiir.get_cheby1_ba(2, 0.05, 2 * 2000.0 / FS)
    xt = torch.as_tensor(x).requires_grad_(True)
    (g,) = torch.autograd.grad((tiir.lfilter(xt, a, b) ** 2).sum(), xt)
    ref = jax.grad(lambda v: jnp.sum(jiir.lfilter(v, a, b) ** 2))(
        jnp.asarray(x))
    _close(g.numpy(), ref, 1e-5)


def test_filters_match(rng):
    freqs = np.fft.rfftfreq(512, 1.0 / FS).astype(np.float32)
    fc, A = np.float32([900.0, 2500.0]), np.float32([-20.0, -35.0])
    H = tfilt.design_filter_G(torch.as_tensor(fc), torch.as_tensor(A), 3.0,
                              torch.as_tensor(freqs)).numpy()
    _close(H, jfilt.design_filter_G(jnp.asarray(fc), jnp.asarray(A), 3.0,
                                    jnp.asarray(freqs)), 1e-6)
    x = _signal(rng)
    p = np.stack([fc, A])
    out = tfilt.apply_filter_fcA(torch.as_tensor(x), torch.as_tensor(p),
                                 torch.as_tensor(freqs), 512).numpy()
    ref = np.asarray(jfilt.apply_filter_fcA(jnp.asarray(x), jnp.asarray(p),
                                            jnp.asarray(freqs), 512))
    assert out.shape == x.shape and _l2_rel(out, ref) <= 1e-6
    est = np.stack([fc * 1.1, A + 5.0])
    mse = float(tfilt.filter_db_mse(torch.as_tensor(p), torch.as_tensor(est),
                                    torch.as_tensor(freqs)))
    jmse = float(jfilt.filter_db_mse(jnp.asarray(p), jnp.asarray(est),
                                     jnp.asarray(freqs)))
    assert mse > 0 and abs(mse - jmse) <= 1e-5 * jmse


@pytest.mark.parametrize("kind,weight", [
    ("complex", "None"), ("complex", "linear"), ("mag", "sqrt"),
    ("logmag", "log")])
def test_stft_norms_and_gradients_match(rng, kind, weight):
    y, d = _signal(rng), _signal(np.random.default_rng(5))

    def tfn(yy, dd):
        if kind == "complex":
            return tfilt.apply_norm_STFT_fweighted(yy, dd, weight, 256)
        return tfilt.apply_norm_STFTmag_fweighted(yy, dd, weight, 256,
                                                  logmag=kind == "logmag")

    def jfn(yy, dd):
        if kind == "complex":
            return jfilt.apply_norm_STFT_fweighted(yy, dd, weight, 256)
        return jfilt.apply_norm_STFTmag_fweighted(yy, dd, weight, 256,
                                                  logmag=kind == "logmag")

    dt = torch.as_tensor(d).requires_grad_(True)
    val = tfn(torch.as_tensor(y), dt)
    (g,) = torch.autograd.grad(val, dt)
    val = val.detach()
    jval, jg = jax.value_and_grad(lambda v: jfn(jnp.asarray(y), v))(
        jnp.asarray(d))
    assert abs(float(val) - float(jval)) <= 1e-5 * abs(float(jval))
    assert _l2_rel(g.numpy(), jg) <= (1e-4 if kind == "logmag" else 1e-5)


def _configs(overrides):
    return jconfig(overrides), tconfig(overrides)


@pytest.mark.parametrize("ftype,extra", [
    ("firwin", []), ("firwin_hpf", []),
    ("cheby1", ["tester.bandwidth_extension.filter.order=4"]),
    ("biquad", []), ("resample", []),
    ("decimate", ["tester.bandwidth_extension.decimate.factor=2"])])
def test_degradation_from_filter_matches(rng, ftype, extra):
    ov = [f"tester.bandwidth_extension.filter.type={ftype}", *extra]
    jargs, targs = _configs(ov)
    jf, jt = jdeg.prepare_filter(jargs, FS)
    tf, tt = tdeg.prepare_filter(targs, FS)
    assert tt == jt == ftype
    for a, b in zip(np.atleast_1d(np.asarray(tf, dtype=object)),
                    np.atleast_1d(np.asarray(jf, dtype=object))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = _signal(rng, L=2048)
    out = tdeg.degradation_from_filter(tf, tt)(torch.as_tensor(x)).numpy()
    ref = np.asarray(jdeg.degradation_from_filter(jf, jt)(jnp.asarray(x)))
    if ftype == "cheby1":
        _iir_close(out, ref, x, *tf)
    elif ftype == "biquad":
        c = np.float32(tf)
        _iir_close(out, ref, x, c[:3] / c[3], c[3:] / c[3])
    else:
        assert out.shape == ref.shape and _l2_rel(out, ref) <= 1e-6


def test_other_degradations_match(rng):
    x = _signal(rng)
    mask = (rng.uniform(size=(1, x.shape[-1])) < 0.3).astype(np.float32)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    pairs = [
        (tdeg.make_mask(torch.as_tensor(mask)), jdeg.make_mask(
            jnp.asarray(mask)), 0.0),
        (tdeg.make_clip(0.02), jdeg.make_clip(0.02), 0.0),
        (tdeg.make_clip(torch.tensor(0.03)), jdeg.make_clip(0.03), 0.0),
        (tdeg.make_stft_mag(256, 64), jdeg.make_stft_mag(256, 64), 1e-6),
    ]
    for tfn, jfn, tol in pairs:
        out, ref = tfn(tx).numpy(), np.asarray(jfn(jx))
        assert out.shape == ref.shape
        assert _l2_rel(out, ref) <= tol
    taps = tfir.get_FIR_lowpass(101, 2000.0, 1.0, FS)
    comp = tdeg.make_masked_composite(torch.as_tensor(mask),
                                      tdeg.make_fir(taps))(tx).numpy()
    ref = jdeg.make_masked_composite(jnp.asarray(mask),
                                     jdeg.make_fir(taps))(jx)
    assert _l2_rel(comp, ref) <= 1e-6


def test_degradation_gradients_match(rng):
    """d sum(w * deg(x)) / dx of every degradation the guidance
    differentiates through, compressive sensing's random mask and phase
    retrieval's STFT magnitude among them."""
    x = _signal(rng, L=2048)
    mask = (rng.uniform(size=(1, x.shape[-1])) < 0.05).astype(np.float32)
    taps = tfir.get_FIR_lowpass(101, 2000.0, 1.0, FS)
    pairs = [  # (port, JAX, l2_rel bar)
        (tdeg.make_mask(torch.as_tensor(mask)),
         jdeg.make_mask(jnp.asarray(mask)), 1e-6),
        (tdeg.make_clip(0.02), jdeg.make_clip(0.02), 1e-6),
        (tdeg.make_stft_mag(256, 64), jdeg.make_stft_mag(256, 64), 1e-5),
        (tdeg.make_fir(taps), jdeg.make_fir(taps), 1e-6),
        (tdeg.make_resample(FS / 4000.0), jdeg.make_resample(FS / 4000.0),
         1e-6),
        (tdeg.make_decimate(2), jdeg.make_decimate(2), 1e-6),
    ]
    for tfn, jfn, bar in pairs:
        w = rng.standard_normal(np.shape(jfn(jnp.asarray(x)))).astype(
            np.float32)
        xt = torch.as_tensor(x).requires_grad_(True)
        (g,) = torch.autograd.grad((torch.as_tensor(w) * tfn(xt)).sum(), xt)
        ref = jax.grad(lambda v: jnp.sum(w * jfn(v)))(jnp.asarray(x))
        assert _l2_rel(g.numpy(), ref) <= bar


@pytest.mark.parametrize("ps", [
    {"norm": 2}, {"norm": 1}, {"norm": "cosine"},
    {"norm": "smoothl1", "smoothl1_beta": 0.01},
    {"norm": 2, "stft_distance": {"use": True, "nfft": 256},
     "freq_weighting": "linear"},
    {"norm": 2, "stft_distance": {"use": True, "mag": True, "nfft": 256},
     "freq_weighting": "sqrt"},
    {"norm": 2, "stft_distance": {"use": True, "mag": True, "logmag": True,
                                  "nfft": 256}, "freq_weighting": "log"}],
    ids=["l2", "l1", "cosine", "smoothl1", "stft", "stft_mag",
         "stft_logmag"])
def test_guidance_norms_match(rng, ps):
    """make_norm_fn: every reconstruction-error norm of the
    posterior_sampling block, its value and its gradient."""
    from babe_tpu.sampling.heun import make_norm_fn as jmake
    from babe_tpu_torch.sampling.heun import make_norm_fn as tmake

    y, d = _signal(rng), _signal(np.random.default_rng(5))
    dt = torch.as_tensor(d).requires_grad_(True)
    val = tmake(ps)(torch.as_tensor(y), dt)
    (g,) = torch.autograd.grad(val, dt)
    jval, jg = jax.value_and_grad(lambda v: jmake(ps)(jnp.asarray(y), v))(
        jnp.asarray(d))
    assert abs(float(val.detach()) - float(jval)) <= 1e-5 * abs(float(jval))
    logmag = ps.get("stft_distance", {}).get("logmag", False)
    assert _l2_rel(g.numpy(), jg) <= (1e-4 if logmag else 1e-5)
