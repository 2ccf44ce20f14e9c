"""The filter-fit kernel's arithmetic (``babe_tpu_torch/csrc/filter_fit.cu``)
mirrored in numpy and held to the references on the CPU.

The kernel runs only on the card; what it computes is mirrored here step
for step in the kernel's order: the first bin at or above fc as the closed
form ceil(fc * nfft / fs) corrected by one bin against the frequency grid,
the segment exp2(A log2(10)/20 * max(log2(f * (1 / fc)), 0)) (in place of
10 ** (A log2(f / fc) / 20)), the per-segment sums with half of dS/dH, the
analytic chain backward as a recurrence over the breakpoints, the step,
the clamps and the tolerance exit.  The mirror is held

  * in float64 to autograd through ``design_filter`` (float64) at every
    iterate of the plain loop ``BlindSampler._fit_loop`` at the flagship
    shape (F = 2049, K = 5), and with every breakpoint on a bin frequency
    (the ties whose gradient max(f, fc) splits): 1e-12 of the largest
    gradient entry per row (the two differ only by float64 rounding of
    log2 and pow; 1e-14 seen);
  * in float32 to the same autograd in float32, the plain loop's own
    gradient: 1e-4 of the largest entry per row (float32 sums over 2049
    bins in two orders, and log2(f * (1 / fc)) against log2(f / fc);
    7e-7 seen);
  * both again at every iterate of the chip check's "fc past Nyquist"
    case (a breakpoint past the last bin, then breakpoints on it);
  * on the first-bin index, to ``(fr >= fc)``'s first index over a
    hypothesis sweep of fc (exact bin frequencies, one float32 ulp either
    side of them, anything up to past the last bin) at fs 22050 and 44100;
  * on the whole fit, in float32, to the JAX ``fit_params`` through the
    harness of ``tests/test_torch_sampling.py::test_fit_params_matches``
    at K = 1, K = 16, an exit at tol, a run to max_iter and
    only_negative_A false: 1e-3 of the largest parameter per row, as that
    test's tolerance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from babe_tpu.sampling import blind as jblind
from babe_tpu.sampling import heun as jheun
from babe_tpu_torch.ops.filters import design_filter
from babe_tpu_torch.ops.stft import rfftfreq
from babe_tpu_torch.sampling.blind import BlindConfig, BlindSampler
from babe_tpu_torch.sampling.heun import SamplerConfig
from babe_tpu_torch.tools.fit_sensitivity import case_config, case_spectra

LOG2_10_OVER_20 = math.log2(10.0) / 20.0
LN10_OVER_20 = math.log(10.0) / 20.0
LOG2E = 1.0 / math.log(2.0)


# ------------------------------------------------------------------ mirror


def first_bin(fr: np.ndarray, fc, bin_scale) -> int:
    """The kernel's first bin n with fr[n] >= fc (F when there is none):
    ceil(fc * bin_scale) in fr's type, clamped, one correction."""
    F = fr.shape[0]
    e = np.ceil(fr.dtype.type(fc) * fr.dtype.type(bin_scale))
    n = 0 if np.isnan(e) else int(min(max(e, 0.0), F - 1))
    below, at, last = fr[max(n - 1, 0)], fr[n], fr[F - 1]
    m = n - 1 if (n > 0 and below >= fc) else (n + 1 if at < fc else n)
    return m if last >= fc else F


def log2_ratio(f, rfc):
    """log2(f / fc) as the kernel computes it: log2(f * (1 / fc))."""
    with np.errstate(divide="ignore"):
        return np.log2(f * rfc)


def mirror_grad(stats, fr, fc, A, bin_scale, dt=np.float64):
    """The loss L and its gradient (d/dfc, d/dA) as the kernel computes them
    for parameters (fc, A) (K,), stats (3, F), grid fr (F,)."""
    one = dt(1.0)
    a, b, c = (np.asarray(v, dt) for v in stats)
    fr = np.asarray(fr, dt)
    fc, A = np.asarray(fc, dt), np.asarray(A, dt)
    K, F = fc.shape[0], fr.shape[0]
    # the chain forward, breakpoint by breakpoint
    fci = np.maximum(fc, dt(1e-9))
    rfc, aq = one / fci, A * dt(LOG2_10_OVER_20)
    gf = np.where(fc >= dt(1e-9), A * dt(LN10_OVER_20) * (-rfc * dt(LOG2E)),
                  dt(0.0))
    nst = np.array([first_bin(fr, fc[i], bin_scale) for i in range(K)])
    fst = np.array([fr[n] if n < F else dt(0.0) for n in nst], dt)
    jp, sc, cont = np.full(K, -1), np.ones(K, dt), np.ones(K, dt)
    xA, xF, xS = np.zeros(K, dt), np.zeros(K, dt), np.zeros(K, dt)
    for i in range(1, K):
        for k in range(i):
            if nst[i] < F and fst[i] >= fc[k]:
                jp[i] = k
        if jp[i] >= 0:
            k = jp[i]
            lg = max(log2_ratio(fst[i], rfc[k]), dt(0.0))
            sc[i] = np.exp2(aq[k] * lg)
            cont[i] = sc[i] * cont[k]
            w = one if fst[i] > fci[k] else dt(0.5)
            xA[i] = cont[k] * (sc[i] * dt(LN10_OVER_20) * lg)
            xF[i] = cont[k] * (sc[i] * gf[k] * w)
            xS[i] = sc[i]
    tb = np.array([nst[i] if (nst[i] < F and fc[i] >= 1e-9 and fst[i] == fc[i])
                   else -1 for i in range(K)])
    # the bins: segment j, its sums (half of dS/dH), the loss
    n = np.arange(F)
    j = np.full(F, -1)
    for i in range(K):
        j = np.where(n >= nst[i], i, j)
    inb = j >= 0
    jj = np.where(inb, j, 0)
    lg = np.where(inb, np.maximum(log2_ratio(fr, rfc[jj]), dt(0.0)), dt(0.0))
    s = np.where(inb, np.exp2(aq[jj] * lg), one)
    co = np.where(inb, cont[jj], one)
    H = s * co
    u = H * a - b
    S = (H * (u - b)).sum(dtype=dt) + c.sum(dtype=dt)
    us = u * s
    t = us * co
    tA, tF = t * lg, np.where(n == tb[jj], dt(0.5) * t, t)
    sA, sF, sC = (np.array([v[inb & (j == i)].sum(dtype=dt) for i in range(K)], dt)
                  for v in (tA, tF, us))
    # d sqrt(clamp(S)) / dS times 2 (the sums hold half of dS/dH)
    dLdS = one / np.sqrt(S) if S >= 1e-12 else dt(0.0)
    gA, gfc, gc = dLdS * dt(LN10_OVER_20) * sA, dLdS * gf * sF, dLdS * sC
    for i in range(K - 1, 0, -1):
        k = jp[i]
        if k >= 0:
            gc[k] = gc[k] + gc[i] * xS[i]
            gA[k] = gA[k] + gc[i] * xA[i]
            gfc[k] = gfc[k] + gc[i] * xF[i]
    return np.sqrt(max(S, dt(1e-12))), gfc, gA


def mirror_fit(stats, fr, p0, cfg, dt=np.float32):
    """The kernel's whole fit: (params (2, K), iterations run)."""
    fc, A = (np.asarray(v, dt).copy() for v in p0)
    K = fc.shape[0]
    scale = np.float32(cfg.nfft / cfg.sample_rate)
    it = 0
    while it < cfg.max_iter:
        _, gfc, gA = mirror_grad(stats, fr, fc, A, scale, dt)
        nfc, nA = fc - dt(cfg.mu[0]) * gfc, A - dt(cfg.mu[1]) * gA
        if cfg.clamp_fc:
            nfc[0] = min(max(nfc[0], dt(cfg.fcmin)), dt(cfg.fcmax))
            for i in range(1, K):
                nfc[i] = min(max(nfc[i], nfc[i - 1] + dt(1.0)), dt(cfg.fcmax))
        if cfg.clamp_A:
            top = -1.0 if cfg.only_negative_A else cfg.Amax
            nA[0] = min(max(nA[0], dt(cfg.Amin)), dt(top))
            for i in range(1, K):
                hi = nA[i - 1] if cfg.only_negative_A else dt(cfg.Amax)
                nA[i] = min(max(nA[i], dt(cfg.Amin)), hi)
        done = (np.abs(nfc - fc).sum(dtype=dt) / dt(K) < cfg.tol[0]
                and np.abs(nA - A).sum(dtype=dt) / dt(K) < cfg.tol[1])
        fc, A, it = nfc, nA, it + 1
        if done:
            break
    return np.stack([fc, A]), it


# -------------------------------------------------------------- references


def autograd_grad(stats, fr, p, dtype):
    """The plain version's objective and gradient, by autograd through
    design_filter, in ``dtype``."""
    a, b, c = (torch.as_tensor(np.asarray(v), dtype=dtype) for v in stats)
    f = torch.as_tensor(np.asarray(fr), dtype=dtype)
    pg = torch.as_tensor(np.asarray(p), dtype=dtype).clone().requires_grad_()
    H = design_filter(pg[0], pg[1], f)
    L = torch.sqrt(torch.clamp((H * H * a - 2.0 * H * b + c).sum(), min=1e-12))
    (g,) = torch.autograd.grad(L, pg)
    return float(L.detach()), g.numpy()


def _flagship_stats(seed=4):
    """The chip check's flagship fit input: 2049 bins, 92 frames."""
    rng = np.random.default_rng(seed)
    shape = (1, 2049, 92)
    X = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    Y = X * np.linspace(1.0, 0.01, 2049)[None, :, None] ** 2
    X, Y = (torch.as_tensor(v.astype(np.complex64)) for v in (X, Y))
    s = BlindSampler(None, None, SamplerConfig(), BlindConfig(), device="cpu")
    return s, s._fit_stats(X, Y)


@pytest.fixture(scope="module")
def flagship_trace():
    s, stats = _flagship_stats()
    trace = []
    with torch.enable_grad():
        s._fit_loop(stats, s.blind.initial_params(), trace=trace)
    return s, [v.numpy() for v in stats], trace


def _rel(x, ref):
    """Max error per row over the row's largest entry."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return (np.abs(x - ref).max(axis=-1)
            / np.maximum(np.abs(ref).max(axis=-1), 1e-30))


def _check_every_iterate(s, stats, trace, dt, tol):
    """The mirror's loss and gradient against autograd's in the mirror's
    dtype at every iterate of ``trace``: the loss within ``tol`` of it, the
    gradient within ``tol`` of each row's largest entry."""
    fr = s.freqs.numpy()
    scale = np.float32(s.blind.nfft / s.blind.sample_rate)
    tdt = torch.float64 if dt == np.float64 else torch.float32
    worst = 0.0
    for p, _ in trace:
        p = p.numpy()
        L, g = autograd_grad(stats, fr, p, tdt)
        Lm, gfc, gA = mirror_grad(stats, fr, p[0], p[1], scale, dt)
        assert abs(Lm - L) <= tol * abs(L)
        worst = max(worst, float(_rel(np.stack([gfc, gA]), g).max()))
    assert worst <= tol, worst


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-12), (np.float32, 1e-4)])
def test_mirror_gradient_matches_autograd_every_iterate(flagship_trace, dt,
                                                        tol):
    s, stats, trace = flagship_trace
    assert len(trace) == s.blind.max_iter and s.freqs.shape[0] == 2049
    _check_every_iterate(s, stats, trace, dt, tol)


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-12), (np.float32, 1e-4)])
def test_mirror_gradient_past_nyquist_every_iterate(dt, tol):
    """The chip check's "fc past Nyquist" case: the first iterate has a
    breakpoint past the last bin (an empty mask, first bin F), the later
    ones breakpoints clamped onto the last bin (a tie at Nyquist)."""
    cfg = case_config("fc past Nyquist")
    s = BlindSampler(None, None, SamplerConfig(), cfg, device="cpu")
    stats = s._fit_stats(*case_spectra(cfg))
    trace = []
    with torch.enable_grad():
        s._fit_loop(stats, cfg.initial_params(), trace=trace)
    fr = s.freqs.numpy()
    assert trace[0][0][0, -1] > fr[-1]
    assert any(float(p[0, -1]) == fr[-1] for p, _ in trace)
    _check_every_iterate(s, [v.numpy() for v in stats], trace, dt, tol)


def test_mirror_gradient_at_ties():
    """Every breakpoint exactly on a bin frequency: the first bin of each
    segment is a tie of max(f, fc), whose fc gradient is halved."""
    s, stats = _flagship_stats()
    stats = [v.numpy() for v in stats]
    fr = s.freqs.numpy()
    p = np.array([[fr[52], fr[60], fr[61], fr[300], fr[400]],
                  [-10.0, -12.0, -20.0, -25.0, -30.0]], np.float32)
    L, g = autograd_grad(stats, fr, p, torch.float64)
    Lm, gfc, gA = mirror_grad(stats, fr, p[0], p[1],
                              np.float32(s.blind.nfft / s.blind.sample_rate))
    assert abs(Lm - L) <= 1e-12 * abs(L)
    assert (_rel(np.stack([gfc, gA]), g) <= 1e-12).all()


def test_mirror_fit_matches_the_plain_loop_at_the_flagship(flagship_trace):
    s, stats, trace = flagship_trace
    with torch.enable_grad():
        ref = s._fit_loop([torch.as_tensor(v) for v in stats],
                          s.blind.initial_params()).numpy()
    p, n_it = mirror_fit(stats, s.freqs.numpy(), s.blind.initial_params(),
                         s.blind)
    assert n_it == sum(1 for _, d in trace if not bool(d))
    assert (_rel(p, ref) <= 1e-3).all(), (p, ref)


# ------------------------------------------------------------ first bin


@st.composite
def _grid_and_fc(draw):
    fs = draw(st.sampled_from([22050.0, 44100.0]))
    nfft = draw(st.sampled_from([512, 1024, 4096]))
    fr = rfftfreq(nfft, fs)
    F = fr.shape[0]
    kind = draw(st.sampled_from(["bin", "below", "above", "any", "past"]))
    n = draw(st.integers(0, F - 1))
    if kind == "bin":
        fc = fr[n]
    elif kind == "below":
        fc = np.nextafter(fr[n], np.float32(-np.inf))
    elif kind == "above":
        fc = np.nextafter(fr[n], np.float32(np.inf))
    elif kind == "any":
        fc = np.float32(draw(st.floats(-100.0, fs / 2 + 100.0, width=32)))
    else:
        fc = np.float32(draw(st.floats(fs / 2, 4 * fs, width=32)))
    return fr, np.float32(nfft / fs), np.float32(fc)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(_grid_and_fc())
def test_first_bin_matches_the_mask(case):
    fr, scale, fc = case
    hits = np.flatnonzero(fr >= fc)
    want = int(hits[0]) if hits.size else fr.shape[0]
    assert first_bin(fr, fc, scale) == want


# -------------------------------------------------- the whole fit vs JAX


def _harness(seed, F=257):
    """tests/test_torch_sampling.py::test_fit_params_matches's spectra."""
    rng = np.random.default_rng(seed)
    shape = (1, F, 10)
    X = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = np.linspace(1.0, 0.05, F)[None, :, None]
    Y = X * f * (1 + 0.1 * rng.standard_normal(shape))
    return X.astype(np.complex64), Y.astype(np.complex64)


K16 = (tuple(300.0 + 40.0 * i for i in range(16)),
       tuple(-10.0 - 2.0 * i for i in range(16)))
EDGES = {
    "K1": dict(init_fc=(300.0,), init_A=(-20.0,), max_iter=30),
    "K16": dict(init_fc=K16[0], init_A=K16[1], max_iter=30),
    # the mean steps fall below tol at iteration 16
    "tol exit": dict(init_fc=(2000.0, 3000.0), init_A=(-20.0, -30.0),
                     tol=(1.5, 0.35), max_iter=60),
    "max_iter": dict(init_fc=(300.0, 500.0), init_A=(-20.0, -30.0),
                     tol=(1e-7, 1e-7), max_iter=40),
    "A may be positive": dict(init_fc=(300.0, 500.0), init_A=(5.0, -3.0),
                              only_negative_A=False, max_iter=30),
}


@pytest.mark.parametrize("name", list(EDGES))
def test_mirror_fit_matches_jax_fit_params(name):
    kw = dict(EDGES[name], nfft=512)
    X, Y = _harness(7)
    p0 = np.asarray([kw["init_fc"], kw["init_A"]], np.float32)
    js = jblind.BlindSampler(None, None, jheun.SamplerConfig(),
                             jblind.BlindConfig(**kw))
    ref = np.asarray(jax.jit(js.fit_params)(jnp.asarray(X), jnp.asarray(Y),
                                            jnp.asarray(p0)))
    ts = BlindSampler(None, None, SamplerConfig(), BlindConfig(**kw),
                      device="cpu")
    stats = [v.numpy() for v in ts._fit_stats(torch.as_tensor(X),
                                               torch.as_tensor(Y))]
    p, n_it = mirror_fit(stats, ts.freqs.numpy(), p0, ts.blind)
    assert (_rel(p, ref) <= 1e-3).all(), (p, ref)
    if name == "tol exit":
        assert 1 < n_it < kw["max_iter"]
    if name == "max_iter":
        assert n_it == kw["max_iter"]
