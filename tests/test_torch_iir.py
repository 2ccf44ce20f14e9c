"""The port's IIR recursion (``ops/iir.py``: the ``_LFilter`` Function
whose CUDA side is ``csrc/iir.cu``) against the JAX package's
``lfilter`` (a ``lax.scan``) and ``jax.grad`` of it, on the same numpy
inputs: cheby1 (order 6) and the RBJ biquad, at 8192 samples and several
row counts.

Tolerances: a 6th-order cheby1 at 1 kHz has poles so near the unit circle
that any fp32 recursion sits about 1e-3 from float64, and two fp32
recursions as far from each other.  So, as ``tests/test_torch_dsp.py``
does, both the forward and the input gradient are held to scipy's
float64 ``lfilter``: the port within twice the JAX package's own l2
error there, plus 1e-7 (the float64 gradient of sum(lfilter(x) * r) is
the filter run over the reversed r, reversed).  The port's gradient runs
the filter over the time-reversed cotangent, JAX transposes the scan: the
same sums in another order, whose fp32 errors differ (cheby1: 2.6e-3
against JAX's 0.9e-3 from float64).  So the gradient's bar is twice the
larger of JAX's gradient error and the error of JAX's own ``lfilter``
run over the reversed cotangent, the computation the port makes.  On the CPU the plain loop runs; the reversed
rows it gives are the forward rows of the flipped input, flipped back,
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from babe_tpu.ops import iir as jiir
from babe_tpu_torch.ops import iir as tiir
from babe_tpu_torch.sampling import degradations as tdeg

FS = 22050
L = 8192


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _l2_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _held_to_f64(out, refs, f64):
    """out (the port) within twice the largest l2 error from f64 of the
    JAX results ``refs``."""
    out = np.asarray(out)
    bar = 2 * max(_l2_rel(r, f64) for r in refs) + 1e-7
    assert out.shape == f64.shape and np.isfinite(out).all()
    assert _l2_rel(out, f64) <= bar, (_l2_rel(out, f64), bar)


def _filters():
    b, a = jiir.get_cheby1_ba(6, 0.05, 2 * 1000.0 / FS)
    c = jiir.design_biquad_lpf(1000.0, FS, 0.707)
    return {"cheby1": (b, a), "biquad": (np.float32(c[:3]),
                                         np.float32(c[3:]))}


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / FS
    x = (0.3 * np.sin(2 * np.pi * 440.0 * t)
         + 0.1 * rng.standard_normal(shape + (L,)))
    return x.astype(np.float32)


@pytest.mark.parametrize("ftype", ["cheby1", "biquad"])
@pytest.mark.parametrize("shape", [(1,), (3,), (2, 2)])
def test_lfilter_function_forward_and_gradient(ftype, shape):
    """Forward and input gradient (the reversed-loop backward) of
    sum(lfilter(x) * r) against JAX's, for a random cotangent r."""
    b, a = _filters()[ftype]
    x = _signal(shape, 1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    y = tiir.lfilter(xt, a, b)
    (g,) = torch.autograd.grad((y * torch.as_tensor(r)).sum(), xt)
    jy = jiir.lfilter(jnp.asarray(x), a, b)
    jg = jax.grad(lambda v: jnp.sum(jiir.lfilter(v, a, b) * r))(
        jnp.asarray(x))
    b64, a64 = np.asarray(b, np.float64), np.asarray(a, np.float64)
    y64 = scipy.signal.lfilter(b64, a64, x.astype(np.float64))
    g64 = scipy.signal.lfilter(b64, a64, r[..., ::-1].astype(
        np.float64))[..., ::-1]
    jrev = np.asarray(jiir.lfilter(jnp.asarray(r[..., ::-1].copy()), a,
                                   b))[..., ::-1]
    _held_to_f64(y.detach().numpy(), [jy], y64)
    _held_to_f64(g.numpy(), [jg, jrev], g64)


def test_reversed_rows_and_the_degradation_closures():
    """The plain reversed recursion is the flipped recursion of the flipped
    rows, bit for bit; ``make_iir`` and ``make_biquad`` give ``lfilter``'s
    result and hold their normalised coefficients once per device and
    dtype."""
    fl = _filters()
    b, a = fl["cheby1"]
    x = torch.as_tensor(_signal((2,), 3))
    rev = tiir._rows(x, tiir._normalised(a, b, torch.float32, "cpu"), True)
    assert torch.equal(rev, tiir.lfilter(x.flip(-1), a, b).flip(-1))
    deg = tdeg.degradation_from_filter((b, a), "cheby1")
    assert torch.equal(deg(x), tiir.lfilter(x, a, b))
    assert torch.equal(deg(x), deg(x)) and len(deg._coef) == 1
    c = jiir.design_biquad_lpf(1000.0, FS, 0.707)
    bq = tdeg.degradation_from_filter(c, "biquad")
    assert torch.equal(bq(x), tiir.biquad(x, *c))


def test_coefficients_get_no_gradient():
    b, a = _filters()["biquad"]
    bt = torch.as_tensor(b).requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        tiir.lfilter(torch.zeros(1, 16), a, bt)
    with pytest.raises(ValueError, match="no gradient"):
        tiir.IIR(bt, a)
    with pytest.raises(ValueError, match="one length"):
        tiir.lfilter(torch.zeros(1, 16), a[:2], b)


def test_the_kernel_launcher_refuses_cpu_tensors():
    """The recursion's launcher takes CUDA tensors only (a CPU tensor runs
    the plain loop in ``lfilter``, never the launcher), and counts
    nothing on the CPU."""
    from babe_tpu_torch import kernels

    kernels.reset_launch_counts()
    with pytest.raises(ValueError):
        kernels.launch_lfilter(torch.zeros((1, 8)), torch.ones(4))
    b, a = _filters()["biquad"]
    tiir.lfilter(torch.zeros(2, 64), a, b)
    assert kernels.LAUNCHES["lfilter"] == 0
