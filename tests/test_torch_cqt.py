"""The port's NSGT-CQT against the JAX transform, both frame modes: the host
frame construction (shapes, plans, mask), forward, inverse, the hpf
projection, and the gradients of real losses through both directions.

Tolerance: fp32 at 2e-4 relative to the largest value (both sides run
float32 FFTs of a few thousand points with different libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.ops.cqt import CQT as JCQT
from babe_tpu_torch.ops.cqt import CQT as TCQT

FS = 22050.0
TOL = 2e-4
CONFIGS = {"native": (4, 16, FS, 8192), "compat": (4, 16, FS, 8190)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    mode = request.param
    n, bpo, fs, L = CONFIGS[mode]
    return JCQT(n, bpo, fs, L, mode=mode), TCQT(n, bpo, fs, L, mode=mode)


def test_frame_plans_identical(pair):
    j, t = pair
    assert j.Ls == t.Ls and j.M == t.M
    np.testing.assert_array_equal(j._mask, t._mask)
    for pj, pt in zip(j._plans, t._plans):
        np.testing.assert_array_equal(pj.idx, pt.idx)
        np.testing.assert_array_equal(pj.w_ana, pt.w_ana)
        np.testing.assert_array_equal(pj.w_syn, pt.w_syn)
    for gj, gt in zip(j._gather_syn, t._gather_syn):
        np.testing.assert_array_equal(gj, gt)


def test_forward_inverse_hpf_match(pair, rng):
    j, t = pair
    x = rng.standard_normal((2, j.audio_len)).astype(np.float32)
    cj = j.fwd(jnp.asarray(x))
    ct = t.fwd(torch.as_tensor(x))
    assert len(ct) == len(cj)
    for a, b in zip(ct, cj):
        assert a.shape == b.shape and a.dtype == torch.complex64
        _close(a.numpy(), b)
    coeffs = [(rng.standard_normal(c.shape) + 1j * rng.standard_normal(
        c.shape)).astype(np.complex64) for c in cj]
    _close(t.bwd([torch.as_tensor(c) for c in coeffs]).numpy(),
           j.bwd(tuple(jnp.asarray(c) for c in coeffs)))
    _close(t.apply_hpf_DC(torch.as_tensor(x)).numpy(),
           j.apply_hpf_DC(jnp.asarray(x)))


def test_gradients_of_real_losses_match(pair, rng):
    """d/dx of a loss through fwd, and d/d(re, im) of a loss through bwd
    (the JAX side uses its scatter-free custom vjps, the port autograd)."""
    j, t = pair
    L = j.audio_len
    x = rng.standard_normal((1, L)).astype(np.float32)
    r = rng.standard_normal((1, L)).astype(np.float32)
    wts = [rng.standard_normal(s).astype(np.float32) for s in
           [(1, j.bins_per_oct, m) for m in j.M]]

    def jloss(xx):
        cs = j.fwd(xx)
        return (sum(jnp.sum(w * jnp.abs(c) ** 2) for w, c in zip(wts, cs))
                + jnp.sum(r * j.bwd(cs, length=L)))

    xt = torch.as_tensor(x).requires_grad_(True)
    cs = t.fwd(xt)
    tl = (sum(torch.sum(torch.as_tensor(w) * c.abs() ** 2)
              for w, c in zip(wts, cs))
          + torch.sum(torch.as_tensor(r) * t.bwd(cs, length=L)))
    (gx,) = torch.autograd.grad(tl, xt)
    _close(gx.numpy(), jax.jit(jax.grad(jloss))(jnp.asarray(x)))

    re = [rng.standard_normal(s).astype(np.float32) for s in
          [(1, j.bins_per_oct, m) for m in j.M]]
    im = [rng.standard_normal(v.shape).astype(np.float32) for v in re]

    def jloss2(re_, im_):
        y = j.bwd(tuple(a + 1j * b for a, b in zip(re_, im_)), length=L)
        return jnp.sum(r * y) + 0.5 * jnp.sum(y * y)

    gre, gim = jax.jit(jax.grad(jloss2, argnums=(0, 1)))(
        [jnp.asarray(v) for v in re], [jnp.asarray(v) for v in im])
    ret = [torch.as_tensor(v).requires_grad_(True) for v in re]
    imt = [torch.as_tensor(v).requires_grad_(True) for v in im]
    y = t.bwd([torch.complex(a, b) for a, b in zip(ret, imt)], length=L)
    grads = torch.autograd.grad(
        torch.sum(torch.as_tensor(r) * y) + 0.5 * torch.sum(y * y),
        ret + imt)
    for a, b in zip(grads, list(gre) + list(gim)):
        _close(a.numpy(), b)


def test_flagship_frame_shapes():
    t = TCQT(7, 64, FS, 184184)
    assert t.Ls == 184320
    assert t.M == (32, 64, 128, 256, 512, 1024, 2048)
