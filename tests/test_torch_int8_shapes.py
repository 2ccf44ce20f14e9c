"""The int8 shapes the port once refused, against the JAX package on the
same numpy inputs: the int8 1x1 product at shapes ``torch._int_mm`` does
not take (``ops/conv_kernels._int_mm``: K zero-padded to a multiple of 32,
then P1's GEMM on the card, float64 on the CPU) against JAX
``dot1x1_int8``'s einsum, and ``conv_int8`` with kernels and dilations
other than C8's (5,3) at (d,1) (the int8 im2col product,
``conv_int8_acc``) against JAX ``conv_int8`` through ``_conv_int8_impl``,
forward and straight-through gradients, also through an int8 ``Conv2d``.

Tolerances: the quantizers, the padding and the int32 accumulators exactly
(the port's accumulator on the JAX package's own int8 operands); the
rescaled outputs and the gradients at 2e-5 of the largest value (fp32
sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.ops import conv_kernels as jck
from babe_tpu_torch.models import blocks as tb
from babe_tpu_torch.ops import conv_kernels as tck

CLOSE = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(a, b, tol=CLOSE):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def _case(seed, B, F, T, C, N, kshape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((*kshape, C, N))).astype(np.float32)
    g = rng.standard_normal((B, F, T, N)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("M,K,N", [(8, 20, 12), (40, 100, 36), (3, 64, 5)])
def test_int_mm_pads_where_the_library_refuses(M, K, N):
    """Shapes torch._int_mm does not take: padding K to a multiple of 32
    leaves the int32 product unchanged, and it equals JAX's int8 einsum."""
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    bt = rng.integers(-127, 128, (N, K), dtype=np.int8)
    assert not tck.int_mm_takes(M, K, N)
    at, btt = torch.as_tensor(a), torch.as_tensor(bt)
    ap, bp = tck.pad_int_mm(at, btt)
    assert ap.shape[1] % 32 == 0 and ap.shape[1] - K < 32
    assert not ap[:, K:].any() and not bp[:, K:].any()
    plain = (at.double() @ btt.double().t()).round().to(torch.int32)
    padded = (ap.double() @ bp.double().t()).round().to(torch.int32)
    out = tck._int_mm(at, btt)
    ref = np.asarray(jnp.einsum("mk,nk->mn", a, bt,
                                preferred_element_type=jnp.int32))
    assert out.dtype == torch.int32
    assert torch.equal(padded, plain) and torch.equal(out, plain)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_dot1x1_int8_at_an_unpadded_width():
    """dot1x1_int8 with C = 20 and N = 12 (neither a multiple of 32 nor,
    for N, of 8): the quantizers and accumulator exactly, the output at
    CLOSE."""
    x, w, _ = _case(1, 1, 4, 3, 20, 12, (1, 1))
    jq, _ = jck._quant_act_per_item(jnp.asarray(x))
    jqw, _ = jck._quant_weight_per_cout(jnp.asarray(w[0, 0]))
    q, _ = tck.quant_act_per_item(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    acc = tck._int_mm(q.reshape(-1, 20),
                      tck.QuantKernel.of(_t(w)).qt).view(1, 4, 3, 12)
    ref = jnp.einsum("bftc,cn->bftn", jq, jqw,
                     preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref))
    _close(tck.dot1x1_int8(_t(x), _t(w)).numpy(),
           jck.dot1x1_int8(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("kshape,dil", [((3, 3), (2, 2)), ((1, 1), (1, 1)),
                                        ((5, 3), (2, 2))])
def test_conv_int8_any_kernel_matches_jax(kshape, dil):
    """The im2col accumulator and the plain one equal JAX's int32 conv on
    the JAX package's int8 operands; the output and the straight-through
    dx and dw at CLOSE (dx the exact transpose)."""
    x, w, g = _case(2, 2, 12, 10, 24, 16, kshape)
    jout, jq, _ = jck._conv_int8_impl(jnp.asarray(x), jnp.asarray(w), dil,
                                      with_q=True)
    jqw, _ = jck._quant_weight_per_cout(jnp.asarray(w))
    jacc = np.asarray(jax.lax.conv_general_dilated(
        jq, jqw, (1, 1), "SAME", rhs_dilation=dil,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    q, qw = (torch.as_tensor(np.array(v)) for v in (jq, jqw))
    np.testing.assert_array_equal(tck.conv_int8_acc(q, qw, dil).numpy(),
                                  jacc)
    np.testing.assert_array_equal(tck.conv_int8_acc_ref(q, qw, dil).numpy(),
                                  jacc)
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    out = tck.conv_int8(xt, wt, dil)
    _close(out.detach().numpy(), jout)
    _, pull = jax.vjp(lambda xx, ww: jck.conv_int8(xx, ww, dil),
                      jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = pull(jnp.asarray(g))
    dx, dw = torch.autograd.grad(out, (xt, wt), _t(g))
    _close(dx.numpy(), rdx)
    _close(dw.numpy(), rdw)


def test_int8_conv_backward_in_int8_at_any_kernel(monkeypatch):
    """Under BABE_INT8_BWD=1 the input gradient of a (3,3) conv at (2,2) is
    the int8 conv of g with the flipped, io-swapped kernel, in both
    packages."""
    monkeypatch.setenv("BABE_INT8_BWD", "1")
    x, w, g = _case(3, 1, 12, 10, 16, 16, (3, 3))
    _, pull = jax.vjp(lambda xx: jck.conv_int8(xx, jnp.asarray(w), (2, 2)),
                      jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(tck.conv_int8(xt, _t(w), (2, 2), bwd=True),
                                xt, _t(g))
    _close(dx.numpy(), pull(jnp.asarray(g))[0])


def test_an_int8_conv2d_of_any_kernel_runs():
    """An int8 ``Conv2d`` with a (3,3) kernel at dilation (2,2) no longer
    raises: its forward is conv_int8's and its input gradient finite."""
    conv = tb.Conv2d(16, 16, kernel=(3, 3), dilation=(2, 2))
    conv.reset_parameters(torch.Generator().manual_seed(4))
    conv.set_int8(tck.Int8Config(minc=16))
    assert conv.int8_active()
    x, _, _ = _case(4, 1, 8, 6, 16, 16, (3, 3))
    xt = _t(x).requires_grad_(True)
    y = conv(xt)
    ref = tck.conv_int8(_t(x), conv.weight.detach(), (2, 2))
    assert torch.equal(y.detach(), ref)
    (dx,) = torch.autograd.grad(y.square().sum(), xt)
    assert torch.isfinite(dx).all() and dx.abs().sum() > 0
