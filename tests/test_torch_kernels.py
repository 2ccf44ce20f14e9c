"""The port's conv kernels (K1 conv5x3, K2 fused dilation stage and its
backward) against the JAX package: on the CPU each wrapper runs its plain
PyTorch version, which is held here to the JAX XLA reference and to the
Pallas kernel in interpret mode, forward and backward, on the same numpy
inputs.  (The filter-fit kernel's plain version is held to JAX in
test_torch_sampling.py.)

Tolerances: fp32 at 2e-4 (the JAX package's own bar between its Pallas
kernel and XLA, tests/test_conv_kernels.py); bf16 as a relative L2 error of
2e-2 (both sides round every intermediate to bf16, but XLA may keep excess
precision inside fused elementwise chains, so single elements can differ by
a bf16 ulp)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.ops import conv_kernels as jck
from babe_tpu_torch import kernels
from babe_tpu_torch.ops import conv_kernels as tck
from babe_tpu_torch.sampling.blind import BlindConfig, BlindSampler
from babe_tpu_torch.sampling.heun import SamplerConfig

FP32_TOL = 2e-4
BF16_L2 = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _pallas_interpret():
    old = jck._BACKEND, jck._INTERPRET
    jck._BACKEND, jck._INTERPRET = "pallas", True
    try:
        yield
    finally:
        jck._BACKEND, jck._INTERPRET = old


def _l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


@pytest.mark.parametrize("d", [1, 2, 8])
def test_conv5x3_matches_xla_and_interpreted_kernel(rng, d):
    # C >= 32 so the JAX dispatcher takes its Pallas kernel; T=20 is not a
    # multiple of 8 (the TPU kernel pads T to T8, the port does not)
    B, F, T, C, N = 1, 16, 20, 32, 16
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((5, 3, C, N))).astype(np.float32)
    out = tck.conv5x3_dilated(_t(x), _t(w), d).numpy()
    ref = np.asarray(jck.conv_xla(_j(x), _j(w), (d, 1)))
    np.testing.assert_allclose(out, ref, rtol=FP32_TOL, atol=FP32_TOL)
    with _pallas_interpret():
        pal = np.asarray(jck.conv5x3_dilated(_j(x), _j(w), d))
    np.testing.assert_allclose(out, pal, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("C,N", [(2, 8), (8, 2)])
def test_conv5x3_pyramid_channels(rng, C, N):
    """The pyramid convs have C = 2 in and their transposes N = 2 out."""
    x = rng.standard_normal((1, 12, 9, C)).astype(np.float32)
    w = rng.standard_normal((5, 3, C, N)).astype(np.float32)
    out = tck.conv5x3_dilated(_t(x), _t(w), 1).numpy()
    ref = np.asarray(jck.conv_xla(_j(x), _j(w), (1, 1)))
    np.testing.assert_allclose(out, ref, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("d", [1, 4])
def test_conv5x3_dx_matches_jax_vjp(rng, d):
    """dx is K1 on the cotangent with the kernel flipped and io-swapped."""
    x = rng.standard_normal((2, 16, 11, 6)).astype(np.float32)
    w = (0.2 * rng.standard_normal((5, 3, 6, 10))).astype(np.float32)
    g = rng.standard_normal((2, 16, 11, 10)).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(tck.conv5x3_dilated(xt, _t(w), d), xt, _t(g))
    _, pull = jax.vjp(lambda xx: jck.conv_xla(xx, _j(w), (d, 1)), _j(x))
    np.testing.assert_allclose(dx.numpy(), np.asarray(pull(_j(g))[0]),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_conv5x3_bf16_matches_xla(rng):
    x = rng.standard_normal((1, 16, 24, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((5, 3, 16, 16))).astype(np.float32)
    out = tck.conv5x3_dilated(_t(x, torch.bfloat16), _t(w, torch.bfloat16), 2)
    ref = jck.conv_xla(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16), (2, 1))
    assert out.dtype == torch.bfloat16
    assert _l2(out.float().numpy(), ref.astype(jnp.float32)) < BF16_L2


def test_conv5x3_weight_grad_raises(rng):
    """Only the int8 stage (K3) still raises on a weight that requires
    grad; K1 now returns the weight gradient (``conv_dw_ref`` on the CPU,
    held to JAX in test_torch_dw.py)."""
    x = _t(rng.standard_normal((1, 8, 8, 4)))
    w = torch.zeros((5, 3, 4, 4), requires_grad=True)
    g = _t(rng.standard_normal((1, 8, 8, 4)))
    tck.conv5x3_dilated(x, w, 1).backward(g)
    np.testing.assert_array_equal(
        w.grad.numpy(), tck.conv_dw_ref(x, g, (5, 3), (1, 1)).numpy())
    qw, sw = tck.quant_weight_per_cout(w.detach())
    with pytest.raises(NotImplementedError):
        tck.fused_stage_int8(x, torch.ones((1, 4)), torch.ones((1, 4)),
                             torch.ones(1), w, kernels.tap_major(qw), sw, 1)


# ------------------------------------------------------------------- K2


def _padded(x, dm, Cp):
    """The JAX chained layout (B, F+4dm, T8+16, Cp), data at
    [:, 2dm:2dm+F, 8:8+T, :C], zero elsewhere."""
    B, F, T, C = x.shape
    T8 = -(-T // 8) * 8
    xp = np.zeros((B, F + 4 * dm, T8 + 16, Cp), np.float32)
    xp[:, 2 * dm:2 * dm + F, 8:8 + T, :C] = x
    return xp


def _unpad(yp, dm, F, T, C):
    return np.asarray(yp[:, 2 * dm:2 * dm + F, 8:8 + T, :C], np.float32)


def _stage_inputs(rng, B=2, F=16, T=20, C=8):
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((5, 3, C, C))).astype(np.float32)
    a = (0.5 + rng.random((B, C))).astype(np.float32)
    s = rng.standard_normal((B, C)).astype(np.float32)
    return x, w, a, s


def _jax_stage(x, w, a, s, d, dm, Cp, dtype=jnp.float32):
    B, F, T, C = x.shape
    w4 = np.zeros((5, 3, Cp, Cp), np.float32)
    w4[:, :, :C, :C] = w
    pad = ((0, 0), (0, Cp - C))
    args = (_j(_padded(x, dm, Cp), dtype), None, _j(w4, dtype),
            _j(np.pad(a, pad)), _j(np.pad(s, pad)))
    return args, (dm, d, F, T, C, Cp)


@pytest.mark.parametrize("d", [1, 2])
def test_fused_stage_matches_jax_ref_and_interpreted_kernel(rng, d):
    x, w, a, s = _stage_inputs(rng)
    B, F, T, C = x.shape
    y, mom = tck.fused_stage(_t(x), _t(a), _t(s), _t(w), d)
    dm, Cp = 2, 128
    (xp, _, w4, ap, sp), static = _jax_stage(x, w, a, s, d, dm, Cp)
    prev = jnp.zeros_like(xp)
    ry, rm = jck._dil_stage_ref(xp, prev, w4, ap, sp, static)
    np.testing.assert_allclose(y.numpy(), _unpad(ry, dm, F, T, C),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(mom.numpy(), np.asarray(rm)[:, :, :C],
                               rtol=FP32_TOL, atol=FP32_TOL)
    with _pallas_interpret():
        py, pm = jck.fused_stage_padded(xp, prev, w4, ap, sp, static)
    np.testing.assert_allclose(y.numpy(), _unpad(py, dm, F, T, C),
                               rtol=FP32_TOL, atol=FP32_TOL)
    # the Pallas kernel sums unrounded tiles in another order
    np.testing.assert_allclose(mom.numpy(), np.asarray(pm)[:, :, :C],
                               rtol=1e-3, atol=1e-3)


def test_fused_stage_bf16_casts_match_jax_ref(rng):
    """bf16: x*a, the gelu, conv*s, the residual sum and the division are
    each rounded to bf16 in the reference's order; moments in fp32."""
    x, w, a, s = _stage_inputs(rng, B=1, F=16, T=24, C=16)
    B, F, T, C = x.shape
    y, mom = tck.fused_stage(_t(x, torch.bfloat16), _t(a), _t(s),
                             _t(w, torch.bfloat16), 2)
    assert y.dtype == torch.bfloat16 and mom.dtype == torch.float32
    (xp, _, w4, ap, sp), static = _jax_stage(x, w, a, s, 2, 2, C,
                                             jnp.bfloat16)
    ry, rm = jck._dil_stage_ref(xp, jnp.zeros_like(xp), w4, ap, sp, static)
    assert _l2(y.float().numpy(), _unpad(ry, 2, F, T, C)) < BF16_L2
    assert _l2(mom.numpy(), np.asarray(rm)) < BF16_L2


def test_fused_stage_grads_match_jax_vjp(rng):
    """dx, da and ds (the moments' cotangent folded into y's) against
    jax.vjp of _dil_stage_ref, the JAX kernel's own backward."""
    x, w, a, s = _stage_inputs(rng, B=2, F=16, T=12, C=8)
    B, F, T, C = x.shape
    d, dm = 2, 2
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gm = rng.standard_normal((2, B, C)).astype(np.float32)
    xt, at, st = (_t(v).requires_grad_(True) for v in (x, a, s))
    y, mom = tck.fused_stage(xt, at, st, _t(w), d)
    dx, da, ds = torch.autograd.grad((y, mom), (xt, at, st),
                                     (_t(gy), _t(gm)))
    (xp, _, w4, ap, sp), static = _jax_stage(x, w, a, s, d, dm, C)
    prev = jnp.zeros_like(xp)
    _, pull = jax.vjp(lambda xx, aa, ss: jck._dil_stage_ref(
        xx, prev, w4, aa, ss, static), xp, ap, sp)
    rdx, rda, rds = pull((_j(_padded(gy, dm, C)), _j(gm)))
    np.testing.assert_allclose(dx.numpy(), _unpad(rdx, dm, F, T, C),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(da.numpy(), np.asarray(rda),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(rds),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_gelu_poly_and_derivative_match_jax(rng):
    v = (3.0 * rng.standard_normal(4096)).astype(np.float32)
    np.testing.assert_allclose(tck._gelu_impl(_t(v)).numpy(),
                               np.asarray(jck._gelu_impl(_j(v))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tck._gelu_deriv(_t(v)).numpy(),
                               np.asarray(jck._gelu_deriv(_j(v))),
                               rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    kernels.reset_launch_counts()
    x, w, a, s = _stage_inputs(rng)
    xt = _t(x).requires_grad_(True)
    y, mom = tck.fused_stage(xt, _t(a), _t(s), _t(w), 1)
    torch.autograd.grad(y.sum() + mom.sum(), xt)
    tck.conv5x3_dilated(_t(x), _t(w), 1)
    s_ = BlindSampler(None, None, SamplerConfig(), BlindConfig(nfft=64),
                      device="cpu")
    X = torch.randn((1, 33, 4), dtype=torch.complex64)
    s_.fit_params(X, X, s_.blind.initial_params())
    assert set(kernels.LAUNCHES) == {"conv5x3", "fused_stage",
                                     "stage_fwd_operand",
                                     "fused_stage_bwd", "filter_fit",
                                     "fused_stage_int8",
                                     "stage_int8_operand", "probe_gemm",
                                     "probe_stage", "dilated_conv",
                                     "conv_dw", "stage_dw_operands",
                                     "fused_stage_dw"}
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_launchers_refuse_cpu_tensors():
    """A launcher takes CUDA tensors only: it never falls back."""
    x = torch.zeros((1, 8, 8, 4))
    with pytest.raises(ValueError):
        kernels.launch_conv5x3(x, torch.zeros((5, 3, 4, 4)), 1)
    with pytest.raises(ValueError):
        kernels.launch_fused_stage(x, torch.ones((1, 4)), torch.ones((1, 4)),
                                   torch.zeros((5, 3, 4, 4)), 1)
    with pytest.raises(ValueError):
        kernels.launch_filter_fit(torch.zeros((3, 5)), torch.zeros(5),
                                  torch.zeros((2, 1)), BlindConfig())
    with pytest.raises(ValueError):
        kernels.launch_fused_stage_bwd(
            x, torch.zeros((2, 1, 4)), x, x, x, torch.ones((1, 4)),
            torch.ones((1, 4)), torch.zeros((5, 3, 4, 4)), 1)
