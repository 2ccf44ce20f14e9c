"""The weight gradients of the port's conv kernels against the JAX package:
``conv_dw_ref`` (the plain version of the ``conv_dw`` kernel, the dw of K1
and K4) against ``jax.vjp`` of ``conv_xla`` with respect to w, and
``dil_stage_dw_ref`` (the plain version of ``fused_stage_dw``, K2's dw)
against ``jax.vjp`` of ``_dil_stage_ref`` with respect to its kernel, the
JAX kernels' own backward; then the same through the autograd Functions
(``conv5x3_dilated``, ``fused_stage``), which no longer refuse a weight
that requires grad.  K3's weight gradient is still not ported and raises.

Every stage check opens the gate: s is O(1) here (the EDM init's 1e-7 gates
would make dw ~0 and any dw pass).  Tolerances: fp32 at 2e-4 relative to the
largest value (summation order); bf16 as a relative L2 error of 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.ops import conv_kernels as jck
from babe_tpu_torch import kernels
from babe_tpu_torch.ops import conv_kernels as tck

TOL = 2e-4
BF16_L2 = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers (these shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def _l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _jax_dw(x, w, g, dil, dtype=jnp.float32):
    _, pull = jax.vjp(lambda ww: jck.conv_xla(_j(x, dtype), ww, dil),
                      _j(w, dtype))
    return pull(_j(g, dtype))[0]


@pytest.mark.parametrize("kf,kt,dil,shape", [
    (5, 3, (1, 1), (2, 16, 20, 8, 8)),    # a stage conv
    (5, 3, (4, 1), (1, 24, 13, 6, 10)),
    (5, 3, (1, 1), (2, 12, 9, 2, 8)),     # a pyramid conv (C = 2)
    (3, 3, (2, 2), (1, 10, 15, 5, 4)),    # K4 shapes
    (7, 5, (1, 1), (1, 14, 11, 3, 6)),
])
def test_conv_dw_ref_matches_jax_vjp(rng, kf, kt, dil, shape):
    B, F, T, C, N = shape
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((kf, kt, C, N))).astype(np.float32)
    g = rng.standard_normal((B, F, T, N)).astype(np.float32)
    dw = tck.conv_dw_ref(_t(x), _t(g), (kf, kt), dil)
    assert dw.dtype == torch.float32 and tuple(dw.shape) == (kf, kt, C, N)
    _close(dw.numpy(), _jax_dw(x, w, g, dil))


def test_conv_dw_ref_bf16_matches_jax_vjp(rng):
    x = rng.standard_normal((1, 16, 24, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((5, 3, 16, 8))).astype(np.float32)
    g = rng.standard_normal((1, 16, 24, 8)).astype(np.float32)
    dw = tck.conv_dw_ref(_t(x, torch.bfloat16), _t(g, torch.bfloat16), (5, 3),
                         (2, 1)).to(torch.bfloat16)
    ref = _jax_dw(x, w, g, (2, 1), jnp.bfloat16)
    assert _l2(dw.float().numpy(), ref.astype(jnp.float32)) < BF16_L2


@pytest.mark.parametrize("d", [1, 2])
def test_conv5x3_weight_grad_through_autograd(rng, d):
    """K1's Function returns dw (in w's dtype, carried to the fp32 param by
    the cast); dx is formed only when the input needs it (the first
    pyramid conv's input does not)."""
    x = rng.standard_normal((2, 16, 11, 6)).astype(np.float32)
    w = (0.2 * rng.standard_normal((5, 3, 6, 10))).astype(np.float32)
    g = rng.standard_normal((2, 16, 11, 10)).astype(np.float32)
    wt = _t(w).requires_grad_(True)
    xt = _t(x)
    tck.conv5x3_dilated(xt, wt, d).backward(_t(g))
    assert xt.grad is None
    _close(wt.grad.numpy(), _jax_dw(x, w, g, (d, 1)))


def _stage_case(rng, B=2, F=16, T=12, C=8):
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((5, 3, C, C))).astype(np.float32)
    a = (0.5 + rng.random((B, C))).astype(np.float32)
    s = rng.standard_normal((B, C)).astype(np.float32)  # an opened gate
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gm = rng.standard_normal((2, B, C)).astype(np.float32)
    return x, w, a, s, gy, gm


def _jax_stage_dw(x, w, a, s, gy, gm, d, dtype=jnp.float32):
    """jax.vjp of _dil_stage_ref in its kernel, on the unpadded layout
    (dm = d, Cp = C: no margins beyond the chain's own)."""
    B, F, T, C = x.shape
    dm = d
    T8 = -(-T // 8) * 8
    xp = np.zeros((B, F + 4 * dm, T8 + 16, C), np.float32)
    xp[:, 2 * dm:2 * dm + F, 8:8 + T] = x
    gp = np.zeros_like(xp)
    gp[:, 2 * dm:2 * dm + F, 8:8 + T] = gy
    xpj = _j(xp, dtype)
    static = (dm, d, F, T, C, C)
    _, pull = jax.vjp(lambda ww: jck._dil_stage_ref(
        xpj, None, ww, _j(a), _j(s), static), _j(w, dtype))
    return pull((_j(gp, dtype), _j(gm)))[0]


@pytest.mark.parametrize("d", [1, 4])
def test_dil_stage_dw_ref_matches_jax_vjp(rng, d):
    x, w, a, s, gy, gm = _stage_case(rng)
    y, _ = tck.dil_stage_ref(_t(x), _t(a), _t(s), _t(w), d)
    dw = tck.dil_stage_dw_ref(_t(x), _t(a), _t(s), y, _t(gy), _t(gm), d)
    _close(dw.numpy(), _jax_stage_dw(x, w, a, s, gy, gm, d))


def test_dil_stage_dw_ref_bf16_matches_jax_vjp(rng):
    x, w, a, s, gy, gm = _stage_case(rng, B=1, F=16, T=24, C=16)
    bf = torch.bfloat16
    y, _ = tck.dil_stage_ref(_t(x, bf), _t(a), _t(s), _t(w, bf), 2)
    dw = tck.dil_stage_dw_ref(_t(x, bf), _t(a), _t(s), y, _t(gy, bf), _t(gm),
                              2).to(bf)
    ref = _jax_stage_dw(x, w, a, s, gy, gm, 2, jnp.bfloat16)
    assert _l2(dw.float().numpy(), ref.astype(jnp.float32)) < BF16_L2


def test_fused_stage_weight_grad_through_autograd(rng):
    """K2's Function returns dw beside dx, da and ds."""
    x, w, a, s, gy, gm = _stage_case(rng)
    wt = _t(w).requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    y, mom = tck.fused_stage(xt, _t(a), _t(s), wt, 2)
    torch.autograd.backward((y, mom), (_t(gy), _t(gm)))
    _close(wt.grad.numpy(), _jax_stage_dw(x, w, a, s, gy, gm, 2))
    assert xt.grad is not None


def test_int8_stage_weight_grad_still_raises(rng):
    """K3's weight gradient waits for quantization-aware training."""
    x, w, a, s, _, _ = _stage_case(rng, C=8)
    qw, sw = tck.quant_weight_per_cout(_t(w))
    with pytest.raises(NotImplementedError):
        tck.fused_stage_int8(_t(x), _t(a), _t(s), torch.ones(2),
                             _t(w).requires_grad_(True),
                             kernels.tap_major(qw), sw, 1)
