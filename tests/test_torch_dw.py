"""The weight gradients of the port's conv kernels against the JAX package:
``conv_dw_ref`` (the plain version of the ``conv_dw`` kernel, the dw of K1
and K4) against ``jax.vjp`` of ``conv_xla`` with respect to w, and
``dil_stage_dw_ref`` (the plain version of ``fused_stage_dw``, K2's dw)
against ``jax.vjp`` of ``_dil_stage_ref`` with respect to its kernel, the
JAX kernels' own backward; then the same through the autograd Functions
(``conv5x3_dilated``, ``fused_stage``), which no longer refuse a weight
that requires grad.  K3's weight gradient is still not ported and raises.
Then the weight-gradient kernels' own parts that the CPU can reach: the
operand pass's plain version (``stage_dw_operands_ref``) and the cut that
``kernels.dw_plan`` hands the GEMM, walked as the kernel walks it.

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
    """K3's weight gradient, which quantization-aware training takes, is
    the exact stage's (the JAX ``_fused_i8_bwd``: the vjp of
    ``_dil_stage_ref``): it no longer raises."""
    x, w, a, s, gy, gm = _stage_case(rng, C=8)
    qw, sw = tck.quant_weight_per_cout(_t(w))
    wt = _t(w).requires_grad_(True)
    gm3 = np.concatenate([gm, rng.standard_normal((1, *gm.shape[1:]))])
    bound = np.abs(x * a[:, None, None, :]).max(axis=(1, 2, 3)) * 1.05
    y, mom = tck.fused_stage_int8(_t(x), _t(a), _t(s), _t(bound), wt,
                                  kernels.tap_major(qw), sw, 1)
    torch.autograd.backward((y, mom), (_t(gy), _t(gm3)))
    _close(wt.grad.numpy(), _jax_stage_dw(x, w, a, s, gy, gm, 1))


# ------------------------------------------- the kernels' operands and cut


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_dw_operands_then_conv_dw_equals_stage_dw(rng, dtype):
    """``fused_stage_dw`` is the operand pass, then ``conv_dw``'s GEMM: the
    two plain versions in a row equal ``dil_stage_dw_ref`` exactly, and
    match jax.vjp of ``_dil_stage_ref`` at the tolerances above."""
    x, w, a, s, gy, gm = _stage_case(rng, B=1, F=16, T=24, C=16)
    dt = getattr(torch, dtype)
    xt, gyt = _t(x, dt), _t(gy, dt)
    y, _ = tck.dil_stage_ref(xt, _t(a), _t(s), _t(w, dt), 2)
    h, gc = tck.stage_dw_operands_ref(xt, _t(a), _t(s), y, gyt, _t(gm))
    assert h.dtype == gc.dtype == dt and h.shape == gc.shape == xt.shape
    dw = tck.conv_dw_ref(h, gc, (5, 3), (2, 1))
    assert torch.equal(dw, tck.dil_stage_dw_ref(xt, _t(a), _t(s), y, gyt,
                                                _t(gm), 2))
    ref = _jax_stage_dw(x, w, a, s, gy, gm, 2,
                        jnp.float32 if dtype == "float32" else jnp.bfloat16)
    if dtype == "float32":
        _close(dw.numpy(), ref)
    else:
        assert _l2(dw.to(dt).float().numpy(), ref.astype(jnp.float32)) < (
            BF16_L2)


def _covered_tiles(plan, table):
    """Emulate the tensor-core and simt routes' walk over the plan (the
    kernel's reading of DwPlan): how often each term (G position b, f, t;
    tap i, j; input-channel tile; output tile) is summed.  Asserts that no
    chunk reads an X row outside [0, F)."""
    B, F, T, KF, KT = plan.B, plan.F, plan.T, plan.KF, plan.KT
    PF, PT = (KF - 1) // 2, (KT - 1) // 2
    seg = table[:KF + 1]
    chunks = table[kernels.DW_HEADER:].reshape(-1, 4)
    assert len(chunks) == seg[KF]
    cnt = np.zeros((B, F, T, KF, KT, plan.c_tiles, plan.n_tiles), np.int32)
    p = np.arange(plan.pp)
    for tile in range(plan.tiles):
        i, j0, c0, n0 = kernels.dw_tile(plan, tile)
        for s in range(plan.splits):
            for k in range(seg[i] + s, seg[i + 1], plan.splits):
                b, f0, nfk, t0 = chunks[k]
                assert 1 <= nfk <= plan.nf
                r, t = p // plan.tl, t0 + p % plan.tl
                live = (r < nfk) & (t < T)
                f, t = f0 + r[live], t[live]
                fx = f + (i - PF) * plan.df
                assert ((fx >= 0) & (fx < F)).all()
                for j in range(j0, min(j0 + plan.taps, KT)):
                    tx = t + (j - PT) * plan.dt
                    ok = (tx >= 0) & (tx < T)
                    np.add.at(cnt, (b, f[ok], t[ok], i, j, c0 // plan.bm,
                                    n0 // plan.bn), 1)
    return cnt


def _covered_fold(plan, table):
    """Emulate the fold route: how often each term (G position b, f, t;
    tap i, j; input channel c; output channel n) is summed, read from where
    the kernel adds it into dW."""
    B, F, T, C, N = plan.B, plan.F, plan.T, plan.C, plan.N
    rows = table.reshape(-1, 4)
    cnt = np.zeros((B, F, T, plan.KF * plan.KT, C, N), np.int32)
    stride = 1 if plan.narrow_x else N
    for tile in range(plan.tiles):
        grp, wt = tile % plan.groups, tile // plan.groups
        ws = np.arange(wt * kernels.DW_FOLD_WIDE,
                       min(plan.wide, (wt + 1) * kernels.DW_FOLD_WIDE))
        for s in range(plan.splits):
            for k in range(s, plan.n_chunks, plan.splits):
                q = np.arange(k * kernels.DW_FOLD_CHUNK,
                              min(B * F * T, (k + 1) * kernels.DW_FOLD_CHUNK))
                b, f, t = np.unravel_index(q, (B, F, T))
                for sf, st, ch, out in rows[grp * kernels.DW_FOLD_ROWS:
                                            (grp + 1) * kernels.DW_FOLD_ROWS]:
                    if ch < 0:
                        continue
                    fn, tn = f + sf, t + st
                    ok = (fn >= 0) & (fn < F) & (tn >= 0) & (tn < T)
                    ij, rem = np.divmod(out + ws * stride, C * N)
                    c, n = np.divmod(rem, N)
                    # the G position: the wide side's when G is wide, else
                    # the shifted narrow read's
                    gb, gf, gt = ((b[ok], f[ok], t[ok]) if plan.narrow_x
                                  else (b[ok], fn[ok], tn[ok]))
                    np.add.at(cnt, (gb[:, None], gf[:, None], gt[:, None],
                                    ij[None], c[None], n[None]), 1)
    return cnt


def _terms(plan):
    """1 where a (G position, i, j) term has its X position inside the
    image, else 0: (B, F, T, KF, KT)."""
    PF, PT = (plan.KF - 1) // 2, (plan.KT - 1) // 2
    f = np.arange(plan.F)[:, None, None, None]
    t = np.arange(plan.T)[None, :, None, None]
    i = np.arange(plan.KF)[None, None, :, None]
    j = np.arange(plan.KT)[None, None, None, :]
    fx, tx = f + (i - PF) * plan.df, t + (j - PT) * plan.dt
    inside = (fx >= 0) & (fx < plan.F) & (tx >= 0) & (tx < plan.T)
    return np.broadcast_to(inside, (plan.B,) + inside.shape).astype(np.int32)


@pytest.mark.parametrize("B,F,T,C,N,kshape,dil,dtype,route", [
    (2, 12, 32, 64, 64, (5, 3), (2, 1), "bfloat16", kernels.DW_MMA),  # T=32
    (1, 10, 20, 32, 48, (5, 3), (1, 1), "bfloat16", kernels.DW_MMA),  # ragged
    (1, 8, 80, 96, 96, (5, 3), (4, 1), "bfloat16", kernels.DW_MMA),   # C=96
    (1, 384, 8, 256, 256, (5, 3), (64, 1), "bfloat16", kernels.DW_MMA),
    (1, 10, 70, 16, 40, (7, 5), (1, 2), "bfloat16", kernels.DW_MMA),  # K4
    (1, 10, 20, 24, 40, (3, 7), (2, 2), "float32", kernels.DW_SIMT),
    (2, 8, 40, 2, 64, (5, 3), (1, 1), "bfloat16", kernels.DW_FOLD),   # C=2
    (2, 8, 40, 64, 2, (5, 3), (1, 1), "bfloat16", kernels.DW_FOLD),   # N=2
    (1, 6, 9, 8, 8, (3, 5), (2, 2), "float32", kernels.DW_FOLD),
])
def test_dw_plan_sums_every_term_exactly_once(B, F, T, C, N, kshape, dil,
                                              dtype, route):
    """The weight-gradient kernel's cut (``kernels.dw_plan``), walked as the
    kernel walks it, sums every term whose X position lies inside the image
    exactly once and no other: chunks that span f rows (T = 32), a ragged T
    (20, 70, 80), the 96-channel tile, the folded narrow side (C = 2,
    N = 2), and at d = 64 on F = 384 the rows of i = 0, 1, 3, 4 that fall
    outside [0, F), which are skipped rather than multiplied as zeros."""
    assert kernels.dw_route(getattr(torch, dtype), C, N) == route
    plan, table = kernels.dw_plan(B, F, T, C, N, kshape, dil, route)
    assert plan.meta()[0] == route and table.dtype == np.int32
    terms = _terms(plan)
    if route == kernels.DW_FOLD:
        cnt = _covered_fold(plan, table)
        want = terms.reshape(B, F, T, -1)[..., None, None]
        assert (cnt == want).all()
        assert (table.reshape(-1, 4)[:, 2] >= 0).sum() == (
            kshape[0] * kshape[1] * min(C, N))
        return
    assert plan.c_tiles * plan.bm >= C > (plan.c_tiles - 1) * plan.bm
    assert plan.n_tiles * plan.bn >= N > (plan.n_tiles - 1) * plan.bn
    assert plan.pp % 16 == 0 and plan.smem <= kernels.DW_MAX_SMEM
    if route == kernels.DW_MMA:
        assert C % plan.bm == 0 or plan.bm == 32
        assert plan.threads == plan.bm * plan.bn // 32 <= 32 * 9
    cnt = _covered_tiles(plan, table)
    assert (cnt == terms[..., None, None]).all()
    if dil[0] == 64:  # skipped rows: kernel row i's chunks cover F - |i-2|*64
        seg = table[:plan.KF + 1]
        rows = [int(table[kernels.DW_HEADER:].reshape(-1, 4)[
            seg[i]:seg[i + 1], 2].sum()) for i in range(plan.KF)]
        assert rows == [F - abs(i - 2) * 64 for i in range(plan.KF)]
