"""K2's forward and K3 on the stage engine: what the CPU can check.

The engine (``csrc/stage_mma_sm90.cuh``) and its operand passes
(``csrc/fused_stage.cu``, ``csrc/fused_stage_int8.cu``) run only on the
card, where ``chip_smoke.py`` holds them to their plain versions.  Here:

  * the routes (``kernels.stage_fwd_route``, ``kernels.stage_int8_route``)
    at every flagship stage, at batch 1 and 4, and at the edge shapes
    ``chip_smoke.py`` checks on the card;
  * the cuts (``kernels.stage_plan`` in the forward and int8 modes),
    walked as the kernel walks them, so that every (position, tap,
    channel) term is summed exactly once and every output written once;
  * the weight packs: the forward's (``stage_fwd_weights``) against
    ``tap_major(w)``, the int8 one (``stage_int8_weights``) against the
    tap-major ``qwt`` the tile reads;
  * the plain versions of the operand passes against the JAX package: h
    (``stage_gelu_ref``) against ``_gelu_exact(x*a)`` in fp32 and bf16, q
    (``stage_quant_ref``) against ``_quant_i8(_gelu_cheap_impl(...))``, bit
    for bit;
  * the plain pieces composed as the engine composes them (operand ->
    ``conv_ref`` -> the epilogue with the engine's reciprocal product)
    against the JAX ``_dil_stage_ref`` in bf16: bit for bit wherever the
    two convs round alike, and the epilogue bit for bit on JAX's own conv.
"""

import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from babe_tpu.ops import conv_kernels as jck
from babe_tpu_torch import kernels
from babe_tpu_torch.ops import conv_kernels as tck

BF, F32 = torch.bfloat16, torch.float32
FWD, I8 = kernels.STAGE_FWD, kernels.STAGE_I8

# the flagship network and its top CQT length at 184184 samples
NS, NUM_DILS = (64, 96, 96, 128, 128, 256, 256), (2, 3, 4, 5, 6, 7, 7)
K2_SHAPES, _ = chip_smoke.flagship_shapes(types.SimpleNamespace(M=[2048]),
                                          NS, NUM_DILS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers (these shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=F32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------------ routes


@pytest.mark.parametrize("B", [1, 4])
def test_k2_takes_the_engine_at_every_flagship_stage(B):
    """bf16: every stage of the flagship network (75 per evaluation, 49
    shapes) takes the engine; fp32 the tile.  Each plan fits the card."""
    assert sum(K2_SHAPES.values()) == 75
    for (F, T, C, d) in K2_SHAPES:
        assert kernels.stage_fwd_route(BF, B, F, T, C, d) == (
            kernels.STAGE_ENGINE), (F, T, C, d)
        assert kernels.stage_fwd_route(F32, B, F, T, C, d) == (
            kernels.STAGE_TILE)
        plan = kernels.stage_plan(FWD, BF, B, F, T, C, d)
        assert plan.mode == FWD and plan.smem <= kernels.MAX_SMEM
        assert plan.splits == (2 if C == 256 else 1)
        NT = C // plan.splits
        assert plan.ring_bytes >= kernels.STAGE_RING * plan.stage_bytes
        assert plan.ring_bytes >= kernels.STAGE_POS * (NT + 8) * 2
        assert kernels.stage_bwd_plan(BF, B, F, T, C, d).splits == (
            plan.splits)


@pytest.mark.parametrize("B", [1, 4])
def test_k3_takes_the_engine_at_every_int8_flagship_stage(B):
    """bf16 x: every stage of at least INT8_MINC channels (68 per
    evaluation) takes the engine, whose fp32 epilogue tile fits the ring;
    fp32 x the tile."""
    int8 = {k: n for k, n in K2_SHAPES.items() if k[2] >= tck.INT8_MINC}
    assert sum(int8.values()) == 68
    for (F, T, C, d) in int8:
        assert kernels.stage_int8_route(BF, B, F, T, C, d) == (
            kernels.STAGE_ENGINE), (F, T, C, d)
        assert kernels.stage_int8_route(F32, B, F, T, C, d) == (
            kernels.STAGE_TILE)
        plan = kernels.stage_plan(I8, BF, B, F, T, C, d)
        assert plan.mode == I8 and plan.smem <= kernels.MAX_SMEM
        assert plan.n_it == 5 * C // 32
        assert plan.splits == (2 if C == 256 else 1)
        NT = C // plan.splits
        assert plan.ring_bytes >= kernels.STAGE_POS * (NT + 4) * 4


def _edge_route(mode, B, F, T, C):
    lo = 96 if mode == I8 else 64
    ok = C % 32 == 0 and lo <= C <= 256 and T >= 16
    return kernels.STAGE_ENGINE if ok else kernels.STAGE_TILE


@pytest.mark.parametrize("edge", chip_smoke.STAGE_FWD_EDGE)
def test_k2_routes_at_the_edges(edge):
    """The edge shapes of ``chip_smoke.py``: ragged T and C = 96 on the
    engine, T = 8 and C = 100 on the tile."""
    B, F, T, C, d = edge
    want = _edge_route(FWD, B, F, T, C)
    assert kernels.stage_fwd_route(BF, B, F, T, C, d) == want
    assert kernels.stage_plan(FWD, BF, B, F, T, C, d).route == want
    assert kernels.stage_fwd_route(F32, B, F, T, C, d) == (
        kernels.STAGE_TILE)


@pytest.mark.parametrize("edge", chip_smoke.K3_EDGE)
def test_k3_routes_at_the_edges(edge):
    B, F, T, C, d = edge
    want = _edge_route(I8, B, F, T, C)
    assert kernels.stage_int8_route(BF, B, F, T, C, d) == want
    assert kernels.stage_plan(I8, BF, B, F, T, C, d).route == want


def test_routes_at_the_channel_bounds():
    """K2's engine starts at 64 channels, K3's at 96 (its int8 stacks'
    floor); both end at 256 and need rows of 16."""
    for C, fwd, i8 in ((32, 0, 0), (64, 1, 0), (96, 1, 1), (100, 0, 0),
                       (256, 1, 1), (288, 0, 0)):
        assert kernels.stage_fwd_route(BF, 1, 64, 40, C, 1) == fwd, C
        assert kernels.stage_int8_route(BF, 1, 64, 40, C, 1) == i8, C
    assert kernels.stage_fwd_route(BF, 1, 64, 15, 64, 1) == 0
    assert kernels.stage_int8_route(BF, 1, 64, 15, 96, 1) == 0


# ------------------------------------------------------------------- cuts


def _engine_terms(plan):
    """Walk an engine cut as the kernel does: block (gx, gy, z), z = b *
    splits + j owning channel tile j, its 128 positions, ring stages it =
    (chunk, kf) of 32 bytes of channels, taps kt.  Count each (b, f, t,
    kf, kt, chunk, j) term whose source lies inside the image and each
    (b, f, t, j) output, and check each position's window cell lies in the
    staged TF x (TT+2) window."""
    B, F, T, C, d, S = plan.B, plan.F, plan.T, plan.C, plan.d, plan.splits
    elem = 1 if plan.mode == I8 else 2
    nch = C * elem // kernels.STAGE_KB
    assert nch * kernels.STAGE_KB == C * elem and plan.n_it == 5 * nch
    assert plan.gz == B * S and (C // S) * S == C
    cnt = np.zeros((B, F, T, 5, 3, nch, S), np.int32)
    out = np.zeros((B, F, T, S), np.int32)
    q = np.arange(kernels.STAGE_POS)
    fr, col = q >> plan.tt_log2, q & (plan.TT - 1)
    assert (fr < plan.TF).all() and plan.TT * plan.TF == kernels.STAGE_POS
    for z in range(plan.gz):
        b, j = divmod(z, S)
        for by in range(plan.gy):
            for bx in range(plan.gx):
                f, t = by * plan.TF + fr, bx * plan.TT + col
                live = (f < F) & (t < T)
                f, t, c0 = f[live], t[live], col[live]
                np.add.at(out, (b, f, t, j), 1)
                for it in range(plan.n_it):
                    chunk, kf = divmod(it, 5)
                    for kt in range(3):
                        assert (c0 + kt < plan.TT + 2).all()
                        fs, ts = f + (kf - 2) * d, t + kt - 1
                        ok = (fs >= 0) & (fs < F) & (ts >= 0) & (ts < T)
                        np.add.at(cnt, (b, f[ok], t[ok], kf, kt, chunk, j),
                                  1)
    return cnt, out


def _inside(B, F, T, d):
    f = np.arange(F)[:, None, None, None]
    t = np.arange(T)[None, :, None, None]
    kf = np.arange(5)[None, None, :, None]
    kt = np.arange(3)[None, None, None, :]
    fs, ts = f + (kf - 2) * d, t + kt - 1
    ins = (fs >= 0) & (fs < F) & (ts >= 0) & (ts < T)
    return np.broadcast_to(ins, (B,) + ins.shape).astype(np.int32)


@pytest.mark.parametrize("mode,B,F,T,C,d", [
    (FWD, 1, 448, 32, 256, 64),   # the deepest stage: 4 rows of 32, two
    (FWD, 2, 48, 20, 64, 1),      # channel tiles; ragged T at batch 2
    (FWD, 1, 16, 70, 96, 4),      # ragged T over one 128-wide row
    (I8, 2, 448, 32, 256, 64),
    (I8, 1, 384, 64, 128, 64),    # rows outside F
    (I8, 2, 48, 20, 96, 1),
    (I8, 1, 40, 16, 96, 2),       # 8 rows of 16
])
def test_engine_plans_sum_every_term_exactly_once(mode, B, F, T, C, d):
    """Every output once (each channel tile of each position); every
    in-image (position, tap, chunk) term once per channel tile: the
    32-byte chunks (16 bf16 or 32 int8 channels) cover C once."""
    plan = kernels.stage_plan(mode, BF, B, F, T, C, d)
    assert plan.splits == (2 if C == 256 else 1)
    assert plan.route == kernels.STAGE_ENGINE
    cnt, out = _engine_terms(plan)
    assert (out == 1).all()
    want = _inside(B, F, T, d)[..., None, None]
    assert (cnt == want).all()


# ------------------------------------------------------------------ packs


@pytest.mark.parametrize("C", [64, 96])
def test_stage_fwd_weights_are_tap_major(rng, C):
    """K2's engine at kernel row kf and tap kt reads pack[kf, :, kt]: its
    B[k][n] must be the tile's tap_major(w)[kf*3+kt, n, k], with n = 8g + r
    and k = 16 chunk + 8h + e."""
    w = _t(rng.standard_normal((5, 3, C, C)))
    pack = kernels.stage_fwd_weights(w)
    assert pack.shape == (5, C // 16, 3, C // 8, 2, 8, 8)
    assert pack.is_contiguous()
    tm = kernels.tap_major(w)
    for kf in range(5):
        for kt in range(3):
            blk = pack[kf, :, kt]                  # (chunk, g, h, r, e)
            b = blk.permute(1, 3, 0, 2, 4).reshape(C, C)  # [n][k]
            assert torch.equal(b, tm[kf * 3 + kt])


@pytest.mark.parametrize("C", [96, 128])
def test_stage_int8_weights_are_qwt(rng, C):
    """K3's engine reads pack[kf, :, kt] as B[k][n] = qwt[kf*3+kt, n, k]
    with n = 8g + r and k = 32 chunk + 16h + e: the per-cout int8 kernel
    the tile reads, 16 int8 per core-matrix row."""
    w = _t(rng.standard_normal((5, 3, C, C)))
    qw, _ = tck.quant_weight_per_cout(w)
    qwt = kernels.tap_major(qw)
    pack = kernels.stage_int8_weights(qwt)
    assert pack.dtype == torch.int8 and pack.is_contiguous()
    assert pack.shape == (5, C // 32, 3, C // 8, 2, 8, 16)
    for kf in range(5):
        for kt in range(3):
            b = pack[kf, :, kt].permute(1, 3, 0, 2, 4).reshape(C, C)
            assert torch.equal(b, qwt[kf * 3 + kt])


# ------------------------------------------------ plain versions vs JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_h_operand_plain_version_matches_jax(rng, dtype):
    """h = gelu(x*a) with x*a rounded to x's dtype first, as K2's
    reference forms it: bit for bit."""
    x = (2.0 * rng.standard_normal((4, 12, 20, 96))).astype(np.float32)
    a = (0.5 + rng.random((4, 96))).astype(np.float32)
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    h = tck.stage_gelu_ref(_t(x, dt), _t(a))
    hj = jck._gelu_exact(_j(x, jdt) * _j(a)[:, None, None, :].astype(jdt))
    assert h.dtype == dt
    np.testing.assert_array_equal(h.float().numpy(), _np(hj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_operand_plain_version_matches_jax(rng, dtype):
    """q = int8(gelu6(float(x)*a) * 127/bound), the JAX int8 stage's
    quantizer: bit for bit, with a bound that some values reach."""
    B, C = 4, 96
    x = (2.0 * rng.standard_normal((B, 12, 20, C))).astype(np.float32)
    a = rng.standard_normal((B, C)).astype(np.float32)
    xd = _t(x, getattr(torch, dtype)).float().numpy()
    bound = (0.8 * np.abs(xd * a[:, None, None, :]).max(axis=(1, 2, 3))
             ).astype(np.float32)
    iv = (np.float32(127.0) / bound).astype(np.float32)
    q = tck.stage_quant_ref(_t(x, getattr(torch, dtype)), _t(a), _t(iv))
    qj = jck._quant_i8(
        jck._gelu_cheap_impl(_j(xd) * _j(a)[:, None, None, :]),
        _j(iv)[:, None, None, None])
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))


def _engine_inv_sqrt2() -> float:
    src = open(os.path.join(kernels.CSRC, "stage_mma_sm90.cuh")).read()
    return float(re.search(r"kInvSq2 = ([0-9.]+)f;", src).group(1))


def _engine_epilogue(x, c, s):
    """The engine's forward epilogue in its rounding order: t1 = round(c *
    round(s)), u = round(x + t1), y = round(u * kInvSq2)."""
    u = x + c * s.to(x.dtype)[:, None, None, :]
    return (u.float() * torch.tensor(_engine_inv_sqrt2())).to(x.dtype)


@pytest.mark.parametrize("B,F,T,C,d", [(1, 16, 20, 64, 2),
                                       (4, 12, 16, 96, 1),
                                       (1, 16, 32, 256, 4)])
def test_plain_pieces_compose_to_the_jax_stage(rng, B, F, T, C, d):
    """bf16: operand -> conv_ref -> the engine's epilogue against the JAX
    ``_dil_stage_ref``.  h bit for bit; the epilogue on JAX's own conv bit
    for bit; the two convs (fp32 sums in another order) round to the same
    bf16 but for under 0.1% of values, each then one bf16 ulp apart (or,
    near zero, where the fp32 sums' own error exceeds the value's spacing,
    within 1e-5 of the largest value), and y is bit for bit wherever they
    round alike."""
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (rng.standard_normal((5, 3, C, C)) / np.sqrt(15 * C)).astype(
        np.float32)
    a = (0.5 + rng.random((B, C))).astype(np.float32)
    s = rng.standard_normal((B, C)).astype(np.float32)
    xt, wt = _t(x, BF), _t(w, BF)
    h = tck.stage_gelu_ref(xt, _t(a))
    c = tck.conv_ref(h, wt, d)
    y = _engine_epilogue(xt, c, _t(s))

    xj, wj = _j(x, jnp.bfloat16), _j(w, jnp.bfloat16)
    hj = jck._gelu_exact(xj * _j(a)[:, None, None, :].astype(jnp.bfloat16))
    cj = jck.conv_xla(hj, wj, (d, 1))
    T8 = -(-T // 8) * 8
    xp = np.zeros((B, F + 4 * d, T8 + 16, C), np.float32)
    xp[:, 2 * d:2 * d + F, 8:8 + T] = x
    yp, _ = jck._dil_stage_ref(_j(xp, jnp.bfloat16), None, wj, _j(a), _j(s),
                               (d, d, F, T, C, C))
    yj = _np(yp)[:, 2 * d:2 * d + F, 8:8 + T]

    np.testing.assert_array_equal(h.float().numpy(), _np(hj))
    ye = _engine_epilogue(xt, _t(_np(cj), BF), _t(s))
    np.testing.assert_array_equal(ye.float().numpy(), yj)
    cn, cjn = c.float().numpy(), _np(cj)
    alike = cn == cjn
    assert (~alike).mean() < 1e-3
    near = np.maximum(np.abs(cjn) * 2.0 ** -7, 1e-5 * np.abs(cjn).max())
    assert (np.abs(cn - cjn)[~alike] <= near[~alike]).all()
    np.testing.assert_array_equal(y.float().numpy()[alike], yj[alike])
