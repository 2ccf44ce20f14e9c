"""K1's narrow routes and K2's backward engine: what the CPU can check.

The kernels themselves (``csrc/conv5x3_narrow.cuh``,
``csrc/stage_mma_sm90.cuh``) run only on the card, where ``chip_smoke.py``
holds them to their plain versions.  Here:

  * the route functions (``kernels.conv5x3_route``,
    ``kernels.stage_bwd_route``) at every flagship shape, at batch 1 and 4,
    and at the edge shapes;
  * the cuts (``conv5x3_plan``, ``stage_bwd_plan``), walked as the kernels
    walk them, so that every (position, tap, channel) term is summed
    exactly once and every output written once;
  * the engine's weight packing (``stage_bwd_weights``) against
    ``tap_major(_flip_io(w))``, the layout the kBwd tile reads;
  * the engine's product by 1/sqrt2 in place of the division, for every
    bf16 input;
  * the plain versions the card is held to, against the JAX package:
    ``conv_ref`` at C = 2 -> N and N -> 2 against ``conv_xla``, and
    ``dil_stage_bwd_ref`` at batch 4 against ``jax.vjp`` of
    ``_dil_stage_ref``.

Tolerances: fp32 at 2e-4 (the JAX package's own bar between its Pallas
kernel and XLA); bf16 as a relative L2 error of 2e-2 (both round every
intermediate to bf16, XLA may keep excess precision inside fused chains).
"""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from babe_tpu.ops import conv_kernels as jck
from babe_tpu_torch import kernels
from babe_tpu_torch.ops import conv_kernels as tck

FP32_TOL = 2e-4
BF16_L2 = 2e-2
BF, F32 = torch.bfloat16, torch.float32

# the flagship network (Ns, num_dils) and its top CQT length at 184184
# samples (7 octaves x 64 bins at 22.05 kHz)
NS, NUM_DILS = (64, 96, 96, 128, 128, 256, 256), (2, 3, 4, 5, 6, 7, 7)
MTOP = 2048
K2_SHAPES, K1_SHAPES = chip_smoke.flagship_shapes(
    types.SimpleNamespace(M=[MTOP]), NS, NUM_DILS)


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


def _l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


# ------------------------------------------------------------------ routes


def test_flagship_shapes_are_the_networks():
    """75 stages per evaluation over 49 distinct shapes, 7 pyramid convs
    and 7 transposes (a guard on the shape lists the route tests use)."""
    assert sum(K2_SHAPES.values()) == 75 and len(K2_SHAPES) == 49
    roles = [k[5] for k, n in K1_SHAPES.items() if n]
    assert roles.count("pyramid fwd") == 7 and roles.count("pyramid dx") == 7


@pytest.mark.parametrize("B", [1, 4])
def test_k1_routes_at_the_flagship_shapes(B):
    """bf16: every pyramid conv (C = 2) takes narrow in, every transpose
    (N = 2) narrow out, the square stage shapes the tiles; fp32 the
    tiles.  The plan of each narrow call fits the card."""
    for (F, T, C, N, d, role), _ in K1_SHAPES.items():
        want = {"pyramid fwd": kernels.K1_NARROW_IN,
                "pyramid dx": kernels.K1_NARROW_OUT,
                "stage shape": kernels.K1_TILE}[role]
        assert kernels.conv5x3_route(BF, C, N) == want, (F, T, C, N, role)
        assert kernels.conv5x3_route(F32, C, N) == kernels.K1_TILE
        plan = kernels.conv5x3_plan(BF, B, F, T, C, N, d)
        assert plan.route == want and plan.smem <= kernels.MAX_SMEM


@pytest.mark.parametrize("C,N,want", [
    (3, 64, kernels.K1_NARROW_IN), (1, 1, kernels.K1_NARROW_IN),
    (8, 256, kernels.K1_NARROW_IN), (8, 264, kernels.K1_TILE),
    (64, 1, kernels.K1_NARROW_OUT), (256, 8, kernels.K1_NARROW_OUT),
    (100, 2, kernels.K1_TILE), (64, 9, kernels.K1_TILE),
    (16, 16, kernels.K1_TILE)])
def test_k1_routes_at_the_edges(C, N, want):
    assert kernels.conv5x3_route(BF, C, N) == want
    assert kernels.conv5x3_route(F32, C, N) == kernels.K1_TILE


@pytest.mark.parametrize("B", [1, 4])
def test_stage_bwd_takes_the_engine_at_every_flagship_stage(B):
    for (F, T, C, d) in K2_SHAPES:
        assert kernels.stage_bwd_route(BF, B, F, T, C, d) == (
            kernels.STAGE_ENGINE), (F, T, C, d)
        assert kernels.stage_bwd_route(F32, B, F, T, C, d) == (
            kernels.STAGE_TILE)
        plan = kernels.stage_bwd_plan(BF, B, F, T, C, d)
        assert plan.smem <= kernels.MAX_SMEM
        assert plan.ring_bytes >= kernels.STAGE_RING * plan.stage_bytes


@pytest.mark.parametrize("B,F,T,C,d,want", [
    (1, 48, 20, 64, 1, kernels.STAGE_ENGINE),   # ragged T
    (1, 64, 70, 128, 4, kernels.STAGE_ENGINE),
    (1, 64, 16, 96, 2, kernels.STAGE_ENGINE),   # shortest row it takes
    (1, 64, 8, 64, 2, kernels.STAGE_TILE),      # T < 16
    (1, 64, 40, 100, 2, kernels.STAGE_TILE),    # C not a multiple of 32
    (1, 64, 40, 32, 2, kernels.STAGE_TILE),     # C under 64
    (1, 64, 40, 288, 2, kernels.STAGE_TILE),    # C over 256
])
def test_stage_bwd_routes_at_the_edges(B, F, T, C, d, want):
    assert kernels.stage_bwd_route(BF, B, F, T, C, d) == want
    assert kernels.stage_bwd_plan(BF, B, F, T, C, d).route == want


# ------------------------------------------------------------------- cuts


def _stage_terms_once(plan):
    """Walk the engine's cut as the kernel does: block (gx, gy, z), z = b *
    splits + j owning channel tile j, its 128 positions (warpgroup q //
    64), ring stages it = (chunk, kf), taps kt.  Count each (b, f, t, kf,
    kt, chunk) term whose source position lies inside the image, once per
    channel tile, and check each position's window cell lies in the staged
    TF x (TT+2) window."""
    B, F, T, C, d, S = plan.B, plan.F, plan.T, plan.C, plan.d, plan.splits
    nch = C // kernels.STAGE_KC
    assert plan.gz == B * S and C % S == 0
    cnt = np.zeros((B, F, T, 5, 3, nch, S), np.int32)
    out = np.zeros((B, F, T, S), np.int32)
    q = np.arange(kernels.STAGE_POS)
    fr, col = q >> plan.tt_log2, q & (plan.TT - 1)
    assert (fr < plan.TF).all() and plan.TT * plan.TF == kernels.STAGE_POS
    # a warpgroup's 64 positions span TF / 2 rows of F when T < 64
    assert len(set(fr[:64])) == max(1, plan.TF // 2)
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


@pytest.mark.parametrize("B,F,T,C,d", [
    (1, 448, 32, 256, 64),   # the deepest stage: 4 rows, 2 per warpgroup
    (1, 384, 64, 128, 64),   # one row per warpgroup, rows outside F
    (2, 48, 20, 64, 1),      # ragged T at batch 2
    (1, 16, 70, 96, 4),      # ragged T over one 128-wide row
    (1, 40, 16, 64, 2),      # 8 rows of 16
])
def test_stage_plan_sums_every_term_exactly_once(B, F, T, C, d):
    plan = kernels.stage_bwd_plan(BF, B, F, T, C, d)
    assert plan.route == kernels.STAGE_ENGINE
    assert plan.n_it == 5 * C // kernels.STAGE_KC
    cnt, out = _stage_terms_once(plan)
    assert (out == 1).all()
    want = _inside(B, F, T, d)[..., None, None]
    assert (cnt == want).all()


def _k1_cover(plan):
    """How often each output position is written by the narrow cut."""
    out = np.zeros((plan.B, plan.F, plan.T), np.int32)
    q = np.arange(kernels.K1_POS)
    for b in range(plan.gz):
        for by in range(plan.gy):
            for bx in range(plan.gx):
                f = by * plan.TF + (q >> plan.tt_log2)
                t = bx * plan.TT + (q & (plan.TT - 1))
                live = (f < plan.F) & (t < plan.T)
                np.add.at(out, (b, f[live], t[live]), 1)
    return out


@pytest.mark.parametrize("B,F,T,C,N,d", [
    (1, 64, 1024, 2, 64, 1), (1, 448, 32, 2, 256, 1), (2, 48, 20, 3, 96, 4),
    (1, 24, 5, 8, 256, 1), (1, 7, 3, 1, 1, 2)])
def test_k1_narrow_in_cut(B, F, T, C, N, d):
    """Every output once; the im2col's columns k = tap*C + c cover the 15
    taps x C channels once, padded with zeros to whole k-steps; the
    channel groups cover N."""
    plan = kernels.conv5x3_plan(BF, B, F, T, C, N, d)
    assert plan.route == kernels.K1_NARROW_IN
    assert (_k1_cover(plan) == 1).all()
    k16 = plan.kp - 8
    assert k16 % 16 == 0 and 15 * C <= k16 < 15 * C + 16
    taps = [(k // C, k % C) for k in range(15 * C)]
    assert len(set(taps)) == 15 * C and max(t for t, _ in taps) == 14
    assert plan.ng * 32 >= N > (plan.ng - 1) * 32
    assert plan.op == plan.ng * 32 + 8 and plan.smem <= kernels.MAX_SMEM


@pytest.mark.parametrize("B,F,T,C,N,d", [
    (1, 64, 1024, 64, 2, 1), (1, 448, 32, 256, 2, 1), (2, 48, 20, 96, 2, 4),
    (1, 64, 70, 64, 1, 1), (1, 24, 5, 256, 8, 1), (1, 9, 3, 16, 2, 2)])
def test_k1_narrow_out_cut(B, F, T, C, N, d):
    """Every output once; the 16-channel chunks cover C once; every
    position's five kernel rows and three taps lie in the staged window
    of 5 * TF rows x TT + 2 columns, which the block's threads cover."""
    plan = kernels.conv5x3_plan(BF, B, F, T, C, N, d)
    assert plan.route == kernels.K1_NARROW_OUT
    assert (_k1_cover(plan) == 1).all()
    assert plan.nch * 16 >= C > (plan.nch - 1) * 16
    q = np.arange(kernels.K1_POS)
    rows = (q >> plan.tt_log2)[:, None] * 5 + np.arange(5)[None]
    cols = (q & (plan.TT - 1))[:, None] + np.arange(3)[None]
    assert rows.max() < 5 * plan.TF and cols.max() < plan.TT + 2
    assert plan.win_px == 5 * plan.TF * (plan.TT + 2)
    assert 2 * plan.win_px <= kernels.K1_OUT_UNITS * 256
    assert plan.smem == kernels.K1_RING * plan.stage_bytes <= (
        kernels.MAX_SMEM)


# ------------------------------------------------------------ engine parts


@pytest.mark.parametrize("C", [64, 96])
def test_stage_bwd_weights_are_the_flipped_transpose(rng, C):
    """The engine at kernel row kf and tap kt reads pack[4-kf, :, 2-kt]:
    its B[k][n] must be the kBwd tile's tap_major(_flip_io(w))[kf*3+kt,
    n, k], with n = 8g + r and k = 16 chunk + 8h + e."""
    w = _t(rng.standard_normal((5, 3, C, C)))
    pack = kernels.stage_bwd_weights(w)
    assert pack.shape == (5, C // 16, 3, C // 8, 2, 8, 8)
    assert pack.is_contiguous()
    tm = kernels.tap_major(tck._flip_io(w))
    for kf in range(5):
        for kt in range(3):
            blk = pack[4 - kf, :, 2 - kt]          # (chunk, g, h, r, e)
            b = blk.permute(1, 3, 0, 2, 4).reshape(C, C)  # [n][k]
            assert torch.equal(b, tm[kf * 3 + kt])


def test_inverse_sqrt2_product_equals_the_division_for_every_bf16():
    """g_pre = round(u / sqrt2) with u and sqrt2 in bf16; the engine
    multiplies by its kInvSq2, the fp32 reciprocal of bf16(sqrt2).  Both
    round to the same bf16 for every finite bf16 u."""
    src = open(os.path.join(kernels.CSRC, "stage_mma_sm90.cuh")).read()
    inv = float(re.search(r"kInvSq2 = ([0-9.]+)f;", src).group(1))
    sq2 = torch.tensor(2.0 ** 0.5, dtype=BF).float()
    assert np.float32(inv) == np.float32(1.0 / np.float64(sq2.item()))
    u = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(BF).float()
    u = u[torch.isfinite(u)]
    a, b = (u / sq2).to(BF), (u * torch.tensor(inv)).to(BF)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# --------------------------------------------------- plain versions vs JAX


@pytest.mark.parametrize("C,N,d", [(2, 64, 1), (2, 96, 2), (64, 2, 1),
                                   (96, 2, 4), (3, 16, 1), (16, 1, 2)])
def test_conv_ref_narrow_sides_match_xla(rng, C, N, d):
    """K1's plain version at the narrow routes' shapes, fp32 and bf16."""
    x = rng.standard_normal((2, 16, 20, C)).astype(np.float32)
    w = (rng.standard_normal((5, 3, C, N)) / np.sqrt(15 * C)).astype(
        np.float32)
    out = tck.conv_ref(_t(x), _t(w), d).numpy()
    ref = np.asarray(jck.conv_xla(_j(x), _j(w), (d, 1)))
    np.testing.assert_allclose(out, ref, rtol=FP32_TOL, atol=FP32_TOL)
    outb = tck.conv_ref(_t(x, BF), _t(w, BF), d)
    refb = jck.conv_xla(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16), (d, 1))
    assert outb.dtype == BF
    assert _l2(outb.float().numpy(), refb.astype(jnp.float32)) < BF16_L2


def _jax_stage_vjp(x, w, a, s, gy, gm, d, dtype):
    """jax.vjp of _dil_stage_ref in the JAX chained layout (2d rows of F
    padding, T padded to 8 plus 16, channels unpadded) w.r.t. x, a, s."""
    B, F, T, C = x.shape
    dm, T8 = d, -(-T // 8) * 8

    def pad(v):
        vp = np.zeros((B, F + 4 * dm, T8 + 16, C), np.float32)
        vp[:, 2 * dm:2 * dm + F, 8:8 + T] = v
        return _j(vp, dtype)

    xp = pad(x)
    prev = jnp.zeros_like(xp)
    static = (dm, d, F, T, C, C)
    _, pull = jax.vjp(lambda xx, aa, ss: jck._dil_stage_ref(
        xx, prev, _j(w, dtype), aa, ss, static), xp, _j(a), _j(s))
    rdx, rda, rds = pull((pad(gy), _j(gm)))
    rdx = np.asarray(rdx.astype(jnp.float32))[:, 2 * dm:2 * dm + F, 8:8 + T]
    return rdx, np.asarray(rda), np.asarray(rds)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dil_stage_bwd_ref_at_batch_4_matches_jax_vjp(rng, dtype):
    """K2's backward's plain version (what the engine is held to on the
    card) at batch 4, ragged T and an opened gate, against the JAX
    kernel's own backward: dx, da and ds."""
    B, F, T, C, d = 4, 12, 20, 16, 2
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((5, 3, C, C))).astype(np.float32)
    a = (0.5 + rng.random((B, C))).astype(np.float32)
    s = rng.standard_normal((B, C)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gm = (rng.standard_normal((2, B, C)) / (F * T)).astype(np.float32)
    dt = getattr(torch, dtype)
    xt, wt = _t(x, dt), _t(w, dt)
    y, _, c = tck._dil_stage_parts(xt, _t(a), _t(s), wt, d)
    dx, da, ds = tck.dil_stage_bwd_ref(xt, _t(a), _t(s), wt, y, c,
                                       _t(gy, dt), _t(gm), d)
    rdx, rda, rds = _jax_stage_vjp(
        x, w, a, s, gy, gm, d,
        jnp.float32 if dtype == "float32" else jnp.bfloat16)
    if dtype == "float32":
        for out, ref in ((dx, rdx), (da, rda), (ds, rds)):
            np.testing.assert_allclose(out.numpy(), ref, rtol=FP32_TOL,
                                       atol=FP32_TOL)
    else:
        assert dx.dtype == BF
        for out, ref in ((dx, rdx), (da, rda), (ds, rds)):
            assert _l2(out.float().numpy(), ref) < BF16_L2
