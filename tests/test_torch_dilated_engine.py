"""K4's TMA route and P2 on the stage engine: what the CPU can check.

K4's TMA + wgmma implicit GEMM (``csrc/dilated_conv.cu``) and P2 on the
stage engine's loop (``csrc/probe_int8.cu``) run only on the card, where
``chip_smoke.py`` holds them to their plain versions.  Here:

  * K4's route (``kernels.dilated_conv_route``) at every level shape of the
    TPU kernel's table, at K2's flagship stage shapes, at the small shapes
    and edges ``chip_smoke.py`` checks, and off the TMA route for fp32 and
    for C or N not a multiple of 8;
  * the cuts (``kernels.dilated_conv_plan``, ``kernels.probe_stage_plan``),
    each walked as its kernel walks it, so that every (position, tap,
    channel) term is summed exactly once and every output written once;
  * a numpy mirror of the TMA route: each k-step's A tile assembled from
    the plan's box origins with zero fill applied per dimension (the rows
    past a box left as NaN, the stale bits of shared memory), multiplied
    by the tap-major pack and stored as the epilogue stores, against the
    plain ``conv_ref`` and the JAX ``_conv_ref``;
  * K4's wrapper: the tap-major pack only for the routes that read it, and
    its launches counted by route;
  * P1's and P2's plain versions (``probe_gemm_ref``, ``probe_stage_ref``)
    against the TPU kernels themselves, ``tools/probe_pallas_int8.py``'s
    ``make_gemm`` and ``make_stage`` run through ``pallas_call`` in
    interpret mode.
"""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from babe_tpu.ops.pallas_conv import _conv_ref as jconv_ref
from babe_tpu_torch import kernels
from babe_tpu_torch.ops import pallas_conv as tpc
from babe_tpu_torch.tools import probe_int8

BF16, F32 = torch.bfloat16, torch.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _plan(shape, dtype=BF16):
    B, F, T, C, N, kf, kt, dil = shape
    return kernels.dilated_conv_plan(dtype, B, F, T, C, N, (kf, kt), dil)


# ------------------------------------------------------------------ routes


def test_k4_takes_the_tma_route_at_every_level_shape():
    """bf16: the five level shapes and their dx (K4 on the flipped,
    io-swapped kernel: the same shapes, C = N) take the TMA route, each
    cut in blocks of two boxes that cover F x T exactly; fp32 the CUDA
    cores."""
    assert len(chip_smoke.K4_LEVELS) == 5
    for shape in chip_smoke.K4_LEVELS:
        B, F, T, C, N, kf, kt, (df, dt) = shape
        plan = _plan(shape)
        assert plan.route == kernels.K4_TMA, shape
        assert kernels.dilated_conv_route(BF16, T, N, C, kf, kt, dt) == (
            kernels.K4_TMA)
        assert _plan(shape, F32).route == kernels.K4_SIMT
        assert plan.gx * plan.gy * 128 == F * T, shape  # no wasted rows
        assert plan.smem <= kernels.MAX_SMEM


def test_k4_takes_the_tma_route_at_every_flagship_stage():
    """K2's 49 stage shapes (bf16, (5,3), dilation (d,1), C -> C), where
    ``chip_smoke.py`` times the route beside K2's engine."""
    assert sum(K2_SHAPES.values()) == 75
    for (F, T, C, d) in K2_SHAPES:
        assert kernels.dilated_conv_route(BF16, T, C, C, 5, 3, 1) == (
            kernels.K4_TMA), (F, T, C, d)
        assert _plan((1, F, T, C, C, 5, 3, (d, 1))).route == kernels.K4_TMA


def _want_route(dtype, T, C, N, kf, kt, dt):
    if dtype != BF16:
        return kernels.K4_SIMT
    if C % 8 == 0 and N % 8 == 0:
        return kernels.K4_TMA
    window = (8 * kf * (16 + (kt - 1) * dt) + kf * kt * 64) * 24 * 2
    if T >= 16 and C >= 16 and window <= kernels.MAX_SMEM:
        return kernels.K4_MMA
    return kernels.K4_SIMT


@pytest.mark.parametrize("shape", chip_smoke.K4_SMALL + chip_smoke.K4_EDGE)
def test_k4_routes_at_the_small_shapes_and_edges(shape):
    """The small shapes of ``chip_smoke.py`` (C = N = 8) and the TMA cut's
    edges: bf16 with C and N multiples of 8 takes the TMA route, fp32 the
    CUDA cores."""
    B, F, T, C, N, kf, kt, (df, dt) = shape
    for dtype in (BF16, F32):
        assert _plan(shape, dtype).route == _want_route(dtype, T, C, N, kf,
                                                        kt, dt)
    assert _plan(shape).route == kernels.K4_TMA


@pytest.mark.parametrize("T,C,N,kf,kt,dt,want", [
    (64, 100, 100, 5, 3, 1, kernels.K4_MMA),   # C, N not multiples of 8
    (64, 64, 3, 5, 3, 1, kernels.K4_MMA),      # N = 3
    (64, 12, 64, 5, 3, 1, kernels.K4_SIMT),    # C = 12: too few channels
    (8, 20, 64, 5, 3, 1, kernels.K4_SIMT),     # rows of 8
    (64, 20, 64, 7, 7, 64, kernels.K4_SIMT),   # the mma window too large
    (64, 64, 64, 7, 7, 64, kernels.K4_TMA),    # no window on the TMA route
])
def test_k4_keeps_the_old_tiles_off_multiples_of_8(T, C, N, kf, kt, dt,
                                                   want):
    assert kernels.dilated_conv_route(BF16, T, C, N, kf, kt, dt) == want
    assert want == _want_route(BF16, T, C, N, kf, kt, dt)
    assert kernels.dilated_conv_route(F32, T, C, N, kf, kt, dt) == (
        kernels.K4_SIMT)



@pytest.mark.parametrize("shape", sorted(chip_smoke.K4_OLD_TILES))
def test_k4_old_tile_shapes_take_the_route_chip_smoke_expects(shape):
    """The bf16 shapes ``chip_smoke.py`` holds on K4's older tiles take the
    route it expects of them (it fails a launch on another route)."""
    B, F, T, C, N, kf, kt, (df, dt) = shape
    want = kernels.K4_ROUTES.index(chip_smoke.K4_OLD_TILES[shape])
    assert want != kernels.K4_TMA
    assert _plan(shape).route == want == _want_route(BF16, T, C, N, kf, kt,
                                                     dt)
    assert _plan(shape, F32).route == kernels.K4_SIMT


# ------------------------------------------------------------------- cuts


def _blocks(plan):
    """Every (block, warpgroup, box row) of a TMA cut as flat arrays: the
    item b, channel tile j, and the position (f, t) the row stores, with
    whether it is a row of the box (rr < TT*TF) inside F x T."""
    z, by, bx = np.meshgrid(np.arange(plan.gz), np.arange(plan.gy),
                            np.arange(plan.gx), indexing="ij")
    z, by, bx = (v.reshape(-1, 1, 1) for v in (z, by, bx))
    w = np.arange(2).reshape(1, 2, 1)
    rr = np.arange(64).reshape(1, 1, 64)
    f = by * 2 * plan.TF + w * plan.TF + rr // plan.TT
    t = bx * plan.TT + rr % plan.TT
    shape = np.broadcast(z, w, rr).shape
    b, j, f, t = (np.broadcast_to(v, shape) for v in (
        z // plan.n_tiles, z % plan.n_tiles, f, t))
    stored = (rr < plan.TT * plan.TF) & (f < plan.F) & (t < plan.T)
    return b[stored], j[stored], f[stored], t[stored]


def _k4_terms(plan):
    """Walk a TMA cut as the kernel does: block (gx, gy, z) with its two
    warpgroups' box rows, ring stages it = (tap, 64-channel chunk).  Count
    each stored output (per channel tile) and each (b, f, t, tap, tile,
    chunk) term whose source lies inside the image."""
    B, F, T = plan.B, plan.F, plan.T
    taps = plan.KF * plan.KT
    PF, PT = (plan.KF - 1) // 2, (plan.KT - 1) // 2
    b, j, f, t = _blocks(plan)
    out = np.bincount(((b * F + f) * T + t) * plan.n_tiles + j,
                      minlength=B * F * T * plan.n_tiles)
    terms = np.zeros(B * F * T * taps * plan.n_tiles * plan.nch, np.int64)
    assert plan.n_k == taps * plan.nch
    for it in range(plan.n_k):
        tap, ch = divmod(it, plan.nch)
        kf, kt = divmod(tap, plan.KT)
        fs, ts = f + (kf - PF) * plan.df, t + (kt - PT) * plan.dt
        ok = (fs >= 0) & (fs < F) & (ts >= 0) & (ts < T)
        idx = ((((b * F + f) * T + t) * taps + tap) * plan.n_tiles
               + j) * plan.nch + ch
        terms += np.bincount(idx[ok], minlength=terms.size)
    return (out.reshape(B, F, T, plan.n_tiles),
            terms.reshape(B, F, T, taps, plan.n_tiles, plan.nch))


def _k4_inside(plan):
    """(B, F, T, taps): 1 where the tap's source lies inside the image."""
    PF, PT = (plan.KF - 1) // 2, (plan.KT - 1) // 2
    f = np.arange(plan.F)[:, None, None]
    t = np.arange(plan.T)[None, :, None]
    kf, kt = np.divmod(np.arange(plan.KF * plan.KT), plan.KT)
    fs, ts = f + (kf - PF) * plan.df, t + (kt - PT) * plan.dt
    ins = (fs >= 0) & (fs < plan.F) & (ts >= 0) & (ts < plan.T)
    return np.broadcast_to(ins, (plan.B,) + ins.shape).astype(np.int64)


def _covers_once(width, step, n, total):
    """Ranges [k*step, k*step + width) for k < n, clipped to [0, total),
    cover every index of [0, total) exactly once."""
    cnt = np.zeros(total, np.int64)
    for k in range(n):
        cnt[k * step:min(total, k * step + width)] += 1
    return bool((cnt == 1).all())


@pytest.mark.parametrize("shape", chip_smoke.K4_LEVELS + chip_smoke.K4_EDGE)
def test_k4_plans_sum_every_term_exactly_once(shape):
    """Every output once (each channel tile of each position); every
    in-image (position, tap) term once per channel tile and 64-channel
    chunk; the chunks cover C and the tiles N exactly once."""
    plan = _plan(shape)
    assert plan.route == kernels.K4_TMA
    assert 1 <= plan.TT * plan.TF <= 64 and plan.TF == 64 // plan.TT
    assert plan.bn in kernels.K4_WIDTHS
    assert _covers_once(64, 64, plan.nch, plan.C)
    assert _covers_once(plan.bn, plan.bn, plan.n_tiles, plan.N)
    out, terms = _k4_terms(plan)
    assert (out == 1).all()
    want = _k4_inside(plan)[..., None, None]
    assert (terms == want).all()


def _p2_terms(plan, BF, BT, d, elem):
    """Walk a P2 cut as the engine's loop walks it: block (gx, gy, j), its
    64 positions in the BF x BT window at (2d, 8) of the staged rows, ring
    stages it = (chunk, kf) of 32 bytes of channels, taps kt.  Every read
    lies in the staged rows (no padding) and is the h element the probe's
    sum names."""
    nrows, BTw = plan.F, plan.T
    nch = plan.C * elem // kernels.STAGE_KB
    assert plan.n_it == 5 * nch and plan.gz == plan.splits
    cnt = np.zeros((BF, BT, 5, 3, nch, plan.splits), np.int64)
    out = np.zeros((BF, BT, plan.splits), np.int64)
    q = np.arange(kernels.PROBE_POS)
    fr, col = q >> plan.tt_log2, q & (plan.TT - 1)
    assert (fr < plan.TF).all() and plan.TT * plan.TF == kernels.PROBE_POS
    for j in range(plan.gz):
        for by in range(plan.gy):
            for bx in range(plan.gx):
                f, t = by * plan.TF + fr, bx * plan.TT + col
                live = (f < BF) & (t < BT)
                f, t, c0 = f[live], t[live], col[live]
                np.add.at(out, (f, t, j), 1)
                for it in range(plan.n_it):
                    chunk, kf = divmod(it, 5)
                    for kt in range(3):
                        assert (c0 + kt < plan.TT + 2).all()
                        # the engine's read: row (f + 2d) + (kf - 2)d,
                        # column (t + 8) + (kt - 1); the probe's h[f + kf
                        # d, 7 + kt + t]
                        fs = (f + 2 * d) + (kf - 2) * d
                        ts = (t + 8) + (kt - 1)
                        assert (fs == f + kf * d).all()
                        assert (ts == 7 + kt + t).all()
                        assert ((fs >= 0) & (fs < nrows) & (ts >= 0)
                                & (ts < BTw)).all()
                        np.add.at(cnt, (f, t, kf, kt, chunk, j), 1)
    return cnt, out


@pytest.mark.parametrize("BF,BT,C,d", probe_int8.STAGE_SHAPES
                         + tuple(chip_smoke.P2_EDGE))
@pytest.mark.parametrize("dtype", [BF16, torch.int8])
def test_p2_plans_sum_every_term_exactly_once(BF, BT, C, d, dtype):
    """Both probe shapes cut into 128 blocks (about one wave of the H100's
    132 SMs; 32 before), the edges (ragged BT, C = 64 and 96) too; every
    output once, every (position, tap, 32-byte chunk) term once per
    channel tile."""
    plan = kernels.probe_stage_plan(BF, BT, C, d, dtype)
    assert plan.mode == kernels.STAGE_PROBE and plan.B == 1
    assert (plan.F, plan.T) == (BF + 4 * d, BT + 16)
    NT = C // plan.splits
    assert NT in kernels.PROBE_NT and NT * plan.splits == C
    if (BF, BT, C, d) in probe_int8.STAGE_SHAPES:
        assert plan.gx * plan.gy * plan.gz == 128
    elem = 2 if dtype == BF16 else 1
    cnt, out = _p2_terms(plan, BF, BT, d, elem)
    assert (out == 1).all()
    assert (cnt == 1).all()
    assert plan.smem == kernels.STAGE_RING * plan.stage_bytes
    assert plan.smem <= kernels.MAX_SMEM


def test_p2_plan_refuses_what_the_loop_does_not_take():
    for BF, BT, C, d in ((4, 16, 48, 1), (4, 16, 0, 1), (0, 16, 64, 1),
                         (4, 16, 64, 0)):
        with pytest.raises(ValueError, match="not taken"):
            kernels.probe_stage_plan(BF, BT, C, d, torch.int8)


def test_p2_nt_is_the_widest_that_fills_a_wave():
    """NT = 64 when that still gives 90% of a wave of PROBE_SMS blocks,
    else NT = 32: both probe shapes take 32 (128 blocks), a larger window
    takes 64; every cut runs the engine's ring."""
    for shape in probe_int8.STAGE_SHAPES:
        for dtype in (BF16, torch.int8):
            plan = kernels.probe_stage_plan(*shape, dtype)
            assert shape[2] // plan.splits == 32
            assert plan.ring_bytes == kernels.STAGE_RING * plan.stage_bytes
    wide = kernels.probe_stage_plan(64, 128, 128, 1, BF16)
    assert wide.splits == 2
    assert wide.gx * wide.gy * wide.gz >= 0.9 * kernels.PROBE_SMS


def test_p2_pack_is_the_engines_tap_major_pack():
    """P2 reads the engine's pack of its tap-major wt: element [kf, ch, kt,
    g, h, r, e] = wt[3kf + kt, 8g + r, 2v ch + v h + e], v = 16 bytes of
    values; for int8 it is K3's pack."""
    g = torch.Generator().manual_seed(3)
    for dtype, v in ((BF16, 8), (torch.int8, 16)):
        C = 64
        _, _, wt = probe_int8.stage_inputs(1, 16, C, 1, dtype, g, "cpu")
        pk = kernels.stage_tap_weights(wt)
        assert pk.shape == (5, C // (2 * v), 3, C // 8, 2, 8, v)
        kf, ch, kt, gg, h, r, e = np.meshgrid(
            *[np.arange(n) for n in pk.shape], indexing="ij")
        want = wt[torch.as_tensor(3 * kf + kt), torch.as_tensor(8 * gg + r),
                  torch.as_tensor(2 * v * ch + v * h + e)]
        assert torch.equal(pk, want)
        if dtype == torch.int8:
            assert torch.equal(pk, kernels.stage_int8_weights(wt))


# ------------------------------------------------ the TMA route, mirrored


def _box_x(x, b, c0, to, fo, TT, TF):
    """The TMA's A box over x (B, F, T, C) at (c0, to, fo, b): 64 channels
    x TT columns x TF rows, zero wherever a coordinate of any dimension
    lies outside the tensor; rows f_l * TT + t_l."""
    _, F, T, C = x.shape
    fi, ti, ci = fo + np.arange(TF), to + np.arange(TT), c0 + np.arange(64)
    ok = (((fi >= 0) & (fi < F))[:, None, None]
          & ((ti >= 0) & (ti < T))[None, :, None] & (ci < C)[None, None, :])
    vals = x[b][np.ix_(np.clip(fi, 0, F - 1), np.clip(ti, 0, T - 1),
                       np.clip(ci, 0, C - 1))]
    return np.where(ok, vals, 0).reshape(TF * TT, 64)


def _box_w(pack, c0, n0, tap, bn):
    """The B box over the tap-major pack (taps, N, C) at (c0, n0, tap): bn
    outputs x 64 channels, zero past N and C."""
    _, N, C = pack.shape
    ni, ci = n0 + np.arange(bn), c0 + np.arange(64)
    ok = (ni < N)[:, None] & (ci < C)[None, :]
    vals = pack[tap][np.ix_(np.clip(ni, 0, N - 1), np.clip(ci, 0, C - 1))]
    return np.where(ok, vals, 0)


def _tma_mirror(x, w, plan):
    """K4's TMA route in numpy (fp32): per block and k-step, both
    warpgroups' A tiles from their box origins, rows past TT*TF left NaN
    (shared memory the TMA never writes), times the B box of the
    tap-major pack; the epilogue stores rows < TT*TF inside F x T and
    outputs < N, each once."""
    B, F, T, C = x.shape
    N = w.shape[3]
    pack = kernels.tap_major(torch.as_tensor(w)).numpy()
    PF, PT = (plan.KF - 1) // 2, (plan.KT - 1) // 2
    live = plan.TT * plan.TF
    y = np.full((B, F, T, N), np.nan, np.float32)
    for z in range(plan.gz):
        b, j = divmod(z, plan.n_tiles)
        n0 = j * plan.bn
        for by in range(plan.gy):
            for bx in range(plan.gx):
                f0, t0 = by * 2 * plan.TF, bx * plan.TT
                acc = np.zeros((2, 64, plan.bn), np.float32)
                for it in range(plan.n_k):
                    tap, ch = divmod(it, plan.nch)
                    kf, kt = divmod(tap, plan.KT)
                    c0 = ch * 64
                    wb = _box_w(pack, c0, n0, tap, plan.bn)
                    for wg in range(2):
                        a = np.full((64, 64), np.nan, np.float32)
                        a[:live] = _box_x(x, b, c0, t0 + (kt - PT) * plan.dt,
                                          f0 + wg * plan.TF
                                          + (kf - PF) * plan.df,
                                          plan.TT, plan.TF)
                        acc[wg] += a @ wb.T
                for wg in range(2):
                    for rr in range(live):
                        f = f0 + wg * plan.TF + rr // plan.TT
                        t = t0 + rr % plan.TT
                        if f >= F or t >= T:
                            continue
                        n1 = min(N, n0 + plan.bn)
                        assert np.isnan(y[b, f, t, n0:n1]).all()  # once
                        y[b, f, t, n0:n1] = acc[wg, rr, :n1 - n0]
    assert not np.isnan(y).any()
    return y


@pytest.mark.parametrize("shape", chip_smoke.K4_EDGE)
def test_tma_mirror_matches_the_conv_at_the_edges(shape, rng):
    """The boxes assembled from the plan's origins, zero-filled per
    dimension, give the 'SAME' conv: no shift bleeds across a row (T and F
    separate dimensions of the map) or an item (B separate), the stale
    rows past a box reach no stored output, the half-empty chunk at C = 96
    and the ragged weight box at N = 40 add nothing.  Held to the plain
    ``conv_ref`` and the JAX ``_conv_ref`` in fp32."""
    B, F, T, C, N, kf, kt, dil = shape
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (rng.standard_normal((kf, kt, C, N)) / np.sqrt(kf * kt * C)).astype(
        np.float32)
    y = _tma_mirror(x, w, _plan(shape))
    ref = tpc.conv_ref(torch.as_tensor(x), torch.as_tensor(w), dil).numpy()
    jref = np.asarray(jconv_ref(jnp.asarray(x), jnp.asarray(w), dil))
    for r in (ref, jref):
        np.testing.assert_allclose(y, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


# ----------------------------------------------------------- the wrapper


def test_k4_wrapper_packs_only_for_the_routes_that_read_it(monkeypatch):
    """The tap-major copy of w is made for the tensor-core routes and not
    for the CUDA-core tile, and each launch counts once in LAUNCHES and
    once under its route (the kernel entry replaced by a stand-in, so
    nothing launches; the tensor checks too, which refuse CPU tensors)."""
    packs, calls = [], []
    real = kernels.tap_major
    monkeypatch.setattr(kernels, "tap_major",
                        lambda w: packs.append(w.dtype) or real(w))
    monkeypatch.setattr(kernels, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_entry",
                        lambda name: lambda *a: calls.append(a) or 0)
    kernels.reset_launch_counts()
    try:
        for dtype, C, want in ((F32, 64, "simt"), (BF16, 64, "tma"),
                               (BF16, 100, "mma")):
            packs.clear()
            x = torch.zeros((1, 8, 32, C), dtype=dtype)
            w = torch.zeros((5, 3, C, C), dtype=dtype)
            before = dict(kernels.ROUTE_LAUNCHES["dilated_conv"])
            kernels.launch_dilated_conv(x, w, (1, 1))
            after = kernels.ROUTE_LAUNCHES["dilated_conv"]
            assert {k: after[k] - before[k] for k in after} == {
                r: int(r == want) for r in kernels.K4_ROUTES}
            assert packs == ([] if want == "simt" else [dtype])
        assert kernels.LAUNCHES["dilated_conv"] == 3 and len(calls) == 3
    finally:
        kernels.reset_launch_counts()
    assert set(kernels.ROUTE_LAUNCHES["dilated_conv"].values()) == {0}


# ------------------------------- P1 and P2's plain versions, against Pallas


@pytest.fixture
def pallas_probe(monkeypatch):
    """``tools/probe_pallas_int8.py`` with its ``pl`` swapped for a
    namespace whose ``pallas_call`` runs in interpret mode (the module
    itself unchanged)."""
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_int8", os.path.join(ROOT, "tools",
                                          "probe_pallas_int8.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, ds=pl.ds))
    return mod


def _jx(t, jdt):
    return jnp.asarray(t.float().numpy()).astype(jdt)


@pytest.mark.parametrize("dtype", [torch.int8, BF16])
def test_probe_plain_versions_match_the_pallas_kernels(dtype, pallas_probe):
    """P1's ``make_gemm`` and P2's ``make_stage`` (one inner repetition:
    the product its repetitions recompute) against ``probe_gemm_ref`` and
    ``probe_stage_ref`` on the same inputs: int8 bit for bit, bf16 within
    1e-5 of the largest |value| (the kernels sum in fp32, the plain
    versions in float64)."""
    jdt = jnp.int8 if dtype == torch.int8 else jnp.bfloat16
    g = torch.Generator().manual_seed(0)
    BF, BT, C, d = 2, 16, 32, 2
    h, w5, _ = probe_int8.stage_inputs(BF, BT, C, d, dtype, g, "cpu")
    call, M = pallas_probe.make_stage(BF + 4 * d, BF, BT, C, d, jdt,
                                      reps_inner=1)
    assert M == BF * BT
    sout = np.asarray(call(_jx(h, jdt), _jx(w5, jdt)))
    sref = probe_int8.probe_stage_ref(h, w5, BF, BT, d).numpy()
    M_, K, N = 64, 96, 32
    a, b, _ = probe_int8.gemm_inputs(M_, K, N, dtype, g, "cpu")
    ot, acct = ((jnp.int32, jnp.int32) if dtype == torch.int8
                else (jnp.bfloat16, jnp.float32))
    gout = np.asarray(pallas_probe.make_gemm(M_, K, N, jdt, ot, acct)(
        _jx(a, jdt), _jx(b, jdt))).astype(np.float64)
    gref = probe_int8.probe_gemm_ref(a, b).double().numpy()
    if dtype == torch.int8:
        assert sout.dtype == np.int32
        np.testing.assert_array_equal(sout, sref)
        np.testing.assert_array_equal(gout, gref)
    else:
        for o, r in ((sout, sref), (gout, gref)):
            np.testing.assert_allclose(o, r, rtol=0,
                                       atol=1e-5 * np.abs(r).max())
