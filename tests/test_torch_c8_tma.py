"""C8's TMA route and Q8's rescale: what the CPU can check.

C8's s8 TMA + wgmma implicit GEMM (``csrc/conv_int8.cu``) and the rescale
(``csrc/quant_int8.cu``, ``act_rescale``) run only on the card, where
``chip_smoke.py`` holds them to their plain versions bit for bit.  Here:

  * C8's routes: the stage engine's at C = N = 96 (rows of 16 or more),
    the TMA route at other multiples of 16, the tile elsewhere;
  * the TMA cut (``kernels.conv_int8_plan``) under hypothesis, over the
    flagship's int8 stage shapes and random (B, F, T, C, N, d): every
    output (b, f, t, n) in exactly one block's live rows, no box past 64
    positions, the ring and the epilogue tile inside the shared memory it
    claims, the grid inside the card's limits, the producer's transaction
    bytes what its boxes deliver;
  * a numpy model of the producer's walk: per (tap, 128-channel chunk) the
    A and B boxes loaded at their coordinates with the TMA's zero fill
    (negative coordinates included), the stale rows past a box left as
    garbage, ks 32-byte k-steps of products accumulated in int32 and stored
    as the epilogue stores, against ``conv_int8_acc_ref`` and the JAX
    ``_conv_int8_impl``'s int32 accumulator, for d in {1, 2, 8}, C = 96
    (a quarter of the box zero fill) and a ragged second chunk;
  * a numpy mirror of the rescale's cut (``kernels.rescale_plan``): every
    element written once with its item's and channel's scale, equal to
    ``int8_rescale_ref`` bit for bit, for N = 96, 128 and a ragged N;
  * the wrappers, their kernel entries replaced by stand-ins: the route
    counted, the plan passed, the tap-major kernel read as it is (packed
    only for the engine), a TMA call off 16-byte alignment refused, the
    rescale's path chosen by N and alignment.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from babe_tpu.ops import conv_kernels as jck
from babe_tpu_torch import kernels
from babe_tpu_torch.ops import conv_kernels as tck

# the flagship network and its top CQT length at 184184 samples
NS, NUM_DILS = (64, 96, 96, 128, 128, 256, 256), (2, 3, 4, 5, 6, 7, 7)
K2_SHAPES, _ = chip_smoke.flagship_shapes(types.SimpleNamespace(M=[2048]),
                                          NS, NUM_DILS)
INT8_SHAPES = sorted(k for k in K2_SHAPES if k[2] >= 96)
SM_SMEM = 233472  # shared memory of one H100 SM that blocks may take
# the amax/all evaluation's int8 1x1 products (B, F, T, N) and their count
# in one guided evaluation of the flagship (BABE_INT8_OPS=all, MINC=128)
RESCALE_SHAPES = {(1, 64, 32, 256): 1, (1, 64, 64, 128): 1,
                  (1, 64, 128, 128): 1, (1, 320, 128, 128): 3,
                  (1, 384, 64, 128): 3, (1, 384, 64, 256): 2,
                  (1, 448, 32, 256): 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the cut


def _blocks(plan):
    """Every (block, warpgroup, box row) of a TMA cut as flat arrays: the
    item b, output tile j and the position (f, t) the row stores, for the
    rows of a box inside F x T."""
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
    live = (rr < plan.TT * plan.TF) & (f < plan.F) & (t < plan.T)
    return b[live], j[live], f[live], t[live]


def _check_cut(plan):
    B, F, T, C, N = plan.B, plan.F, plan.T, plan.C, plan.N
    assert plan.route == kernels.C8_TMA
    # boxes: at most 64 positions, one warpgroup's A slot
    assert 1 <= plan.TT * plan.TF <= 64 and plan.TF == 64 // plan.TT
    assert plan.TT <= 256 and plan.TF <= 256 and plan.bn <= 256
    # every output (b, f, t, n) in exactly one block's live rows
    b, j, f, t = _blocks(plan)
    cover = np.bincount(((b * F + f) * T + t) * plan.n_tiles + j,
                        minlength=B * F * T * plan.n_tiles)
    assert (cover == 1).all()
    tiles = np.zeros(N, np.int64)
    for k in range(plan.n_tiles):
        tiles[k * plan.bn:min(N, (k + 1) * plan.bn)] += 1
    assert (tiles == 1).all()
    # the contraction: 15 taps x the 128-channel chunks covering C once
    assert plan.nch == -(-C // kernels.C8_CHUNK)
    assert plan.n_k == 15 * plan.nch
    # the ring and the epilogue tile fit the shared memory it claims
    assert kernels.C8_CHUNK * plan.TT * plan.TF <= kernels.C8_ABOX
    assert plan.stage_bytes == 2 * kernels.C8_ABOX + (
        plan.bn * kernels.C8_CHUNK)
    assert plan.stage_bytes % 1024 == 0  # each slot's boxes 1024-aligned
    # the epilogue's int32 tile (128 rows of bn + 4) is laid over the ring
    assert 128 * (plan.bn + 4) * 4 <= plan.stages * plan.stage_bytes
    assert plan.smem == plan.stages * plan.stage_bytes + 1024
    assert 2 <= plan.stages <= 8
    assert kernels.c8_blocks(plan.bn) * plan.smem <= SM_SMEM
    assert plan.smem <= kernels.MAX_SMEM
    # the grid
    assert plan.gx * plan.TT >= T > (plan.gx - 1) * plan.TT
    assert plan.gy * 2 * plan.TF >= F > (plan.gy - 1) * 2 * plan.TF
    assert plan.gz == B * plan.n_tiles
    assert plan.gx < 2**31 and plan.gy <= 65535 and plan.gz <= 65535
    # the producer announces 128 * (2 TT TF + bn) bytes (TX_BYTES, the
    # kernel's expression): what its three boxes deliver, zero fill
    # included, two A boxes (128 x TT x TF x 1 int8) and one B box (128 x
    # bn x 1)
    boxes = [(kernels.C8_CHUNK, plan.TT, plan.TF, 1)] * 2 + [
        (kernels.C8_CHUNK, plan.bn, 1)]
    assert 128 * (2 * plan.TT * plan.TF + plan.bn) == sum(
        int(np.prod(bx)) for bx in boxes)


TX_BYTES = "const uint32_t tx_bytes = 128 * (2 * p.TT * p.TF + BN);"


def test_c8_kernel_announces_what_the_cut_checks():
    """The transaction bytes ``_check_cut`` holds to the boxes are the
    ones the producer in ``csrc/conv_int8.cu`` announces, and its boxes
    are the sizes the cut assumes (128 channels x TT x TF x 1, 128 x bn x
    1)."""
    src = open(os.path.join(kernels.CSRC, "conv_int8.cu")).read()
    assert TX_BYTES in src
    assert ("{kChunk, (cuuint32_t)k.TT, (cuuint32_t)k.TF, 1}" in src
            and "{kChunk, (cuuint32_t)k.bn, 1}" in src)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_c8_plan_at_the_flagship_shapes(shape, B):
    """The flagship's 96-channel stages take the engine (one channel
    tile, 15 ring stages of 32 channels x 5 kernel rows), the others the
    TMA route; the TMA cut, which ``chip_smoke.py`` also times at 96
    channels, is whole at every shape."""
    F, T, C, d = shape
    plan = kernels.conv_int8_plan(B, F, T, C, C, d)
    if C == 96:
        assert plan.route == kernels.C8_ENGINE
        sp = kernels.stage_plan(kernels.STAGE_C8, torch.int8, B, F, T, C, d)
        assert (sp.route, sp.splits, sp.n_it) == (kernels.STAGE_ENGINE, 1,
                                                  15)
        assert sp.smem <= kernels.MAX_SMEM
        plan = kernels.conv_int8_plan(B, F, T, C, C, d,
                                      route=kernels.C8_TMA)
    _check_cut(plan)
    assert plan.bn == C and plan.n_tiles == 1


@settings(max_examples=100, deadline=None)
@given(B=st.integers(1, 4), F=st.integers(1, 200), T=st.integers(1, 200),
       c16=st.integers(1, 24), n16=st.integers(1, 24),
       d=st.sampled_from([1, 2, 4, 8, 16, 32, 64]))
def test_c8_plan_covers_every_output_once(B, F, T, c16, n16, d):
    C, N = 16 * c16, 16 * n16
    route = kernels.conv_int8_route(B, F, T, C, N, d)
    assert route == (kernels.C8_ENGINE if C == N == 96 and T >= 16
                     else kernels.C8_TMA)
    plan = kernels.conv_int8_plan(B, F, T, C, N, d, route=kernels.C8_TMA)
    _check_cut(plan)
    assert plan.bn == next((w for w in kernels.C8_WIDTHS if w >= N), 256)


def test_c8_plan_refuses_cuts_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="engine"):
        kernels.conv_int8_plan(1, 8, 16, 128, 128, 1,
                               route=kernels.C8_ENGINE)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.conv_int8_plan(1, 8, 16, 100, 96, 1, route=kernels.C8_TMA)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernels.conv_int8_plan(1, 8, 16, 128, 40, 1, route=kernels.C8_TMA)
    with pytest.raises(ValueError, match="grid"):
        kernels.conv_int8_plan(70000, 8, 16, 128, 128, 1)


def test_conv_int8_route():
    """The engine at C = N = 96 with rows of 16 or more, the TMA route
    wherever else C and N are multiples of 16 (the flagship's other int8
    stages, the tiny network's 16 and 32 channels, 96 channels on short
    rows), the tile elsewhere; the engine's and the tile's plans carry
    their route alone."""
    TMA, TILE, E = kernels.C8_TMA, kernels.C8_TILE, kernels.C8_ENGINE
    for shape in ((4, 448, 20, 256, 256, 1), (1, 64, 8, 96, 96, 1),
                  (1, 64, 256, 16, 16, 1), (1, 64, 8, 32, 32, 2),
                  (1, 64, 64, 96, 128, 1), (1, 3, 5, 160, 48, 8)):
        assert kernels.conv_int8_route(*shape) == TMA, shape
    for want, shapes in ((E, ((1, 128, 1024, 96, 96, 4),
                              (2, 64, 16, 96, 96, 1))),
                         (TILE, ((1, 64, 64, 100, 100, 1),
                                 (1, 64, 64, 96, 40, 1),
                                 (1, 8, 8, 8, 16, 1)))):
        for shape in shapes:
            assert kernels.conv_int8_route(*shape) == want, shape
            plan = kernels.conv_int8_plan(*shape)
            assert plan.route == want and plan.TT == plan.bn == 0


# ------------------------------------------------ the producer's walk


def _box(a, origin, size):
    """A TMA box of ``a`` (numpy, outermost dimension first) at ``origin``
    of extent ``size``: every element outside the tensor, in any dimension,
    negative coordinates included, is zero."""
    idx, ok = [], np.ones(size, bool)
    for k, (o, n, dim) in enumerate(zip(origin, size, a.shape)):
        i = o + np.arange(n)
        shape = [1] * len(size)
        shape[k] = n
        ok &= ((i >= 0) & (i < dim)).reshape(shape)
        idx.append(np.clip(i, 0, dim - 1))
    return np.where(ok, a[np.ix_(*idx)], 0)


def _walk(q, qwt, plan, rng):
    """C8's TMA route in numpy: per block and ring stage (tap outer,
    128-channel chunk inner) the producer's three boxes at their
    coordinates, each warpgroup's 64-row A slot with the rows past TT * TF
    holding stale garbage, four 32-byte k-steps of products into int32
    accumulators; the epilogue stores each live row inside F x T and each
    output < N once.  Returns the int32 accumulator (B, F, T, N)."""
    B, F, T, C = q.shape
    N = qwt.shape[1]
    live = plan.TT * plan.TF
    width = kernels.C8_CHUNK
    acc = np.full((B, F, T, N), np.iinfo(np.int32).min, np.int64)
    stored = np.zeros((B, F, T, N), np.int64)
    for z in range(plan.gz):
        b, jt = divmod(z, plan.n_tiles)
        n0 = jt * plan.bn
        for by in range(plan.gy):
            for bx in range(plan.gx):
                f0, t0 = by * 2 * plan.TF, bx * plan.TT
                regs = np.zeros((2, 64, plan.bn), np.int64)
                for it in range(plan.n_k):
                    tap, ch = divmod(it, plan.nch)
                    kf, kt = divmod(tap, 3)
                    c0 = ch * width
                    # B box over qw (15, N, C) at (c0, n0, tap)
                    wb = _box(qwt, (tap, n0, c0), (1, plan.bn, width))[0]
                    for wg in range(2):
                        slot = rng.integers(-128, 128, (64, width))
                        # A box over q (C, T, F, B) at (c0, t0 + kt - 1,
                        # f0 + wg TF + (kf - 2) d, b)
                        slot[:live] = _box(
                            q, (b, f0 + wg * plan.TF + (kf - 2) * plan.d,
                                t0 + kt - 1, c0),
                            (1, plan.TF, plan.TT, width),
                        ).reshape(live, width)
                        # four 32-byte k-steps
                        for k in range(0, width, 32):
                            regs[wg] += (slot[:, k:k + 32]
                                         @ wb[:, k:k + 32].T)
                assert (np.abs(regs[:, :live]) < 2**31).all()
                for wg in range(2):
                    for rr in range(live):
                        f = f0 + wg * plan.TF + rr // plan.TT
                        t = t0 + rr % plan.TT
                        if f >= F or t >= T:
                            continue
                        n1 = min(N, n0 + plan.bn)
                        acc[b, f, t, n0:n1] = regs[wg, rr, :n1 - n0]
                        stored[b, f, t, n0:n1] += 1
    assert (stored == 1).all()
    return acc.astype(np.int32)


def _jax_acc(q, qw, d):
    """The JAX ``_conv_int8_impl``'s int32 accumulator: an fp32 x of
    integers with every item's amax 127 and an integer kernel with every
    output channel's amax 127 quantize to themselves (unit scales), and
    its fp32 output is then the accumulator exactly (|acc| < 2^24)."""
    out = jck._conv_int8_impl(jnp.asarray(q.astype(np.float32)),
                              jnp.asarray(qw.astype(np.float32)), (d, 1))
    out = np.asarray(out)
    assert (np.abs(out) < 2**24).all()
    return out.astype(np.int32)


@pytest.mark.parametrize("B,F,T,C,N,d", [
    (2, 9, 20, 96, 96, 1),      # C = 96: a quarter of the box filled
    (1, 21, 12, 96, 96, 8),     # d = 8 reaches past F from every row
    (2, 7, 70, 32, 48, 2),      # T past one box (TT = 64 is not it)
    (1, 5, 3, 160, 64, 1),      # two chunks, the second ragged (ks = 4)
    (1, 12, 9, 16, 16, 2),      # the tiny network's width
])
def test_producer_walk_is_the_int8_conv(B, F, T, C, N, d):
    rng = np.random.default_rng(B * 1000 + C + N + d)
    q = rng.integers(-127, 128, (B, F, T, C)).astype(np.int8)
    qw = rng.integers(-127, 128, (5, 3, C, N)).astype(np.int8)
    q.reshape(B, -1)[:, 0] = 127        # each item's amax 127
    qw.reshape(-1, N)[0] = -127         # each output channel's amax 127
    plan = kernels.conv_int8_plan(B, F, T, C, N, d, route=kernels.C8_TMA)
    qwt = kernels.tap_major(torch.as_tensor(qw)).numpy()
    acc = _walk(q, qwt, plan, rng)
    ref = tck.conv_int8_acc_ref(torch.as_tensor(q), torch.as_tensor(qw),
                                (d, 1)).numpy()
    np.testing.assert_array_equal(acc, ref)
    np.testing.assert_array_equal(acc, _jax_acc(q, qw, d))


# -------------------------------------------------------- the rescale


def _rescale_mirror(acc, scale, plan, dtype):
    """act_rescale on its cut in numpy: every block (x, b) and thread t
    walks ``plan.thread_cells(t)`` shifted to its rows; returns the output
    and how often each element was written."""
    B, rows, N = acc.shape
    out = np.zeros((B, rows, N), np.float32)
    hits = np.zeros((B, rows, N), np.int64)
    blocks = np.arange(plan.gx)[:, None] * plan.rows_blk
    for t in range(plan.threads):
        rr, cc = plan.thread_cells(t)
        # the thread's rows in every block x (rr < rows_blk: a block's rows
        # end at the next block's first), past the last row masked
        r = (blocks + np.array(list(rr), np.int64)[None, :]).ravel()
        r = r[r < rows]
        c = np.array(list(cc), np.int64)
        if r.size == 0 or c.size == 0:
            continue
        assert (np.array(list(rr)) < plan.rows_blk).all()
        for b in range(B):
            sel = np.ix_(r, c)
            out[b][sel] = acc[b][sel].astype(np.float32) * scale[b, c][None, :]
            hits[b][sel] += 1
    return torch.as_tensor(out).to(dtype), hits


@pytest.mark.parametrize("B,F,T,N,vec", [
    (1, 40, 32, 128, True), (2, 20, 17, 96, True), (1, 64, 32, 256, True),
    (3, 6, 5, 36, False), (2, 9, 7, 128, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rescale_cut_writes_every_element_once(B, F, T, N, vec, dtype):
    rng = np.random.default_rng(N + B)
    acc = rng.integers(-2**24, 2**24, (B, F * T, N)).astype(np.int32)
    sx = (rng.random(B) / 100).astype(np.float32)
    sw = (rng.random(N) / 100).astype(np.float32)
    scale = tck.int8_scale(torch.as_tensor(sx), torch.as_tensor(sw)).numpy()
    plan = kernels.rescale_plan(B, F * T, N, vec)
    assert plan.vec == (vec and N % 8 == 0)
    assert plan.threads <= kernels.RESCALE_THREADS
    assert plan.gx * plan.rows_blk >= F * T > (plan.gx - 1) * plan.rows_blk
    if plan.vec:
        assert plan.threads == (N // 8) * (kernels.RESCALE_THREADS // (N // 8))
    out, hits = _rescale_mirror(acc, scale, plan, dtype)
    assert (hits == 1).all()
    ref = tck.int8_rescale_ref(torch.as_tensor(acc), torch.as_tensor(sx),
                               torch.as_tensor(sw), dtype)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape", sorted(RESCALE_SHAPES))
def test_rescale_plan_at_the_flagship_1x1_shapes(shape):
    """At every int8 1x1 product of an amax/all evaluation the 8-channel
    path, a block of 256 threads, and at least one wave of the card's
    SMs' worth of blocks where the rows allow it."""
    B, F, T, N = shape
    plan = kernels.rescale_plan(B, F * T, N, True)
    assert plan.vec and plan.threads == 256
    per_pass = 256 // (N // 8)
    assert plan.rows_blk % per_pass == 0
    assert plan.rows_blk // per_pass <= kernels.RESCALE_ROWS
    assert plan.gx * B >= min(132, F * T // per_pass)


def test_rescale_plan_refuses_what_the_kernel_does_not_take():
    for args in ((0, 8, 8), (1, 0, 8), (70000, 8, 8), (1, 2**31, 8)):
        with pytest.raises(ValueError):
            kernels.rescale_plan(*args, True)


# ------------------------------------------------------- the wrappers


@pytest.fixture
def stand_in(monkeypatch):
    """The kernel entries replaced by a stand-in that records its
    arguments (the tensor checks too, which refuse CPU tensors)."""
    calls = []
    monkeypatch.setattr(kernels, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_entry",
                        lambda name: lambda *a: calls.append((name, a)) or 0)
    kernels.reset_launch_counts()
    yield calls
    kernels.reset_launch_counts()


def test_c8_wrapper_passes_the_plan_and_counts_its_route(stand_in,
                                                         monkeypatch):
    """Each launch counts once under its route and passes its route and
    plan: the TMA route its C8Plan and the tap-major kernel as it is, the
    engine its StagePlan and the engine's pack (made here, the only route
    that packs), the tile no plan."""
    packs = []
    real = kernels.stage_int8_weights
    monkeypatch.setattr(kernels, "stage_int8_weights",
                        lambda w: packs.append(w.shape) or real(w))
    for C, N, want in ((128, 128, "tma"), (96, 96, "engine"),
                       (100, 100, "tile")):
        packs.clear()
        q = torch.zeros((1, 8, 32, C), dtype=torch.int8)
        qwt = torch.zeros((15, N, C), dtype=torch.int8)
        before = dict(kernels.ROUTE_LAUNCHES["conv_int8"])
        kernels.launch_conv_int8(q, qwt, torch.ones((1, N)), 2,
                                 torch.bfloat16)
        after = kernels.ROUTE_LAUNCHES["conv_int8"]
        assert {k: after[k] - before[k] for k in after} == {
            r: int(r == want) for r in kernels.C8_ROUTES}
        name, a = stand_in[-1]
        route = kernels.C8_ROUTES.index(want)
        assert name == "conv_int8" and a[13] == route
        assert a[1] == qwt.data_ptr()  # the tap-major kernel as it is
        assert packs == ([(15, N, C)] if want == "engine" else [])
        meta = [] if a[14] is None else list(a[14][:a[15]])
        if want == "tma":
            assert meta == kernels.conv_int8_plan(1, 8, 32, C, N, 2).meta()
        elif want == "engine":
            assert a[2] != a[1]  # the pack
            assert meta == kernels.stage_plan(kernels.STAGE_C8, torch.int8,
                                              1, 8, 32, C, 2).meta()
        else:
            assert meta == []
    assert kernels.LAUNCHES["conv_int8"] == 3


def test_c8_wrapper_refuses_a_tma_call_off_alignment(stand_in):
    buf = torch.zeros(8 * 32 * 128 + 1, dtype=torch.int8)
    q = buf[1:].view(1, 8, 32, 128)
    with pytest.raises(ValueError, match="aligned"):
        kernels.launch_conv_int8(q, torch.zeros((15, 128, 128),
                                                dtype=torch.int8),
                                 torch.ones((1, 128)), 1, torch.float32)
    with pytest.raises(ValueError, match="plan for"):
        kernels.launch_conv_int8(
            buf[:-1].view(1, 8, 32, 128),
            torch.zeros((15, 128, 128), dtype=torch.int8),
            torch.ones((1, 128)), 1, torch.float32,
            plan=kernels.conv_int8_plan(1, 8, 32, 128, 128, 2))
    assert stand_in == [] and kernels.LAUNCHES["conv_int8"] == 0


def test_rescale_wrapper_takes_the_path_its_tensors_allow(stand_in):
    for N, off, vec in ((128, 0, 1), (36, 0, 0), (128, 1, 0)):
        buf = torch.zeros(2 * 10 * N + off, dtype=torch.int32)
        acc = buf[off:].view(2, 10, N)
        kernels.launch_act_rescale(acc, torch.ones((2, N)), torch.bfloat16)
        name, a = stand_in[-1]
        plan = kernels.rescale_plan(2, 10, N, bool(vec))
        assert name == "act_rescale"
        assert a[3:] == (2, 10, N, 1, vec, plan.threads, plan.rows_blk,
                         plan.gx, 0)
    assert kernels.LAUNCHES["act_rescale"] == 3


def test_rescale_source_has_no_per_element_64_bit_division():
    """act_rescale's device code divides only to find a thread's channels
    and first row, in 32 bits, once (no ``/`` or ``%`` on a size_t or long
    long inside its loops)."""
    src = open(os.path.join(kernels.CSRC, "quant_int8.cu")).read()
    body = src[src.index("    act_rescale(const int32_t*"):
               src.index("inline bool bad_cut(")]
    loops = body[body.index("for (int r"):]
    assert "/" not in loops.replace("//", "") and "%" not in loops
