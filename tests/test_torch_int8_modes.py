"""The JAX package's unfused int8 configurations in the port against the
JAX package on the same numpy inputs: ``conv_int8``, ``conv_int8_hinted``
and ``dot1x1_int8`` (forward, and their straight-through dx and dw with and
without ``BABE_INT8_BWD=1``, ``exact_backward()`` winning), the knobs, the
unfused int8 ``ResnetBlock`` under the bound scales and under
``BABE_INT8_SCALE=amax BABE_INT8_OPS=all`` (its 1x1s in int8 too), the tiny
model's guidance gradient in the JAX API's configuration
(``BABE_INT8_FUSED=0 BABE_INT8_BWD=1``), and one quantization-aware
training step.

The JAX side runs on the CPU, where its int8 path is always the unfused one
(its fused chain needs the TPU or interpret mode).  The blocks run
eagerly on both sides; the model and the training step run under jax.jit,
whose fusions reorder fp32 sums and so flip a few int8 values (under
amax/all the JAX package's own jit and eager outputs differ by 1.7e-3 L2
on the tiny model, the port and eager JAX by 2.3e-4).

Tolerances: the quantizers and the int32 accumulators exactly (the port's
accumulator on the JAX package's int8 operands); the int8 values may flip
where a summation order moves a value across a rounding boundary, at most
a 1e-3 share (as in test_torch_int8.py: 0 here); the outputs and the exact
gradients at 2e-5 of the largest value (fp32 sums in another order); the
blocks and the model at an L2 error of 1e-3 (a few quantization flips move
them by far less than int8 moves them from the exact network); a training
step's gradients at an L2 error of 2e-3 over all parameters and 1e-2 of
each parameter's largest (the flips move the gates' gradients most: 1.3e-3
and 3.7e-3 measured against jit, 7.4e-4 and 3.2e-3 against eager JAX),
where int8 moves them from the exact network's by far more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.diffusion.edm import EDM as JEDM
from babe_tpu.models import blocks as jb
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu.ops import conv_kernels as jck
from babe_tpu_torch import kernels
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.diffusion.edm import EDM as TEDM
from babe_tpu_torch.models import blocks as tb
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.ops import conv_kernels as tck
from babe_tpu_torch.training.trainer import Trainer as TTrainer
from babe_tpu_torch.utils.weights import load_flax, to_flax

CLOSE = 2e-5
CHAIN_L2 = 1e-3
FLIP_SHARE = 1e-3
GRAD_TOL = 1e-2
GRAD_L2 = 2e-3
L = 4096
TINY = [f"exp.audio_len={L}", "exp.use_bf16=false", "exp.remat=false",
        "network.Ns=[16,16,32]", "network.num_dils=[1,2,2]",
        "network.emb_dim=32", "network.attention_layers=[0,0,0,0]",
        "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8"]
JAX_API = {"BABE_PRECISION": "int8", "BABE_INT8_MINC": "16",
           "BABE_INT8_FUSED": "0", "BABE_INT8_BWD": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(monkeypatch, knobs):
    for k in ("BABE_INT8_FUSED", "BABE_INT8_BWD", "BABE_INT8_SCALE",
              "BABE_INT8_OPS", "BABE_INT8_MINC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(a, b, tol=CLOSE):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def _l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


# --------------------------------------------------------------- the knobs


def test_int8_config_reads_the_jax_knobs():
    c = tck.Int8Config.from_env({})
    assert (c.scale, c.minc, c.ops, c.fused, c.bwd) == (
        "bound", 96, "conv", 96, False)
    c = tck.Int8Config.from_env({"BABE_INT8_FUSED": "0",
                                 "BABE_INT8_BWD": "1"})
    assert c.fused is None and c.bwd and c.minc == 96
    c = tck.Int8Config.from_env({"BABE_INT8_SCALE": "amax"})
    assert c.minc == 128 and c.fused is None  # no fused chain under amax
    c = tck.Int8Config.from_env({"BABE_INT8_FUSED": "64",
                                 "BABE_INT8_MINC": "16",
                                 "BABE_INT8_OPS": "all"})
    assert (c.fused, c.minc, c.ops) == (64, 16, "all")
    assert c.active(16, 32, is_1x1=True) and not c.active(8, 32)
    assert not tck.Int8Config.from_env({}).active(96, 96, is_1x1=True)
    with pytest.raises(ValueError):
        tck.Int8Config.from_env({"BABE_INT8_SCALE": "minmax"})


@pytest.mark.parametrize("knobs,fused,unfused", [
    ({}, {32}, set()),
    ({"BABE_INT8_FUSED": "0"}, set(), {32}),
    ({"BABE_INT8_SCALE": "amax"}, set(), {32}),
    ({"BABE_INT8_FUSED": "16"}, {16, 32}, set()),
])
def test_set_precision_routes_the_stacks(monkeypatch, knobs, fused, unfused):
    """Which dilation stacks run the fused chain (K3) and which the unfused
    int8 loop, at BABE_INT8_MINC=32; bf16 takes every stack back."""
    _env(monkeypatch, dict(knobs, BABE_INT8_MINC="32"))
    m = TModel.from_config(tconfig(TINY), precision="int8")
    blocks = [b for b in m.net.modules() if isinstance(b, tb.ResnetBlock)]
    assert {b.N for b in blocks if b.int8} == fused
    assert {b.N for b in blocks if b.unfused_int8} == unfused
    m.net.set_precision("bf16")
    assert not any(b.int8 or b.unfused_int8 for b in blocks)
    assert not any(c.int8_active() for c in m.net.modules()
                   if isinstance(c, tb.Conv2d))


# ----------------------------------------------------- the convs themselves


def _conv_case(rng, B=2, F=16, T=12, C=32, N=32, kshape=(5, 3)):
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((*kshape, C, N))).astype(np.float32)
    g = rng.standard_normal((B, F, T, N)).astype(np.float32)
    bound = (1.05 * np.abs(x).max(axis=(1, 2, 3))).astype(np.float32)
    return x, w, g, bound


def _jax_acc(qx, qw, d):
    return np.asarray(jax.lax.conv_general_dilated(
        qx, qw, (1, 1), "SAME", rhs_dilation=(d, 1),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("kind,d", [("conv", 2), ("hinted", 4), ("1x1", 1)])
def test_int8_conv_forward_matches_jax(rng, kind, d):
    """The quantizers bit for bit, the int32 accumulator exactly on the
    same int8 operands, the rescaled output at CLOSE."""
    x, w, _, bound = _conv_case(rng, kshape=(1, 1) if kind == "1x1"
                                else (5, 3))
    if kind == "hinted":
        jq, js = jck._quant_act_with_scale(jnp.asarray(x), jnp.asarray(bound))
        q, s = tck.quant_act_with_scale(_t(x), _t(bound))
    else:
        jq, js = jck._quant_act_per_item(jnp.asarray(x))
        q, s = tck.quant_act_per_item(_t(x))
    flips = int((q.numpy() != np.asarray(jq)).sum())
    assert flips <= FLIP_SHARE * q.numel(), flips
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(-1))
    jqw, _ = jck._quant_weight_per_cout(jnp.asarray(w))
    acc = tck.conv_int8_acc_ref(torch.as_tensor(np.array(jq)),
                                torch.as_tensor(np.array(jqw)), (d, 1))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), _jax_acc(jq, jqw, d))
    if kind == "conv":
        out = tck.conv_int8(_t(x), _t(w), d)
        ref = jck.conv_int8(jnp.asarray(x), jnp.asarray(w), (d, 1))
    elif kind == "hinted":
        out = tck.conv_int8(_t(x), _t(w), d, bound=_t(bound))
        ref = jck.conv_int8_hinted(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(bound), (d, 1))
    else:
        out = tck.dot1x1_int8(_t(x), _t(w))
        ref = jck.dot1x1_int8(jnp.asarray(x), jnp.asarray(w))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("bwd", ["0", "1"])
@pytest.mark.parametrize("kind", ["conv", "hinted", "1x1"])
def test_int8_conv_grads_match_jax_custom_vjp(rng, monkeypatch, kind, bwd):
    """dx and dw against the JAX custom vjps (dw = g against dequant(qx);
    dx the exact transpose, or under BABE_INT8_BWD=1 the int8 conv of g
    with the flipped, io-swapped kernel; the 1x1's the plain vjp)."""
    monkeypatch.setenv("BABE_INT8_BWD", bwd)
    x, w, g, bound = _conv_case(rng, C=24, N=24, kshape=(1, 1)
                                if kind == "1x1" else (5, 3))
    d = 2
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    if kind == "conv":
        f = lambda xx, ww: jck.conv_int8(xx, ww, (d, 1))  # noqa: E731
    elif kind == "hinted":
        f = lambda xx, ww: jck.conv_int8_hinted(  # noqa: E731
            xx, ww, jnp.asarray(bound), (d, 1))
    else:
        f = jck.dot1x1_int8
    _, pull = jax.vjp(f, jx, jw)
    rdx, rdw = pull(jnp.asarray(g))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    if kind == "1x1":
        out = tck.dot1x1_int8(xt, wt)
    else:
        out = tck.conv_int8(xt, wt, d, bwd=bwd == "1",
                            bound=_t(bound) if kind == "hinted" else None)
    dx, dw = torch.autograd.grad(out, (xt, wt), _t(g))
    _close(dx.numpy(), rdx)
    _close(dw.numpy(), rdw)


def test_exact_backward_wins_over_the_int8_backward(rng, monkeypatch):
    """Inside exact_backward() the int8 conv's dx is the exact transpose in
    both packages, whatever BABE_INT8_BWD and the port's bwd flag say; the
    int8 dx differs from it."""
    monkeypatch.setenv("BABE_INT8_BWD", "1")
    x, w, g, _ = _conv_case(rng, C=24, N=24)
    xt = _t(x).requires_grad_(True)
    with jck.exact_backward():
        _, pull = jax.vjp(lambda xx: jck.conv_int8(xx, jnp.asarray(w),
                                                   (2, 1)), jnp.asarray(x))
        rdx = pull(jnp.asarray(g))[0]
    with tck.exact_backward():
        (dx,) = torch.autograd.grad(tck.conv_int8(xt, _t(w), 2, bwd=True),
                                    xt, _t(g))
    _close(dx.numpy(), rdx)
    monkeypatch.setenv("BABE_INT8_BWD", "0")
    _, pull = jax.vjp(lambda xx: jck.conv_int8(xx, jnp.asarray(w), (2, 1)),
                      jnp.asarray(x))
    _close(dx.numpy(), pull(jnp.asarray(g))[0])
    (dx8,) = torch.autograd.grad(tck.conv_int8(xt, _t(w), 2, bwd=True), xt,
                                 _t(g))
    assert _l2(dx8.numpy(), dx.numpy()) > 1e-4


def test_int8_convs_on_the_cpu_count_nothing(rng):
    kernels.reset_launch_counts()
    x, w, g, bound = _conv_case(rng, T=4)
    xt = _t(x).requires_grad_(True)
    out = tck.conv_int8(xt, _t(w), 1, bound=_t(bound), bwd=True)
    torch.autograd.grad(out, xt, _t(g))
    tck.dot1x1_int8(_t(x), _t(w[:1, :1]))
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_int8_launchers_refuse_cpu_tensors():
    q = torch.zeros((1, 8, 16, 32), dtype=torch.int8)
    with pytest.raises(ValueError):
        kernels.launch_conv_int8(q, torch.zeros((15, 32, 32),
                                                dtype=torch.int8),
                                 torch.ones((1, 32)), 1, torch.float32)
    with pytest.raises(ValueError):
        kernels.launch_act_quant_dyn(torch.zeros((1, 8)))
    with pytest.raises(ValueError):
        kernels.launch_act_quant(torch.zeros((1, 8)), torch.ones(1))
    with pytest.raises(ValueError):
        kernels.launch_act_rescale(torch.zeros((1, 8), dtype=torch.int32),
                                   torch.ones((1, 8)), torch.float32)


def test_conv_int8_routes():
    """C8's routes: the stage engine's int8 loop at C = N = 96 with rows of
    at least 16 positions (the flagship's 96-channel stages), the TMA route
    at any other C and N that are multiples of 16 (the flagship's 128- and
    256-channel stages, the tiny widths, short rows), the tile elsewhere.
    The engine's cut at 96 channels: one channel tile, 15 ring stages; the
    TMA cut of the deepest stage: one 256-wide tile of outputs, two
    128-channel chunks a tap (30 ring stages)."""
    TMA, TILE, E = kernels.C8_TMA, kernels.C8_TILE, kernels.C8_ENGINE
    assert kernels.conv_int8_route(1, 128, 1024, 96, 96, 4) == E
    assert kernels.conv_int8_route(4, 448, 20, 256, 256, 1) == TMA
    for shape in ((1, 64, 256, 16, 16, 1), (1, 64, 256, 32, 32, 2),
                  (1, 64, 8, 96, 96, 1), (1, 64, 64, 96, 128, 1),
                  (1, 64, 64, 160, 160, 1)):
        assert kernels.conv_int8_route(*shape) == TMA, shape
    for shape in ((1, 64, 64, 100, 100, 1), (1, 64, 64, 96, 40, 1)):
        assert kernels.conv_int8_route(*shape) == TILE, shape
    plan = kernels.stage_plan(kernels.STAGE_C8, torch.int8, 1, 128, 1024,
                              96, 4)
    assert (plan.route, plan.splits, plan.n_it) == (kernels.STAGE_ENGINE, 1,
                                                    15)
    plan = kernels.conv_int8_plan(1, 448, 20, 256, 256, 1)
    assert (plan.bn, plan.n_tiles, plan.n_k) == (256, 1, 30)


# ------------------------------------------------------------- the blocks


def _opened(tree, shift):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) + shift
        if any("gate" in str(k) or "affine" in str(k) for k in p)
        else np.asarray(v), tree)


@pytest.mark.parametrize("scale,ops", [("bound", "conv"), ("amax", "all")])
def test_unfused_int8_block_matches_jax(rng, monkeypatch, scale, ops):
    """The unfused int8 ResnetBlock (GroupNorm, affine, degree-6 gelu, the
    hinted or dynamic int8 conv, gated residual per stage; under ops=all
    its 1x1 proj_in and res_conv through dot1x1_int8) against the JAX
    block under BABE_PRECISION=int8 BABE_INT8_FUSED=0, its output and its
    input gradient with the int8 backward on."""
    _env(monkeypatch, {"BABE_PRECISION": "int8", "BABE_INT8_MINC": "16",
                       "BABE_INT8_FUSED": "0", "BABE_INT8_SCALE": scale,
                       "BABE_INT8_OPS": ops, "BABE_INT8_BWD": "1"})
    C, N, E = 16, 32, 32
    x = rng.standard_normal((2, 16, 12, C)).astype(np.float32)
    emb = rng.standard_normal((2, E)).astype(np.float32)
    tblk = tb.ResnetBlock(C, N, True, num_dils=3, emb_dim=E, Fdim=16)
    gen = torch.Generator().manual_seed(0)
    for m in tblk.modules():
        if isinstance(m, (tb.Linear, tb.Conv2d)):
            m.reset_parameters(gen)
    params = _opened(to_flax(tblk)[0], 0.2)
    load_flax(tblk, params)
    tblk.requires_grad_(False)
    tblk.set_int8(tck.Int8Config.from_env())
    assert tblk.unfused_int8
    hinted = []
    orig = tck._ConvInt8.forward

    def spy(ctx, x_, w_, bound, *rest):
        hinted.append(bound is not None)
        return orig(ctx, x_, w_, bound, *rest)

    monkeypatch.setattr(tck._ConvInt8, "forward", staticmethod(spy))
    assert sum(m.int8_active() for m in tblk.modules()
               if isinstance(m, tb.Conv2d) and m.kernel_size == (1, 1)) == (
                   2 if ops == "all" else 0)
    jblk = jb.ResnetBlock(C, N, True, num_dils=3, emb_dim=E, Fdim=16)
    xt = _t(x).requires_grad_(True)
    out = tblk(xt, _t(emb))
    assert hinted == [scale == "bound"] * 3
    ref, pull = jax.vjp(lambda xx: jblk.apply({"params": params}, xx,
                                              jnp.asarray(emb)),
                        jnp.asarray(x))
    assert _l2(out.detach().numpy(), ref) <= CHAIN_L2
    g = rng.standard_normal(out.shape).astype(np.float32)
    (dx,) = torch.autograd.grad(out, xt, _t(g))
    assert _l2(dx.numpy(), pull(jnp.asarray(g))[0]) <= CHAIN_L2
    # the int8 convs are engaged: far from the exact block
    tblk.set_int8(None)
    exact = tblk(_t(x), _t(emb)).numpy()
    assert _l2(out.detach().numpy(), exact) > 5 * _l2(
        out.detach().numpy(), ref)


# -------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def tiny():
    """The tiny network in both packages on the same weights (the port's
    seeded init with gates and affines opened by 0.01, as
    test_torch_int8.py's models8)."""
    args = jconfig(TINY)
    tm = TModel.from_config(args).init(seed=0, device="cpu")
    params, buffers = to_flax(tm.net)
    v = {"params": _opened(params, 0.01), "buffers": buffers}
    load_flax(tm.net, v["params"], v["buffers"])
    tm.net.requires_grad_(False)
    return args, JModel.from_config(args), v, tm


def test_tiny_model_guidance_grad_matches_jax(tiny, rng, monkeypatch):
    """The denoiser output and its guidance gradient (the vjp to the input
    through the int8 convs and their int8 input cotangents) against the JAX
    model in the JAX API's configuration."""
    _env(monkeypatch, JAX_API)
    args, jm, v, tm = tiny
    tm.net.set_precision("int8")
    try:
        assert all(b.unfused_int8 for b in tm.net.modules()
                   if isinstance(b, tb.ResnetBlock) and b.fused)
        x = (0.1 * rng.standard_normal((1, L))).astype(np.float32)
        sig = np.full((1, 1), 0.3, np.float32)
        tden = tm.fused_denoiser(TEDM.from_config(args))
        xt = _t(x).requires_grad_(True)
        out = tden(xt, _t(sig))
        (gx,) = torch.autograd.grad((out * out).sum(), xt)
        jden = jm.fused_denoiser(v, JEDM.from_config(args))
        ref, pull = jax.vjp(jax.jit(lambda xx: jden(xx, jnp.asarray(sig))),
                            jnp.asarray(x))
        e_out = _l2(out.detach().numpy(), ref)
        assert e_out <= CHAIN_L2
        assert _l2(gx.numpy(), pull(2.0 * ref)[0]) <= CHAIN_L2
        tm.net.set_precision(None)
        exact = tden(_t(x), _t(sig)).numpy()
        assert _l2(out.detach().numpy(), exact) > 5 * e_out
    finally:
        tm.net.set_precision(None)


def _grad_map(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_qat_step_gradients_match_jax_trainer(tmp_path, rng, monkeypatch):
    """One training step under BABE_PRECISION=int8 (the JAX package's
    unfused int8 on this CPU; the port with BABE_INT8_FUSED=0 and, as in a
    process where an int8 load set it, BABE_INT8_BWD=1, which the step's
    exact_backward() overrides): the loss and every parameter's gradient
    against jax.value_and_grad of the JAX loss inside its exact_backward(),
    on the same weights, sigma and noise; the int8 forward is engaged (the
    gradients differ from the exact network's by far more)."""
    _env(monkeypatch, dict(JAX_API))
    ov = TINY + [f"model_dir={tmp_path}", "exp.batch=2", "exp.seed=3",
                 "exp.resume=false", "tester.do_test=false",
                 "logging.save_model=false"]
    targs = tconfig(ov)
    tm = TModel.from_config(targs)
    tr = TTrainer(targs, None, tm, TEDM.from_config(
        targs, cqt_hpf=tm.apply_hpf_DC), device="cpu")
    assert tm.net.precision == "int8"
    assert any(b.unfused_int8 for b in tm.net.modules()
               if isinstance(b, tb.ResnetBlock))
    p, b = to_flax(tm.net)
    p = _opened(p, 0.2)
    load_flax(tm.net, p, b)
    sigma = np.full((2, 1), 0.2, np.float32)
    noise = (rng.standard_normal((2, L)) * sigma).astype(np.float32)
    x = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    loss, grads, _, _ = tr._grads(_t(x), _t(sigma), _t(noise))
    tm.net.set_precision(None)
    _, exact, _, _ = tr._grads(_t(x), _t(sigma), _t(noise))
    jargs = jconfig(ov)
    jm = JModel.from_config(jargs)
    jedm = JEDM.from_config(jargs, cqt_hpf=jm.apply_hpf_DC)
    jedm.sample_ptrain_safe = lambda key, n: jnp.asarray(sigma[:, 0])
    jedm.sample_prior = lambda key, shape, s: jnp.asarray(noise)

    def jloss(pp):
        net = lambda xx, cn: jm.apply(  # noqa: E731
            {"params": pp, "buffers": b}, xx, cn)
        e, _ = jedm.loss_fn(jax.random.PRNGKey(0), net, jnp.asarray(x),
                            use_cqt_DC_correction=False)
        return e.mean()

    with jck.exact_backward():
        jval, jgrads = jax.jit(jax.value_and_grad(jloss))(p)
    _close(float(loss), float(jval), 1e-4)
    ref = _grad_map(jgrads)
    assert set(grads) == set(ref)

    def tree_l2(a):
        num = sum(float(np.sum((a[k].numpy() - ref[k]) ** 2)) for k in ref)
        return (num / sum(float(np.sum(ref[k] ** 2)) for k in ref)) ** 0.5

    err = tree_l2(grads)
    assert err <= GRAD_L2, err
    assert tree_l2(exact) > 5 * err
    top = max(float(np.abs(v).max()) for v in ref.values())
    for k, g in grads.items():
        scale = max(float(np.abs(ref[k]).max()), 1e-6 / GRAD_TOL * top)
        e = float(np.abs(g.numpy() - ref[k]).max())
        assert e <= GRAD_TOL * scale, (k, e, scale)
