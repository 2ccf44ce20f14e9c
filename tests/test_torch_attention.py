"""The port's time attention (``_relative_position_bucket``,
``RelativePositionBias``, ``TimeAttentionBlock`` and the attention branch
of ``ResnetBlock``) against the JAX package, on the same weights: the JAX
variables from ``init``, reseeded with numpy so the 1e-7-initialised gates
(``gate2`` among them) carry signal, cross into the port through the
weight bridge.

Tolerances: the bucketing exactly (integers); everything else in fp32 at
``test_torch_model.py``'s 2e-4 relative to the largest value (summation
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from babe_tpu.config import make_config
from babe_tpu.models import blocks as jb
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu_torch.models import blocks as tb
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.utils.weights import load_flax, to_flax

TOL = 2e-4
AD = {"num_heads": 2, "attn_dropout": 0.0, "bias_qkv": False, "N": 0,
      "rel_pos_num_buckets": 8, "rel_pos_max_distance": 16,
      "use_rel_pos": True, "Nproj": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def _reseed(tree, rng):
    """O(1/sqrt(fan_in)) weights for every leaf, GroupNorm gains around
    1."""
    def leaf(path, v):
        v = np.asarray(v)
        if "gamma" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        fan = int(np.prod(v.shape[:-1])) if v.ndim > 1 else 1
        return (rng.standard_normal(v.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@settings(max_examples=25, deadline=None)
@given(half=st.integers(2, 32), extra=st.integers(1, 400))
def test_relative_position_bucket_matches_jax_exactly(half, extra):
    """Every relative position in -300..300 (past max_distance too) lands
    in JAX's bucket, for num_buckets 4..64 and max_distance above a
    quarter of them."""
    num_buckets = 2 * half
    max_distance = num_buckets // 4 + extra
    rel = np.arange(-300, 301)
    want = np.asarray(jb._relative_position_bucket(
        jnp.asarray(rel, jnp.int32), num_buckets, max_distance))
    got = tb._relative_position_bucket(torch.as_tensor(rel), num_buckets,
                                       max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < num_buckets


@pytest.mark.parametrize("shape,ad", [
    ((2, 16, 12, 8), AD),
    ((1, 24, 7, 6), dict(AD, bias_qkv=True, num_heads=3)),
    ((2, 16, 9, 8), dict(AD, use_rel_pos=False)),
])
def test_time_attention_block_matches_jax(rng, shape, ad):
    """TimeAttentionBlock alone (F = Fdim), forward and input gradient."""
    x = rng.standard_normal(shape).astype(np.float32)
    F, C = shape[1], shape[3]
    jblk = jb.TimeAttentionBlock(ad, F)
    params = _reseed(jax.tree.map(np.asarray, jblk.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"], rng)
    tblk = tb.TimeAttentionBlock(ad, F, C)
    load_flax(tblk, params)
    xt = torch.as_tensor(x).requires_grad_(True)
    out = tblk(xt)
    jp = jax.tree.map(jnp.asarray, params)
    jout, pull = jax.vjp(lambda xx: jblk.apply({"params": jp}, xx),
                         jnp.asarray(x))
    _close(out.detach().numpy(), jout)
    g = rng.standard_normal(out.shape).astype(np.float32)
    (dx,) = torch.autograd.grad(out, xt, torch.as_tensor(g))
    _close(dx.numpy(), pull(jnp.asarray(g))[0])


def _tiny_args(attention):
    return make_config({
        "exp": {"sample_rate": 22050, "audio_len": 4096},
        "network": {
            "use_fencoding": False, "use_norm": True, "emb_dim": 32,
            "Ns": [8, 8, 16], "num_dils": [1, 1, 2],
            "cqt": {"window": "kaiser", "beta": 1, "num_octs": 3,
                    "bins_per_oct": 8},
            "num_bottleneck_layers": 1, "attention_layers": attention,
            "attention_dict": AD}})


@pytest.fixture(scope="module")
def tiny_attention():
    """The tiny network with attention_layers [0, 1, 1, 1] in both
    packages, on the same reseeded weights."""
    args = _tiny_args([0, 1, 1, 1])
    jm = JModel.from_config(args)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), batch=2))
    params = _reseed(v["params"], np.random.default_rng(7))
    tm = TModel.from_config(args).init(seed=0, device="cpu")
    load_flax(tm.net, params, v["buffers"])
    return jm, {"params": params, "buffers": v["buffers"]}, tm


def test_tiny_network_with_attention_matches_jax(tiny_attention, rng):
    """The full forward (CQT -> U-Net with attention on levels 1, 2 and the
    bottleneck -> CQT^-1) and its gradient with respect to the input."""
    jm, v, tm = tiny_attention
    assert sum(isinstance(m, tb.TimeAttentionBlock)
               for m in tm.net.modules()) == 5
    tm.net.requires_grad_(False)
    x = (0.1 * rng.standard_normal((2, 4096))).astype(np.float32)
    cn = np.asarray([[-0.5], [0.25]], np.float32)
    jv = jax.tree.map(jnp.asarray, v)

    def jloss(xx):
        y = jm.apply(jv, xx, jnp.asarray(cn))
        return jnp.sum(y**2), y

    (_, jout), jdx = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    out = tm.apply(xt, torch.as_tensor(cn))
    _close(out.detach().numpy(), jout)
    (dx,) = torch.autograd.grad((out * out).sum(), xt)
    _close(dx.numpy(), jdx)


def test_attention_params_round_trip_the_bridge(tiny_attention):
    """to_flax(load_flax(p)) gives back the JAX tree, attention included,
    with the flax names."""
    _, v, tm = tiny_attention
    params, buffers = to_flax(tm.net)
    flat = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_leaves_with_path(params)}
    want = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_leaves_with_path(v["params"])}
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    for name in ("['downs_1_2']['attn_block']['qk']['conv']['kernel']",
                 "['middle_0_1']['attn_block']['rel_pos']"
                 "['relative_attention_bias']",
                 "['ups_0_1']['gate2']['kernel']",
                 "['downs_2_2']['norm2']['gamma']"):
        assert name in flat, name
