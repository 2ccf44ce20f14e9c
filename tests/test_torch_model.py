"""The port's CQTDiff+ network against the JAX package on the same weights:
the JAX variables (from ``CQTDiffPlus.init``, then reseeded with numpy so
the 1e-7-initialised gates carry signal) cross into the port through the
weight bridge.  The JAX side runs its XLA path (the unfused dilation loop);
the port always runs the fused-chain form, so these tests also hold the
fused chain's GroupNorm-from-moments algebra to the plain loop.

Tolerances: fp32 at 2e-4 relative to the largest value (summation order);
bf16 as a relative L2 error of 3e-2 (every block re-rounds to bf16, and
rounding flips compound across a block's seven stages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_args
from babe_tpu.diffusion.edm import EDM as JEDM
from babe_tpu.models import blocks as jb
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu_torch.diffusion.edm import EDM as TEDM
from babe_tpu_torch.models import blocks as tb
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.utils.weights import from_flax, load_flax, to_flax

TOL = 2e-4
BF16_L2 = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
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


def reseed(tree, rng):
    """Numpy weights of O(1/sqrt(fan_in)) for every leaf; GroupNorm gains
    around 1."""
    def leaf(path, v):
        v = np.asarray(v)
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        fan = int(np.prod(v.shape[:-1])) if v.ndim > 1 else 1
        return (rng.standard_normal(v.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.mark.parametrize("T", [20, 13])
def test_resnet_block_53_fused_chain_matches_jax(rng, T):
    B, F, N, E = 2, 32, 16, 32
    x = rng.standard_normal((B, F, T, 8)).astype(np.float32)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    jblk = jb.ResnetBlock(8, N, True, num_dils=3, emb_dim=E, Fdim=F)
    params = reseed(_np_tree(jblk.init(jax.random.PRNGKey(0), x, emb))[
        "params"], rng)
    tblk = tb.ResnetBlock(8, N, True, num_dils=3, emb_dim=E, Fdim=F)
    load_flax(tblk, params)
    tblk.requires_grad_(False)

    @jax.jit
    def jf(xx):
        return jblk.apply({"params": params}, xx, jnp.asarray(emb))

    xt = torch.as_tensor(x).requires_grad_(True)
    out = tblk(xt, torch.as_tensor(emb))
    _close(out.detach().numpy(), jf(jnp.asarray(x)))
    g = rng.standard_normal(out.shape).astype(np.float32)
    (dx,) = torch.autograd.grad(out, xt, torch.as_tensor(g))
    _, pull = jax.vjp(jf, jnp.asarray(x))
    _close(dx.numpy(), pull(jnp.asarray(g))[0])


def test_resnet_block_11_proj_after_matches_jax(rng):
    B, F, T, E = 2, 16, 12, 32
    x = rng.standard_normal((B, F, T, 24)).astype(np.float32)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    kw = dict(use_norm=True, num_dils=1, kernel_size=(1, 1), emb_dim=E,
              proj_place="after")
    jblk = jb.ResnetBlock(24, 2, **kw)
    params = reseed(_np_tree(jblk.init(jax.random.PRNGKey(1), x, emb))[
        "params"], rng)
    tblk = tb.ResnetBlock(24, 2, **kw)
    load_flax(tblk, params)
    out = tblk(torch.as_tensor(x), torch.as_tensor(emb)).detach().numpy()
    _close(out, jblk.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(emb)))


def test_flagship_width_block_bf16_matches_jax(rng):
    """One flagship-width block (128 -> 256 channels, 7 dilations, bf16
    compute over fp32 weights) on a short length."""
    B, F, T, E = 1, 64, 16, 256
    x = rng.standard_normal((B, F, T, 128)).astype(np.float32)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    jblk = jb.ResnetBlock(128, 256, True, num_dils=7, emb_dim=E, Fdim=F)
    params = reseed(_np_tree(jblk.init(jax.random.PRNGKey(2), x, emb))[
        "params"], rng)
    tblk = tb.ResnetBlock(128, 256, True, num_dils=7, emb_dim=E, Fdim=F)
    load_flax(tblk, params)
    tblk.requires_grad_(False)
    ref = jax.jit(jblk.apply)({"params": params},
                              jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(emb, jnp.bfloat16))
    out = tblk(torch.as_tensor(x).bfloat16(), torch.as_tensor(emb).bfloat16())
    assert out.dtype == torch.bfloat16
    assert _l2(out.float().numpy(), ref.astype(jnp.float32)) < BF16_L2


@pytest.mark.parametrize("up", [False, True])
def test_resample_time_matches_jax(rng, up):
    x = rng.standard_normal((2, 3, 16, 5)).astype(np.float32)
    _close(tb.resample_time(torch.as_tensor(x), up).numpy(),
           jb.resample_time(jnp.asarray(x), up), tol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    """Tiny config (__graft_entry__._flagship_args(tiny=True)), reseeded
    JAX weights, both models."""
    rng = np.random.default_rng(7)
    args = _flagship_args(audio_len=4096, tiny=True)
    jm = JModel.from_config(args)
    v = _np_tree(jm.init(jax.random.PRNGKey(0)))
    v = {"params": reseed(v["params"], rng), "buffers": v["buffers"]}
    tm = TModel.from_config(args)
    load_flax(tm.net, v["params"], v["buffers"])
    tm.net.requires_grad_(False)
    return args, jm, v, tm


def test_weight_bridge_round_trip(tiny):
    _, _, v, tm = tiny
    p, b = to_flax(tm.net)
    for src, back in ((v["params"], p), (v["buffers"], b)):
        flat_a = jax.tree_util.tree_leaves_with_path(src)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for k, val in flat_a:
            np.testing.assert_array_equal(val, flat_b[k])
    assert set(from_flax(v["params"], v["buffers"])) == set(
        tm.net.state_dict())


def test_model_apply_and_fused_denoiser_match_jax(tiny, rng):
    args, jm, v, tm = tiny
    x = (0.1 * rng.standard_normal((1, 4096))).astype(np.float32)
    cn = np.full((1, 1), -0.4, np.float32)
    _close(tm.apply(torch.as_tensor(x), torch.as_tensor(cn)).numpy(),
           jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(cn)))
    jden = jm.fused_denoiser(v, JEDM.from_config(args))
    tden = tm.fused_denoiser(TEDM.from_config(args))
    sig = np.full((1, 1), 0.3, np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    out = tden(xt, torch.as_tensor(sig))
    ref, pull = jax.vjp(jax.jit(lambda xx: jden(xx, jnp.asarray(sig))),
                        jnp.asarray(x))
    _close(out.detach().numpy(), ref)
    g = rng.standard_normal(x.shape).astype(np.float32)
    (dx,) = torch.autograd.grad(out, xt, torch.as_tensor(g))
    _close(dx.numpy(), pull(jnp.asarray(g))[0])


def test_freq_encoding_and_rff_embedding_match_jax(rng):
    """The two RFF modules, with their buffers crossing the bridge."""
    x = rng.standard_normal((2, 8, 5, 2)).astype(np.float32)
    jenc = jb.AddFreqEncodingRFF(8, 32)
    v = _np_tree(jenc.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    tenc = tb.AddFreqEncodingRFF(8, 32)
    load_flax(tenc, {}, v["buffers"])
    _close(tenc(torch.as_tensor(x)).numpy(), jenc.apply(v, jnp.asarray(x)))
    sig = rng.standard_normal((2, 1)).astype(np.float32)
    jmlp = jb.RFF_MLP_Block(emb_dim=32)
    v = _np_tree(jmlp.init(jax.random.PRNGKey(4), jnp.asarray(sig)))
    v = {"params": reseed(v["params"], rng), "buffers": v["buffers"]}
    tmlp = tb.RFF_MLP_Block(emb_dim=32)
    load_flax(tmlp, v["params"], v["buffers"])
    _close(tmlp(torch.as_tensor(sig)).detach().numpy(),
           jmlp.apply(v, jnp.asarray(sig)))


def test_attention_raises_not_ported():
    """Attention is ported (tests/test_torch_attention.py): a block with a
    full attention_dict builds the gated attention branch, and one that
    lacks the relative-position keys that use_rel_pos needs raises
    KeyError naming the key, as the JAX module does."""
    with pytest.raises(KeyError, match="rel_pos_num_buckets"):
        tb.ResnetBlock(8, 8, attention_dict={"num_heads": 2})
    blk = tb.ResnetBlock(8, 8, attention_dict={
        "num_heads": 2, "rel_pos_num_buckets": 8,
        "rel_pos_max_distance": 16}, Fdim=16)
    assert isinstance(blk.attn_block, tb.TimeAttentionBlock)
    assert {"affine2", "gate2", "norm2"} <= set(dict(blk.named_children()))
