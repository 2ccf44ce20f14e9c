"""K4, the port's general dilated conv (``babe_tpu_torch/ops/pallas_conv``),
against the JAX package: on the CPU ``dilated_conv_nhwc`` runs its plain
version ``conv_ref`` and its gradient (dx through the flipped kernel, dw
through ``conv_dw_ref``), held to the JAX ``dilated_conv_nhwc`` in interpret
mode (the Pallas kernel), to ``jax.grad`` of it, and to the XLA reference
``_conv_ref`` at kernels and dilations the TPU kernel does not tile.  Also
``Conv2d``'s dispatch and a ``ResnetBlock(kernel_size=(3,3))``, whose
dilation loop runs on K4.

Tolerances: fp32 at 2e-4 relative to the largest value (summation order;
the JAX package's own bar between its kernels and XLA); bf16 as a relative
L2 error of 2e-2 (both sides round the output to bf16 from fp32 sums taken
in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.models import blocks as jb
from babe_tpu.ops.pallas_conv import _conv_ref as jconv_ref
from babe_tpu.ops.pallas_conv import dilated_conv_nhwc as jdilated
from babe_tpu_torch import kernels
from babe_tpu_torch.models import blocks as tb
from babe_tpu_torch.ops import pallas_conv as tpc
from babe_tpu_torch.utils.weights import load_flax

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


def _inputs(rng, B, F, T, C, N, kf, kt):
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((kf, kt, C, N))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("df", [1, 2, 4])
def test_k4_matches_interpreted_kernel_and_xla(rng, df):
    """tests/test_pallas_conv.py's forward cases."""
    x, w = _inputs(rng, 2, 16, 64, 8, 8, 5, 3)
    out = tpc.dilated_conv_nhwc(torch.as_tensor(x), torch.as_tensor(w),
                                (df, 1)).numpy()
    _close(out, jdilated(jnp.asarray(x), jnp.asarray(w), (df, 1), True))
    _close(out, jconv_ref(jnp.asarray(x), jnp.asarray(w), (df, 1)))


def _grads_port(x, w, dil):
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    (tpc.dilated_conv_nhwc(xt, wt, dil) ** 2).sum().backward()
    return xt.grad.numpy(), wt.grad.numpy()


def test_k4_grads_match_jax_grad_of_interpreted_kernel(rng):
    """tests/test_pallas_conv.py's gradient case: dx and dw of
    sum(conv(x, w)^2) against jax.grad through the Pallas kernel's vjp."""
    x, w = _inputs(rng, 1, 8, 32, 8, 8, 5, 3)
    gx, gw = _grads_port(x, w, (2, 1))
    jgx, jgw = jax.grad(
        lambda xx, ww: jnp.sum(jdilated(xx, ww, (2, 1), True) ** 2),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(gx, jgx)
    _close(gw, jgw)


@pytest.mark.parametrize("kf,kt,dil,shape", [
    (3, 3, (1, 1), (2, 12, 10, 6, 5)),
    (7, 5, (2, 1), (1, 20, 13, 4, 6)),
    (3, 3, (2, 2), (2, 9, 17, 5, 3)),
    (5, 3, (1, 2), (1, 16, 11, 3, 7)),
])
def test_k4_other_kernels_and_dilations_match_xla(rng, kf, kt, dil, shape):
    """Kernels and dilations (dt = 2) the TPU kernel hands to XLA, at
    ragged F, T and C: forward, dx and dw against _conv_ref and its vjp."""
    B, F, T, C, N = shape
    x, w = _inputs(rng, B, F, T, C, N, kf, kt)
    out = tpc.dilated_conv_nhwc(torch.as_tensor(x), torch.as_tensor(w),
                                dil).numpy()
    ref, pull = jax.vjp(lambda xx, ww: jconv_ref(xx, ww, dil),
                        jnp.asarray(x), jnp.asarray(w))
    _close(out, ref)
    g = rng.standard_normal(out.shape).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    tpc.dilated_conv_nhwc(xt, wt, dil).backward(torch.as_tensor(g))
    rdx, rdw = pull(jnp.asarray(g))
    _close(xt.grad.numpy(), rdx)
    _close(wt.grad.numpy(), rdw)


def test_k4_bf16_matches_xla(rng):
    x, w = _inputs(rng, 1, 16, 24, 16, 16, 3, 3)
    out = tpc.dilated_conv_nhwc(torch.as_tensor(x).bfloat16(),
                                torch.as_tensor(w).bfloat16(), (2, 1))
    assert out.dtype == torch.bfloat16
    ref = jconv_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                    (2, 1))
    assert _l2(out.float().numpy(), ref.astype(jnp.float32)) < BF16_L2


def test_k4_only_input_grad_when_the_weight_is_frozen(rng):
    """dw is not formed when the weight needs no gradient, dx not when the
    input needs none."""
    x, w = _inputs(rng, 1, 8, 8, 4, 4, 3, 3)
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w)
    tpc.dilated_conv_nhwc(xt, wt, (1, 1)).sum().backward()
    assert xt.grad is not None and wt.grad is None
    xt, wt = torch.as_tensor(x), torch.as_tensor(w).requires_grad_(True)
    tpc.dilated_conv_nhwc(xt, wt, (1, 1)).sum().backward()
    assert wt.grad is not None and xt.grad is None


def test_conv2d_dispatch(monkeypatch):
    """(1,1) is a matmul, (5,3) with dt = 1 K1, every other odd kernel K4;
    even kernels are refused."""
    seen = []
    real = tb.dilated_conv_nhwc

    def spy(x, w, dil):
        seen.append((tuple(w.shape[:2]), dil))
        return real(x, w, dil)

    monkeypatch.setattr(tb, "dilated_conv_nhwc", spy)
    x = torch.zeros((1, 8, 6, 4))
    for k, d in (((1, 1), (1, 1)), ((5, 3), (2, 1)), ((5, 3), (1, 2)),
                 ((3, 3), (4, 1)), ((7, 1), (1, 1))):
        c = tb.Conv2d(4, 3, k, dilation=d)
        c.reset_parameters(torch.Generator().manual_seed(0))
        assert c(x).shape == (1, 8, 6, 3)
    assert seen == [((5, 3), (1, 2)), ((3, 3), (4, 1)), ((7, 1), (1, 1))]
    with pytest.raises(NotImplementedError):
        tb.Conv2d(4, 3, (4, 3))


def _reseed(tree, rng):
    def leaf(path, v):
        v = np.asarray(v)
        if "gamma" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        fan = int(np.prod(v.shape[:-1])) if v.ndim > 1 else 1
        return (rng.standard_normal(v.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_resnet_block_3x3_matches_jax(rng):
    """A (3,3) ResnetBlock runs its dilation loop on K4: output, input
    gradient and every parameter's gradient against JAX (gates opened by
    the reseed)."""
    B, F, T, E = 2, 16, 12, 32
    x = rng.standard_normal((B, F, T, 8)).astype(np.float32)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    kw = dict(use_norm=True, num_dils=3, kernel_size=(3, 3), emb_dim=E,
              Fdim=F)
    jblk = jb.ResnetBlock(8, 16, **kw)
    params = _reseed(jax.tree.map(np.asarray, jblk.init(
        jax.random.PRNGKey(0), x, emb))["params"], rng)
    tblk = tb.ResnetBlock(8, 16, **kw)
    load_flax(tblk, params)
    xt = torch.as_tensor(x).requires_grad_(True)
    out = tblk(xt, torch.as_tensor(emb))

    def f(pp, xx):
        return jblk.apply({"params": pp}, xx, jnp.asarray(emb))

    ref, pull = jax.vjp(f, params, jnp.asarray(x))
    _close(out.detach().numpy(), ref)
    g = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.as_tensor(g))
    gp, gx = pull(jnp.asarray(g))
    _close(xt.grad.numpy(), gx)
    flat = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(gp)}
    for name, p in tblk.named_parameters():
        key = "".join(f"['{s}']" for s in name.split("."))
        _close(p.grad.numpy(), flat[key])


def test_k4_launchers_refuse_cpu_tensors():
    x = torch.zeros((1, 8, 8, 4))
    with pytest.raises(ValueError):
        kernels.launch_dilated_conv(x, torch.zeros((3, 3, 4, 4)), (1, 1))
    with pytest.raises(ValueError):
        kernels.launch_conv_dw(x, x, (3, 3), (1, 1))
    with pytest.raises(ValueError):
        kernels.launch_fused_stage_dw(x, torch.ones((1, 4)), torch.ones((1, 4)),
                                      x, x, torch.zeros((2, 1, 4)), 1)


def test_k4_on_the_cpu_counts_nothing(rng):
    kernels.reset_launch_counts()
    x, w = _inputs(rng, 1, 8, 8, 4, 4, 3, 3)
    _grads_port(x, w, (1, 2))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
