"""The port's MultiStage STFT denoiser against the JAX package on the same
weights: the JAX ``init`` weights cross into the port through the weight
bridge (``load_denoiser_flax``), at small widths (depth 2 and 3, two dense
layers, 65 bins, a 128-sample window, 0.2 s segments).

Tolerances are the JAX package's own denoiser parity bar
(``tests/test_denoiser_parity.py``): atol 2e-4 on the network's output and
1e-3 relative to the largest value on the audio."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.models.denoiser import MultiStageDenoiser as JDenoiser
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.models.denoiser import MultiStageDenoiser as TDenoiser
from babe_tpu_torch.models.denoiser import setup_denoiser
from test_torch_pt_ckpt import reference_state_dict

from babe_tpu_torch.utils.weights import (
    denoiser_from_flax,
    denoiser_to_flax,
    load_denoiser_flax,
)

FS = 22050
NET_ATOL = 2e-4
AUDIO_TOL = 1e-3
SMALL = dict(num_tfc=2, use_fencoding=True, use_SAM=True, f_dim=65, fs=FS,
             stft_win_size=128, stft_hop_size=32, segment_seconds=0.2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(depth, num_stages, seed=1):
    """A JAX denoiser with its init weights and the port's with the same."""
    jd = JDenoiser(depth=depth, num_stages=num_stages, **SMALL)
    params = jax.tree.map(np.asarray,
                          jd.init(jax.random.PRNGKey(seed))["params"])
    td = TDenoiser(depth=depth, num_stages=num_stages, device="cpu",
                   **SMALL)
    load_denoiser_flax(td.net, params)
    return jd, {"params": params}, td


@pytest.fixture(scope="module")
def pair2():
    return _pair(2, 2)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


@pytest.mark.parametrize("depth,num_stages", [(3, 1), (3, 2), (2, 2)])
def test_net_forward_matches(depth, num_stages, rng):
    """The network on a (B, frames, bins, 2) spectrum (the port's NCHW is
    the same tensor transposed); two stages return (pred2, pred1)."""
    jd, v, td = _pair(depth, num_stages)
    x = rng.standard_normal((2, 37, 65, 2)).astype(np.float32)
    ref = jd.net.apply(v, jnp.asarray(x))
    out = td.net(torch.as_tensor(x).permute(0, 3, 1, 2))
    if num_stages == 1:
        ref, out = (ref,), (out,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        o = o.permute(0, 2, 3, 1).numpy()
        assert o.shape == r.shape
        np.testing.assert_allclose(o, np.asarray(r), atol=NET_ATOL, rtol=0)


def test_apply_model_matches(pair2, rng):
    jd, v, td = pair2
    x = (0.1 * rng.standard_normal((1, 3000))).astype(np.float32)
    ref = jd.apply_model(v, jnp.asarray(x))
    out = td.apply_model(torch.as_tensor(x))
    assert out.shape == (1, 3000)
    _close(out.numpy(), ref, AUDIO_TOL)


@pytest.mark.parametrize("chunks", [0.6, 2.5, "edge"])
def test_apply_chunked_ola_matches(pair2, rng, chunks):
    """One chunk, 2.5 chunks, and an input that ends exactly at a chunk
    edge (two full strides of seg - 1024, then one whole segment)."""
    jd, v, td = pair2
    seg = td.segment
    assert seg == jd.segment
    L = (2 * (seg - 1024) + seg if chunks == "edge"
         else int(chunks * seg))
    x = (0.1 * rng.standard_normal((1, L))).astype(np.float32)
    ref = jd.apply_chunked_ola(v, jnp.asarray(x))
    out = td.apply_chunked_ola(torch.as_tensor(x))
    assert out.shape == (1, L)
    _close(out.numpy(), ref, AUDIO_TOL)


def test_bridge_round_trip_is_exact(pair2):
    """JAX params -> the port -> JAX params, bit for bit; the frequency
    embedding crosses as a learned parameter."""
    _, v, td = pair2
    back = denoiser_to_flax(td.net)
    flat_in = jax.tree_util.tree_leaves_with_path(v["params"])
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)
    sd = denoiser_from_flax(v["params"])
    assert "freq_encoding_fembeddings" in dict(td.net.named_parameters())
    assert sd["freq_encoding_fembeddings"].shape == (65, 10)


def test_setup_denoiser_loads_ckpt_and_refuses_pt(pair2, tmp_path, capsys):
    _, v, td = pair2
    ov = ["tester.denoiser.depth=2", "tester.denoiser.num_tfc=2",
          "tester.denoiser.f_dim=65", "tester.denoiser.stft_win_size=128",
          "tester.denoiser.stft_hop_size=32",
          "tester.denoiser.segment_size=0.2"]
    path = tmp_path / "den.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"params": v["params"]}, f)
    args = tconfig(ov + [f"tester.denoiser.checkpoint_path={path}"])
    den = setup_denoiser(args, device="cpu")
    x = torch.as_tensor(np.linspace(-0.1, 0.1, 2000, dtype=np.float32))[None]
    torch.testing.assert_close(den.apply_model(x), td.apply_model(x),
                               rtol=0, atol=0)
    # a reference .pt is no longer refused: it loads the same weights
    # (tests/test_torch_pt_ckpt.py holds it to the JAX setup_denoiser)
    pt = tmp_path / "den.pt"
    torch.save({"network": reference_state_dict(v["params"])}, pt)
    den_pt = setup_denoiser(
        tconfig(ov + [f"tester.denoiser.checkpoint_path={pt}"]),
        device="cpu")
    torch.testing.assert_close(den_pt.apply_model(x), den.apply_model(x),
                               rtol=0, atol=0)
    # a missing path warns, as the JAX package does, and keeps a seeded init
    missing = str(tmp_path / "absent.ckpt")
    a = setup_denoiser(tconfig(ov + [
        f"tester.denoiser.checkpoint_path={missing}"]), device="cpu")
    assert "not found" in capsys.readouterr().out
    b = setup_denoiser(tconfig(ov + [
        f"tester.denoiser.checkpoint_path={missing}"]), device="cpu")
    torch.testing.assert_close(a.apply_model(x), b.apply_model(x),
                               rtol=0, atol=0)
    # the JAX package reads the same config the same way
    assert JDenoiser.from_config(jconfig(ov).tester.denoiser).segment == (
        den.segment)
