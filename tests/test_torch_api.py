"""The port's library API on a checkpoint written by the JAX package: load,
blind and informed ``enhance`` (one segment, long inputs through the chunk
loop, a foreign sample rate, the denoiser chain), ``estimate_filter``,
``generate``, the tester cache, the errors of what the port does not serve
yet, and the port's independence from JAX (no module of jax or babe_tpu is
imported or named)."""

import os
import pathlib
import pickle
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu_torch.api import BABE

ROOT = pathlib.Path(__file__).resolve().parents[1]
NET = ["exp.audio_len=4096", "exp.use_bf16=false", "network.Ns=[8,8,16]",
       "network.num_dils=[1,1,2]", "network.emb_dim=32",
       "network.attention_layers=[0,0,0,0]", "network.cqt.num_octs=3",
       "network.cqt.bins_per_oct=8"]
TESTER = ["tester.T=2", "tester.blind_bwe.optimization.max_iter=3",
          "tester.blind_bwe.initial_conditions.fc=[300]",
          "tester.blind_bwe.initial_conditions.A=[-20]",
          "tester.blind_bwe.NFFT=512",
          "tester.complete_recording.overlap=0.02"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny checkpoint as the JAX trainer writes it (numpy trees + args)."""
    path = tmp_path_factory.mktemp("api") / "tiny.ckpt"
    args = jconfig(NET)
    v = jax.tree.map(np.asarray, JModel.from_config(args).init(
        jax.random.PRNGKey(0)))
    with open(path, "wb") as f:
        pickle.dump({"it": 7, "params": v["params"], "buffers": v["buffers"],
                     "ema": v["params"], "args": args.to_dict()}, f)
    return str(path)


@pytest.fixture(scope="module")
def model(ckpt):
    return BABE.load(ckpt, overrides=TESTER, device="cpu")


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.05 * np.sin(2 * np.pi * 330 * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_load_adopts_checkpoint_config(model):
    assert model.device == torch.device("cpu")
    assert model._tester.it == 7
    assert tuple(model.args.network.Ns) == (8, 8, 16)
    assert model._tester.audio_len == 4096


def test_blind_enhance_returns_finite_segment(model):
    x = _audio(3000)
    out, info = model.enhance(x, 22050, seed=0)
    assert out.shape == (1, 3000) and np.isfinite(out).all()
    assert info["fs"] == 22050
    assert info["fc"].shape == (1,) and info["A"].shape == (1,)
    assert np.isfinite(info["fc"]).all() and np.isfinite(info["A"]).all()


def test_informed_enhance_and_estimate_filter(model):
    x = _audio(4096, seed=1)
    out, info = model.enhance(x, 22050, filter=(1000.0, -40.0), seed=1)
    assert out.shape == (1, 4096) and np.isfinite(out).all()
    assert float(info["fc"][0]) == 1000.0
    fc, A = model.estimate_filter(x, 22050, seed=2)
    assert fc.shape == (1,) and A.shape == (1,) and A[0] < 0


def test_generate_is_finite_and_seeded(model):
    a = model.generate(n=1, seed=3)
    b = model.generate(n=1, seed=3)
    assert a.shape == (1, 4096) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_what_this_slice_does_not_serve_raises(model, ckpt, tmp_path):
    with pytest.raises(ValueError):
        BABE.load(ckpt, overrides=TESTER, precision="fp8", device="cpu")
    # reference .pt checkpoints load now (tests/test_torch_pt_ckpt.py); a
    # missing one is named, and a file that is no torch pickle is refused
    with pytest.raises(FileNotFoundError, match="weights.pt"):
        BABE.load("weights.pt", device="cpu")
    pt = tmp_path / "denoiser.pt"
    pt.write_bytes(b"a reference torch checkpoint")
    with pytest.raises(pickle.UnpicklingError):
        BABE.load(ckpt, overrides=TESTER, denoiser_checkpoint=str(pt),
                  device="cpu")
    with pytest.raises(ValueError, match="denoiser_checkpoint"):
        model.enhance(_audio(4000), 22050, denoise=True)


def test_enhance_long_ar_path(model):
    x = _audio(10000, seed=4)  # > audio_len: the chunk loop
    out, info = model.enhance(x, 22050, filter=(600.0, -25.0), seed=4)
    assert out.shape == (1, 10000) and np.isfinite(out).all()
    out, info = model.enhance(x, 22050, seed=5)  # blind, then the loop
    assert out.shape == (1, 10000) and np.isfinite(out).all()
    assert np.isfinite(info["fc"]).all() and np.isfinite(info["A"]).all()


def test_enhance_resamples_input(model):
    x = 0.05 * np.random.default_rng(3).standard_normal(2000).astype(
        np.float32)
    out, info = model.enhance(x, 44100, filter=(500.0, -20.0), seed=5)
    assert out.shape == (1, 1000) and np.isfinite(out).all()
    assert info["fs"] == 22050


def test_enhance_with_denoiser_chain(ckpt, tmp_path):
    from babe_tpu_torch.models.denoiser import MultiStageDenoiser
    from babe_tpu_torch.utils.weights import denoiser_to_flax

    den = MultiStageDenoiser(depth=2, num_tfc=2, num_stages=2, f_dim=65,
                             stft_win_size=128, stft_hop_size=32,
                             segment_seconds=0.2, seed=1, device="cpu")
    dpath = tmp_path / "den.ckpt"
    with open(dpath, "wb") as f:
        pickle.dump({"params": denoiser_to_flax(den.net)}, f)
    m = BABE.load(ckpt, overrides=TESTER + [
        "tester.denoiser.depth=2", "tester.denoiser.num_tfc=2",
        "tester.denoiser.num_stages=2", "tester.denoiser.f_dim=65",
        "tester.denoiser.stft_win_size=128",
        "tester.denoiser.stft_hop_size=32",
        "tester.denoiser.segment_size=0.2"],
        denoiser_checkpoint=str(dpath), device="cpu")
    x = _audio(3000, seed=6)
    out, info = m.enhance(x, 22050, filter=(700.0, -25.0), denoise=True,
                          seed=6)
    assert out.shape == (1, 3000) and np.isfinite(out).all()
    plain, _ = m.enhance(x, 22050, filter=(700.0, -25.0), seed=6)
    assert not np.allclose(out, plain)  # the denoiser ran first


def test_denoise_without_denoiser_raises(model):
    with pytest.raises(ValueError):
        model.enhance(np.zeros(1000, np.float32), 22050, denoise=True)


def test_tester_cache_is_bounded(model):
    """An LRU cache of testers by length; the native length is pinned."""
    native = int(model.args.exp.audio_len)
    for L in (native + 256, native + 512, native + 768, native + 1024):
        model._tester_at(L)
    assert len(model._testers) <= model._testers_maxsize
    assert native in model._testers
    assert native + 1024 in model._testers
    assert native + 256 not in model._testers


def test_mismatched_checkpoint_names_parameters(ckpt):
    with pytest.raises(ValueError, match="shape mismatch"):
        BABE.load(ckpt, overrides=TESTER + ["network.Ns=[8,8,24]"],
                  device="cpu")


def test_default_device_is_the_card(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        BABE.load(ckpt, overrides=TESTER)


def test_import_leaves_jax_and_babe_tpu_out():
    code = ("import sys, babe_tpu_torch.api, babe_tpu_torch.kernels, "
            "babe_tpu_torch.models.denoiser; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'babe_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b"
                     r"|babe_tpu\.")
    files = sorted((ROOT / "babe_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    hits = []
    for p in files:
        for line in p.read_text().splitlines():
            if pat.search(line.replace("babe_tpu_torch", "")):
                hits.append(f"{p.relative_to(ROOT)}: {line.strip()}")
    assert not hits, hits
