"""The port's library API on a checkpoint written by the JAX package: load,
blind and informed ``enhance``, ``estimate_filter``, ``generate``, the
errors of what this slice does not serve yet, and the port's independence
from JAX (no module of jax or babe_tpu is imported or named)."""

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
          "tester.blind_bwe.NFFT=512"]


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


def test_what_this_slice_does_not_serve_raises(model, ckpt):
    with pytest.raises(NotImplementedError):
        model.enhance(_audio(5000), 22050)  # longer than one segment
    with pytest.raises(NotImplementedError):
        model.enhance(_audio(4000), 44100)  # foreign sample rate
    with pytest.raises(NotImplementedError):
        model.enhance(_audio(4000), 22050, denoise=True)
    with pytest.raises(NotImplementedError):
        BABE.load(ckpt, overrides=TESTER, precision="int8", device="cpu")
    with pytest.raises(NotImplementedError):
        BABE.load("weights.pt", device="cpu")


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
    code = ("import sys, babe_tpu_torch.api, babe_tpu_torch.kernels; "
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
