"""The port's evaluation CLI (``python -m babe_tpu_torch.test``) against the
repository's ``test.py``: both ``_main`` functions run in-process on one
``.ckpt`` (the tiny reseeded network of ``tests/test_torch_longform.py``)
over the same test folder and recordings folder, each writing under its
own ``model_dir``.  Here the blind modes (``blind_bwe``,
``real_blind_bwe``, ``mushra``), informed ``bwe`` with the firwin filter
of the shared tester config and ``unconditional``;
``tests/test_torch_test_cli_inverse.py`` and
``tests/test_torch_test_cli_formal.py`` run the other modes through the
same helper.

The two packages draw different noise, so what is compared is what the
noise does not touch:
  * every mode writes the JAX mode's files (the same relative paths under
    ``outputs/`` and the formal-test folder; ``metrics.jsonl`` aside, which
    the JAX tester opens before any mode runs), and every port wav is
    finite;
  * the port's ``metrics.jsonl`` records: as many per mode as JAX's, each
    with every key of the JAX record;
  * the deterministic outputs: the original and degraded wavs (the test
    items' crops, the parametric test filter, the firwin lowpass) within
    one PCM16 step (both write 16-bit wavs of fp32 values that may differ
    in the last bits), ``lsd_degraded`` and ``lsd_high_band_degraded``
    within 1e-4 relative (fp32 STFTs and logs in another order), and the
    informed filter's taps exactly."""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.sampling import degradations as jdeg
from babe_tpu_torch import test as tcli
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.data.wavio import read_wav, write_wav
from babe_tpu_torch.sampling import degradations as tdeg
from test_torch_longform import tiny_weights
from test_torch_sampling import TINY

REPO = pathlib.Path(__file__).resolve().parents[1]
PCM16 = 1.0 / 32767
SEG = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers (these shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli():
    """The repository's test.py as a module (its name would clash with the
    standard library's ``test`` package)."""
    spec = importlib.util.spec_from_file_location("babe_jax_test_cli",
                                                  REPO / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A ``.ckpt`` of the tiny reseeded network, two test items and two
    recordings (3 segments of tones and noise at 22.05 kHz each)."""
    import pickle

    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    for d in ("test", "recs", "formal_in"):
        (tmp / d).mkdir()
    t = np.arange(3 * SEG) / 22050
    for i in range(2):
        x = (0.05 * np.sin(2 * np.pi * (220 + 110 * i) * t)
             + 0.02 * np.sin(2 * np.pi * 3000 * t)
             + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
        for d, name in (("test", f"item{i}"), ("recs", f"rec{i}"),
                        ("formal_in", f"f{i}")):
            write_wav(str(tmp / d / f"{name}.wav"), x, 22050)
    params, buffers = tiny_weights(tconfig(TINY))
    ckpt = tmp / "tiny.ckpt"
    with open(ckpt, "wb") as f:
        pickle.dump({"it": 1, "params": params, "buffers": buffers,
                     "ema": params}, f)
    return tmp


def overrides(tmp, name: str, modes) -> list[str]:
    d = tmp / name
    return TINY + [
        f"model_dir={d}", f"tester.checkpoint={tmp / 'tiny.ckpt'}",
        "dset=musicnet", f"dset.test.path={tmp / 'test'}",
        "dset.test.num_samples=2",
        f"tester.blind_bwe.real_recordings.path={tmp / 'recs'}",
        "tester.blind_bwe.real_recordings.num_samples=2",
        f"tester.formal_test.path={tmp / 'formal_in'}",
        f"tester.formal_test.folder={d / 'formal_out'}",
        "tester.unconditional.audio_len=4096",
        "tester.unconditional.num_samples=2",
        "tester.modes=[" + ",".join(modes) + "]"]


def run_both(tmp, modes, extra=()):
    """Both CLIs' ``_main`` on the same inputs; returns the JAX and the
    port model_dir."""
    _jax_cli()._main(jconfig(overrides(tmp, "jax", modes) + list(extra)))
    ov = overrides(tmp, "port", modes) + list(extra)
    tcli._main(tconfig(ov), device="cpu", overrides=ov)
    return tmp / "jax", tmp / "port"


def files(d: pathlib.Path) -> set[str]:
    return {str(p.relative_to(d)) for p in d.rglob("*")
            if p.is_file() and p.name != "metrics.jsonl"}


def records(d: pathlib.Path) -> list[dict]:
    path = d / "outputs" / "metrics.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()]


def check_files_and_records(jdir, tdir):
    """The same files, finite wavs, the JAX records' keys and count."""
    jf, tf = files(jdir), files(tdir)
    assert jf and tf == jf, (sorted(jf - tf), sorted(tf - jf))
    for rel in tf:
        if rel.endswith(".wav"):
            assert np.isfinite(read_wav(str(tdir / rel))[0]).all(), rel
    jr, tr = records(jdir), records(tdir)
    assert [r["mode"] for r in tr] == [r["mode"] for r in jr]
    for a, b in zip(tr, jr):
        assert set(b) <= set(a), sorted(set(b) - set(a))


def same_wavs(jdir, tdir, folder: str):
    names = sorted(p.name for p in (jdir / "outputs" / folder).glob("*.wav"))
    assert names
    for n in names:
        a, fa = read_wav(str(tdir / "outputs" / folder / n))
        b, fb = read_wav(str(jdir / "outputs" / folder / n))
        assert fa == fb and a.shape == b.shape
        assert np.abs(a - b).max() <= 1.01 * PCM16, (folder, n)


def test_blind_informed_and_unconditional_modes(inputs):
    modes = ["blind_bwe", "real_blind_bwe", "mushra", "bwe", "unconditional"]
    jdir, tdir = run_both(inputs, modes)
    check_files_and_records(jdir, tdir)
    for folder in ("blind_bwe_original", "blind_bwe_degraded",
                   "bwe_original", "bwe_degraded", "mushra_original",
                   "mushra_degraded", "real_blind_bwe_degraded"):
        same_wavs(jdir, tdir, folder)
    jr = [r for r in records(jdir) if r["mode"] == "blind_bwe"]
    tr = [r for r in records(tdir) if r["mode"] == "blind_bwe"]
    assert len(jr) == 2
    for a, b in zip(tr, jr):
        assert a["item"] == b["item"]
        for k in ("lsd_degraded", "lsd_high_band_degraded"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), k
        for k in ("lsd", "lsd_high_band", "filter_db_mse"):
            assert np.isfinite(a[k])


def test_informed_filter_matches():
    """The informed filter of every shipped tester config (all firwin)."""
    seen = set()
    for cfg in sorted((REPO / "conf" / "tester").glob("*.yaml")):
        ov = [f"tester={cfg.stem}"]
        jf, jt = jdeg.prepare_filter(jconfig(ov), 22050)
        tf, tt = tdeg.prepare_filter(tconfig(ov), 22050)
        assert tt == jt
        seen.add(tt)
        for a, b in zip(np.atleast_1d(np.asarray(tf, dtype=object)),
                        np.atleast_1d(np.asarray(jf, dtype=object))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "firwin" in seen


def test_missing_checkpoint_names_both_paths(inputs):
    args = tconfig(overrides(inputs, "port", ["bwe"])
                   + ["tester.checkpoint=absent.ckpt"])
    with pytest.raises(FileNotFoundError) as e:
        tcli._main(args, device="cpu", overrides=[])
    assert "'absent.ckpt'" in str(e.value)
    assert repr(os.path.join(str(inputs / "port"), "absent.ckpt")) in str(
        e.value)


def test_unknown_mode_raises(inputs):
    ov = overrides(inputs, "port_unknown", ["no_such_mode"])
    with pytest.raises(NotImplementedError, match="no_such_mode"):
        tcli._main(tconfig(ov), device="cpu", overrides=ov)


def test_device_defaults_to_the_card(inputs):
    """Without device=cpu the CLI asks for the card, and says so when
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only message is not shown")
    ov = overrides(inputs, "port_card", ["bwe"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(ov)
