"""The port's evaluation CLI against the repository's ``test.py`` on the
folder evaluations (the helper, the inputs and what is compared are
``tests/test_torch_test_cli.py``'s): ``formal_test_bwe`` informed with the
firwin filter (overlap-added segments in batches) and blind (each segment
its own request, the filters pickled beside the wav), then
``formal_test_bwe_small`` (blind, one segment a file, a filter dB-MSE
record each).  A second run over the same folder restores nothing: the
outputs already there are kept."""

import pickle

import numpy as np
import pytest
import torch

from babe_tpu_torch.data.wavio import read_wav
from test_torch_test_cli import check_files_and_records, inputs, records, \
    run_both

__all__ = ["inputs"]  # the fixture, shared with the CLI tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers (these shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("blind", [False, True])
def test_formal_test_bwe(inputs, blind):
    extra = [f"tester.formal_test.blind={str(blind).lower()}"]
    tag = "blind" if blind else "informed"
    jdir, tdir = run_both(_sub(inputs, tag), ["formal_test_bwe"], extra)
    check_files_and_records(jdir, tdir)
    outs = sorted((tdir / "formal_out").glob("*.wav"))
    assert [p.name for p in outs] == ["f0.wav", "f1.wav"]
    for p in outs:  # the whole file, restored at the model's rate
        x, fs = read_wav(str(p))
        ref, _ = read_wav(str(inputs / "formal_in" / p.name))
        assert fs == 22050 and x.shape == ref.shape
    if blind:
        with open(tdir / "formal_out" / "f0.filter_data.pkl", "rb") as f:
            data = pickle.load(f)
        with open(jdir / "formal_out" / "f0.filter_data.pkl", "rb") as f:
            jdata = pickle.load(f)
        assert [d[0] for d in data] == [d[0] for d in jdata]
        assert all(np.shape(d[1]) == np.shape(j[1])
                   for d, j in zip(data, jdata))


def _sub(inputs, tag):
    """A copy of the inputs' folder layout under ``tag`` (its own outputs;
    the checkpoint and wavs are shared by link)."""
    d = inputs / tag
    if not d.exists():
        d.mkdir()
        for name in ("tiny.ckpt", "test", "recs", "formal_in"):
            (d / name).symlink_to(inputs / name)
    return d


def test_formal_test_bwe_small_and_resume(inputs):
    d = _sub(inputs, "small")
    jdir, tdir = run_both(d, ["formal_test_bwe_small"])
    check_files_and_records(jdir, tdir)
    recs = records(tdir)
    assert [r["item"] for r in recs] == ["f0", "f1"]
    assert all(np.isfinite(r["filter_db_mse"]) for r in recs)
    stamp = (tdir / "formal_out" / "f0.wav").stat().st_mtime_ns
    run_both(d, ["formal_test_bwe_small"])
    assert (tdir / "formal_out" / "f0.wav").stat().st_mtime_ns == stamp
    assert len(records(tdir)) == 2
