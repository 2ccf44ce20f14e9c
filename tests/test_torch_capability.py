"""Plumbing of the port's two quality tools on the CPU, at a size that
checks the wiring, not the gates: ``babe_tpu_torch.tools.capability_e2e``
(seeded data -> ``python -m babe_tpu_torch.train`` for 3 iterations ->
``python -m babe_tpu_torch.test tester=blind_bwe`` at T = 2 ->
``metrics.jsonl``) and ``babe_tpu_torch.tools.quality_int8 --mode lsd``
(the same checkpoint served in bf16 and in int8 with the int8 floor
lowered to the tiny widths).  Their JSON lines carry the JAX tools' keys,
finite LSDs for both probes, and the int8 run really differs from the bf16
one (every tiny dilation stack ran the int8 stage's plain version).  The
gates themselves are the card's: ``chip_smoke.py``'s ``capability``
phase."""

import json
import math

import pytest

from babe_tpu_torch.tools import capability_e2e, quality_int8


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_process():
    """The tools' CLI processes run with one intra-op thread: the suite
    shares the CPU among several workers, and each process would start
    one thread per core."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory, _one_thread_per_process):
    wd = tmp_path_factory.mktemp("cap")
    out = capability_e2e.main(["--its", "3", "--T", "2", "--device", "cpu",
                               "--workdir", str(wd)])
    return wd, out


def test_capability_e2e_plumbing(trained):
    wd, out = trained
    keys = {"items", "lsd_high_band_degraded", "lsd_high_band_reconstructed",
            "lsd_degraded", "lsd_reconstructed", "improved_all"}
    assert keys <= set(out) and out["items"] == 2
    assert out["train_s"] > 0 and out["test_s"] > 0
    for k in keys - {"items", "improved_all"}:
        assert len(out[k]) == 2 and all(math.isfinite(v) for v in out[k])
    assert (wd / "exp" / "22k_8s-3.ckpt").exists()
    assert isinstance(out["improved_all"], bool)


def test_quality_int8_lsd_plumbing(trained, capsys):
    wd, _ = trained
    out = quality_int8.main(["--mode", "lsd", "--T", "2", "--device", "cpu",
                             "--workdir", str(wd)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    keys = {"mode", "items", "T", "lsd_bf16", "lsd_int8", "lsd_delta_mean",
            "lsd_hb_delta_mean", "gate_pass"}
    assert keys <= set(out) and out["mode"] == "lsd" and out["items"] == 2
    assert all(math.isfinite(v) for v in out["lsd_bf16"] + out["lsd_int8"])
    assert out["lsd_bf16"] != out["lsd_int8"]
