"""The port's LSD evaluator, launchers and distillation proof, on the CPU.

``babe_tpu_torch.tools.eval_lsd --tiny`` generates blind-BWE
reconstructions of wavs the test writes, through the port's formal test,
and reports per-item LSD and high-band LSD (with deltas against a
reference folder); the JAX tool's own ``evaluate`` reads the same files
and must give the same JSON keys and, on the same audio, the same numbers
within 1e-4 dB (both take the STFT in fp32).  The port's three
``scripts/*_torch.sh`` carry the overrides of the JAX package's three
launchers, and every class those overrides name resolves through
``babe_tpu_torch.setup``.  ``babe_tpu_torch.tools.distill_e2e`` at 2 + 2
iterations trains a teacher, distills a student through ``python -m
babe_tpu_torch.train`` and prints both gates (a run this short passes
neither: the gates are read, not held)."""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from babe_tpu_torch.data.wavio import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 22050


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wavs(folder, n, seconds, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    for i in range(n):
        x = sum(np.sin(2 * np.pi * f * (i + 1) * t) / k
                for k, f in enumerate((220.0, 660.0, 2500.0, 6000.0), 1))
        write_wav(os.path.join(folder, f"w{i}.wav"),
                  (0.1 * x + 0.01 * rng.standard_normal(t.shape)).astype(
                      np.float32), FS)


def test_eval_lsd_tiny_matches_the_jax_tools_report(tmp_path, capsys):
    sys.path.insert(0, REPO)
    from tools import eval_lsd as jtool

    from babe_tpu_torch.tools import eval_lsd as ttool

    audio, out, ref = (str(tmp_path / d) for d in ("audio", "out", "ref"))
    _wavs(audio, 2, 0.5, 3)
    shutil.copytree(audio, ref)
    res = ttool.main(["--audio_dir", audio, "--out_dir", out, "--ref_dir",
                      ref, "--fc", "1000", "--tiny", "--device", "cpu"])
    assert "MEANINGLESS" in capsys.readouterr().out
    with open(os.path.join(out, "lsd_report.json")) as f:
        report = json.load(f)
    assert set(report) == {"1000"}
    ours = res[1000]
    theirs = jtool.evaluate(audio, out, ref, 1000, FS)
    assert set(ours) == set(theirs) == {"summary", "items"}
    assert set(ours["summary"]) == set(theirs["summary"]) == {
        "fc", "n_items", "lsd_ours_mean", "lsd_hb_ours_mean",
        "lsd_delta_mean", "lsd_hb_delta_mean", "north_star_pass"}
    assert ours["summary"]["n_items"] == 2
    for a, b in zip(ours["items"], theirs["items"]):
        assert set(a) == set(b) and a["item"] == b["item"]
        for k in set(a) - {"item"}:
            assert abs(a[k] - b[k]) <= 1e-4, (k, a[k], b[k])
        assert a["lsd_ref"] == 0.0 and a["lsd_ours"] > 0
    # a second run finds every file written and only evaluates
    again = ttool.main(["--audio_dir", audio, "--out_dir", out, "--fc",
                        "1000", "--skip_generate"])
    assert again[1000]["items"][0]["lsd_ours"] == ours["items"][0][
        "lsd_ours"]


def _overrides(path):
    """The Hydra overrides of a launcher script (its indented
    ``key=value`` lines), with its variables at their defaults."""
    with open(path) as f:
        text = f.read()
    defaults = {}
    for k, v in re.findall(r"^(\w+)=\$\{\1:-(.*)\}[ \t]*(?:#.*)?$", text,
                           re.M):
        defaults[k] = re.sub(r"\$\{(\w+)\}", lambda m: defaults[m.group(1)],
                             v)
    out = []
    for ov in re.findall(r"^[ \t]+([\w.]+=\S+?)[ \t]*\\?$", text, re.M):
        out.append(re.sub(r'"\$(\w+)"', lambda m: defaults[m.group(1)], ov))
    return out, text


@pytest.mark.parametrize("name,cli", [("test_blind_bwe", "test"),
                                      ("train_maestro_22k", "train"),
                                      ("train_cocochorales", "train")])
def test_scripts_carry_the_jax_overrides_and_resolve(name, cli):
    from babe_tpu_torch import setup
    from babe_tpu_torch.config import default_config

    ours, text = _overrides(os.path.join(REPO, "scripts",
                                         f"{name}_torch.sh"))
    theirs, _ = _overrides(os.path.join(REPO, "scripts", f"{name}.sh"))
    assert ours == theirs and len(ours) >= 7
    assert f"-m babe_tpu_torch.{cli}" in text
    args = default_config(ours)
    setup.setup_network(args)
    setup.setup_diff_parameters(args)
    setup.tester_class(args.tester.callable)
    setup.sampler_class(args.tester.get("sampler_callable",
                                        "sampling.blind.BlindSampler"))
    setup.trainer_class(args.exp.get("trainer_callable",
                                     "training.trainer.Trainer"))
    setup.dataset_class(args.dset.callable)
    setup.test_dataset_class(args.dset.test.callable)


def test_distill_e2e_runs_and_reports_both_gates(tmp_path, capsys,
                                                 monkeypatch):
    from babe_tpu_torch.tools import distill_e2e

    # the training CLI's processes share the CPU with the suite's workers
    monkeypatch.setenv("OMP_NUM_THREADS", "2")

    rc = distill_e2e.main(["--teacher_its", "2", "--distill_its", "2",
                           "--device", "cpu", "--workdir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert rc == (0 if out["loss_gate"] and out["tracking_gate"] else 1)
    for k in ("pd_loss_before", "pd_loss_after", "pd_loss_ratio",
              "mse_teacher_halfsteps_vs_full",
              "mse_student_halfsteps_vs_full", "tracking_budget",
              "loss_gate", "tracking_gate"):
        assert k in out, k
    assert np.isfinite(out["pd_loss_before"]) and out["pd_loss_after"] > 0
    assert os.path.exists(tmp_path / "teacher" / "22k_8s-2.ckpt")
    assert os.path.exists(tmp_path / "student_T8" / "22k_8s-2.ckpt")
