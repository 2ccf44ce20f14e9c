"""End-to-end capability check with trained weights: train a tiny CQTDiff+
on seeded harmonic audio through the port's training CLI, then run
zero-shot blind BWE on low-passed probes through the port's test CLI and
check that the reconstruction beats the degraded input on high-band LSD.

Counterpart of ``tools/capability_e2e.py``, with the same data (12 seeded
2 s band-limited sawtooths on three f0s for training, two probes), the same
tiny network (``TINY``), the same training and test overrides and the same
gate.  It drives data -> ``python -m babe_tpu_torch.train`` -> checkpoint
-> ``python -m babe_tpu_torch.test tester=blind_bwe`` -> ``metrics.jsonl``,
on the card unless ``--device cpu`` is given:

    python -m babe_tpu_torch.tools.capability_e2e [--its 1500] [--T 15] \\
        [--workdir DIR] [--device cuda]

Prints one JSON line with the LSD numbers (reconstructed and degraded, on
the whole band and on the band above the 1 kHz cutoff) and the training
and testing seconds; exit 0 iff the high-band LSD improved on every probe.
``tools/quality_int8.py --mode lsd`` reuses its workdir.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FS = 22050
SEG = 8192
# published sigma_data (conf/diff_params/edm.yaml): the data's RMS
SIGMA_DATA = 0.063
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = [
    "exp.audio_len=%d" % SEG,
    "exp.resample_factor=1",
    "exp.use_bf16=false",
    "network.Ns=[16,16,32]",
    "network.num_dils=[1,2,2]",
    "network.emb_dim=64",
    "network.attention_layers=[0,0,0,0]",
    "network.cqt.num_octs=3",
    "network.cqt.bins_per_oct=16",
]
# the blind test: degraded at 1 kHz, well inside the 3-octave band
BLIND_TEST = [
    "tester=blind_bwe", "dset=musicnet", "dset.test.num_samples=2",
    "tester.blind_bwe.test_filter.fc=[1000]",
    "tester.blind_bwe.test_filter.A=[-40]",
    "tester.blind_bwe.optimization.max_iter=20",
    "tester.blind_bwe.initial_conditions.fc=[500]",
    "tester.blind_bwe.initial_conditions.A=[-20]",
    "tester.blind_bwe.NFFT=1024",
    "tester.blind_bwe.sigma_norm=None",
]


def default_workdir() -> str:
    return os.path.join(tempfile.gettempdir(), "babe_cap_torch")


def sawtooth(f0: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """Band-limited sawtooth: harmonics to Nyquist with 1/k rolloff, so
    every octave has energy for BWE to recover."""
    t = np.arange(n) / FS
    x = np.zeros(n)
    k = 1
    while k * f0 < FS / 2 - 50:
        x += np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
        k += 1
    x = x / np.std(x) * SIGMA_DATA
    return x.astype(np.float32)


def run_cli(module: str, argv: list[str], env=None) -> str:
    """``python -m <module> <argv>`` from the repository root; echoes and
    returns its standard output, raises on a non-zero exit."""
    r = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                       env=env, stdout=subprocess.PIPE, text=True)
    print(r.stdout, end="", flush=True)
    if r.returncode != 0:
        raise subprocess.CalledProcessError(r.returncode, module)
    return r.stdout


def blind_records(model_dir: str) -> list[dict]:
    """The ``blind_bwe`` records of ``<model_dir>/outputs/metrics.jsonl``."""
    path = os.path.join(model_dir, "outputs", "metrics.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("mode") == "blind_bwe"]


def rotate_metrics(model_dir: str) -> None:
    """The logger appends: keep an earlier run's records out of the gate."""
    path = os.path.join(model_dir, "outputs", "metrics.jsonl")
    if os.path.exists(path):
        os.replace(path, path + ".prev")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--its", type=int, default=1500)
    ap.add_argument("--workdir", default=default_workdir())
    ap.add_argument("--T", type=int, default=15, help="sampler steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from babe_tpu_torch.data.wavio import write_wav

    wd = args.workdir
    train_dir, test_dir, exp_dir = (os.path.join(wd, d) for d in
                                    ("train", "test", "exp"))
    for d in (train_dir, test_dir, exp_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    # a narrow f0 family, so the tiny model can learn the distribution
    f0s = [110.0, 146.8, 220.0]
    for i in range(12):
        write_wav(os.path.join(train_dir, f"t{i}.wav"),
                  sawtooth(f0s[i % len(f0s)], 2 * FS, rng), FS)
    for i, f0 in enumerate(f0s[:2]):
        write_wav(os.path.join(test_dir, f"probe{i}.wav"),
                  sawtooth(f0, 2 * FS, rng), FS)
    dev = f"device={args.device}"

    print(f"[capability_e2e] training {args.its} its on {args.device} ...",
          flush=True)
    t0 = time.perf_counter()
    run_cli("babe_tpu_torch.train", [
        dev, f"model_dir={exp_dir}", "dset=musicnet", f"dset.path={train_dir}",
        "exp.batch=4", f"exp.total_its={args.its}", "exp.resume=false",
        # a demo-scale schedule: the published lr 2e-4 with a 10k-it rampup
        # would keep a 1.5k-it run at ~15% of its rate throughout
        "exp.lr=1e-3", "exp.lr_rampup_it=100", *TINY,
        "logging.log_interval=200", "logging.save_interval=100000",
        "tester.do_test=false"])
    train_s = time.perf_counter() - t0
    ckpt = os.path.join(exp_dir, f"22k_8s-{args.its}.ckpt")
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"missing final checkpoint {ckpt}")

    print("[capability_e2e] blind BWE on low-passed probes ...", flush=True)
    rotate_metrics(exp_dir)
    t0 = time.perf_counter()
    run_cli("babe_tpu_torch.test", [
        dev, f"model_dir={exp_dir}", f"tester.checkpoint={ckpt}",
        f"dset.test.path={test_dir}", *BLIND_TEST, *TINY,
        f"tester.T={args.T}"])
    test_s = time.perf_counter() - t0
    recs = blind_records(exp_dir)
    if not recs:
        raise RuntimeError("no blind_bwe metrics logged")
    out = {
        "items": len(recs), "its": args.its, "T": args.T,
        "device": args.device,
        "lsd_high_band_degraded": [r["lsd_high_band_degraded"] for r in recs],
        "lsd_high_band_reconstructed": [r["lsd_high_band"] for r in recs],
        "lsd_degraded": [r["lsd_degraded"] for r in recs],
        "lsd_reconstructed": [r["lsd"] for r in recs],
        "train_s": train_s, "test_s": test_s,
        "improved_all": all(r["lsd_high_band"] < r["lsd_high_band_degraded"]
                            for r in recs),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["improved_all"] else 1)
