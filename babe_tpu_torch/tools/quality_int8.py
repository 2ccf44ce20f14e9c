"""Quality gate of the int8 path on trained weights: blind-BWE LSD in int8
against the same run in the model's compute dtype.

Counterpart of ``tools/quality_int8.py --mode lsd``: it takes the trained
tiny checkpoint and the probes of ``capability_e2e`` (its ``--workdir``),
serves blind BWE through ``python -m babe_tpu_torch.test`` twice with the
same seed, ``BABE_PRECISION=bf16`` and ``BABE_PRECISION=int8``, and
``BABE_INT8_MINC=16`` so that every dilation stack of the tiny network
(16, 16 and 32 channels) runs the int8 stage, and reports the per-item LSD
and high-band LSD deltas, int8 minus bf16.  Gate: |mean LSD delta| < 0.05
dB, and on the card the int8 run launched its configuration's int8 conv
(K3 for the fused chain, C8 for the unfused convs; the launches are read
from the test CLI's ``kernel launches`` line).  The trajectory mode of the
JAX tool is ``chip_smoke.py``'s ``quality`` phase here.

The int8 run takes the environment's int8 knobs (``models/cqtdiff.py``):
the port's default is the fused chain; the JAX tool measures the JAX
package's default, the unfused convs with the exact input gradient, which
is ``BABE_INT8_FUSED=0``.

    [BABE_INT8_FUSED=0] python -m babe_tpu_torch.tools.quality_int8 \\
        --mode lsd [--workdir DIR] [--T 15] [--device cuda]

Prints one JSON line; exit 0 iff the gate passes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from babe_tpu_torch.ops.conv_kernels import Int8Config
from babe_tpu_torch.tools.capability_e2e import (BLIND_TEST, TINY,
                                                 blind_records,
                                                 default_workdir,
                                                 rotate_metrics, run_cli)

LAUNCHES_TAG = "kernel launches: "


def run_lsd(workdir: str, T: int, device: str = "cuda") -> dict:
    exp_dir = os.path.join(workdir, "exp")
    ckpts = sorted((f for f in os.listdir(exp_dir) if f.endswith(".ckpt")),
                   key=lambda f: int(f.split("-")[-1].split(".")[0]))
    if not ckpts:
        raise FileNotFoundError(
            f"no trained checkpoint under {exp_dir}: run "
            f"python -m babe_tpu_torch.tools.capability_e2e --workdir "
            f"{workdir} first")
    ckpt = os.path.join(exp_dir, ckpts[-1])
    results, launches = {}, {}
    env8 = dict(os.environ, BABE_PRECISION="int8", BABE_INT8_MINC="16")
    cfg = Int8Config.from_env(env8)
    kernel = "fused_stage_int8" if cfg.fused is not None else "conv_int8"
    for prec in ("bf16", "int8"):
        env = (env8 if prec == "int8"
               else dict(os.environ, BABE_PRECISION=prec,
                         BABE_INT8_MINC="16"))
        mdir = os.path.join(workdir, f"q_{prec}")
        os.makedirs(mdir, exist_ok=True)
        rotate_metrics(mdir)
        stdout = run_cli("babe_tpu_torch.test", [
            f"device={device}", f"model_dir={mdir}",
            f"tester.checkpoint={ckpt}",
            f"dset.test.path={os.path.join(workdir, 'test')}", *BLIND_TEST,
            *TINY, f"tester.T={T}", "exp.seed=11"], env=env)
        results[prec] = blind_records(mdir)
        lines = [ln for ln in stdout.splitlines()
                 if ln.startswith(LAUNCHES_TAG)]
        launches[prec] = (json.loads(lines[-1][len(LAUNCHES_TAG):])
                          if lines else {})
    pairs = list(zip(results["bf16"], results["int8"]))
    d_lsd = [i8["lsd"] - bf["lsd"] for bf, i8 in pairs]
    d_hb = [i8["lsd_high_band"] - bf["lsd_high_band"] for bf, i8 in pairs]
    mean_d = sum(d_lsd) / len(d_lsd)
    k8 = launches["int8"].get(kernel, 0)
    return {
        "mode": "lsd", "items": len(d_lsd), "T": T, "device": device,
        "int8_config": dataclasses.asdict(cfg),
        "lsd_bf16": [r["lsd"] for r in results["bf16"]],
        "lsd_int8": [r["lsd"] for r in results["int8"]],
        "lsd_delta_mean": mean_d,
        "lsd_hb_delta_mean": sum(d_hb) / len(d_hb),
        "k3_launches_int8": launches["int8"].get("fused_stage_int8", 0),
        "c8_launches_int8": launches["int8"].get("conv_int8", 0),
        "k3_launches_bf16": launches["bf16"].get("fused_stage_int8", 0),
        "gate_pass": bool(abs(mean_d) < 0.05
                          and (device == "cpu" or k8 > 0)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lsd"], default="lsd")
    ap.add_argument("--workdir", default=default_workdir())
    ap.add_argument("--T", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_lsd(args.workdir, args.T, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["gate_pass"] else 1)
