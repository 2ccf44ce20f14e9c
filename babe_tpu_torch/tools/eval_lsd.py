"""One-command LSD evaluation of blind BWE, in the port.

Counterpart of the JAX package's ``tools/eval_lsd.py``, with the same
arguments and the same JSON keys:

  1. (generate) run the port's blind-BWE formal test over a directory of
     original wavs (``Tester.formal_test_bwe(blind=True)``: the degradation
     of ``tester=blind_bwe_formal_<fc>``, OLA chunking, a file already
     written is skipped), writing the reconstructions to --out_dir, and
  2. (evaluate) for every item the LSD and the high-band LSD (above the
     cutoff) of the reconstruction against the original, and, where
     --ref_dir holds reconstructions of the same files made elsewhere, the
     per-item and mean LSD deltas, ours minus theirs.  |mean delta| <= 0.1
     dB is the north-star's bar.

    python -m babe_tpu_torch.tools.eval_lsd --audio_dir <originals> \\
        --fc 1000 --ckpt weights.ckpt --out_dir /tmp/eval1000 \\
        [--ref_dir <reference outputs>]

--ckpt is a local .ckpt or reference .pt (a .pt selects the checkpoint's
CQT frame, ``network=cqtdiff+_ckpt``); nothing is downloaded.  It runs on
the card unless --device cpu.  --tiny runs a seeded random tiny model on
short segments: a smoke test of the pipeline whose LSD numbers mean
nothing (it says so).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

TINY_NET = [
    "network.Ns=[8,8,16]", "network.num_dils=[1,1,2]", "network.emb_dim=32",
    "network.attention_layers=[0,0,0,0]", "network.cqt.num_octs=3",
    "network.cqt.bins_per_oct=8", "exp.use_bf16=false",
]
TINY_TESTER = [
    "exp.audio_len=4096", "tester.T=4",
    "tester.blind_bwe.optimization.max_iter=4",
    "tester.blind_bwe.initial_conditions.fc=[300]",
    "tester.blind_bwe.initial_conditions.A=[-20]",
    "tester.blind_bwe.NFFT=512", "tester.formal_test.OLA=256",
]


def build_tester(fc: int, audio_dir: str, out_dir: str, ckpt: str | None,
                 tiny: bool, extra: list[str], device: str = "cuda"):
    """The port's tester of ``tester=blind_bwe_formal_<fc>`` on
    ``audio_dir``, writing to ``out_dir``, with ``ckpt``'s weights (or, for
    --tiny without one, a seeded random init)."""
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.setup import (setup_diff_parameters, setup_network,
                                      tester_class)
    from babe_tpu_torch.test import _resolve_checkpoint
    from babe_tpu_torch.utils.weights import to_flax

    overrides = [
        f"tester=blind_bwe_formal_{fc}",
        f"tester.formal_test.path={audio_dir}",
        f"tester.formal_test.folder={out_dir}",
        f"model_dir={out_dir}",
    ]
    if ckpt is not None and ckpt.endswith(".pt"):
        # the reference's weights were trained with its own CQT frame
        overrides.append("network=cqtdiff+_ckpt")
    if tiny:
        overrides += TINY_NET + TINY_TESTER
    args = default_config(overrides + list(extra))
    args.exp["remat"] = False
    model = setup_network(args)
    diff_params = setup_diff_parameters(args, cqt_hpf=model.apply_hpf_DC)
    tester = tester_class(args.tester.callable)(args, model, diff_params,
                                                device=device)
    if ckpt is not None:
        args.tester["checkpoint"] = ckpt
        tester.load_checkpoint(_resolve_checkpoint(args))
    else:
        print("WARNING: no --ckpt given: random-init weights, the LSD "
              "numbers below are MEANINGLESS (pipeline smoke only)")
        model.init(seed=0, device="cpu")
        tester.set_variables(*to_flax(model.net))
    return tester


def evaluate(audio_dir: str, out_dir: str, ref_dir: str | None, fc: int,
             fs: int) -> dict:
    """Per-item LSD and high-band LSD of ``out_dir``'s reconstructions
    against ``audio_dir``'s originals (both at ``fs``), with the deltas
    against ``ref_dir``'s where it has the item; and their means."""
    from babe_tpu_torch.data.wavio import read_wav, to_mono
    from babe_tpu_torch.ops.resample import resample
    from babe_tpu_torch.utils.metrics import lsd, lsd_high_band

    def load(path, n=None):
        d, f = read_wav(path)
        d = torch.as_tensor(np.atleast_2d(to_mono(d)).astype(np.float32))
        if f != fs:
            d = resample(d, int(f), fs)
        return d[0] if n is None else d[0, :n]

    rows = []
    for opath in sorted(glob.glob(os.path.join(audio_dir, "*.wav"))):
        name = os.path.basename(opath)
        ours_path = os.path.join(out_dir, name)
        if not os.path.exists(ours_path):
            print(f"SKIP {name}: no generated output at {ours_path}")
            continue
        orig, ours = load(opath), load(ours_path)
        n = min(orig.shape[-1], ours.shape[-1])
        o, u = orig[:n][None], ours[:n][None]
        row = {"item": name,
               "lsd_ours": float(lsd(o, u)[0]),
               "lsd_hb_ours": float(lsd_high_band(o, u, fs, fc)[0])}
        if ref_dir is not None:
            rpath = os.path.join(ref_dir, name)
            if os.path.exists(rpath):
                ref = load(rpath, n)[None]
                o_r = o[..., :ref.shape[-1]]
                row["lsd_ref"] = float(lsd(o_r, ref)[0])
                row["lsd_hb_ref"] = float(lsd_high_band(o_r, ref, fs, fc)[0])
                row["lsd_delta"] = row["lsd_ours"] - row["lsd_ref"]
                row["lsd_hb_delta"] = row["lsd_hb_ours"] - row["lsd_hb_ref"]
            else:
                print(f"note: no reference output for {name} in {ref_dir}")
        rows.append(row)
        print("  " + json.dumps(row))

    if not rows:
        raise SystemExit(f"no evaluable items (originals: {audio_dir}, "
                         f"outputs: {out_dir})")
    summary = {
        "fc": fc, "n_items": len(rows),
        "lsd_ours_mean": float(np.mean([r["lsd_ours"] for r in rows])),
        "lsd_hb_ours_mean": float(np.mean([r["lsd_hb_ours"] for r in rows])),
    }
    deltas = [r["lsd_delta"] for r in rows if "lsd_delta" in r]
    if deltas:
        summary["lsd_delta_mean"] = float(np.mean(deltas))
        summary["lsd_hb_delta_mean"] = float(
            np.mean([r["lsd_hb_delta"] for r in rows if "lsd_hb_delta" in r]))
        summary["north_star_pass"] = bool(
            abs(summary["lsd_delta_mean"]) <= 0.1)
    return {"summary": summary, "items": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--audio_dir", required=True,
                    help="directory of original (full-band) wavs")
    ap.add_argument("--out_dir", required=True,
                    help="where the reconstructions are written and read")
    ap.add_argument("--ref_dir", default=None,
                    help="directory of reconstructions made elsewhere (same "
                         "file names); enables the delta report")
    ap.add_argument("--ckpt", default=None, help="a .ckpt or .pt file")
    ap.add_argument("--fc", type=int, nargs="+", default=[1000, 3000])
    ap.add_argument("--fs", type=int, default=22050,
                    help="evaluation sample rate for --skip_generate runs "
                         "(the rate the wavs were generated at; otherwise "
                         "the tester's)")
    ap.add_argument("--skip_generate", action="store_true",
                    help="only run the metric pass on an existing out_dir")
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny random model: a smoke test of the pipeline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain PyTorch path)")
    ap.add_argument("--override", nargs="*", default=[],
                    help="extra config dotted overrides")
    a = ap.parse_args(argv)

    results = {}
    for fc in a.fc:
        out_dir = (a.out_dir if len(a.fc) == 1
                   else os.path.join(a.out_dir, str(fc)))
        os.makedirs(out_dir, exist_ok=True)
        if not a.skip_generate:
            tester = build_tester(fc, a.audio_dir, out_dir, a.ckpt, a.tiny,
                                  a.override, a.device)
            tester.formal_test_bwe(blind=True)
            tester.close()
            fs = tester.fs
        else:
            fs = a.fs
        print(f"== fc={fc} ==")
        results[fc] = evaluate(a.audio_dir, out_dir, a.ref_dir, fc, fs)
        print("SUMMARY " + json.dumps(results[fc]["summary"]))

    report = os.path.join(a.out_dir, "lsd_report.json")
    with open(report, "w") as f:
        json.dump({str(k): v for k, v in results.items()}, f, indent=1)
    print(f"report written to {report}")
    return results


if __name__ == "__main__":
    main()
