"""End-to-end progressive-distillation proof with trained weights, in the
port.

Counterpart of the JAX package's ``tools/distill_e2e.py``, through the
port's training CLI, on the card unless ``--device cpu`` is given:

  1. train a tiny CQTDiff+ teacher on the capability tool's seeded
     sawtooths (``python -m babe_tpu_torch.train``, diff_params=edm);
  2. distill a student initialised from the teacher's EMA with the PD
     double-step objective (``diff_params=edm_PD``,
     ``diff_params.PD.teacher_checkpoint=<teacher>``, stage 0);
  3. sample with the student at half the ODE steps (``PD_sample`` stage 0)
     and hold it to the teacher's full-step ODE endpoint.

Gates (both must hold; one JSON line, exit 0 iff both pass), as the JAX
tool's:
  * loss_gate: the PD objective on held-out batches falls at least 2x from
    the undistilled student (the teacher's weights) to the distilled one;
  * tracking_gate: the mean MSE of the student at T/2 steps against the
    teacher at T is below 0.1 * sigma_data^2 (10% of the signal's power).

    python -m babe_tpu_torch.tools.distill_e2e [--teacher_its 1500] \\
        [--distill_its 1000] [--boundaries_T 8] [--workdir DIR] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

from babe_tpu_torch.tools.capability_e2e import (FS, REPO, SEG, SIGMA_DATA,
                                                 TINY, run_cli, sawtooth)


def default_workdir() -> str:
    return os.path.join(tempfile.gettempdir(), "babe_pd_torch")


def _student_init(teacher_ckpt: str, path: str) -> None:
    """The student's starting checkpoint (iteration 0): the teacher's EMA
    as params and EMA, its buffers, Adam's state zeroed."""
    import torch

    from babe_tpu_torch.testers.tester import read_checkpoint
    from babe_tpu_torch.utils.weights import (adam_state_from_flax,
                                              adam_state_to_flax)

    pay = read_checkpoint(teacher_ckpt)
    _, mu, nu, _ = adam_state_from_flax(pay["opt_state"])
    zero = {k: torch.zeros_like(v) for k, v in mu.items()}
    with open(path, "wb") as f:
        pickle.dump({"it": 0, "params": pay["ema"],
                     "buffers": pay["buffers"],
                     "opt_state": adam_state_to_flax(
                         0, zero, dict(zero), 0,
                         clip=len(pay["opt_state"]) > 1),
                     "ema": pay["ema"], "args": pay.get("args", {})}, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--teacher_its", type=int, default=1500)
    ap.add_argument("--distill_its", type=int, default=1000)
    ap.add_argument("--boundaries_T", type=int, default=8)
    ap.add_argument("--workdir", default=default_workdir())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.data.wavio import write_wav
    from babe_tpu_torch.diffusion.edm_pd import EDMPD
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.testers.tester import read_checkpoint
    from babe_tpu_torch.utils.weights import load_flax

    wd = args.workdir
    train_dir = os.path.join(wd, "train")
    teacher_dir = os.path.join(wd, "teacher")
    # the student is specific to the boundary schedule it distills against
    student_dir = os.path.join(wd, f"student_T{args.boundaries_T}")
    for d in (train_dir, teacher_dir, student_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    f0s = [110.0, 146.8, 220.0]
    for i in range(12):
        write_wav(os.path.join(train_dir, f"t{i}.wav"),
                  sawtooth(f0s[i % len(f0s)], 2 * FS, rng), FS)
    common = [
        f"device={args.device}", "dset=musicnet", f"dset.path={train_dir}",
        "exp.batch=4", "exp.lr=1e-3", "exp.lr_rampup_it=100", *TINY,
        "logging.log_interval=200", "logging.save_interval=100000",
        "tester.do_test=false",
    ]
    secs = {}

    teacher_ckpt = os.path.join(teacher_dir,
                                f"22k_8s-{args.teacher_its}.ckpt")
    if not os.path.exists(teacher_ckpt):
        # a checkpoint of another --teacher_its would be resumed past
        # total_its and saved under its old name
        for stale in os.listdir(teacher_dir):
            os.remove(os.path.join(teacher_dir, stale))
        print(f"[distill_e2e] training teacher {args.teacher_its} its ...",
              flush=True)
        t0 = time.perf_counter()
        run_cli("babe_tpu_torch.train", [
            f"model_dir={teacher_dir}", f"exp.total_its={args.teacher_its}",
            "exp.resume=false", *common])
        secs["teacher_s"] = time.perf_counter() - t0
    assert os.path.exists(teacher_ckpt), f"missing teacher {teacher_ckpt}"

    init_path = os.path.join(student_dir, "22k_8s-0.ckpt")
    _student_init(teacher_ckpt, init_path)
    student_ckpt = os.path.join(student_dir,
                                f"22k_8s-{args.distill_its}.ckpt")
    if not os.path.exists(student_ckpt):
        # the resume takes the largest iteration: drop a student of another
        # --distill_its so distillation starts from the teacher's weights
        for stale in os.listdir(student_dir):
            if stale != os.path.basename(init_path):
                os.remove(os.path.join(student_dir, stale))
        print(f"[distill_e2e] distilling student {args.distill_its} its ...",
              flush=True)
        t0 = time.perf_counter()
        run_cli("babe_tpu_torch.train", [
            f"model_dir={student_dir}", f"exp.total_its={args.distill_its}",
            "exp.resume=true", "diff_params=edm_PD",
            f"diff_params.PD.teacher_checkpoint={teacher_ckpt}",
            f"diff_params.PD.boundaries.T={args.boundaries_T}",
            "diff_params.PD.stage=0", *common])
        secs["distill_s"] = time.perf_counter() - t0
    assert os.path.exists(student_ckpt), f"missing student {student_ckpt}"

    # ---------------------------------------------------------------- eval
    dev = torch.device(args.device)
    cfg = default_config([f"model_dir={wd}", "diff_params=edm_PD",
                          f"diff_params.PD.boundaries.T={args.boundaries_T}",
                          *TINY])

    def load_net(path):
        pay = read_checkpoint(path)
        m = CQTDiffPlus.from_config(cfg)
        load_flax(m.net, pay["ema"], pay.get("buffers", {}))
        m.to(dev).eval().requires_grad_(False)
        return m

    teacher, student = load_net(teacher_ckpt), load_net(student_ckpt)
    edm = EDMPD.from_config(cfg, cqt_hpf=teacher.apply_hpf_DC)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    with torch.no_grad():
        # gate 1: the PD objective on held-out batches, distilled against
        # undistilled (the undistilled student is the teacher)
        eval_rng = np.random.default_rng(7)
        batch = torch.as_tensor(np.stack([
            sawtooth(f0s[i % len(f0s)], SEG, eval_rng) for i in range(4)]),
            device=dev)

        def pd_loss(net):
            return float(np.mean([float(edm.loss_fn_PD(
                gen(100 + i), net.apply, teacher.apply, batch, 0)[0].mean())
                for i in range(4)]))

        loss_before, loss_after = pd_loss(teacher), pd_loss(student)
        ratio = loss_before / max(loss_after, 1e-12)

        # gate 2: the distilled T/2-step sampler against the teacher's
        # full T-step ODE endpoint
        mse_t, mse_s = [], []
        for i in range(3):
            ref = edm.PD_sample(gen(200 + i), 2, SEG, teacher.apply, -1)
            t_half = edm.PD_sample(gen(200 + i), 2, SEG, teacher.apply, 0)
            s_half = edm.PD_sample(gen(200 + i), 2, SEG, student.apply, 0)
            mse_t.append(float(((t_half - ref) ** 2).mean()))
            mse_s.append(float(((s_half - ref) ** 2).mean()))
    mse_student = float(np.mean(mse_s))
    budget = 0.1 * SIGMA_DATA**2  # 10% of the signal's power
    out = {
        "pd_loss_before": round(loss_before, 6),
        "pd_loss_after": round(loss_after, 6),
        "pd_loss_ratio": round(ratio, 2),
        "mse_teacher_halfsteps_vs_full": round(float(np.mean(mse_t)), 8),
        "mse_student_halfsteps_vs_full": round(mse_student, 8),
        "tracking_budget": round(budget, 8),
        "loss_gate": ratio >= 2.0,
        "tracking_gate": mse_student < budget,
        **{k: round(v, 1) for k, v in secs.items()},
    }
    print(json.dumps(out), flush=True)
    return 0 if (out["loss_gate"] and out["tracking_gate"]) else 1


if __name__ == "__main__":
    sys.exit(main())
