"""Training: ``Trainer.train_step`` on the trainer's own data stream, steps
back to back.

Set-up writes seeded 44.1 kHz recordings (the restoration mix's notes,
unfiltered) under ``TMPDIR``; the trainer reads them through its own
loader (``AudioFolderDataset`` behind the ``Batcher``), crops twice the
segment and resamples by the configuration's factor.  Set-up builds one
trainer with the seeded weights and drives it through its first steps
with the window's own call; the window takes the same trainer on.  Of the
first three steps the raw crops, the draws (sigma, noise), the losses
(each item's too),
Adam's first moment after step 1 (the first gradient as the optimizer got
it) and the weights and their EMA after step 3 are kept.  Once the window
has closed the reference resamples the same crops, follows the same three
steps from the seeded weights in float32, and the gaps are compared:

  data_err    ||x - ref|| / ||ref|| of the resampled batches
  loss_err    the largest |loss - ref| / |ref| of the three steps;
              item_loss_err the same of each item's loss
  grad_err    the worst leaf's |(||g|| - ||ref||)| / max(||ref||, the median
              leaf's ||ref||) of the first gradient; grad_med the median
              leaf's
  update_err  the same of the weights' change over the three steps, over
              the leaves whose reference gradient is at least a thousandth
              of the median leaf's; update_med the median leaf's
  ema_err     the same of the EMA's change; ema_med the median leaf's
"""

from __future__ import annotations

import math
import os
import shutil
import statistics
import tempfile
import time

import torch

from perfbench import traffic
from perfbench.loops import (Clock, WindowClosed, build_program,
                               close_window, free, model_counts, net_config,
                               reference_precision, rel, start_window)
from perfbench.weights import derive, load_into

CHECKS = ("data_err", "loss_err", "item_loss_err", "grad_err", "grad_med",
          "update_err", "update_med", "ema_err", "ema_med")
CHECK_STEPS = 3


class _Recorder:
    """The trainer's batch stream, keeping the raw batches it hands on."""

    def __init__(self, it):
        self.it = it
        self.keep = None

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        if self.keep is not None:
            self.keep.append(b)
        return b

    def close(self):
        """Stop the loader's thread and wait for it: it may be blocked
        handing on a batch, so the queue is drained until it has ended."""
        self.it.close()
        worker, q = self.it._thread, self.it.q
        while worker.is_alive():
            while not q.empty():
                q.get_nowait()
            worker.join(0.05)


def write_recordings(mix: dict, seed: int, folder: str) -> None:
    from babe_tpu_torch.data.wavio import write_wav

    d = mix["data"]
    fs, n = int(d["fs"]), int(d["seconds"] * d["fs"])
    for k in range(int(d["files"])):
        g = torch.Generator().manual_seed(derive(seed, f"wav{k}"))
        x = traffic.recording(d["recording"], n, float(fs), g, "cpu")
        x = x * (float(d["recording"]["std"]) / x.std())
        write_wav(os.path.join(folder, f"rec{k}.wav"), x.numpy(), fs)


class Cell:
    def __init__(self, run, folder: str):
        from babe_tpu_torch.config import make_config
        from babe_tpu_torch.data.datasets import setup_dataset
        from babe_tpu_torch.setup import setup_diff_parameters
        from babe_tpu_torch.training.trainer import Trainer

        self.run = run
        mix = run.mix
        self.args, self.model, self.weights = build_program(
            run, remat=bool(mix["remat"]))
        a = self.args
        a.exp["batch"] = int(mix["batch"])
        a.exp["resume"] = False
        a["model_dir"] = folder
        write_recordings(mix, run.seed, folder)
        a["dset"] = make_config({"name": "perfbench", "path": folder,
                                 "callable": mix["data"]["callable"],
                                 "overfit": False})
        self.data = _Recorder(setup_dataset(a))
        diff = setup_diff_parameters(a, cqt_hpf=self.model.apply_hpf_DC)
        tr = self.tr = Trainer(a, self.data, self.model, diff,
                               device=run.device)
        # the trainer draws its own init: the seeded weights replace it
        load_into(tr.net, self.weights)
        tr.ema = {k: p.detach().clone() for k, p in tr.params.items()}
        self.clock = Clock()
        self.kept = None
        get_batch, apply_update = tr.get_batch, tr._apply_update
        draws, loss = tr.edm.train_draws, tr._loss

        def timed(name, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                if run.trace:  # spans are read from the traced run alone
                    if run.device.type == "cuda":
                        torch.cuda.synchronize(run.device)
                    run.span(name, time.perf_counter() - t)
                return out
            return call

        def batch():
            x = get_batch()
            if self.kept is not None:
                self.kept["x"].append(x.detach().clone())
            return x

        def item_losses(x, sigma, noise, j):
            err2, sig = loss(x, sigma, noise, j)
            if self.kept is not None:
                self.kept["items"].append(err2.detach().float().mean(
                    dim=tuple(range(1, err2.dim()))).clone())
            return err2, sig

        def train_draws(gen, x, sigma=None, noise=None):
            out = draws(gen, x, sigma, noise)
            if self.kept is not None:
                self.kept["draws"].append(tuple(v.detach().clone()
                                                for v in out))
            return out

        tr.get_batch = timed("data_s", batch)
        tr._apply_update = timed("update_s", apply_update)
        tr.edm.train_draws = train_draws
        tr._loss = item_losses

    def step(self) -> bool:
        self.clock.before()
        out = self.tr.train_step()
        ok = not out["nonfinite"]
        if self.kept is not None:
            self.kept["loss"].append(float(out["loss"]))
        self.clock.tick()
        return ok

    def first_steps(self) -> None:
        """The steps the check follows, through the window's own call; the
        first of them warms every shape up."""
        tr = self.tr
        self.kept = {"draws": [], "loss": [], "x": [], "items": []}
        self.data.keep = self.kept.setdefault("raw", [])
        for k in range(CHECK_STEPS):
            self.step()
            if k == 0:
                self.kept["mu1"] = {n: m.clone() for n, m in tr.mu.items()}
        self.kept["p3"] = {n: p.detach().clone()
                           for n, p in tr.params.items()}
        self.kept["ema3"] = {n: e.clone() for n, e in tr.ema.items()}
        self.data.keep = None
        kept, self.kept = self.kept, None
        self.checked = kept


def run(run) -> None:
    folder = tempfile.mkdtemp(prefix="perfbench-train-")
    try:
        cell = Cell(run, folder)
        cell.first_steps()
        t0 = start_window(run, cell.clock)
        try:
            while True:
                run.attempted += 1
                run.failed += 0 if cell.step() else 1
        except WindowClosed:
            pass
        close_window(run, cell.clock, t0)
        B = int(run.mix["batch"])
        L, fs = int(cell.args.exp.audio_len), float(cell.args.exp.sample_rate)
        run.audio_s = B * L / fs * run.units
        run.counts = model_counts(run, L, fs, B, {
            "forward": 1, "input_grad": 1, "weight_grad": 1})
        kept, weights = cell.checked, cell.weights
        cell.data.close()
        del cell
        free()
        for name, v in compare(run, kept, weights).items():
            run.check(name, v)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def opt_config(run):
    from perfbench.reference.training import OptConfig

    exp = run.config["exp"]
    o = exp["optimizer"]
    return OptConfig(lr=float(exp["lr"]), rampup=max(int(exp["lr_rampup_it"]),
                                                     1),
                     b1=float(o["beta1"]), b2=float(o["beta2"]),
                     eps=float(o["eps"]),
                     max_norm=(float(exp["max_grad_norm"])
                               if exp["use_grad_clip"] else None),
                     ema_rate=float(exp["ema_rate"]),
                     ema_rampup=float(exp["ema_rampup"]),
                     batch=int(run.mix["batch"]))


def leaf_gaps(prog: dict, ref: dict, keys) -> tuple[float, float]:
    """(the worst leaf's, the median leaf's) gap of norms, each leaf's
    against the larger of its own reference norm and the median leaf's."""
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(rn.values())
    gaps = [abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
            for k in keys]
    return max(gaps), statistics.median(gaps)


def compare(run, kept, weights) -> dict:
    """The gaps of the kept steps against the reference's three steps from
    the seeded weights on the same raw crops and draws."""
    from perfbench.reference.diffusion import EDMConfig
    from perfbench.reference.training import Adam, loss_and_grads, resample

    reference_precision()
    exp = run.config["exp"]
    rf = int(exp["resample_factor"])
    fs = int(exp["sample_rate"])
    cfg = net_config(run)
    e = EDMConfig(float(run.config["diff_params"]["sigma_data"]))
    leaves = [k for k in kept["p3"]]
    opt = Adam(opt_config(run), {k: weights[k] for k in leaves})
    P = dict(weights)
    out = {"data_err": 0.0, "loss_err": 0.0, "item_loss_err": 0.0}
    g1 = None
    L = int(exp["audio_len"])
    for k in range(CHECK_STEPS):
        raw = torch.as_tensor(kept["raw"][k], device=run.device)
        xr = resample(raw, fs * rf, fs)[:, :L]
        out["data_err"] = max(out["data_err"], rel(kept["x"][k], xr))
        sigma, noise = kept["draws"][k]
        if sigma.shape[0] != xr.shape[0]:
            # the program drew for another batch than its loader gave it
            return {k: math.inf for k in CHECKS}
        P.update(opt.p)
        loss, items, grads = loss_and_grads(P, cfg, e, xr, sigma, noise,
                                            leaves)
        out["loss_err"] = max(out["loss_err"],
                              abs(kept["loss"][k] - loss) / abs(loss))
        out["item_loss_err"] = max(out["item_loss_err"], float(
            ((kept["items"][k].double().cpu() - items).abs() / items).max()))
        taken = opt.step(grads)
        if k == 0:
            g1 = taken
    b1 = opt.o.b1
    out["grad_err"], out["grad_med"] = leaf_gaps(
        {n: m / (1 - b1) for n, m in kept["mu1"].items()}, g1, leaves)
    gn = {k: float(g1[k].norm()) for k in leaves}
    med = statistics.median(gn.values())
    moved = [k for k in leaves if gn[k] >= 1e-3 * med]
    out["update_err"], out["update_med"] = leaf_gaps(
        {k: kept["p3"][k] - weights[k] for k in moved},
        {k: opt.p[k] - weights[k] for k in moved}, moved)
    out["ema_err"], out["ema_med"] = leaf_gaps(
        {k: kept["ema3"][k] - weights[k] for k in moved},
        {k: opt.ema[k] - weights[k] for k in moved}, moved)
    return {k: (math.inf if math.isnan(v) else v) for k, v in out.items()}
