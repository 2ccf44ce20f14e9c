"""Training on one device: Adam with the linear LR ramp, the global-norm
clip, the non-finite guard and the EMA.

Counterpart of ``babe_tpu/training/trainer.py``.  The optimizer is written
out here rather than taken from ``torch.optim``, so that it does what the
JAX package's optax chain (``clip_by_global_norm`` then ``adam`` with a
schedule) does, operation for operation in fp32:

  * the clip scales by max_norm / norm (no epsilon), only when norm >=
    max_norm; ``grad_norm`` in the metrics is the unclipped norm;
  * Adam's moments, its bias correction at count + 1 and
    m / (sqrt(v) + eps);
  * the learning rate lr * min(count / rampup, 1) at the schedule's count
    before its increment, so the first update has rate 0;
  * the EMA with its warm-up over samples, t = it * batch, it taken before
    its increment;
  * the non-finite guard: the loss and the gradients' norm are checked
    first (one host read per step), and a non-finite step changes nothing,
    not the params, the moments, the counts, the EMA nor ``it``;
  * gradient accumulation (``exp.num_accumulation_rounds``) as the mean of
    the rounds' gradients, and the sigma-binned loss statistics.

Random draws (the training sigmas and noise) come from one
``torch.Generator`` on the training device, seeded from ``exp.seed``; the
weights from the model's seeded init.  Checkpoints are the JAX trainer's
pickles: params, buffers, EMA and Adam's state in the JAX layout
(``utils/weights.py``), readable by both packages' loaders.

Not ported, each raising ``NotImplementedError`` naming ROADMAP.md when
configured: the tester demos of heavy logging (a run that would reach
``logging.heavy_log_interval`` with ``tester.do_test`` on), the
progressive-distillation teacher and the orbax checkpoint backend.  The
trainer runs on one device.
"""

from __future__ import annotations

import glob
import math
import os
import pickle
import re
import time

import numpy as np
import torch

from babe_tpu_torch.ops.resample import resample, resample_batch
from babe_tpu_torch.testers.tester import read_checkpoint
from babe_tpu_torch.utils.device import check_device
from babe_tpu_torch.utils.logging import MetricsLogger, plot_loss_by_sigma
from babe_tpu_torch.utils.profiling import ScheduledProfiler
from babe_tpu_torch.utils.weights import (
    adam_state_from_flax,
    adam_state_to_flax,
    from_flax,
    load_flax,
    to_flax,
    to_tree,
)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")


class Trainer:
    """The training loop around one model on one device."""

    def __init__(self, args, dset, model, edm, device="cuda"):
        teacher = args.get_path("diff_params.PD.teacher_checkpoint", None)
        if teacher not in (None, "None", ""):
            raise _not_ported("progressive distillation (the PD teacher)")
        if str(args.exp.get("ckpt_backend", "pickle")).lower() != "pickle":
            raise _not_ported("the orbax checkpoint backend")
        self.device = check_device(device)
        self.args, self.dset, self.model, self.edm = args, dset, model, edm
        exp = args.exp
        seed = int(exp.get("seed", 42))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        model.init(seed=seed, device=self.device)
        self.net = model.net
        self.params = dict(self.net.named_parameters())
        self.ema = {k: p.detach().clone() for k, p in self.params.items()}
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0        # Adam's count
        self.sched_count = 0  # the LR schedule's count
        self.it = 0
        self.total_params = sum(p.numel() for p in self.params.values())

        self.lr = float(exp.lr)
        self.rampup = max(int(exp.get("lr_rampup_it", 0)), 1)
        self.max_norm = (float(exp.get("max_grad_norm", 1.0))
                         if exp.get("use_grad_clip", True) else None)
        opt = exp.get("optimizer", {})
        self.b1 = float(opt.get("beta1", 0.9))
        self.b2 = float(opt.get("beta2", 0.999))
        self.eps = float(opt.get("eps", 1e-8))
        self.ema_rate = float(exp.get("ema_rate", 0.9999))
        self.ema_rampup = float(exp.get("ema_rampup", 10000))
        self.batch_size = int(exp.get("batch", 4))
        self.num_accum = int(exp.get("num_accumulation_rounds", 1))
        self.use_dc = bool(exp.get("use_cqt_DC_correction", False))

        nb = int(args.get_path("logging.num_sigma_bins", 10))
        smin, smax = edm.p.sigma_min, edm.p.sigma_max
        self.bin_edges = torch.logspace(
            math.log10(smin), math.log10(smax), nb, dtype=torch.float32,
            device=self.device)
        self.sigma_bins = np.logspace(np.log10(smin), np.log10(smax), nb)

        self._resumed = False
        if bool(exp.get("resume", False)):
            self._resumed = self.resume_from_checkpoint()
        self.metrics_log = MetricsLogger(
            os.path.join(str(args.model_dir), "train_logs"))
        self.profiler = ScheduledProfiler.from_config(args)
        self._stat_buffer: list[dict] = []

    # ----------------------------------------------------------- checkpoints

    def _ckpt_path(self, it: int) -> str:
        return os.path.join(str(self.args.model_dir),
                            f"{self.args.exp.exp_name}-{it}.ckpt")

    def _state_payload(self) -> dict:
        params, buffers = to_flax(self.net)
        return {
            "it": int(self.it), "params": params, "buffers": buffers,
            "opt_state": adam_state_to_flax(
                self.count, self.mu, self.nu, self.sched_count,
                clip=self.max_norm is not None),
            "ema": to_tree(self.ema),
        }

    def save_checkpoint(self) -> str:
        """``<model_dir>/<exp_name>-<it>.ckpt``: it, params, buffers,
        opt_state, ema and args, as the JAX trainer writes it."""
        os.makedirs(str(self.args.model_dir), exist_ok=True)
        path = self._ckpt_path(self.it)
        with open(path, "wb") as f:
            pickle.dump(dict(self._state_payload(), args=self.args.to_dict()),
                        f)
        if bool(self.args.get_path("logging.remove_last_checkpoint", False)):
            prev = getattr(self, "_latest_ckpt", None)
            if prev and prev != path and os.path.exists(prev):
                os.remove(prev)
        self._latest_ckpt = path
        return path

    def resume_from_checkpoint(self, path: str | None = None) -> bool:
        """Resume from ``path`` or from the latest ``<exp_name>-<it>.ckpt``
        in model_dir (written by either package): params, buffers, EMA,
        Adam's moments and counts, and ``it``."""
        if path is None:
            name = str(self.args.exp.exp_name)
            rx = re.compile(rf"{re.escape(name)}-(\d+)\.ckpt$")
            found = [(int(m.group(1)), p) for p in glob.glob(os.path.join(
                str(self.args.model_dir), f"{name}-*.ckpt"))
                for m in [rx.search(p)] if m]
            if not found:
                return False
            path = max(found)[1]
        payload = read_checkpoint(path)
        load_flax(self.net, payload["params"], payload.get("buffers", {}))
        count, mu, nu, sched = adam_state_from_flax(payload["opt_state"])
        for dst, src in ((self.ema, from_flax(payload["ema"])), (self.mu, mu),
                         (self.nu, nu)):
            if set(src) != set(dst):
                raise ValueError(f"checkpoint {path} does not fit this "
                                 f"model: its EMA or optimizer state names "
                                 f"other parameters")
            for k, v in src.items():
                dst[k].copy_(v.to(dst[k].device))
        self.count, self.sched_count = count, sched
        self.it = int(payload["it"])
        self._latest_ckpt = path
        print(f"resumed from {path} (it={self.it})")
        return True

    # ------------------------------------------------------------ the step

    def get_batch(self) -> torch.Tensor:
        """The next batch on the device, resampled to the model's rate and
        cropped to exp.audio_len."""
        batch = next(self.dset)
        exp = self.args.exp
        if isinstance(batch, tuple):
            audio, fs = batch
            return resample_batch(torch.as_tensor(audio, device=self.device),
                                  fs, int(exp.sample_rate),
                                  int(exp.audio_len))
        audio = torch.as_tensor(np.asarray(batch, np.float32),
                                device=self.device)
        rf = int(exp.get("resample_factor", 1))
        if rf != 1:
            audio = resample(audio, rf, 1)
        return audio[:, :int(exp.audio_len)]

    def _grads(self, x, sigma=None, noise=None):
        """(loss, grads, error2, sigma): the mean of the rounds' losses and
        gradients (a batch of exp.batch items per round)."""
        rounds = self.num_accum
        xs = x.reshape(rounds, -1, x.shape[-1])
        for p in self.params.values():
            p.grad = None
        losses, e2s, sigs = [], [], []
        for r in range(rounds):
            s_r = None if sigma is None else sigma.reshape(rounds, -1, 1)[r]
            n_r = None if noise is None else noise.reshape(
                rounds, -1, noise.shape[-1])[r]
            err2, sig = self.edm.loss_fn(self.gen, self.model.apply, xs[r],
                                         self.use_dc, sigma=s_r, noise=n_r)
            loss = err2.mean()
            loss.backward()
            losses.append(loss.detach())
            e2s.append(err2.detach())
            sigs.append(sig.detach())
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        loss = losses[0]
        if rounds > 1:
            grads = {k: g / rounds for k, g in grads.items()}
            loss = sum(losses[1:], losses[0]) / rounds
        for p in self.params.values():
            p.grad = None
        return loss, grads, torch.cat(e2s), torch.cat(sigs)

    @torch.no_grad()
    def _apply_update(self, grads, gnorm) -> None:
        """The optax chain's update, then the EMA and ``it``."""
        f32 = dict(dtype=torch.float32, device=self.device)
        if self.max_norm is not None and not bool(gnorm < self.max_norm):
            grads = {k: g / gnorm * self.max_norm for k, g in grads.items()}
        self.count += 1
        bc1 = 1.0 - torch.tensor(self.b1, **f32) ** self.count
        bc2 = 1.0 - torch.tensor(self.b2, **f32) ** self.count
        step = torch.tensor(self.sched_count, **f32) / self.rampup
        neg_lr = -(self.lr * torch.clamp(step, max=1.0))
        self.sched_count += 1
        for k, p in self.params.items():
            g, m, v = grads[k], self.mu[k], self.nu[k]
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(upd * neg_lr)
        t = torch.tensor(self.it, **f32) * self.batch_size
        if bool(t < self.ema_rampup):
            s = torch.clamp(t / self.ema_rampup, 0.0, self.ema_rate)
        else:
            s = torch.tensor(self.ema_rate, **f32)
        for k, p in self.params.items():
            e = self.ema[k]
            e.copy_(e * s + p * (1.0 - s))
        self.it += 1

    def _step(self, x, sigma=None, noise=None) -> dict:
        loss, grads, error2, sig = self._grads(x, sigma, noise)
        gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        finite = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if finite:
            self._apply_update(grads, gnorm)
        per_item = error2.mean(dim=tuple(range(1, error2.dim())))
        idx = torch.searchsorted(self.bin_edges, sig.reshape(-1).float())
        nb1 = self.bin_edges.numel() + 1

        def binned(v):
            return torch.zeros(nb1, device=v.device).index_add_(0, idx, v)

        return {"loss": loss, "grad_norm": gnorm, "nonfinite": not finite,
                "sigma_bin_sums": binned(per_item),
                "sigma_bin_sqsums": binned(per_item ** 2),
                "sigma_bin_counts": binned(torch.ones_like(per_item))}

    def train_step(self, batch=None, sigma=None, noise=None) -> dict:
        """One step on ``batch`` (the next one from the stream by default).
        ``sigma`` [N,1] and ``noise`` [N,T] (the prior draw, scaled by
        sigma) replace the generator's draws when given."""
        x = self.get_batch() if batch is None else torch.as_tensor(
            batch, dtype=torch.float32, device=self.device)
        return self._step(x, sigma, noise)

    # ------------------------------------------------------------- logging

    def easy_logging(self, it: int):
        """Aggregate the buffered step statistics into one record, and plot
        the loss by sigma."""
        if not self._stat_buffer:
            return
        buf = self._stat_buffer
        losses = np.asarray([m["loss"] for m in buf])
        gnorms = np.asarray([m["grad_norm"] for m in buf])
        sums = np.sum([m["sigma_bin_sums"] for m in buf], axis=0)
        sqsums = np.sum([m["sigma_bin_sqsums"] for m in buf], axis=0)
        counts = np.sum([m["sigma_bin_counts"] for m in buf], axis=0)
        per_bin = sums / np.maximum(counts, 1.0)
        per_bin_std = np.sqrt(np.maximum(
            sqsums / np.maximum(counts, 1.0) - per_bin**2, 0.0))
        rec = {"loss": float(losses.mean()), "loss_std": float(losses.std()),
               "grad_norm": float(gnorms.mean())}
        for edge, v, c in zip(self.sigma_bins, per_bin, counts):
            if c > 0:
                rec[f"error_sigma_{edge:.3g}"] = float(v)
        self.metrics_log.log(rec, step=it)
        nb = len(self.sigma_bins)
        used = counts[:nb] > 0
        if used.any():
            plot_loss_by_sigma(
                per_bin[:nb][used], per_bin_std[:nb][used],
                self.sigma_bins[used],
                os.path.join(str(self.args.model_dir), "train_logs",
                             "loss_by_sigma.png"))
        buf.clear()

    @torch.no_grad()
    def freq_logging(self, it: int, batch: torch.Tensor):
        """Mean CQT magnitude of the training error per octave."""
        err2, _ = self.edm.loss_fn(self.gen, self.model.apply, batch)
        coeffs = self.model.cqt.fwd(torch.sqrt(err2))
        self.metrics_log.log({f"error_oct_{o}": float(c.abs().mean())
                              for o, c in enumerate(coeffs)}, step=it)

    @torch.no_grad()
    def log_feature_stats(self, it: int, batch: torch.Tensor):
        """Mean and std of every network module's output on one noisy
        batch (forward hooks; the JAX package captures intermediates)."""
        sigma = self.edm.sample_ptrain_safe(self.gen, batch.shape[0])[:, None]
        inp, _, cnoise = self.edm.prepare_train_preconditioning(
            self.gen, batch, sigma)
        rec, hooks = {}, []

        def hook(name):
            def fn(_mod, _inp, out):
                if isinstance(out, (tuple, list)):
                    out = next((o for o in out if torch.is_tensor(o)), None)
                if torch.is_tensor(out) and len(rec) < 400:
                    a = out.detach()
                    a = (a.abs() if a.is_complex() else a).float()
                    rec[f"feat/{name}/mean"] = float(a.mean())
                    rec[f"feat/{name}/std"] = float(a.std())
            return fn

        for name, mod in self.net.named_modules():
            if name:
                hooks.append(mod.register_forward_hook(
                    hook(name.replace(".", "/"))))
        try:
            self.net(self.model.cqt.fwd(inp), cnoise)
        finally:
            for h in hooks:
                h.remove()
        self.metrics_log.log(rec, step=it)

    # ------------------------------------------------------------ main loop

    def training_loop(self, max_its: int | None = None):
        log_cfg = self.args.get("logging", {})
        save_interval = int(log_cfg.get("save_interval", 10000))
        log_interval = int(log_cfg.get("log_interval", 100))
        heavy_interval = int(log_cfg.get("heavy_log_interval", 50000))
        freq_interval = int(log_cfg.get("freq_cqt_logging", 0) or 0)
        feat_interval = (int(log_cfg.get("log_feature_stats_interval", 0))
                         if log_cfg.get("log_feature_stats", False) else 0)
        max_nonfinite = int(log_cfg.get("max_consecutive_nonfinite", 20))
        if (bool(self.args.get_path("tester.do_test", False))
                and heavy_interval > 0
                and (max_its is None or max_its >= heavy_interval)):
            raise _not_ported("heavy logging (the tester demos at "
                              "logging.heavy_log_interval; run with "
                              "tester.do_test=false)")
        it0 = self.it
        t_start = time.time()
        streak = 0
        while max_its is None or self.it < max_its:
            batch = self.get_batch()
            metrics = self._step(batch)
            self.profiler.step()
            it = self.it
            if metrics["nonfinite"]:
                streak += 1
                print(f"WARNING: non-finite loss/grads at it {it} — update "
                      f"skipped ({streak} consecutive)", flush=True)
                if streak >= max_nonfinite:
                    raise RuntimeError(
                        f"{streak} consecutive non-finite training steps at "
                        f"it {it}; halting (tune lr/grad-clip, or raise "
                        f"logging.max_consecutive_nonfinite)")
            else:
                streak = 0
                self._stat_buffer.append(
                    {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                     for k, v in metrics.items()})
            if it % log_interval == 0:
                rate = (it - it0) / max(time.time() - t_start, 1e-9)
                print(f"it {it} loss {float(metrics['loss']):.5f} it/s "
                      f"{rate:.2f}", flush=True)
                self.easy_logging(it)
            if freq_interval and it % freq_interval == 0:
                self.freq_logging(it, batch)
            if feat_interval and it > 0 and it % feat_interval == 0:
                self.log_feature_stats(it, batch)
            if (it > 0 and it % save_interval == 0
                    and log_cfg.get("save_model", True)):
                self.save_checkpoint()
        self.profiler.close()
        return self
