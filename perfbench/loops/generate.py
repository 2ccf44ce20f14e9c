"""Unconditional generation: ``Tester.unconditional`` (on one process,
``predict_unconditional`` of ``Tester.sampler()``) on batches of clips,
back to back (a closed loop with one client).

The window counts denoiser evaluations, as restoration does.  A few Heun
steps of the first batch, drawn from the seed, are kept: each one's state
after the stochastic move (x_hat, t_hat), its first denoised estimate and
the state it handed on.  Once the window has closed the plain reference
takes the same steps from the same states in float32; the largest gaps
are compared:

  den_err    ||x_den - ref|| / ||ref's network term|| of the step's first
             denoised estimate
  step_err   ||x_next - ref|| / ||ref - x_hat||: the step's update (two
             evaluations and the Heun average; Euler on the last step)
"""

from __future__ import annotations

import math
import random

import torch

from perfbench.loops import (Clock, WindowClosed, build_program,
                               close_window, free, model_counts, net_config,
                               reference_precision, rel, start_window)
from perfbench.weights import derive

CHECKS = ("den_err", "step_err")

class Cell:
    def __init__(self, run):
        from babe_tpu_torch.setup import setup_diff_parameters
        from babe_tpu_torch.testers.tester import Tester

        self.run = run
        self.args, self.model, self.weights = build_program(run, remat=False)
        self.model.net.requires_grad_(False)
        diff = setup_diff_parameters(self.args,
                                     cqt_hpf=self.model.apply_hpf_DC)
        self.tester = Tester(self.args, self.model, diff, device=run.device)
        self.tester.loaded = True
        u = self.args.tester.unconditional
        self.shape = (int(u.num_samples), int(u.audio_len))
        self.L = int(self.args.exp.audio_len)
        if self.shape[1] != self.L:
            raise ValueError("tester.unconditional.audio_len has to be the "
                             "network's exp.audio_len")
        self.fs = float(self.args.exp.sample_rate)
        T = int(self.args.tester.T)
        self.E = int(self.args.tester.order) * (T - 1) + 1
        self.sampler = self.tester.sampler()
        self.clock = Clock()
        self.batch = 0
        self.moves = 0
        self.want: set = set()     # (batch, step) pairs kept for the check
        self.kept: dict = {}       # step -> its state and results
        self.last = None
        s = self.sampler
        move, score = s._move, s._score

        def _move(x, t_i, g, gen, snoise=1.0):
            prev = self.kept.get(self.moves - 1)
            if prev is not None and "x_next" not in prev:
                prev["x_next"] = x.detach().clone()
            out = move(x, t_i, g, gen, snoise)
            if (self.batch, self.moves) in self.want:
                self.kept[self.moves] = {"x_hat": out[0].detach().clone(),
                                         "t_hat": float(out[1]),
                                         "step": self.moves}
            self.moves += 1
            return out

        def _score(x, t, **kw):
            self.clock.before()
            out = score(x, t, **kw)
            k = self.kept.get(self.moves - 1)
            if k is not None and "x_den" not in k:
                k["x_den"] = (out * t**2 + x).detach().clone()
            self.last = out
            self.clock.tick()
            return out

        s._move, s._score = _move, _score

    def serve(self, k: int) -> bool:
        gen = torch.Generator(device=self.run.device).manual_seed(
            derive(self.run.seed, f"sampler{k}"))
        self.batch, self.moves = k, 0
        # Tester.unconditional on one process: its sampler's
        # predict_unconditional (this sampler, instrumented)
        x = self.sampler.predict_unconditional(gen, self.shape)
        last = self.kept.get(self.moves - 1)
        if k == 0 and last is not None and "x_next" not in last:
            last["x_next"] = x.detach().clone()
        return bool(torch.isfinite(x).all())

    def warm_up(self) -> None:
        self.clock.stop_after = 2
        try:
            self.serve(-1)
        except WindowClosed:
            pass


def run(run) -> None:
    cell = Cell(run)
    cell.warm_up()
    cell.want = pick(run, cell)
    t0 = start_window(run, cell.clock)
    k = 0
    try:
        while True:
            run.attempted += 1
            run.failed += 0 if cell.serve(k) else 1
            k += 1
    except WindowClosed:
        if cell.last is not None and not bool(torch.isfinite(cell.last).all()):
            run.failed += 1
    close_window(run, cell.clock, t0)
    run.audio_s = cell.shape[0] * cell.L / cell.fs * run.units / cell.E
    run.counts = model_counts(run, cell.L, cell.fs, cell.shape[0],
                              {"forward": 1})
    kept, weights = list(cell.kept.values()), cell.weights
    del cell
    free()
    for name, v in compare(run, kept, weights).items():
        run.check(name, v)


def pick(run, cell) -> set:
    """The (batch, step) pairs kept for the check: ``check_steps`` steps of
    the first batch, drawn from the seed."""
    T = int(cell.args.tester.T)
    rng = random.Random(derive(run.seed, "check"))
    return {(0, i) for i in rng.sample(range(T), int(
        run.mix["check_steps"]))}


def control_step(cell, k: dict) -> dict:
    """A kept step taken again by the program as it is set now (the
    control: its int8 path switched on), from the same state."""
    s = cell.sampler
    score = type(s)._score
    t, _ = s._schedule(False)
    t_hat, t_next, x_hat = k["t_hat"], float(t[k["step"] + 1]), k["x_hat"]
    s1 = score(s, x_hat, t_hat)
    d1 = -t_hat * s1
    h = t_next - t_hat
    x_next = x_hat + h * d1
    if t_next != 0.0:
        x_next = x_hat + h * 0.5 * (d1 - t_next * score(s, x_next, t_next))
    return dict(k, x_den=s1 * t_hat**2 + x_hat, x_next=x_next)


def compare(run, kept: list, weights) -> dict:
    """The largest gaps over the kept steps against the reference's step
    from the same state."""
    from perfbench.reference.diffusion import EDMConfig, heun_step, schedule

    kept = [k for k in kept if "x_next" in k and "x_den" in k]
    if not kept:
        return {"den_err": math.inf, "step_err": math.inf}
    reference_precision()
    cfg = net_config(run)
    dp = run.config["tester"]["diff_params"]
    e = EDMConfig(float(dp["sigma_data"]))
    t = schedule(float(dp["sigma_max"]), float(dp["sigma_min"]),
                 float(dp["ro"]), int(run.config["tester"]["T"]))
    worst = {"den_err": 0.0, "step_err": 0.0}
    for k in kept:
        x_next, x_den, net = heun_step(
            weights, cfg, e, k["x_hat"], k["t_hat"], float(t[k["step"] + 1]))
        worst["den_err"] = max(worst["den_err"], rel(k["x_den"], x_den, net))
        worst["step_err"] = max(worst["step_err"], rel(
            k["x_next"], x_next, x_next - k["x_hat"]))
    return worst
