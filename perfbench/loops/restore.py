"""Blind restoration: ``BlindSampler.predict_blind_bwe`` from
``Tester.sampler()`` on requests of several segments of one band-limited
recording, back to back (a closed loop with one client).

The window counts guided evaluations: a request that the window's end cuts
counts by the evaluations it completed.  A sample of the first request's
evaluations, drawn from the seed, is kept (the sampler's state going in and
what the evaluation gave back); once the window has closed and the
program's state is freed, the plain reference runs each of them again from
the same state in float32 and the gaps are compared with the cell's limits:

  den_err    ||x_den - ref|| / ||ref's network term||: the denoised
             estimate (CQT, U-Net, EDM preconditioning, the band
             projection) against the part of it the network makes
  fit_err    |J(program's filter) - J(reference's)| / J(reference's), J the
             fit's objective on the program's own denoised estimate and
             the reference's filter the reference's fit of it from the same
             start: the fit is a projected descent with a tolerance exit
             whose end point (fc, A) moves far under the smallest change
             of its input, while the objective it reaches does not
  guide_err  ||guide - ref|| / ||ref|| of the guidance term, (x_den -
             x_hat) / t^2 - score, the reference's under the program's
             fitted filter (the input gradient through the network, the
             STFT, the filter)
"""

from __future__ import annotations

import math
import random
import time

import torch

from perfbench import traffic
from perfbench.loops import (Clock, WindowClosed, build_program,
                               close_window, free, model_counts, net_config,
                               reference_precision, rel, start_window)
from perfbench.weights import derive

CHECKS = ("den_err", "guide_err", "fit_err")

def evals_per_request(args) -> int:
    T, order = int(args.tester.T), int(args.tester.order)
    return order * (T - 1) + 1


class Cell:
    """The program of a restoration cell, built and instrumented."""

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
        self.sampler = self.tester.sampler()
        self.clock = Clock()
        self.wanted: set = set()
        self.samples: list = []
        self.request = 0
        self.in_request = 0
        self.last = None
        self.L = int(self.args.exp.audio_len)
        self.fs = float(self.args.exp.sample_rate)
        self.E = evals_per_request(self.args)
        orig = self.sampler._stage

        def stage(x_hat, t_cur, params, y, Y, gen, den_noise=None):
            self.clock.before()
            out = orig(x_hat, t_cur, params, y, Y, gen, den_noise)
            if (self.request, self.in_request) in self.wanted:
                self.samples.append({
                    "x_hat": x_hat.detach().clone(), "t": float(t_cur),
                    "params": params.detach().clone(), "y": y,
                    "score": out[0].detach().clone(),
                    "params_out": out[1].detach().clone(),
                    "x_den": out[2].detach().clone()})
            self.in_request += 1
            self.last = out[0]
            self.clock.tick()
            return out

        self.sampler._stage = stage

    def serve(self, k: int) -> tuple[bool, float]:
        """Request k: (finite, seconds from the call to a synchronize
        after it); raises WindowClosed when the window ends inside it."""
        run = self.run
        y, _ = traffic.restore_request(run.mix, run.seed, k, self.L, self.fs,
                                       run.device)
        gen = torch.Generator(device=run.device).manual_seed(
            derive(run.seed, f"sampler{k}"))
        self.request, self.in_request = k, 0
        t = time.perf_counter()
        x, params = self.sampler.predict_blind_bwe(gen, y)
        ok = bool(torch.isfinite(x).all() & torch.isfinite(params).all())
        return ok, time.perf_counter() - t

    def warm_up(self) -> None:
        """Every shape of the cell's requests: the two stages of one Heun
        step (the kernels built and loaded, the FFT plans made)."""
        self.clock.stop_after = 2
        try:
            self.serve(-1)
        except WindowClosed:
            pass


def pick(run, E: int) -> set:
    """The (request, evaluation) pairs whose state is kept for the check:
    ``check_evaluations`` of the first request's, its first (where the
    fit starts from the initial filter, far from its end point) and the
    rest drawn from the seed."""
    rng = random.Random(derive(run.seed, "check"))
    n = int(run.mix["check_evaluations"])
    return {(0, 0)} | {(0, i) for i in rng.sample(range(1, E), n - 1)}


def run(run) -> None:
    cell = Cell(run)
    cell.warm_up()
    cell.wanted = pick(run, cell.E)
    t0 = start_window(run, cell.clock)
    k = 0
    try:
        while True:
            run.attempted += 1
            ok, secs = cell.serve(k)
            run.span("request_s", secs)
            run.failed += 0 if ok else 1
            k += 1
    except WindowClosed:
        if cell.last is not None and not bool(torch.isfinite(cell.last).all()):
            run.failed += 1
    close_window(run, cell.clock, t0)
    S = int(run.mix["segments"])
    run.audio_s = S * cell.L / cell.fs * run.units / cell.E
    run.counts = model_counts(run, cell.L, cell.fs, S,
                              {"forward": 1, "input_grad": 1})
    samples, weights = cell.samples, cell.weights
    del cell
    free()
    for name, v in compare(run, samples, weights).items():
        run.check(name, v)


def blind_config(run):
    from perfbench.reference.diffusion import BlindConfig

    t = run.config["tester"]
    bb, opt = t["blind_bwe"], t["blind_bwe"]["optimization"]
    fs = float(run.config["exp"]["sample_rate"])
    fcmax = bb["fcmax"]
    return BlindConfig(
        nfft=int(bb["NFFT"]), sample_rate=fs,
        mu=tuple(float(m) for m in opt["mu"]),
        tol=tuple(float(v) for v in opt["tol"]),
        max_iter=int(opt["max_iter"]), fcmin=float(bb["fcmin"]),
        fcmax=fs / 2 if fcmax == "nyquist" else float(fcmax),
        Amin=float(bb["Amin"]), xi=float(t["posterior_sampling"]["xi"]),
        audio_len=int(run.config["exp"]["audio_len"]))


def reference(run, samples, weights, quant_bits=None,
              outputs=None) -> list:
    """The reference's readings of each kept evaluation, from its state in
    float32 (``quant_bits``: with the (5,3) convs of the int8 stacks in
    that many bits): the denoised estimate and its network term; the fit
    objective, on the statistics of the program's denoised estimate, at
    the reference's end point, at the program's and at the start; the
    guidance term under the program's fitted filter.  ``outputs``
    (default: what the program gave back) supplies the denoised estimate
    and the fitted filter."""
    from perfbench.reference.diffusion import (EDMConfig, denoise, fit,
                                               fit_stats, freqs_of, guidance,
                                               objective, stft)

    reference_precision()
    cfg = net_config(run, quant_bits)
    e = EDMConfig(float(run.config["tester"]["diff_params"]["sigma_data"]))
    b = blind_config(run)
    out = []
    for s, o in zip(samples, outputs or samples):
        with torch.no_grad():
            x_den, net = denoise(weights, cfg, e, s["x_hat"], s["t"],
                                 parts=True)
            f = freqs_of(b, s["y"].device)
            X, Y = stft(o["x_den"], b.nfft), stft(s["y"], b.nfft)
            p_ref = fit(b, f, X, Y, s["params"])
            stats = [v.double() for v in fit_stats(X, Y)]
            J = [float(objective(stats, p.double(), f.double()))
                 for p in (p_ref, o["params_out"], s["params"])]
        g = guidance(weights, cfg, e, b, s["x_hat"], s["t"], o["params_out"],
                     s["y"])
        out.append({"x_den": x_den, "net": net, "J": J, "guide": g})
    return out


def gaps(o: dict, ref: dict) -> dict:
    """The compared numbers of one evaluation against the reference's."""
    guide_p = (o["x_den"] - o["x_hat"]) / o["t"] ** 2 - o["score"]
    J_ref, J_prog, _ = ref["J"]
    return {"den_err": rel(o["x_den"], ref["x_den"], ref["net"]),
            "guide_err": rel(guide_p, ref["guide"]),
            "fit_err": abs(J_prog - J_ref) / J_ref}


def compare(run, samples, weights, outputs=None, refs=None) -> dict:
    """The largest gaps over the kept evaluations between what the program
    gave back (or ``outputs`` at the same states) and the reference."""
    if not samples:
        return {k: math.inf for k in CHECKS}
    outputs = outputs or samples
    refs = reference(run, samples, weights, outputs=outputs) if refs is None \
        else refs
    worst: dict = {}
    for o, r in zip(outputs, refs):
        for k, v in gaps(o, r).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
