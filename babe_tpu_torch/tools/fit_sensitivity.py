"""How far the blind filter fit's end point moves when its arithmetic moves
by one float32 rounding, and so how closely two correct fits can agree.

The fit (``BlindSampler._fit_loop``, and the kernel ``csrc/filter_fit.cu``
on the card) is up to 100 steps of projected gradient descent on a loss
whose segments jump as a breakpoint crosses a bin, with clamps between the
breakpoints.  A difference of one rounding in a step can send the steps
down another path, so two fits that round in different orders (the plain
loop on the CPU and on the card, the kernel) need not end at the same
point.  This tool measures that spread for each case of ``FIT_CASES`` (the
cases the chip check runs), with the plain loop on the CPU, over
``--seeds`` draws of two kinds (draw 0 is the fit itself):

  * input: every per-bin statistic moved by -1, 0 or +1 float32 ulp;
  * step: every step's gradient entry scaled by 1 + u 2^-23 z, z standard
    normal (u = ``--ulps``, 1 by default: about one rounding of each entry,
    as another summation order gives; the kernel's gradient and the plain
    loop's differ by up to about 6, tests/test_torch_fit_engine.py).

It prints per row (fc, A) how far each draw's end point lies from draw
0's, beside the end-point bar of 1e-2 x the row's largest |value|.  With
``--kernel`` (needs a card) it also runs the kernel on each input draw and
prints its distance from the plain loop on the same draw.  Usage:

    python -m babe_tpu_torch.tools.fit_sensitivity [--seeds N] [--ulps U]
        [--kernel] [case ...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from babe_tpu_torch.sampling.blind import BlindConfig, BlindSampler
from babe_tpu_torch.sampling.heun import SamplerConfig

# BlindConfig overrides of the fit's cases; "tie" puts every breakpoint on a
# bin frequency, "tol exit" pins every fc at fcmax so the mean steps fall
# below tol (at iteration 24 on the CPU plain loop), "fc past Nyquist"
# starts two breakpoints at or past the last bin (one with an empty mask)
FIT_CASES = {
    "flagship": {},
    "K1": dict(init_fc=(300.0,), init_A=(-20.0,)),
    "K16": dict(init_fc=tuple(200.0 + 40.0 * i for i in range(16)),
                init_A=tuple(-10.0 - 2.0 * i for i in range(16))),
    "fc past Nyquist": dict(init_fc=(280.0, 285.0, 290.0, 11000.0,
                                     12000.0)),
    "tie": dict(init_fc="bins", max_iter=3),
    "tol exit": dict(fcmax=400.0, tol=(0.5, 0.5)),
    "max_iter": dict(max_iter=7),
    "A may be positive": dict(only_negative_A=False),
    # other grids: 513 bins leave 12 of a thread's 17 register slots empty,
    # 4097 bins run the 256-thread block
    "513 bins": dict(nfft=1024),
    "4097 bins": dict(nfft=8192),
}
FIT_BAR = 1e-2  # of a row's largest |value|: the end point's bar


def case_config(name: str) -> BlindConfig:
    kw = dict(FIT_CASES[name])
    if kw.get("init_fc") == "bins":  # exact bin frequencies
        fr = BlindSampler(None, None, SamplerConfig(), BlindConfig(
            nfft=kw.get("nfft", 4096)), device="cpu").freqs
        kw["init_fc"] = tuple(float(fr[n]) for n in (52, 60, 61, 300, 400))
    return BlindConfig(**kw)


def case_spectra(cfg: BlindConfig, seed: int = 4):
    """Random spectra X and a lowpassed Y = X (1 .. 0.01)^2 over the bins of
    ``cfg.nfft``, 92 frames: complex64 (1, F, 92) each."""
    F = cfg.nfft // 2 + 1
    rng = np.random.default_rng(seed)
    shape = (1, F, 92)
    X = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    Y = X * np.linspace(1.0, 0.01, F)[None, :, None] ** 2
    return tuple(torch.as_tensor(v.astype(np.complex64)) for v in (X, Y))


def perturbed(stats, draw: int):
    """The stats with every entry moved by -1, 0 or +1 float32 ulp (draw 0:
    unchanged)."""
    if draw == 0:
        return stats
    g = torch.Generator().manual_seed(draw)
    out = []
    for v in stats:
        step = torch.randint(-1, 2, v.shape, generator=g)
        up = torch.nextafter(v, torch.full_like(v, float("inf")))
        dn = torch.nextafter(v, torch.full_like(v, float("-inf")))
        out.append(torch.where(step > 0, up, torch.where(step < 0, dn, v)))
    return out


def row_err(x: torch.Tensor, ref: torch.Tensor) -> np.ndarray:
    return (x.double().cpu() - ref.double().cpu()).abs().amax(1).numpy()


def noisy_fit(s: BlindSampler, stats, p0: torch.Tensor, draw: int,
              ulps: float = 1.0):
    """``s._fit_loop`` with each step's gradient entries scaled by
    1 + ulps 2^-23 z (z standard normal, seeded by ``draw``)."""
    b, g_ = s.blind, torch.Generator().manual_seed(draw)
    p = p0.detach()
    for _ in range(b.max_iter):
        with torch.enable_grad():
            pg = p.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(s._objective_from_stats(stats, pg), pg)
        g = g * (1.0 + ulps * 2.0 ** -23 * torch.randn(g.shape,
                                                      generator=g_))
        newp = s._clamp(p - s._mu * g)
        done = (bool((newp[0] - p[0]).abs().mean() < b.tol[0])
                and bool((newp[1] - p[1]).abs().mean() < b.tol[1]))
        p = newp
        if done:
            break
    return p


def spread(name: str, seeds: int, kernel: bool, ulps: float = 1.0,
           log=print) -> dict:
    """End points over ``seeds`` draws of each kind (and the kernel's on
    each input draw with ``kernel``)."""
    cfg = case_config(name)
    s = BlindSampler(None, None, SamplerConfig(), cfg, device="cpu")
    X, Y = case_spectra(cfg)
    stats = s._fit_stats(X, Y)
    p0 = cfg.initial_params()
    with torch.enable_grad():
        ref = s._fit_loop(stats, p0)
    moved = {"input": [], "step": []}
    kerr = []
    for draw in range(seeds):
        st = perturbed(stats, draw)
        if draw:
            with torch.enable_grad():
                moved["input"].append(row_err(s._fit_loop(st, p0), ref))
            moved["step"].append(row_err(noisy_fit(s, stats, p0, draw, ulps),
                                           ref))
        if kernel:
            from babe_tpu_torch import kernels

            dev = BlindSampler(None, None, SamplerConfig(), cfg,
                               device="cuda")
            k = kernels.launch_filter_fit(
                torch.stack(st).cuda().contiguous(), dev.freqs,
                cfg.initial_params("cuda"), cfg)
            with torch.enable_grad():
                kerr.append(row_err(k, s._fit_loop(st, p0) if draw else ref))
    bar = FIT_BAR * ref.abs().amax(1).double().numpy()

    def fmt(rows):
        return "; ".join(f"{m[0]:.4g} {m[1]:.4g}" for m in rows) or "-"

    log(f"[{name}] bar (fc, A) {bar[0]:.4g} {bar[1]:.4g} | plain end point "
        f"moved by (fc, A) over {seeds - 1} input draws: "
        f"{fmt(moved['input'])} | over {seeds - 1} step draws of {ulps:g} "
        f"ulp: "
        f"{fmt(moved['step'])}"
        + (f" | kernel vs plain on each input draw: {fmt(kerr)}"
           if kernel else ""))
    return {"case": name, "bar": bar.tolist(),
            **{k: [m.tolist() for m in v] for k, v in moved.items()},
            "kernel": [e.tolist() for e in kerr]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", default=list(FIT_CASES))
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--ulps", type=float, default=1.0)
    ap.add_argument("--kernel", action="store_true")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if a.kernel and not torch.cuda.is_available():
        print("fit_sensitivity: --kernel needs a CUDA device", file=sys.stderr)
        return 2
    for name in a.cases:
        spread(name, a.seeds, a.kernel, a.ulps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
