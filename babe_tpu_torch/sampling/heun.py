"""Second-order stochastic Heun sampler (EDM), in PyTorch.

Counterpart of ``babe_tpu/sampling/heun.py``.  The JAX package runs the
reverse process as one ``lax.scan`` of predictor/corrector half-steps; here
it is a Python loop over the same steps, with the same arithmetic: the
stochastic time move, the denoiser, the Tweedie score with optional
reconstruction guidance (``torch.autograd.grad`` with respect to the input
only), and the final Euler step to t = 0, so no network evaluation sees
sigma = 0.

Noise comes from an explicit ``torch.Generator`` on the sampler's device;
every entry point takes an optional ``x_init`` (the initial state, already
scaled by t[0]) in place of the first noise draw.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from babe_tpu_torch.diffusion.edm import EDM


def make_norm_fn(ps_cfg: Any) -> Callable:
    """Reconstruction-error norm from the posterior_sampling config block."""
    norm = ps_cfg.get("norm", 2)
    stft_cfg = ps_cfg.get("stft_distance", {}) or {}
    if norm == "cosine":
        def fn(y, den_rec):
            cos = (y * den_rec).sum(-1) / (
                y.norm(dim=-1) * den_rec.norm(dim=-1) + 1e-6)
            return torch.clamp(1 - cos, min=0).sum()

        return fn
    if stft_cfg.get("use", False) or norm == "smoothl1":
        raise NotImplementedError(
            f"guidance norm {norm!r} / STFT distance is not ported yet")
    ord_ = float(norm)

    def fn(y, den_rec):
        d = (y - den_rec).reshape(y.shape[0], -1)
        return torch.linalg.vector_norm(d, ord=ord_, dim=-1).sum()

    return fn


@dataclass
class SamplerConfig:
    T: int = 35
    order: int = 2
    xi: float = 0.0
    data_consistency: bool = False
    snoise: float = 1.0
    snr_observations: float | None = None
    start_sigma: float | None = None
    filter_out_cqt_DC_Nyq: bool = True
    norm_fn: Callable = None
    audio_len: int = 184184

    @classmethod
    def from_args(cls, args) -> "SamplerConfig":
        t = args.tester
        ss = t.posterior_sampling.get("start_sigma", "None")
        snr = t.posterior_sampling.get("SNR_observations", "None")
        return cls(
            T=int(t.T),
            order=int(t.order),
            xi=float(t.posterior_sampling.xi),
            data_consistency=bool(t.posterior_sampling.data_consistency),
            snoise=float(t.diff_params.get("Snoise", 1.0))
            if not t.diff_params.get("same_as_training", True)
            else float(args.diff_params.get("Snoise", 1.0)),
            start_sigma=None if ss in ("None", None) else float(ss),
            snr_observations=None if snr in ("None", None) else float(snr),
            filter_out_cqt_DC_Nyq=bool(t.get("filter_out_cqt_DC_Nyq", True)),
            norm_fn=make_norm_fn(t.posterior_sampling),
            audio_len=int(args.exp.audio_len),
        )


def _randn(shape, gen: torch.Generator | None, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=device)


def _obs_noise(y: torch.Tensor, snr_db: float, gen) -> torch.Tensor:
    """y plus white noise at ``snr_db`` per item."""
    snr = 10.0 ** (snr_db / 10.0)
    sig = torch.sqrt(y.var(-1, correction=0, keepdim=True) / snr)
    return y + sig * _randn(y.shape, gen, y.device)


class Sampler:
    """EDM Heun sampler over a bound denoiser.

    denoiser: (x[B,T], sigma[B,1]) -> x_hat[B,T], the preconditioned
      D(x; sigma).  edm: supplies the schedule and gamma.  hpf: optional
      projection applied to denoised estimates."""

    def __init__(self, denoiser: Callable, edm: EDM, cfg: SamplerConfig,
                 hpf: Callable | None = None, device="cpu"):
        self.denoiser = denoiser
        self.edm = edm
        self.cfg = cfg
        self.hpf = hpf if cfg.filter_out_cqt_DC_Nyq else None
        self.device = torch.device(device)

    # ----------------------------------------------------------- internals

    def _denoise(self, x: torch.Tensor, t: float) -> torch.Tensor:
        sig = torch.full((x.shape[0], 1), float(t), dtype=torch.float32,
                         device=x.device)
        x_hat = self.denoiser(x, sig)
        if self.hpf is not None:
            x_hat = self.hpf(x_hat)
        return x_hat

    def _score(self, x, t: float, y=None, degradation=None, gen=None):
        cfg = self.cfg
        if y is None:
            with torch.no_grad():
                return (self._denoise(x, t) - x) / t**2
        if cfg.snr_observations is not None:
            y = _obs_noise(y, cfg.snr_observations, gen)
        if cfg.xi > 0:
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                x_hat = self._denoise(xg, t)
                nval = cfg.norm_fn(y, degradation(x_hat))
                (grads,) = torch.autograd.grad(nval, xg)
            x_hat = x_hat.detach()
            normguide = grads.norm() / cfg.audio_len**0.5
            # base-sampler scaling xi / (normguide * t + 1e-6); the blind
            # sampler scales differently (see blind.py)
            s = cfg.xi / (normguide * t + 1e-6)
            score = (x_hat - x) / t**2 - s * grads
            if cfg.data_consistency:
                with torch.no_grad():
                    x_dc = score * t**2 + x
                    x_dc = y + x_dc - degradation(x_dc)
                score = (x_dc - x) / t**2
            return score
        with torch.no_grad():
            x_hat = self._denoise(x, t)
            x_hat = y + x_hat - degradation(x_hat)
        return (x_hat - x) / t**2

    def _schedule(self, warm: bool):
        cfg = self.cfg
        if warm:
            t = self.edm.create_schedule_from_initial_t(cfg.start_sigma, cfg.T)
        else:
            t = self.edm.create_schedule(cfg.T)
        return t.tolist(), self.edm.get_gamma(t).tolist()

    def _run(self, gen, shape, y=None, degradation=None, x_init=None):
        cfg = self.cfg
        dev = y.device if y is not None else self.device
        warm = (cfg.start_sigma is not None and y is not None
                and tuple(y.shape) == tuple(shape))
        t, gamma = self._schedule(warm)
        if x_init is not None:
            x = x_init.to(dev, torch.float32)
        else:
            x = _randn(shape, gen, dev) * t[0]
            if warm:
                x = y + x

        def score(x_, t_):
            return self._score(x_, t_, y=y, degradation=degradation, gen=gen)

        def move(x_, t_i, g):
            t_hat = t_i + g * t_i
            eps = _randn(x_.shape, gen, dev) * cfg.snoise
            return x_ + math.sqrt(max(t_hat**2 - t_i**2, 0.0)) * eps, t_hat

        for i in range(cfg.T - 1):
            x_hat, t_hat = move(x, t[i], gamma[i])
            d1 = -t_hat * score(x_hat, t_hat)
            h = t[i + 1] - t_hat
            if cfg.order == 2:
                d = -t[i + 1] * score(x_hat + h * d1, t[i + 1])
                x = x_hat + h * 0.5 * (d1 + d)
            else:
                x = x_hat + h * d1
        x_hat, t_hat = move(x, t[cfg.T - 1], gamma[cfg.T - 1])
        sc = score(x_hat, t_hat)
        return x_hat + (0.0 - t_hat) * (-t_hat * sc)

    # ------------------------------------------------------------- public

    def predict_unconditional(self, gen, shape, x_init=None):
        return self._run(gen, shape, x_init=x_init)

    def predict_conditional(self, gen, y, degradation, x_init=None):
        return self._run(gen, y.shape, y=y, degradation=degradation,
                         x_init=x_init)

    def predict_bwe(self, gen, ylpf, filt, filt_type: str, x_init=None):
        from babe_tpu_torch.sampling import degradations as D

        deg = D.degradation_from_filter(filt, filt_type)
        return self.predict_conditional(gen, ylpf, deg, x_init=x_init)
