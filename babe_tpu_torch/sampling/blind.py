"""BABE blind sampler: joint posterior sampling and degradation-filter
estimation, in PyTorch.

Counterpart of ``babe_tpu/sampling/blind.py``.  Per Heun stage:

  1. denoise with the graph kept (one forward through the network),
  2. projected-gradient filter fit on the (fc_k, A_k) parameters against the
     frequency-weighted STFT-magnitude mismatch, with per-parameter step
     sizes, sequential monotonicity clamps and a tolerance exit; on the
     card the whole loop is one kernel, on the CPU a loop of ``max_iter``
     iterations with a ``done`` mask (once done is set the parameters
     freeze), so the host never waits on a value,
  3. reconstruction-guidance gradient through the network with the updated
     filter (``torch.autograd.grad`` with respect to the input only),
  4. Tweedie score plus guidance scaled xi/(normguide+1e-6)·rec/t, then the
     Heun update.

The observation STFT is computed once per request.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from babe_tpu_torch import kernels as _k
from babe_tpu_torch.diffusion.edm import EDM
from babe_tpu_torch.ops.filters import _freq_weighting, design_filter
from babe_tpu_torch.ops.stft import apply_filter_istft, apply_stft, rfftfreq
from babe_tpu_torch.sampling import degradations as D
from babe_tpu_torch.sampling.heun import (
    Sampler,
    SamplerConfig,
    _obs_noise,
    _randn,
)


@dataclass
class BlindConfig:
    nfft: int = 4096
    sample_rate: float = 22050.0
    mu: tuple[float, float] = (1000.0, 10.0)
    tol: tuple[float, float] = (5e-3, 5e-3)
    max_iter: int = 100
    clamp_fc: bool = True
    clamp_A: bool = True
    only_negative_A: bool = True
    fcmin: float = 20.0
    fcmax: float = 11025.0
    Amin: float = -50.0
    Amax: float = 30.0
    init_fc: tuple = (280, 285, 290, 295, 300)
    init_A: tuple = (-15, -17, -20, -25, -30)
    freq_weighting_filter: str = "sqrt"

    @classmethod
    def from_args(cls, args) -> "BlindConfig":
        bb = args.tester.blind_bwe
        if float(bb.get("sigma_den_estimate", 0.0) or 0.0) > 0:
            raise NotImplementedError(
                "blind_bwe.sigma_den_estimate > 0 (a noise-regularised "
                "filter fit) is not ported yet")
        fcmax = bb.get("fcmax", "nyquist")
        if fcmax == "nyquist":
            fcmax = float(args.exp.sample_rate) / 2
        return cls(
            nfft=int(bb.NFFT),
            sample_rate=float(args.exp.sample_rate),
            mu=tuple(float(m) for m in bb.optimization.mu),
            tol=tuple(float(t) for t in bb.optimization.tol),
            max_iter=int(bb.optimization.max_iter),
            clamp_fc=bool(bb.optimization.clamp_fc),
            clamp_A=bool(bb.optimization.clamp_A),
            only_negative_A=bool(bb.optimization.get("only_negative_A", True)),
            fcmin=float(bb.fcmin),
            fcmax=float(fcmax),
            Amin=float(bb.Amin),
            Amax=float(bb.Amax),
            init_fc=tuple(bb.initial_conditions.fc),
            init_A=tuple(bb.initial_conditions.A),
            freq_weighting_filter=str(args.tester.posterior_sampling.get(
                "freq_weighting_filter", "sqrt")),
        )

    def initial_params(self, device="cpu") -> torch.Tensor:
        return torch.tensor([list(self.init_fc), list(self.init_A)],
                            dtype=torch.float32, device=device)


def _clip(v, lo, hi):
    """clip(v, lo, hi); lo and hi are numbers or tensors."""
    v = torch.maximum(v, lo) if torch.is_tensor(lo) else v.clamp(min=lo)
    return torch.minimum(v, hi) if torch.is_tensor(hi) else v.clamp(max=hi)


class BlindSampler(Sampler):
    """The Heun sampler with joint filter estimation."""

    def __init__(self, denoiser, edm: EDM, cfg: SamplerConfig,
                 blind: BlindConfig, hpf=None, device="cpu"):
        super().__init__(denoiser, edm, cfg, hpf=hpf, device=device)
        self.blind = blind
        self.freqs = torch.as_tensor(rfftfreq(blind.nfft, blind.sample_rate),
                                     device=self.device)
        self._mu = torch.tensor(blind.mu, dtype=torch.float32,
                                device=self.device)[:, None]

    # ------------------------------------------------------ filter optimizer

    def _clamp(self, p: torch.Tensor) -> torch.Tensor:
        """Sequential monotonicity clamps: fc increasing by at least 1 Hz,
        A non-increasing (and negative) across the breakpoints."""
        b = self.blind
        fc, A = p[0], p[1]
        K = fc.shape[0]
        if b.clamp_fc:
            fcs = [_clip(fc[0], b.fcmin, b.fcmax)]
            for k in range(1, K):
                fcs.append(_clip(fc[k], fcs[-1] + 1.0, b.fcmax))
            fc = torch.stack(fcs)
        if b.clamp_A:
            As = [_clip(A[0], b.Amin, -1.0 if b.only_negative_A else b.Amax)]
            for k in range(1, K):
                As.append(_clip(A[k], b.Amin,
                                As[-1] if b.only_negative_A else b.Amax))
            A = torch.stack(As)
        return torch.stack([fc, A])

    def _fit_stats(self, Xden, Y):
        """Per-frequency sufficient statistics of the fit objective:
        || (|X| H - |Y|) w ||^2 = sum_F w^2 (H^2 a - 2 H b + c) with
        a = sum |X|^2, b = sum |X||Y|, c = sum |Y|^2 over (B, T)."""
        Xm, Ym = Xden.abs(), Y.abs()
        w = _freq_weighting(torch.linspace(0.0, 1.0, Xm.shape[-2],
                                           device=Xm.device),
                            self.blind.freq_weighting_filter)
        w2 = w * w
        return ((Xm * Xm).sum((0, -1)) * w2, (Xm * Ym).sum((0, -1)) * w2,
                (Ym * Ym).sum((0, -1)) * w2)

    def _objective_from_stats(self, stats, params):
        a, bb, c = stats
        H = design_filter(params[0], params[1], self.freqs)
        # the quadratic form can go slightly negative by fp32 cancellation
        # near convergence; the floor keeps the sqrt and its gradient finite
        s = (H * H * a - 2.0 * H * bb + c).sum()
        return torch.sqrt(torch.clamp(s, min=1e-12))

    def fit_params(self, Xden, Y, params0):
        """Projected gradient descent with a tolerance exit, at most
        ``max_iter`` iterations; after the exit the parameters freeze.  On
        the card the whole loop is one kernel (``csrc/filter_fit.cu``); on
        the CPU it is ``_fit_loop``, its plain version."""
        stats = self._fit_stats(Xden.detach(), Y)
        if params0.is_cuda:
            return _k.launch_filter_fit(
                torch.stack(stats).contiguous(), self.freqs,
                params0.detach().float().contiguous(), self.blind)
        return self._fit_loop(stats, params0)

    def _fit_loop(self, stats, params0):
        """The filter-fit kernel's plain version: ``max_iter`` iterations
        of autograd through ``design_filter`` with a ``done`` mask."""
        b = self.blind
        mu = self._mu.to(params0.device)
        p = params0.detach()
        done = torch.zeros((), dtype=torch.bool, device=p.device)
        for _ in range(b.max_iter):
            with torch.enable_grad():
                pg = p.requires_grad_(True)
                (g,) = torch.autograd.grad(
                    self._objective_from_stats(stats, pg), pg)
            p = p.detach()
            newp = self._clamp(p - mu * g)
            conv = (((newp[0] - p[0]).abs().mean() < b.tol[0])
                    & ((newp[1] - p[1]).abs().mean() < b.tol[1]))
            p = torch.where(done, p, newp)
            done = done | conv
        return p

    # ------------------------------------------------------------ main loop

    def degradation_fcA(self, x, params):
        return D.make_fcA(self.freqs, self.blind.nfft)(x, params)

    def _stage(self, x_hat, t_cur: float, params, y, Y, gen):
        """One guided score evaluation with a filter re-fit.  Returns
        (score, params)."""
        cfg, b = self.cfg, self.blind
        y_obs = y
        if cfg.snr_observations is not None:
            y_obs = _obs_noise(y, cfg.snr_observations, gen)
        with torch.enable_grad():
            xg = x_hat.detach().requires_grad_(True)
            x_den = self._denoise(xg, t_cur)
            # one analysis STFT of x_den serves the filter fit (on its
            # detached copy) and the guidance gradient
            X = apply_stft(x_den, b.nfft)
            params = self.fit_params(X, Y, params)
            H = design_filter(params[0], params[1], self.freqs)
            xf = apply_filter_istft(X, H, b.nfft)[..., :x_den.shape[-1]]
            val = cfg.norm_fn(y_obs, xf)
            (rec,) = torch.autograd.grad(val, xg)
        x_den = x_den.detach()
        normguide = rec.norm() / cfg.audio_len**0.5
        s = cfg.xi / (normguide + 1e-6)
        score = (x_den - x_hat) / t_cur**2 - s * rec / t_cur
        if cfg.data_consistency:
            with torch.no_grad():
                x_dc = score * t_cur**2 + x_hat
                x_dc = y + x_dc - self.degradation_fcA(x_dc, params)
            score = (x_dc - x_hat) / t_cur**2
        return score, params

    def predict_blind_bwe(self, gen, y, x_init=None):
        """Blind BWE of the observation y [B, L]: (x, filter_params[2, K])."""
        cfg, b = self.cfg, self.blind
        Y = apply_stft(y, b.nfft)
        params = b.initial_params(y.device)
        warm = cfg.start_sigma is not None
        t, gamma = self._schedule(warm)
        if x_init is not None:
            x = x_init.to(y.device, torch.float32)
        else:
            x = _randn(y.shape, gen, y.device) * t[0]
            if warm:
                x = y + x

        def move(x_, t_i, g):
            t_hat = t_i + g * t_i
            eps = _randn(x_.shape, gen, x_.device)
            return x_ + math.sqrt(max(t_hat**2 - t_i**2, 0.0)) * eps, t_hat

        for i in range(cfg.T - 1):
            x_hat, t_hat = move(x, t[i], gamma[i])
            sc, params = self._stage(x_hat, t_hat, params, y, Y, gen)
            d1 = -t_hat * sc
            h = t[i + 1] - t_hat
            if cfg.order == 2:
                sc, params = self._stage(x_hat + h * d1, t[i + 1], params,
                                         y, Y, gen)
                x = x_hat + h * 0.5 * (d1 - t[i + 1] * sc)
            else:
                x = x_hat + h * d1
        x_hat, t_hat = move(x, t[cfg.T - 1], gamma[cfg.T - 1])
        sc, params = self._stage(x_hat, t_hat, params, y, Y, gen)
        return x_hat - t_hat * sc * (0.0 - t_hat), params

    def predict_bwe(self, gen, ylpf, filt, filt_type: str, x_init=None):
        """Informed BWE; ``filt_type='fc_A'`` takes the parametric filter
        breakpoints [2, K]."""
        if filt_type == "fc_A":
            params = torch.as_tensor(filt, dtype=torch.float32,
                                     device=ylpf.device)
            return self.predict_conditional(
                gen, ylpf, lambda x: self.degradation_fcA(x, params),
                x_init=x_init)
        return super().predict_bwe(gen, ylpf, filt, filt_type, x_init=x_init)
