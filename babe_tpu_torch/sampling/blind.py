"""BABE blind sampler: joint posterior sampling and degradation-filter
estimation, in PyTorch.

Counterpart of ``babe_tpu/sampling/blind.py``.  Per Heun stage:

  1. denoise with the graph kept (one forward through the network),
  2. projected-gradient filter fit on the (fc_k, A_k) parameters against the
     frequency-weighted STFT-magnitude mismatch, with per-parameter step
     sizes, sequential monotonicity clamps and a tolerance exit; on the
     card the whole loop is one kernel, on the CPU a loop of ``max_iter``
     iterations with a ``done`` mask (once done is set the parameters
     freeze), so the host never waits on a value; with
     ``blind_bwe.sigma_den_estimate`` > 0 the fit sees the denoised
     estimate plus that much white noise from the sampler's generator,
     and the guidance below keeps the clean estimate,
  3. reconstruction-guidance gradient through the network with the updated
     filter (``torch.autograd.grad`` with respect to the input only),
  4. Tweedie score plus guidance scaled xi/(normguide+1e-6)·rec/t, then the
     Heun update.

The observation STFT is computed once per request.  ``rid=True`` also
returns the denoised estimate, the filter and the score of every step;
informed ``predict_bwe`` can track the filter fit on its denoised
estimates as a diagnostic (``test_filter_fit``), with the fit objective's
(fc, A) landscape at every step (``compute_sweep``).

``predict_bwe_AR`` is the informed step of the autoregressive long-input
loop (``testers/tester.py::Tester._ar_loop``): the previous chunk's tail
is an inpainting observation over the overlap, optionally held by a
data-consistency replacement on a hann-feathered mask
(``prepare_smooth_mask``, host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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
    sigma_den_estimate: float = 0.0

    @classmethod
    def from_args(cls, args) -> "BlindConfig":
        bb = args.tester.blind_bwe
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
            sigma_den_estimate=float(bb.get("sigma_den_estimate", 0.0)
                                     or 0.0),
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
                 blind: BlindConfig, hpf=None, device="cuda"):
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

    def _fit_loop(self, stats, params0, trace: list | None = None):
        """The filter-fit kernel's plain version: ``max_iter`` iterations
        of autograd through ``design_filter`` with a ``done`` mask.  A
        ``trace`` list receives (params, done) as each iteration starts."""
        b = self.blind
        mu = self._mu.to(params0.device)
        p = params0.detach()
        done = torch.zeros((), dtype=torch.bool, device=p.device)
        for _ in range(b.max_iter):
            if trace is not None:
                trace.append((p.detach(), done))
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

    def _stage(self, x_hat, t_cur: float, params, y, Y, gen,
               den_noise=None):
        """One guided score evaluation with a filter re-fit.  Returns
        (score, params, denoised estimate).  With ``sigma_den_estimate``
        > 0 the fit sees its own STFT of the denoised estimate plus that
        much white noise (``den_noise``, drawn from ``gen`` after the
        observation noise unless given), and the guidance gradient keeps
        the clean estimate."""
        cfg, b = self.cfg, self.blind
        y_obs = y
        if cfg.snr_observations is not None:
            y_obs = _obs_noise(y, cfg.snr_observations, gen)
        with torch.enable_grad():
            xg = x_hat.detach().requires_grad_(True)
            x_den = self._denoise(xg, t_cur)
            if b.sigma_den_estimate > 0:
                if den_noise is None:
                    den_noise = _randn(x_den.shape, gen, x_den.device)
                Xden = apply_stft(x_den.detach()
                                  + b.sigma_den_estimate * den_noise, b.nfft)
                params = self.fit_params(Xden, Y, params)
                val = cfg.norm_fn(y_obs, self.degradation_fcA(x_den, params))
            else:
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
        return score, params, x_den

    def predict_blind_bwe(self, gen, y, rid: bool = False, x_init=None):
        """Blind BWE of the observation y [B, L]: (x, filter_params[2, K]),
        or with ``rid`` (x, filter_params, denoised [T, B, L], t [T + 1],
        filter_params [T, 2, K], score [T, B, L]), each trajectory taken
        at the first stage of every step and at the final step."""
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
        traj = []
        for i in range(cfg.T - 1):
            x_hat, t_hat = self._move(x, t[i], gamma[i], gen)
            sc, params, x_den = self._stage(x_hat, t_hat, params, y, Y, gen)
            if rid:
                traj.append((x_den, params, sc))
            d1 = -t_hat * sc
            h = t[i + 1] - t_hat
            if cfg.order == 2:
                sc, params, _ = self._stage(x_hat + h * d1, t[i + 1], params,
                                            y, Y, gen)
                x = x_hat + h * 0.5 * (d1 - t[i + 1] * sc)
            else:
                x = x_hat + h * d1
        x_hat, t_hat = self._move(x, t[cfg.T - 1], gamma[cfg.T - 1], gen)
        sc, params, x_den = self._stage(x_hat, t_hat, params, y, Y, gen)
        x = x_hat - t_hat * sc * (0.0 - t_hat)
        if not rid:
            return x, params
        traj.append((x_den, params, sc))
        dens, filts, scores = (torch.stack(v) for v in zip(*traj))
        return (x, params, dens, torch.tensor(t, dtype=torch.float32), filts,
                scores)

    def predict_bwe(self, gen, ylpf, filt, filt_type: str, rid: bool = False,
                    test_filter_fit: bool = False,
                    compute_sweep: bool = False, x_init=None):
        """Informed BWE; ``filt_type='fc_A'`` takes the parametric filter
        breakpoints [2, K].

        With ``test_filter_fit`` the filter fit also runs at every stage on
        the denoised estimate (the guidance keeps the known filter), and
        the result is (x, denoised [T, B, L], t [T + 1], fitted
        params [T, 2, K]); with ``compute_sweep`` also the (fc, A) grid of
        ``compute_sweep`` at every step: (x, denoised, t, params,
        norms [T, 15, 12], grads [T, 15, 12, 2]).  This diagnostic runs the
        2nd-order steps whatever ``order`` says, as the JAX package's."""
        if filt_type == "fc_A":
            fixed = torch.as_tensor(filt, dtype=torch.float32,
                                    device=ylpf.device)
            deg = lambda x: self.degradation_fcA(x, fixed)  # noqa: E731
        if not test_filter_fit:
            if filt_type == "fc_A":
                return self.predict_conditional(gen, ylpf, deg, rid=rid,
                                                x_init=x_init)
            return super().predict_bwe(gen, ylpf, filt, filt_type, rid=rid,
                                       x_init=x_init)
        if filt_type != "fc_A":
            deg = D.degradation_from_filter(filt, filt_type)
        cfg, b = self.cfg, self.blind
        Y = apply_stft(ylpf, b.nfft)
        params = b.initial_params(ylpf.device)
        warm = cfg.start_sigma is not None
        t, gamma = self._schedule(warm)
        if x_init is not None:
            x = x_init.to(ylpf.device, torch.float32)
        else:
            x = _randn(ylpf.shape, gen, ylpf.device) * t[0]
            if warm:
                x = ylpf + x

        def stage(x_, t_, params, record: bool):
            sc = self._score(x_, t_, y=ylpf, degradation=deg, gen=gen)
            x_den = (sc * t_**2 + x_).detach()
            params = self.fit_params(apply_stft(x_den, b.nfft), Y, params)
            if record:
                traj.append((x_den, params) + (
                    self.compute_sweep(x_den, ylpf) if compute_sweep
                    else ()))
            return sc, params

        traj = []
        for i in range(cfg.T - 1):
            x_hat, t_hat = self._move(x, t[i], gamma[i], gen, cfg.snoise)
            sc, params = stage(x_hat, t_hat, params, True)
            d1 = -t_hat * sc
            h = t[i + 1] - t_hat
            sc, params = stage(x_hat + h * d1, t[i + 1], params, False)
            x = x_hat + h * 0.5 * (d1 - t[i + 1] * sc)
        x_hat, t_hat = self._move(x, t[cfg.T - 1], gamma[cfg.T - 1], gen,
                                  cfg.snoise)
        sc, params = stage(x_hat, t_hat, params, True)
        x = x_hat + t_hat**2 * sc
        out = [torch.stack(v) for v in zip(*traj)]
        return (x, out[0], torch.tensor(t, dtype=torch.float32), *out[1:])

    def predict_bwe_AR(self, gen, ylpf, y_masked, filt, filt_type: str, mask,
                       smooth_mask_size: int = 0, x_init=None):
        """Autoregressive chunk continuation: the composite observation
        mask*y_masked + (1-mask)*ylpf under the degradation
        mask*x + (1-mask)*lpf(x).  With ``smooth_mask_size`` > 0 the mask is
        feathered over that many samples and every score is followed by a
        data-consistency replacement of the feathered overlap by
        ``y_masked``."""
        if filt_type == "fc_A":
            params = torch.as_tensor(filt, dtype=torch.float32,
                                     device=ylpf.device)
            base = lambda x: self.degradation_fcA(x, params)  # noqa: E731
        elif filt_type == "firwin":
            base = D.make_fir(filt)
        else:
            raise NotImplementedError(filt_type)
        dev = ylpf.device
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        y_masked = torch.as_tensor(y_masked, dtype=torch.float32, device=dev)
        y = mask * y_masked + (1 - mask) * ylpf
        deg = lambda x: mask * x + (1 - mask) * base(x)  # noqa: E731
        post = None
        if smooth_mask_size > 0:
            smooth = torch.as_tensor(
                prepare_smooth_mask(mask.cpu().numpy(), smooth_mask_size),
                device=dev)
            y_sm = smooth * y_masked

            def post(sc, x, t):
                # data-consistency replacement on the feathered overlap
                with torch.no_grad():
                    x_hat = sc * t**2 + x
                    x_hat = y_sm + x_hat - smooth * x_hat
                    return (x_hat - x) / t**2

        return self.predict_conditional(gen, y, deg, x_init=x_init,
                                        score_postprocess=post)


    def compute_sweep(self, denoised, y, fc_s=None, A_s=None):
        """The fit objective's landscape over a grid of one-breakpoint
        filters (fc in logspace(2.5, 4, 15) Hz, A in linspace(-80, -5, 12)
        dB/octave): (norms [15, 12], grads [15, 12, 2] with respect to
        (fc, A)), every grid point at once."""
        dev = y.device
        fc_s = (torch.logspace(2.5, 4, 15, device=dev) if fc_s is None
                else torch.as_tensor(fc_s, dtype=torch.float32, device=dev))
        A_s = (torch.linspace(-80, -5, 12, device=dev) if A_s is None
               else torch.as_tensor(A_s, dtype=torch.float32, device=dev))
        Xm = apply_stft(denoised, self.blind.nfft).abs()
        Ym = apply_stft(y, self.blind.nfft).abs()
        w = _freq_weighting(torch.linspace(0.0, 1.0, Xm.shape[-2],
                                           device=dev),
                            self.blind.freq_weighting_filter)[:, None]
        with torch.enable_grad():
            fc = fc_s[:, None].expand(-1, A_s.shape[0]).clone()
            A = A_s[None, :].expand(fc_s.shape[0], -1).clone()
            fc.requires_grad_(True)
            A.requires_grad_(True)
            # design_filter's one-breakpoint response at every grid point
            f = self.freqs
            fci = torch.clamp(fc, min=1e-9)[..., None]
            seg = 10.0 ** (A[..., None] * torch.log2(
                torch.maximum(f, fci) / fci) / 20.0)
            H = torch.where(f >= fc[..., None], seg, torch.ones_like(seg))
            d = (Xm * H[:, :, None, :, None] - Ym) * w
            norms = torch.sqrt((d**2).sum((2, 3, 4)))
            g_fc, g_A = torch.autograd.grad(norms.sum(), (fc, A))
        return norms.detach(), torch.stack([g_fc, g_A], dim=-1)


def prepare_smooth_mask(mask, size: int = 10) -> np.ndarray:
    """Hann-feather the 1->0 and 0->1 steps of a binary mask [B, N] (host
    numpy; the testers build their masks on the host).  The slicing is the
    reference's: for a step within one window of either end, or a mask
    that starts at 0, numpy refuses the assignment (ValueError)."""
    m = np.asarray(mask)
    B, N = m.shape
    row = m[0].copy().astype(np.float32)
    # torch.hann_window(2*size) is periodic: w[n] = 0.5 - 0.5 cos(pi n / size)
    n = np.arange(2 * size)
    hann = (0.5 - 0.5 * np.cos(np.pi * n / size)).astype(np.float32)
    hann_left, hann_right = hann[:size], hann[size:]
    out = row.copy()
    prev = 1.0
    for i in range(N):
        if row[i] != prev:
            if row[i] == 0:
                out[i - size : i] = hann_right[:size]
            else:
                out[i : i + size] = hann_left[:size]
        prev = row[i]
    return np.broadcast_to(out[None], (B, N)).copy()
