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
scaled by t[0]) in place of the first noise draw.  ``predict_conditional``
also takes a ``score_postprocess`` ``(score, x, t) -> score`` applied after
every score evaluation (the autoregressive step's data-consistency
replacement on its feathered overlap, ``blind.py``).  With ``rid=True`` an
entry point also returns the denoised estimate of every step and the
schedule.  The inverse problems (inpainting, compressive sensing,
declipping, phase retrieval, informed BWE through any degradation of
``degradations.py``, autoregressive continuation) are entry points over the
same run; an observation of another shape than the signal (resampled,
decimated, an STFT magnitude) goes through ``predict_resample``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from babe_tpu_torch.diffusion.edm import EDM
from babe_tpu_torch.ops.filters import (
    apply_norm_STFT_fweighted,
    apply_norm_STFTmag_fweighted,
)
from babe_tpu_torch.sampling import degradations as D
from babe_tpu_torch.utils.device import check_device


def make_norm_fn(ps_cfg: Any) -> Callable:
    """Reconstruction-error norm from the posterior_sampling config block:
    smooth L1, cosine, the STFT distances (complex, or magnitude and
    log-magnitude) or the L^p norm per item, summed over the batch."""
    norm = ps_cfg.get("norm", 2)
    stft_cfg = ps_cfg.get("stft_distance", {}) or {}
    if norm == "smoothl1":
        beta = float(ps_cfg.get("smoothl1_beta", 1.0))

        def fn(y, den_rec):
            d = y - den_rec
            ad = d.abs()
            return torch.where(ad < beta, 0.5 * d**2 / beta,
                               ad - 0.5 * beta).sum()

        return fn
    if norm == "cosine":
        def fn(y, den_rec):
            cos = (y * den_rec).sum(-1) / (
                y.norm(dim=-1) * den_rec.norm(dim=-1) + 1e-6)
            return torch.clamp(1 - cos, min=0).sum()

        return fn
    if stft_cfg.get("use", False):
        nfft = int(stft_cfg.get("nfft", 2048))
        fw = ps_cfg.get("freq_weighting", "None")
        if stft_cfg.get("mag", False):
            logmag = bool(stft_cfg.get("logmag", False))
            return lambda y, d: apply_norm_STFTmag_fweighted(y, d, fw, nfft,
                                                             logmag)
        return lambda y, d: apply_norm_STFT_fweighted(y, d, fw, nfft)
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
      projection applied to denoised estimates.  ``device`` defaults to
      the card and raises without one unless the CPU is asked for."""

    def __init__(self, denoiser: Callable, edm: EDM, cfg: SamplerConfig,
                 hpf: Callable | None = None, device="cuda"):
        self.denoiser = denoiser
        self.edm = edm
        self.cfg = cfg
        self.hpf = hpf if cfg.filter_out_cqt_DC_Nyq else None
        self.device = check_device(device, type(self).__name__)

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

    # (rows of the global batch, this rank's slice of them) while a rank
    # samples its share of an unconditional batch: every draw is made at
    # the global batch's size and sliced, so the share's samples are those
    # of the whole batch (``predict_unconditional_rows``)
    draw_rows: tuple[int, slice] | None = None

    def _randn(self, shape, gen, device) -> torch.Tensor:
        if self.draw_rows is None:
            return _randn(shape, gen, device)
        n, rows = self.draw_rows
        return _randn((n, *shape[1:]), gen, device)[rows]

    def _move(self, x, t_i: float, g: float, gen, snoise: float = 1.0):
        """The stochastic time move: (x + sqrt(t_hat^2 - t_i^2) eps snoise,
        t_hat) with t_hat = t_i (1 + g)."""
        t_hat = t_i + g * t_i
        eps = self._randn(x.shape, gen, x.device) * snoise
        return x + math.sqrt(max(t_hat**2 - t_i**2, 0.0)) * eps, t_hat

    def _run(self, gen, shape, y=None, degradation=None, x_init=None,
             score_postprocess=None, rid: bool = False):
        """The reverse process from t[0] to 0.  With ``rid`` it returns
        (x, denoised [T, *shape], t [T + 1]): the denoised estimate at the
        first score of every step, and at the final step."""
        cfg = self.cfg
        dev = y.device if y is not None else self.device
        warm = (cfg.start_sigma is not None and y is not None
                and tuple(y.shape) == tuple(shape))
        t, gamma = self._schedule(warm)
        if x_init is not None:
            x = x_init.to(dev, torch.float32)
        else:
            x = self._randn(shape, gen, dev) * t[0]
            if warm:
                x = y + x
        dens = []

        def score(x_, t_):
            sc = self._score(x_, t_, y=y, degradation=degradation, gen=gen)
            if score_postprocess is not None:
                sc = score_postprocess(sc, x_, t_)
            return sc

        for i in range(cfg.T - 1):
            x_hat, t_hat = self._move(x, t[i], gamma[i], gen, cfg.snoise)
            sc = score(x_hat, t_hat)
            if rid:
                dens.append(sc * t_hat**2 + x_hat)
            d1 = -t_hat * sc
            h = t[i + 1] - t_hat
            if cfg.order == 2:
                d = -t[i + 1] * score(x_hat + h * d1, t[i + 1])
                x = x_hat + h * 0.5 * (d1 + d)
            else:
                x = x_hat + h * d1
        x_hat, t_hat = self._move(x, t[cfg.T - 1], gamma[cfg.T - 1], gen,
                                  cfg.snoise)
        sc = score(x_hat, t_hat)
        x = x_hat + (0.0 - t_hat) * (-t_hat * sc)
        if rid:
            dens.append(sc * t_hat**2 + x_hat)
            return x, torch.stack(dens), torch.tensor(t, dtype=torch.float32)
        return x

    # ------------------------------------------------------------- public

    def predict_unconditional(self, gen, shape, rid: bool = False,
                              x_init=None):
        return self._run(gen, shape, rid=rid, x_init=x_init)

    def predict_unconditional_rows(self, gen, shape, rows: slice):
        """The ``rows`` of ``predict_unconditional(gen, shape)``, computed
        alone: the clips are independent, and every noise draw is made at
        the whole batch's size."""
        local = (len(range(shape[0])[rows]), *shape[1:])
        self.draw_rows = (shape[0], rows)
        try:
            return self._run(gen, local)
        finally:
            self.draw_rows = None

    def predict_conditional(self, gen, y, degradation, rid: bool = False,
                            x_init=None, score_postprocess=None):
        return self._run(gen, y.shape, y=y, degradation=degradation, rid=rid,
                         x_init=x_init, score_postprocess=score_postprocess)

    def predict_resample(self, gen, y, shape, degradation, rid: bool = False,
                         x_init=None):
        """An observation of another shape than the signal (resampled,
        decimated, an STFT magnitude): the signal has ``shape``."""
        return self._run(gen, shape, y=y, degradation=degradation, rid=rid,
                         x_init=x_init)

    def predict_inpainting(self, gen, y_masked, mask, rid: bool = False,
                           x_init=None):
        return self.predict_conditional(gen, y_masked, D.make_mask(mask),
                                        rid=rid, x_init=x_init)

    def predict_bwe(self, gen, ylpf, filt, filt_type: str, rid: bool = False,
                    x_init=None):
        deg = D.degradation_from_filter(filt, filt_type)
        if filt_type in ("resample", "decimate"):
            return self.predict_resample(
                gen, ylpf, (ylpf.shape[0], self.cfg.audio_len), deg, rid=rid,
                x_init=x_init)
        return self.predict_conditional(gen, ylpf, deg, rid=rid,
                                        x_init=x_init)

    def predict_declipping(self, gen, y_clipped, clip_value,
                           rid: bool = False, x_init=None):
        return self.predict_conditional(gen, y_clipped,
                                        D.make_clip(clip_value), rid=rid,
                                        x_init=x_init)

    def predict_compsens(self, gen, y_masked, mask, rid: bool = False,
                         x_init=None):
        return self.predict_inpainting(gen, y_masked, mask, rid=rid,
                                       x_init=x_init)

    def predict_phase_retrieval(self, gen, y_mag, win_size, hop_size,
                                rid: bool = False, x_init=None):
        return self.predict_resample(
            gen, y_mag, (y_mag.shape[0], self.cfg.audio_len),
            D.make_stft_mag(win_size, hop_size), rid=rid, x_init=x_init)

    def predict_autoregressive(self, gen, shape, N: int, overlap: float):
        """Unconditional continuation by masked outpainting: ``N`` chunks,
        each after the first holding the previous chunk's last
        ``overlap`` share as an inpainting observation."""
        endmask = int(overlap * shape[-1])
        mask = torch.ones((1, self.cfg.audio_len), device=self.device)
        mask[:, endmask:] = 0.0
        x = self.predict_unconditional(gen, shape)
        xcat = x
        for _ in range(N - 1):
            x_masked = torch.zeros((1, self.cfg.audio_len),
                                   device=self.device)
            x_masked[:, :endmask] = x[:, -endmask:]
            x = self.predict_conditional(gen, x_masked, D.make_mask(mask))
            xcat = torch.cat([xcat, x[..., endmask:]], dim=-1)
        return xcat
