"""EDM diffusion parameterization (Karras et al. 2022) in PyTorch.

Counterpart of ``babe_tpu/diffusion/edm.py``: the preconditioning (cskip,
cout, cin, cnoise), the denoiser D(x) = cskip x + cout net(cin x, cnoise),
the rho-schedule with the reference's (nb_steps-1) divisor and t[-1] = 0,
the warm-start schedule and the per-step stochasticity gamma; and the
training half: training-sigma sampling (the schedule distribution with
ro_train, or lognormal), the prior, the training preconditioning and the
per-sample loss with the optional CQT DC correction.  Schedules are computed
in float32, as the JAX package computes them.  Random draws take an explicit
``torch.Generator`` (drawn on its device); the JAX package's ``jax.random``
keys give other numbers, so a test hands both sides the same sigma and
noise.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch


@dataclass(frozen=True)
class EDMParams:
    sigma_data: float = 0.063
    sigma_min: float = 1e-5
    sigma_max: float = 10.0
    ro: float = 13.0
    ro_train: float = 10.0
    Schurn: float = 5.0
    Snoise: float = 1.0
    Stmin: float = 0.0
    Stmax: float = 50.0
    P_mean: float = -1.2
    P_std: float = 1.2

    @classmethod
    def from_config(cls, dp: Any) -> "EDMParams":
        """Build from a diff_params config node (training or tester block)."""
        def get(k, d):
            try:
                v = dp[k]
            except (KeyError, TypeError):
                return d
            return float(v)

        return cls(**{f: get(f, d) for f, d in (
            ("sigma_data", 0.063), ("sigma_min", 1e-5), ("sigma_max", 10.0),
            ("ro", 13.0), ("ro_train", 10.0), ("Schurn", 5.0),
            ("Snoise", 1.0), ("Stmin", 0.0), ("Stmax", 50.0),
            ("P_mean", -1.2), ("P_std", 1.2))})

    def updated(self, **kw) -> "EDMParams":
        return replace(self, **kw)


class EDM:
    """EDM preconditioning, schedules and training loss.  A ``net`` given
    to :meth:`denoiser` or :meth:`loss_fn` is any callable
    ``net(x[B,T], cnoise[B,1])``."""

    def __init__(self, p: EDMParams, cqt_hpf=None):
        self.p = p
        self.cqt_hpf = cqt_hpf

    @classmethod
    def from_config(cls, args: Any, cqt_hpf=None) -> "EDM":
        dp = args.diff_params
        if bool(dp.get_path("aweighting.use_aweighting", False)):
            raise NotImplementedError(
                "A-weighted EDM loss is not ported yet: it needs ops/fir.py "
                "(ROADMAP.md)")
        return cls(EDMParams.from_config(dp), cqt_hpf=cqt_hpf)

    # ------------------------------------------------------------ precond

    def cskip(self, sigma):
        sd2 = self.p.sigma_data**2
        return sd2 / (sigma**2 + sd2)

    def cout(self, sigma):
        sd = self.p.sigma_data
        return sigma * sd * (sd**2 + sigma**2) ** -0.5

    def cin(self, sigma):
        return (self.p.sigma_data**2 + sigma**2) ** -0.5

    def cnoise(self, sigma):
        return 0.25 * torch.log(sigma)

    def denoiser(self, xn, net, sigma):
        """D(x; sigma) = cskip*x + cout*net(cin*x, cnoise); sigma [B,1],
        [B] or a scalar."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=xn.device)
        if sigma.ndim == 0:
            sigma = sigma[None, None]
        elif sigma.ndim == 1:
            sigma = sigma[:, None]
        return self.cskip(sigma) * xn + self.cout(sigma) * net(
            self.cin(sigma) * xn, self.cnoise(sigma))

    # ------------------------------------------------------------ schedules

    def _rho_schedule(self, t0: float, nb_steps: int) -> torch.Tensor:
        p = self.p
        i = torch.arange(0, nb_steps + 1, dtype=torch.float32)
        a = t0 ** (1 / p.ro)
        t = (a + i / (nb_steps - 1) * (p.sigma_min ** (1 / p.ro) - a)) ** p.ro
        t[-1] = 0.0
        return t

    def create_schedule(self, nb_steps: int) -> torch.Tensor:
        """rho-schedule, nb_steps+1 float32 entries on the CPU, the last
        forced to 0 (the reference's (nb_steps-1) divisor kept)."""
        return self._rho_schedule(self.p.sigma_max, nb_steps)

    def create_schedule_from_initial_t(self, initial_t: float,
                                       nb_steps: int) -> torch.Tensor:
        """Warm-start schedule from ``initial_t``."""
        return self._rho_schedule(float(initial_t), nb_steps)

    def get_gamma(self, t: torch.Tensor) -> torch.Tensor:
        """Per-step stochasticity: min(Schurn/N, sqrt2-1) inside
        (Stmin, Stmax), else 0."""
        p = self.p
        inside = (t > p.Stmin) & (t < p.Stmax)
        g = min(p.Schurn / t.shape[0], 2**0.5 - 1)
        return torch.where(inside, torch.tensor(g, dtype=torch.float32),
                           torch.tensor(0.0))

    # ------------------------------------------------------------ training

    def sample_ptrain_safe(self, gen: torch.Generator, N: int) -> torch.Tensor:
        """sigma ~ the schedule distribution with ro_train: (N,) float32 on
        the generator's device."""
        p = self.p
        a = torch.rand((N,), generator=gen, device=gen.device)
        hi, lo = p.sigma_max ** (1 / p.ro_train), p.sigma_min ** (1 / p.ro_train)
        return (hi + a * (lo - hi)) ** p.ro_train

    def sample_ptrain_lognormal(self, gen: torch.Generator,
                                N: int) -> torch.Tensor:
        """Karras lognormal sigma, clipped to [sigma_min, sigma_max]."""
        p = self.p
        ln = torch.randn((N,), generator=gen, device=gen.device) * p.P_std \
            + p.P_mean
        return torch.clamp(torch.exp(ln), p.sigma_min, p.sigma_max)

    def sample_prior(self, gen: torch.Generator, shape, sigma) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=gen.device) * sigma

    def prepare_train_preconditioning(self, gen, x, sigma, noise=None):
        """(input, target, cnoise) for sigma [B,1]; ``noise`` (the prior
        draw, already scaled by sigma) is drawn from ``gen`` when not
        given."""
        if noise is None:
            noise = self.sample_prior(gen, x.shape, sigma).to(x.device)
        cskip, cout, cin = self.cskip(sigma), self.cout(sigma), self.cin(sigma)
        target = (1.0 / cout) * (x - cskip * (x + noise))
        return cin * (x + noise), target, self.cnoise(sigma)

    def loss_fn(self, gen, net, x, use_cqt_DC_correction: bool = False,
                sigma=None, noise=None):
        """Per-sample squared error [B,T] and the sigmas [B,1] used.
        ``sigma`` and ``noise`` are drawn from ``gen`` (sigma first) unless
        given."""
        if sigma is None:
            sigma = self.sample_ptrain_safe(gen, x.shape[0])[:, None]
        sigma = sigma.to(x.device)
        inp, target, cnoise = self.prepare_train_preconditioning(
            gen, x, sigma, noise)
        error = net(inp, cnoise) - target
        if use_cqt_DC_correction and self.cqt_hpf is not None:
            error = self.cqt_hpf(error)
        return error**2, sigma
