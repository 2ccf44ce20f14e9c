"""Epsilon/VDM-style EDM variant, for diffwave-sr-type checkpoints, in
PyTorch.

Counterpart of ``babe_tpu/diffusion/edm_eps.py``: a logSNR-linear scheduler
with the gamma <-> t <-> sigma <-> (alpha, s) conversions, a denoiser that
maps the EDM sigma onto the (a, s) parameterization and returns
x0 = (z - s eps_hat) / a, and the DDIM reverse process.  The training side
(schedule, training sigmas, preconditioning, loss) is the inherited EDM
one, as in the JAX package: the eps parameterization changes only the
denoiser mapping.  ``EDMEps.from_config`` reads ``diff_params.T`` and
``diff_params.scheduler.gamma0``/``gamma1`` and, like the JAX class, not
the A-weighting.
"""

from __future__ import annotations

import torch

from babe_tpu_torch.diffusion.edm import EDM, EDMParams


class EDMEps(EDM):
    def __init__(self, p: EDMParams, T: int = 1000, gamma0: float = -13.3,
                 gamma1: float = 5.0, **kw):
        super().__init__(p, **kw)
        self.T = int(T)
        self.gamma0 = float(gamma0)
        self.gamma1 = float(gamma1)

    @classmethod
    def from_config(cls, args, cqt_hpf=None) -> "EDMEps":
        dp = args.diff_params
        return cls(
            EDMParams.from_config(dp),
            T=int(dp.get("T", 1000)),
            gamma0=float(dp.get_path("scheduler.gamma0", -13.3)),
            gamma1=float(dp.get_path("scheduler.gamma1", 5.0)),
            cqt_hpf=cqt_hpf,
        )

    # ------------------------------------------ scheduler conversions

    def logsnr_linear(self, t):
        t = torch.clamp(t, 0.0, 1.0)
        return self.gamma0 * (1 - t) + self.gamma1 * t, t

    def gamma_to_t(self, gamma):
        return (gamma - self.gamma0) / (self.gamma1 - self.gamma0)

    def t_to_gamma(self, t):
        return self.gamma0 + t * (self.gamma1 - self.gamma0)

    def gamma_2_as(self, gamma):
        var = torch.sigmoid(gamma)
        return torch.sqrt(1 - var), torch.sqrt(var)

    def gamma_to_sigma(self, gamma):
        return torch.sqrt(torch.exp(gamma))

    def sigma_to_gamma(self, sigma):
        return torch.log(sigma**2)

    def sigma_to_t(self, sigma):
        return self.gamma_to_t(self.sigma_to_gamma(sigma))

    def gamma2logas(self, g):
        log_var = -torch.nn.functional.softplus(-g)
        return 0.5 * (-g + log_var), log_var

    # ------------------------------------------------------- denoiser

    def denoiser(self, xn, net, sigma):
        """sigma -> (a, s); x0 = (z - s eps_hat) / a with z = a xn and the
        network conditioned on t; sigma [B,1], [B] or a scalar."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=xn.device)
        if sigma.ndim == 0:
            sigma = sigma[None, None]
        elif sigma.ndim == 1:
            sigma = sigma[:, None]
        gamma = self.sigma_to_gamma(sigma)
        t = self.gamma_to_t(gamma)
        a, s = self.gamma_2_as(gamma)
        z_t = a * xn
        eps_hat = net(z_t, t.expand(z_t.shape[0], 1))
        return (-s * eps_hat + z_t) / a

    # -------------------------------------------------- DDIM reverse

    @torch.no_grad()
    def reverse_process_ddim(self, gen, shape, net, z_init=None):
        """The DDIM reverse process over ``T`` steps from z ~ N(0, 1) of
        ``shape``, drawn from ``gen`` unless ``z_init`` is given."""
        z = (torch.randn(tuple(shape), generator=gen, device=gen.device)
             if z_init is None else z_init.float())
        tt = torch.linspace(0.0, 1.0, self.T + 1, device=z.device)
        gamma, steps = self.logsnr_linear(tt)
        Pm1 = -torch.expm1((gamma[1:] - gamma[:-1]) * 0.5)
        log_alpha, log_var = self.gamma2logas(gamma)
        alpha_st = torch.exp(log_alpha[:-1] - log_alpha[1:])
        std = torch.exp(0.5 * log_var)
        for t in range(self.T, 0, -1):
            s = t - 1
            noise_hat = net(z, steps[t].expand(z.shape[0], 1))
            z = z * alpha_st[s] + std[s] * Pm1[s] * noise_hat
        return z
