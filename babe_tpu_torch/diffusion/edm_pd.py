"""Progressive-distillation (PD) EDM variant, in PyTorch.

Counterpart of ``babe_tpu/diffusion/edm_pd.py``: the boundary schedule
(``create_schedule(PD.boundaries.T)``), one deterministic ODE step, the
distillation loss (two teacher ODE steps give the student's one-step
target) and the distilled few-step sampler.  Random draws (the pair index
j and the prior noise, in that order) come from the caller's
``torch.Generator``; the loss and the sampler also take them as arguments,
so that a test hands both packages the same draws.
"""

from __future__ import annotations

import torch

from babe_tpu_torch.diffusion.edm import EDM, EDMParams


class EDMPD(EDM):
    def __init__(self, p: EDMParams, boundaries_T: int = 16, **kw):
        super().__init__(p, **kw)
        self.boundaries = self.create_schedule(int(boundaries_T))

    @classmethod
    def from_config(cls, args, cqt_hpf=None) -> "EDMPD":
        dp = args.diff_params
        return cls(
            EDMParams.from_config(dp),
            boundaries_T=int(dp.get_path("PD.boundaries.T", 16)),
            cqt_hpf=cqt_hpf,
        )

    def ode_update(self, x, sigma_1, sigma_0, net_teacher):
        """One deterministic ODE step from sigma_0 to sigma_1."""
        x0_hat = self.denoiser(x, net_teacher, sigma_0)
        score = (x0_hat - x) / sigma_0**2
        return x - (sigma_1 - sigma_0) * sigma_0 * score

    def pd_draws(self, gen, x, stage: int, j=None, noise=None):
        """(schedule, j, i, noise) of one PD loss on x [B,T]: the stage's
        schedule from high to low sigma, the step pair j [B,1] (None when
        the schedule has 3 boundaries or fewer), its boundary index i and
        the prior draw scaled by sigma_0, j and noise each drawn from
        ``gen`` unless given, j first."""
        schedule = self.boundaries[::2**stage] if stage > 0 else self.boundaries
        schedule = schedule.flip(0).to(x.device)
        B, n = x.shape[0], schedule.shape[0]
        if n > 3:
            if j is None:
                j = torch.randint(1, n // 2, (B, 1), generator=gen,
                                  device=gen.device)
            i = j.to(x.device).long() * 2 + 1
        else:
            i = torch.full((B, 1), 2, device=x.device)
        if noise is None:
            noise = self.sample_prior(gen, x.shape,
                                      schedule[i].to(gen.device))
        return schedule, j, i, noise.to(x.device)

    def loss_fn_PD(self, gen, net, net_teacher, x, stage: int, j=None,
                   noise=None):
        """Per-sample squared error [B,T] of the student against the
        teacher's double step, and the sigmas [B,1] used.  ``j`` [B,1]
        (the step pair, in [1, n // 2) over the stage's n boundaries when
        n > 3) and ``noise`` [B,T] (the prior draw, already scaled by
        sigma_0) are drawn from ``gen`` (j first) unless given.  The
        teacher runs without autograd; the error is DC-corrected when the
        CQT's hpf is set."""
        schedule, j, i, noise = self.pd_draws(gen, x, stage, j, noise)
        sigma_0, sigma_1, sigma_2 = schedule[i], schedule[i - 1], schedule[i - 2]
        cskip_0, cout_0, cin_0 = (self.cskip(sigma_0), self.cout(sigma_0),
                                  self.cin(sigma_0))
        zn = x + noise
        with torch.no_grad():
            z_teacher = self.ode_update(zn, sigma_1, sigma_0, net_teacher)
            z_teacher = self.ode_update(z_teacher, sigma_2, sigma_1,
                                        net_teacher)
            r = sigma_2 / sigma_0
            x0_student = (z_teacher - r * zn) / (1 - r)
            target = (1.0 / cout_0) * (x0_student - cskip_0 * zn)
        error = net(cin_0 * zn, self.cnoise(sigma_0)) - target
        if self.cqt_hpf is not None:
            error = self.cqt_hpf(error)
        return error**2, sigma_0

    @torch.no_grad()
    def PD_sample(self, gen, N: int, L: int, net, stage: int, z_init=None):
        """The distilled sampler: N signals of L samples from the stage's
        boundaries (every 2^(stage+1)-th), from z ~ N(0, 1) drawn from
        ``gen`` unless ``z_init`` is given."""
        schedule = self.boundaries[::2 ** (stage + 1)].flip(0)
        z = (torch.randn((N, L), generator=gen, device=gen.device)
             if z_init is None else z_init.float())
        schedule = schedule.to(z.device)
        z = z * schedule[-1]
        n = schedule.shape[0]
        for i in range(n - 1):
            z = self.ode_update(z, schedule[n - 2 - i], schedule[n - 1 - i],
                                net)
        return z
