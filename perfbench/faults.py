"""Faults planted underneath the timed path, to show that a cell's check
fails them: a step that hands its state back unchanged, half of the batch
left out, an answer altered where it is produced.  Each takes a
``monkeypatch``-like object (``setattr(obj, name, value)``) and the kind of
the cell's traffic.  The CPU tests plant them in tiny runs
(``perfbench/tests/test_faults.py``); ``perfbench/calibrate.py --fault``
reads them on the card at a cell's own size."""

from __future__ import annotations

import torch


def unchanged(mp, kind: str) -> None:
    """The step hands its state back unchanged: no update of the weights
    (training), a zero score with the state as its own denoised estimate
    (sampling)."""
    from babe_tpu_torch.sampling.blind import BlindSampler
    from babe_tpu_torch.sampling.heun import Sampler
    from babe_tpu_torch.training.trainer import Trainer

    def update(self, grads, gnorm):
        self.it += 1

    def stage(self, x_hat, t_cur, params, y, Y, gen, den_noise=None):
        return torch.zeros_like(x_hat), params, x_hat

    mp.setattr(Trainer, "_apply_update", update)
    mp.setattr(BlindSampler, "_stage", stage)
    mp.setattr(Sampler, "_score", lambda self, x, t, **kw: torch.zeros_like(x))


def half_batch(mp, kind: str) -> None:
    """Half of the batch left out: training takes the mean loss over the
    rest; sampling leaves the rest's network output at zero."""
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlusNet
    from babe_tpu_torch.training.trainer import Trainer

    if kind == "train":
        loss = Trainer._loss

        def half(self, x, sigma, noise, j):
            n = x.shape[0] // 2
            return loss(self, x[:n], None if sigma is None else sigma[:n],
                        None if noise is None else noise[:n], j)

        mp.setattr(Trainer, "_loss", half)
        return
    fwd = CQTDiffPlusNet.forward

    def forward(self, coeffs, sigma):
        n = coeffs[0].shape[0] // 2
        outs = fwd(self, [c[:n] for c in coeffs], sigma[:n])
        return [torch.cat([o, torch.zeros_like(o)]) for o in outs]

    mp.setattr(CQTDiffPlusNet, "forward", forward)


def altered(mp, kind: str) -> None:
    """The network's answer for the first item altered (negated) where it
    is made."""
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlusNet

    fwd = CQTDiffPlusNet.forward

    def forward(self, coeffs, sigma):
        outs = fwd(self, coeffs, sigma)
        return [torch.cat([-o[:1], o[1:]]) for o in outs]

    mp.setattr(CQTDiffPlusNet, "forward", forward)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}


class Patch:
    """A ``setattr`` that remembers what it replaced; ``undo()`` puts it
    back."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved = []
