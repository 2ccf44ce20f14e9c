"""The training step, plain PyTorch in float32: the data's polyphase
resampling, EDM's loss and its gradients, the global-norm clip, Adam with
a linear learning-rate ramp, and the EMA of the weights.

Written from the descriptions they follow: torchaudio's windowed-sinc
resampler (``sinc_interp_hann``, lowpass width 6, rolloff 0.99); Adam
(Kingma and Ba) with bias correction at the step's count and the rate
lr * min(count / rampup, 1) taken at the count before the step, so the
first step moves nothing; optax's ``clip_by_global_norm`` (scaled by
max_norm / norm only when norm >= max_norm); the EMA with a warm-up over
samples, rate min(t / ema_rampup, ema_rate), t = steps before this one
times the batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.diffusion import train_loss


def resample(x: torch.Tensor, orig: int, new: int) -> torch.Tensor:
    """x [..., T] from rate ``orig`` to ``new``: ceil(T * new / orig)
    samples."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    width_z, roll = 6, 0.99
    base = min(orig, new) * roll
    width = math.ceil(width_z * orig / base)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base
    t = np.clip(t, -width_z, width_z)
    win = np.cos(t * np.pi / width_z / 2.0) ** 2
    tp = t * np.pi
    k = np.where(tp == 0, 1.0, np.sin(tp) / np.where(tp == 0, 1.0, tp))
    k = torch.as_tensor((k * win * base / orig).astype(np.float32),
                        device=x.device)
    T = x.shape[-1]
    xr = x.reshape(-1, 1, T).float()
    xp = torch.nn.functional.pad(xr, (width, width + orig))
    y = torch.nn.functional.conv1d(xp, k[:, None, :], stride=orig)
    n = int(math.ceil(new * T / orig))
    return y.transpose(1, 2).reshape(xr.shape[0], -1)[:, :n].reshape(
        *x.shape[:-1], n)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 2e-4
    rampup: int = 10000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_norm: float | None = 1.0
    ema_rate: float = 0.9999
    ema_rampup: float = 10000.0
    batch: int = 4


def loss_and_grads(P, cfg, e, x, sigma, noise, leaves):
    """EDM's mean loss over the batch, each item's loss, and the mean's
    gradients with respect to the ``leaves`` of P, one item at a time (the
    mean over items is the sum of each item's over the batch's size)."""
    B = x.shape[0]
    params = {k: (v.detach().requires_grad_(True) if k in leaves else v)
              for k, v in P.items()}
    grads = {k: torch.zeros_like(P[k]) for k in leaves}
    items = []
    for i in range(B):
        with torch.enable_grad():
            li = train_loss(params, cfg, e, x[i:i + 1], sigma[i:i + 1],
                            noise[i:i + 1]) / B
            gs = torch.autograd.grad(li, [params[k] for k in leaves],
                                     allow_unused=True)
        for k, g in zip(leaves, gs):
            if g is not None:
                grads[k] += g
        items.append(float(li.detach()) * B)
    return sum(items) / B, torch.tensor(items, dtype=torch.float64), grads


class Adam:
    """The optimizer and the EMA on a dict of float32 leaves."""

    def __init__(self, o: OptConfig, params: dict):
        self.o = o
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.ema = {k: v.clone() for k, v in self.p.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0

    def step(self, grads: dict) -> dict:
        """One update; returns the gradients as the optimizer took them
        (after the clip)."""
        o = self.o
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values()))
        if o.max_norm is not None and not norm < o.max_norm:
            grads = {k: g / norm * o.max_norm for k, g in grads.items()}
        lr = o.lr * min(self.count / o.rampup, 1.0)
        self.count += 1
        bc1, bc2 = 1.0 - o.b1 ** self.count, 1.0 - o.b2 ** self.count
        for k, g in grads.items():
            self.m[k] = (1 - o.b1) * g + o.b1 * self.m[k]
            self.v[k] = (1 - o.b2) * g * g + o.b2 * self.v[k]
            upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + o.eps)
            self.p[k] = self.p[k] - lr * upd
        t = (self.count - 1) * o.batch
        s = min(t / o.ema_rampup, o.ema_rate)
        for k in self.p:
            self.ema[k] = self.ema[k] * s + self.p[k] * (1.0 - s)
        return grads
