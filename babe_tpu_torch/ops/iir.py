"""IIR filtering (lfilter, biquad) and its host-side design, in PyTorch.

Counterpart of ``babe_tpu/ops/iir.py``.  The recursion is sequential, so
``lfilter`` is a loop over time of the transposed direct form II, in the
JAX package's order (the delay line updated as b[1:] x - a[1:] y plus the
shifted state); it is differentiable with autograd.  The reference uses
IIR filters only for optional degradation variants (cheby1, biquad), never
on the main path.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch


def lfilter(x: torch.Tensor, a, b) -> torch.Tensor:
    """Direct-form-II-transposed IIR along the last axis, as
    ``torchaudio.functional.lfilter(x, a, b, clamp=False)``."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    b = b / a[0]
    a = a / a[0]
    n = a.shape[0]
    xf = x.reshape(-1, x.shape[-1])
    state = xf.new_zeros((xf.shape[0], n - 1))
    pad = xf.new_zeros((xf.shape[0], 1))
    ys = []
    for t in range(xf.shape[-1]):
        xt = xf[:, t]
        yt = b[0] * xt + state[:, 0]
        new = b[1:] * xt[:, None] - a[1:] * yt[:, None]
        state = new + torch.cat([state[:, 1:], pad], dim=1)
        ys.append(yt)
    return torch.stack(ys, dim=-1).reshape(x.shape)


def biquad(x: torch.Tensor, b0, b1, b2, a0, a1, a2) -> torch.Tensor:
    """``torchaudio.functional.biquad`` equivalent."""
    return lfilter(x, [a0, a1, a2], [b0, b1, b2])


def get_cheby1_ba(order: int, ripple: float, hi: float):
    """Chebyshev type-I lowpass (b, a), host scipy; ``hi`` is the cutoff
    as a fraction of Nyquist."""
    b, a = scipy.signal.cheby1(order, ripple, hi, btype="lowpass",
                               output="ba")
    return b.astype(np.float32), a.astype(np.float32)


def design_biquad_lpf(fc: float, fs: float, Q: float):
    """RBJ biquad lowpass coefficients (b0, b1, b2, a0, a1, a2)."""
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / 2.0 / Q
    b0 = (1.0 - math.cos(w0)) / 2.0
    b1 = 1.0 - math.cos(w0)
    b2 = b0
    a0 = 1.0 + alpha
    a1 = -2.0 * math.cos(w0)
    a2 = 1.0 - alpha
    return b0, b1, b2, a0, a1, a2
