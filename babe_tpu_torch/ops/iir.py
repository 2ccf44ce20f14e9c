"""IIR filtering (lfilter, biquad) and its host-side design, in PyTorch.

Counterpart of ``babe_tpu/ops/iir.py``.  ``lfilter`` is the transposed
direct form II along the last axis, in the JAX package's order (the delay
line updated as b[1:] x - a[1:] y plus the shifted state), as an autograd
Function: on a CUDA tensor one launch of ``csrc/iir.cu`` (a row a thread,
fp32), on a CPU tensor the plain loop over time (``lfilter_ref``).  The
input gradient is the same filter run over the time-reversed cotangent
from a zero state (the transpose of a causal LTI filter matrix is the
time-reversed filter): the kernel reading and writing back to front, or
the plain loop on the flipped cotangent.  The coefficients come from host
designs (``get_cheby1_ba``, ``design_biquad_lpf``) and get no gradient.
``IIR`` holds one filter's coefficients on each device it has run on,
divided by a[0] once.  The reference uses IIR filters only for optional
degradation variants (cheby1, biquad), never on the main path.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch

from babe_tpu_torch import kernels as _k


def _no_grad(*vs) -> None:
    if any(torch.is_tensor(v) and v.requires_grad for v in vs):
        raise ValueError("lfilter: the coefficients get no gradient; pass "
                         "them detached")


def _normalised(a, b, dtype, device) -> torch.Tensor:
    """b then a as one tensor (2n,) of ``dtype`` on ``device``, each
    divided by a[0] there (as the JAX loop divides them)."""
    _no_grad(a, b)
    a = torch.as_tensor(a, dtype=dtype, device=device)
    b = torch.as_tensor(b, dtype=dtype, device=device)
    if a.dim() != 1 or a.shape != b.shape or a.shape[0] < 2:
        raise ValueError(f"lfilter: a and b must be 1-D of one length >= 2, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    return torch.cat([b / a[0], a / a[0]])


def lfilter_ref(xf: torch.Tensor, b: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
    """The plain recursion over rows xf (R, L), b and a already divided by
    a[0]: a loop over time (the kernel's plain version)."""
    n = a.shape[0]
    state = xf.new_zeros((xf.shape[0], n - 1))
    pad = xf.new_zeros((xf.shape[0], 1))
    ys = []
    for t in range(xf.shape[-1]):
        xt = xf[:, t]
        yt = b[0] * xt + state[:, 0]
        new = b[1:] * xt[:, None] - a[1:] * yt[:, None]
        state = new + torch.cat([state[:, 1:], pad], dim=1)
        ys.append(yt)
    if not ys:
        return xf.clone()
    return torch.stack(ys, dim=-1)


def _rows(xf: torch.Tensor, coef: torch.Tensor,
          reverse: bool) -> torch.Tensor:
    """The recursion over the rows of xf with the normalised coefficients
    coef (b then a), or with ``reverse`` over each row back to front: the
    kernel on CUDA (fp32), else the plain loop."""
    if xf.is_cuda:
        if xf.dtype != torch.float32:
            raise ValueError(f"lfilter: the kernel takes fp32, got "
                             f"{xf.dtype}")
        return _k.launch_lfilter(xf.contiguous(), coef, reverse=reverse)
    b, a = coef.chunk(2)
    if reverse:
        return lfilter_ref(xf.flip(-1), b, a).flip(-1)
    return lfilter_ref(xf, b, a)


class _LFilter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coef):
        ctx.save_for_backward(coef)
        L = x.shape[-1]
        return _rows(x.reshape(-1, L), coef, False).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        (coef,) = ctx.saved_tensors
        L = g.shape[-1]
        dx = _rows(g.reshape(-1, L).to(coef.dtype), coef, True)
        return dx.reshape(g.shape), None


class IIR:
    """One IIR filter (b, a), callable on (..., L) tensors; the normalised
    coefficients are made once per (device, dtype)."""

    def __init__(self, b, a):
        _no_grad(a, b)
        self.b, self.a = (v.cpu().numpy() if torch.is_tensor(v)
                          else np.asarray(v) for v in (b, a))
        self._coef: dict = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        key = (x.dtype, x.device)
        if key not in self._coef:
            self._coef[key] = _normalised(self.a, self.b, x.dtype, x.device)
        return _LFilter.apply(x, self._coef[key])


def lfilter(x: torch.Tensor, a, b) -> torch.Tensor:
    """Direct-form-II-transposed IIR along the last axis, as
    ``torchaudio.functional.lfilter(x, a, b, clamp=False)``."""
    return _LFilter.apply(x, _normalised(a, b, x.dtype, x.device))


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
