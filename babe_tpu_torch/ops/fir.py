"""FIR filter design (host scipy) and application, in PyTorch.

Counterpart of ``babe_tpu/ops/fir.py``: the taps of the firwin
degradations are designed on the host with scipy (Kaiser window) and
applied as a 'same'-padded correlation along the last axis, the
semantics of ``torch.nn.functional.conv1d(y, taps, padding='same')``,
on the tensor's device (TF32 off, so fp32 stays fp32 on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch


@functools.lru_cache(maxsize=32)
def get_FIR_lowpass(order: int, fc: float, beta: float,
                    sr: float) -> np.ndarray:
    """Kaiser-window lowpass FIR taps, shape (order,)."""
    taps = scipy.signal.firwin(numtaps=order, cutoff=fc, width=beta,
                               window="kaiser", fs=sr)
    return taps.astype(np.float32)


@functools.lru_cache(maxsize=32)
def get_FIR_highpass(order: int, fc: float, beta: float,
                     sr: float) -> np.ndarray:
    """Kaiser-window highpass FIR taps, shape (order - 1,)."""
    taps = scipy.signal.firwin(numtaps=order - 1, cutoff=fc, width=beta,
                               window="kaiser", fs=sr, pass_zero="highpass")
    return taps.astype(np.float32)


def apply_fir(y: torch.Tensor, taps) -> torch.Tensor:
    """'same'-padded correlation of ``y`` [..., T] with ``taps`` (k,):
    out[n] = sum_j y[n + j - lo] taps[j], zero-padded by lo = k - 1 - k // 2
    on the left and k // 2 on the right (one more on the left for an even
    k, as torch's 'same')."""
    taps = torch.as_tensor(taps, dtype=y.dtype, device=y.device)
    k = taps.shape[0]
    hi = k // 2
    lo = k - 1 - hi
    shape = y.shape
    x = torch.nn.functional.pad(y.reshape(-1, 1, shape[-1]), (lo, hi))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = torch.nn.functional.conv1d(x, taps.reshape(1, 1, -1))
    return out.reshape(shape)
