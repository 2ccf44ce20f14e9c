"""A-weighting and pre-emphasis FIR filters for the perceptual weighting of
the training loss.

Counterpart of ``babe_tpu/ops/aweighting.py``: the taps are designed on the
host with scipy (the IEC A-weighting analog prototype, its bilinear map,
``freqz`` on 512 points and a ``firls`` fit), and applied on the tensor's
device as the 'same' correlation of ``ops/fir.py::apply_fir``.  The EDM
loss applies them to the training error when
``diff_params.aweighting.use_aweighting`` is set.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch

from babe_tpu_torch.ops.fir import apply_fir


@functools.lru_cache(maxsize=8)
def aweighting_fir(fs: float, ntaps: int = 101) -> np.ndarray:
    """An ``ntaps``-tap FIR fit to the IEC A-weighting curve at rate
    ``fs``, float32 (``ntaps`` odd)."""
    if ntaps % 2 == 0:
        raise ValueError(f"ntaps must be odd (ntaps={ntaps})")
    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    A1000 = 1.9997
    NUMs = [(2 * np.pi * f4) ** 2 * (10 ** (A1000 / 20)), 0, 0, 0, 0]
    DENs = np.polymul(
        [1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2],
        [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2],
    )
    DENs = np.polymul(np.polymul(DENs, [1, 2 * np.pi * f3]),
                      [1, 2 * np.pi * f2])
    b, a = scipy.signal.bilinear(NUMs, DENs, fs=fs)
    w_iir, h_iir = scipy.signal.freqz(b, a, worN=512, fs=fs)
    taps = scipy.signal.firls(ntaps, w_iir, abs(h_iir), fs=fs)
    return taps.astype(np.float32)


def hp_fir(coef: float = 0.85) -> np.ndarray:
    """First-order highpass pre-emphasis taps."""
    return np.array([1.0, -coef, 0.0], dtype=np.float32)


def fd_fir(coef: float = 0.85) -> np.ndarray:
    """Folded-differentiator pre-emphasis taps."""
    return np.array([1.0, 0.0, -coef], dtype=np.float32)


def apply_aweighting(error: torch.Tensor, fs: float,
                     ntaps: int = 101) -> torch.Tensor:
    """``error`` [..., T] filtered by the A-weighting FIR of rate ``fs``."""
    return apply_fir(error, aweighting_fir(fs, ntaps))
