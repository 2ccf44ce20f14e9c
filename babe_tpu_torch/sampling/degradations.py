"""Degradation operators for the BWE samplers, as closures.

Counterpart of ``babe_tpu/sampling/degradations.py`` for the operators the
blind and informed BWE paths use.  The FIR, IIR, biquad and resampling
degradations belong to the DSP slice of the port and raise until then.
"""

from __future__ import annotations

from typing import Callable

import torch

from babe_tpu_torch.ops.filters import design_filter
from babe_tpu_torch.ops.stft import apply_filter


def make_decimate(factor: int) -> Callable:
    """Naive decimation x[0:-1:factor]."""
    return lambda x: x[..., 0:-1:factor]


def make_fcA(freqs: torch.Tensor, nfft: int) -> Callable:
    """Parametric STFT-domain lowpass; takes (x, params[2, K])."""

    def deg(x, params):
        H = design_filter(params[0], params[1], freqs)
        return apply_filter(x, H, nfft)

    return deg


def degradation_from_filter(filt, filt_type: str) -> Callable:
    """Degradation for an informed-BWE filter of the given type."""
    if filt_type == "decimate":
        return make_decimate(filt)
    if filt_type in ("firwin", "firwin_hpf", "cheby1", "biquad", "resample"):
        raise NotImplementedError(
            f"filter type {filt_type!r} is not ported yet (the FIR/IIR/"
            "resample DSP slice of the port); use the parametric 'fc_A'")
    raise NotImplementedError(filt_type)
