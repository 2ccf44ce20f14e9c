"""Degradation operators for the inverse problems, as closures.

Counterpart of ``babe_tpu/sampling/degradations.py``: every inverse task
is a function ``degradation(x)`` handed to a guided sampler.  Filter design
happens on the host when the closure is built (scipy taps, IIR
coefficients); the closures run on the tensor's device and are
differentiable with autograd.
"""

from __future__ import annotations

from typing import Callable

import torch

from babe_tpu_torch.ops import fir, iir
from babe_tpu_torch.ops.filters import design_filter
from babe_tpu_torch.ops.resample import resample
from babe_tpu_torch.ops.stft import apply_filter, hamming_window, stft


def make_fir(taps) -> Callable:
    """FIR lowpass or highpass: a 'same'-padded correlation with taps."""
    return lambda x: fir.apply_fir(x, taps)


def make_iir(b, a) -> Callable:
    """cheby1-style IIR (b, a) through ``iir.lfilter``, its coefficients
    held on each device once."""
    return iir.IIR(b, a)


def make_biquad(coeffs) -> Callable:
    b0, b1, b2, a0, a1, a2 = coeffs
    return iir.IIR([b0, b1, b2], [a0, a1, a2])


def make_decimate(factor: int) -> Callable:
    """Naive decimation x[0:-1:factor]."""
    return lambda x: x[..., 0:-1:factor]


def make_resample(factor: float, N: int = 100) -> Callable:
    """Resampling by ``factor`` (rates N * factor -> N, gcd-reduced)."""
    return lambda x: resample(x, int(N * factor), N)


def make_mask(mask) -> Callable:
    """Inpainting and compressive sensing: mask * x."""
    return lambda x: mask * x


def make_clip(clip_value) -> Callable:
    """Declipping: x clipped to +-clip_value (a number or a tensor)."""
    return lambda x: torch.clamp(x, -clip_value, clip_value)


def make_stft_mag(win_size: int, hop_size: int) -> Callable:
    """Phase retrieval: |STFT| with a hamming window of ``win_size`` and
    hop ``hop_size``, the input zero-padded by ``win_size`` at the end."""
    w = hamming_window(win_size)

    def deg(x):
        return stft(torch.nn.functional.pad(x, (0, win_size)), win_size,
                    hop_size, w).abs()

    return deg


def make_fcA(freqs: torch.Tensor, nfft: int) -> Callable:
    """Parametric STFT-domain lowpass; takes (x, params[2, K])."""

    def deg(x, params):
        H = design_filter(params[0], params[1], freqs)
        return apply_filter(x, H, nfft)

    return deg


def make_masked_composite(mask, base: Callable) -> Callable:
    """Autoregressive outpainting observation: mask * x + (1 - mask) *
    base(x)."""
    return lambda x, *a: mask * x + (1 - mask) * base(x, *a)


def prepare_filter(args, sample_rate: float):
    """Host-side design of ``tester.bandwidth_extension.filter``: returns
    (filt, type)."""
    f = args.tester.bandwidth_extension.filter
    ftype = f.type
    if ftype == "firwin":
        return fir.get_FIR_lowpass(int(f.order), float(f.fc), float(f.beta),
                                   sample_rate), ftype
    if ftype == "firwin_hpf":
        return fir.get_FIR_highpass(int(f.order), float(f.fc), float(f.beta),
                                    sample_rate), ftype
    if ftype == "cheby1":
        b, a = iir.get_cheby1_ba(int(f.order), float(f.ripple),
                                 2 * float(f.fc) / sample_rate)
        return (b, a), ftype
    if ftype == "biquad":
        return iir.design_biquad_lpf(float(f.fc), sample_rate,
                                     float(f.biquad.Q)), ftype
    if ftype == "resample":
        return sample_rate / float(f.resample.fs), ftype
    if ftype == "decimate":
        return int(args.tester.bandwidth_extension.decimate.factor), ftype
    raise NotImplementedError(f"filter type {ftype}")


def degradation_from_filter(filt, filt_type: str) -> Callable:
    """The degradation of an informed-BWE filter of the given type."""
    if filt_type in ("firwin", "firwin_hpf"):
        return make_fir(filt)
    if filt_type == "cheby1":
        b, a = filt
        return make_iir(b, a)
    if filt_type == "biquad":
        return make_biquad(filt)
    if filt_type == "resample":
        return make_resample(filt)
    if filt_type == "decimate":
        return make_decimate(filt)
    raise NotImplementedError(filt_type)
