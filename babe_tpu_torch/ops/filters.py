"""Parametric degradation filter and the blind-BWE fit objective, in PyTorch.

Counterpart of ``babe_tpu/ops/filters.py`` (``design_filter``,
``_freq_weighting``, ``apply_filter_and_norm_STFTmag_fweighted``).  All
functions are differentiable with autograd.
"""

from __future__ import annotations

import torch


def design_filter(fc, A, f: torch.Tensor) -> torch.Tensor:
    """Piecewise log-log lowpass magnitude response.

    fc: breakpoints (K,) in Hz; A: slopes (K,) in dB/octave; f: frequency
    grid.  H = 1 below fc[0]; past each breakpoint the response follows
    10^(A[i] log2(f/fc[i]) / 20), scaled so the segments chain at the first
    frequency bin >= fc[i]."""
    fc = torch.atleast_1d(torch.as_tensor(fc, dtype=f.dtype, device=f.device))
    A = torch.atleast_1d(torch.as_tensor(A, dtype=f.dtype, device=f.device))
    H = torch.ones_like(f)
    for i in range(fc.shape[0]):
        mask = f >= fc[i]
        fci = torch.clamp(fc[i], min=1e-9)
        # the argument is clamped to the masked domain so the unselected
        # branch cannot overflow and poison gradients through where
        seg = 10.0 ** (A[i] * torch.log2(torch.maximum(f, fci) / fci) / 20.0)
        if i == 0:
            H = torch.where(mask, seg, H)
        else:
            # gather, not H[first]: a tensor index would sync the host
            first = torch.argmax(mask.to(torch.int32)).reshape(1)
            cont = torch.where(mask.any(), H.index_select(0, first)[0],
                               torch.ones_like(H[0]))
            H = torch.where(mask, seg * cont, H)
    return H


def _freq_weighting(freqs01: torch.Tensor, kind: str) -> torch.Tensor:
    """Frequency weighting curves over a [0, 1] grid."""
    if kind in (None, "None", "none"):
        return torch.ones_like(freqs01)
    curves = {
        "linear": lambda f: f,
        "log": lambda f: torch.log2(1 + f),
        "sqrt": torch.sqrt,
        "log2": torch.log2,
        "log10": torch.log10,
        "cubic": lambda f: f**3,
        "quadratic": lambda f: f**2,
        "logcubic": lambda f: torch.log2(1 + f**3),
        "logquadratic": lambda f: torch.log2(1 + f**2),
        "squared": lambda f: f**4,
    }
    if kind not in curves:
        raise ValueError(f"unknown freq weighting {kind!r}")
    return curves[kind](freqs01)


def apply_filter_and_norm_STFTmag_fweighted(X, Xref, H, freq_weight="linear"):
    """The blind filter-fit objective || (|X| H - |Xref|) w ||_2 for complex
    STFTs [..., F, T] and a response H [F]."""
    Xm = X.abs() * H[..., :, None]
    Xr = Xref.abs()
    w = _freq_weighting(torch.linspace(0.0, 1.0, Xm.shape[-2],
                                       device=Xm.device), freq_weight)[:, None]
    return torch.sqrt(torch.sum(((Xm - Xr) * w) ** 2))
