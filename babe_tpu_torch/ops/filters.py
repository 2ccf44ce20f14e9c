"""Parametric degradation filters and frequency-weighted norms, in PyTorch.

Counterpart of ``babe_tpu/ops/filters.py``: the piecewise log-log lowpass
``design_filter`` (and ``design_filter_G`` with a broadband gain), the
STFT-domain degradation ``apply_filter_fcA``, the STFT-distance guidance
norms, the blind-BWE fit objective and the filter-estimation metric
``filter_db_mse``.  All functions are differentiable with autograd.
"""

from __future__ import annotations

import torch

from babe_tpu_torch.ops.stft import apply_filter, apply_stft

_EPS = 1e-8


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


def design_filter_G(fc, A, G, f: torch.Tensor) -> torch.Tensor:
    """``design_filter`` times a broadband gain of G dB."""
    G = torch.as_tensor(G, dtype=f.dtype, device=f.device)
    return design_filter(fc, A, f) * 10.0 ** (G / 20.0)


def apply_filter_fcA(x: torch.Tensor, filter_params, freqs: torch.Tensor,
                     nfft: int) -> torch.Tensor:
    """Degrade ``x`` with the parametric lowpass of ``filter_params``
    [2, K] (fc, A) by an STFT-domain multiply."""
    H = design_filter(filter_params[0], filter_params[1], freqs)
    return apply_filter(x, H, nfft)


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


def _weights(n_freq: int, kind: str, device) -> torch.Tensor:
    """The weighting curve over ``n_freq`` bins, as a column [F, 1]."""
    return _freq_weighting(torch.linspace(0.0, 1.0, n_freq, device=device),
                           kind)[:, None]


def apply_norm_STFT_fweighted(y, den_rec, freq_weight="linear", nfft=1024):
    """L2 distance between the complex STFTs of ``den_rec`` and ``y``,
    each frequency weighted."""
    X = apply_stft(den_rec, nfft)
    Xref = apply_stft(y, nfft)
    d = (X - Xref) * _weights(X.shape[-2], freq_weight, X.device)
    return torch.sqrt(torch.sum(d.abs() ** 2))


def apply_norm_STFTmag_fweighted(y, den_rec, freq_weight="linear", nfft=1024,
                                 logmag=False):
    """L2 distance between the STFT magnitudes of ``den_rec`` and ``y``
    (their log10 with ``logmag``), each frequency weighted."""
    X = apply_stft(den_rec, nfft).abs()
    Xref = apply_stft(y, nfft).abs()
    w = _weights(X.shape[-2], freq_weight, X.device)
    X = X * w
    Xref = Xref * w
    if logmag:
        return torch.sqrt(torch.sum(
            (torch.log10(X + _EPS) - torch.log10(Xref + _EPS)) ** 2))
    return torch.sqrt(torch.sum((X - Xref) ** 2))


def apply_filter_and_norm_STFTmag_fweighted(X, Xref, H, freq_weight="linear"):
    """The blind filter-fit objective || (|X| H - |Xref|) w ||_2 for complex
    STFTs [..., F, T] and a response H [F]."""
    Xm = X.abs() * H[..., :, None]
    Xr = Xref.abs()
    w = _weights(Xm.shape[-2], freq_weight, Xm.device)
    return torch.sqrt(torch.sum(((Xm - Xr) * w) ** 2))


def filter_db_mse(params_true, params_est, freqs: torch.Tensor) -> torch.Tensor:
    """Filter-estimation metric: the mean squared difference of the two
    responses in dB."""
    Ht = design_filter(params_true[0], params_true[1], freqs)
    He = design_filter(params_est[0], params_est[1], freqs)
    return torch.mean((20 * torch.log10(Ht + _EPS)
                       - 20 * torch.log10(He + _EPS)) ** 2)
