"""STFT / iSTFT with the reference's torch.stft conventions (hamming window,
hop nfft//2, center=False), in PyTorch.

Counterpart of ``babe_tpu/ops/stft.py``.  Layouts are (..., freq, frames).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hamming_window(n: int) -> np.ndarray:
    """Periodic hamming, as torch.hamming_window(n)."""
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32)


@functools.lru_cache(maxsize=32)
def _istft_plan(nfft: int, hop: int, n_frames: int):
    """Overlap-add indices and the window envelope (host numpy)."""
    w = hamming_window(nfft)
    T = (n_frames - 1) * hop + nfft
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(nfft)[None, :]).reshape(-1)
    env = np.zeros(T, dtype=np.float32)
    np.add.at(env, idx, np.tile(w**2, n_frames))
    return idx, np.maximum(env, 1e-11)


def stft(x: torch.Tensor, nfft: int, hop: int | None = None) -> torch.Tensor:
    """[..., T] -> complex [..., nfft//2+1, n_frames] (center=False)."""
    hop = nfft // 2 if hop is None else hop
    w = torch.as_tensor(hamming_window(nfft), device=x.device)
    frames = x.unfold(-1, nfft, hop) * w
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def istft(X: torch.Tensor, nfft: int, hop: int | None = None,
          length: int | None = None) -> torch.Tensor:
    """Inverse of :func:`stft` with torch.istft's window-envelope
    normalisation."""
    hop = nfft // 2 if hop is None else hop
    dev = X.device
    w = torch.as_tensor(hamming_window(nfft), device=dev)
    frames = torch.fft.irfft(X.transpose(-1, -2), n=nfft, dim=-1) * w
    n_frames = frames.shape[-2]
    idx, env = _istft_plan(nfft, hop, n_frames)
    lead = frames.shape[:-2]
    y = frames.new_zeros((*lead, env.shape[0]))
    y = y.index_add(-1, torch.as_tensor(idx, device=dev),
                    frames.reshape(*lead, -1))
    y = y / torch.as_tensor(env, device=dev)
    return y if length is None else y[..., :length]


def apply_stft(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """The blind-BWE analysis STFT: zero-pad by nfft at the end, hamming
    window, hop nfft//2, center=False.  Complex [..., nfft//2+1, frames]."""
    return stft(torch.nn.functional.pad(x, (0, nfft)), nfft)


def apply_filter_istft(X: torch.Tensor, H: torch.Tensor,
                       nfft: int) -> torch.Tensor:
    """Multiply a frequency response onto an STFT and invert."""
    return istft(X * H[..., :, None], nfft)


def apply_filter(x: torch.Tensor, H: torch.Tensor, nfft: int) -> torch.Tensor:
    """STFT-domain filtering: stft -> xH -> istft -> crop."""
    return apply_filter_istft(apply_stft(x, nfft), H, nfft)[..., :x.shape[-1]]


@functools.lru_cache(maxsize=16)
def rfftfreq(nfft: int, fs: float) -> np.ndarray:
    return np.fft.rfftfreq(nfft, d=1.0 / fs).astype(np.float32)
