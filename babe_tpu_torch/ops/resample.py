"""Polyphase windowed-sinc resampling as a strided convolution.

Counterpart of ``babe_tpu/ops/resample.py``: the same kernel, built on the
host in float64 as torchaudio's ``sinc_interp_hann`` method builds it
(lowpass_filter_width 6, cutoff 0.99 * min(orig, new) / 2, one filter phase
per output polyphase branch), applied as one strided 1-D convolution
(``torch.nn.functional.conv1d``, as the JAX package leaves it to XLA; TF32
off, so fp32 stays fp32 on the card).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _resample_kernel(orig_freq: int, new_freq: int,
                     lowpass_filter_width: int = 6,
                     rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """(kernel [new_freq, width'], width) for gcd-reduced rates."""
    assert orig_freq > 0 and new_freq > 0
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq,
                    dtype=np.float64)[None, :] / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq
         + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t_pi = t * np.pi
    kernel = np.where(t_pi == 0, 1.0,
                      np.sin(t_pi) / np.where(t_pi == 0, 1.0, t_pi))
    kernel = kernel * window * (base_freq / orig_freq)
    return kernel.astype(np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample along the last axis; output length ceil(T * new / orig)."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    if orig == new:
        return x
    kernel, width = _resample_kernel(orig, new)
    shape = x.shape
    T = shape[-1]
    target_len = int(math.ceil(new * T / orig))
    xr = x.reshape(-1, 1, T).float()
    xp = torch.nn.functional.pad(xr, (width, width + orig))
    k = torch.as_tensor(kernel, device=x.device)[:, None, :]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = torch.nn.functional.conv1d(xp, k, stride=orig)  # [B, new, L]
    y = y.transpose(1, 2).reshape(xr.shape[0], -1)[:, :target_len]
    return y.reshape(*shape[:-1], target_len)


def resample_batch(audio: torch.Tensor, fs, fs_target: int,
                   length_target: int) -> torch.Tensor:
    """Resample each item of ``audio`` [B, T] from its own rate ``fs[i]``
    (host numbers) to ``fs_target``, then crop or zero-pad it to
    ``length_target``."""
    fs = np.asarray(fs).reshape(-1)
    out = []
    for i in range(audio.shape[0]):
        a = audio[i:i + 1]
        f = int(fs[i])
        if f != fs_target:
            if f == 44100 and fs_target == 22050:
                a = resample(a, 2, 1)
            elif f == 48000 and fs_target == 22050:
                a = resample(a, 320, 147)
            else:
                a = resample(a, f, fs_target)
        if a.shape[-1] < length_target:
            a = torch.nn.functional.pad(a, (0, length_target - a.shape[-1]))
        out.append(a[..., :length_target])
    return torch.cat(out, dim=0)
