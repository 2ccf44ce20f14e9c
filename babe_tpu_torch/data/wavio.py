"""WAV read/write through scipy (PCM16/24/32 and float32 WAVs), float32
audio in [-1, 1] at the boundary: the port's copy of the JAX package's
``data/wavio.py``."""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile as _wav


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """(audio float32 [T] or [T, C], sample_rate)."""
    fs, data = _wav.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    return audio, int(fs)


def write_wav(path: str, audio: np.ndarray, fs: int,
              subtype: str = "PCM_16") -> str:
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2 and audio.shape[0] < audio.shape[1]:
        audio = audio.T  # (C, T) -> (T, C)
    if subtype == "PCM_16":
        data = np.clip(audio, -1.0, 1.0)
        _wav.write(path, fs, (data * 32767.0).astype(np.int16))
    else:
        _wav.write(path, fs, audio)
    return path


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 2:
        return audio.mean(axis=-1)
    return audio
