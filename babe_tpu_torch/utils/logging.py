"""Observability: a JSONL metrics stream, the testers' wav writer, the
reverse-process trajectories (``.npz``) and, when matplotlib is installed,
spectrogram, filter-response and loss-by-sigma plots and the trajectory's
spectrogram animation (a plot returns None without it).  Counterpart of
``babe_tpu/utils/logging.py``; its wandb mirror is not ported (a wandb run
would contact a server: see ROADMAP.md)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from babe_tpu_torch.data.wavio import write_wav


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def _np(v) -> np.ndarray:
    """A host numpy array of a tensor (any device, bf16 as fp32) or an
    array."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


def write_audio_file(x, fs: int, name: str, path: str) -> str:
    """``<path>/<name>.wav``; the items of a batch are concatenated."""
    os.makedirs(path, exist_ok=True)
    x = _np(x)
    if x.ndim == 2 and x.shape[0] > 1:
        x = x.reshape(-1)
    elif x.ndim == 2:
        x = x[0]
    if not name.endswith(".wav"):
        name = name + ".wav"
    return write_wav(os.path.join(path, name), x, fs)


def plot_loss_by_sigma(means, stds, bins, out_path: str) -> str | None:
    """Loss against noise level, with error bars; None without
    matplotlib."""
    plt = _mpl()
    if plt is None:
        return None
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.errorbar(np.asarray(bins, dtype=float), np.asarray(means, dtype=float),
                yerr=np.asarray(stds, dtype=float), marker="o")
    ax.set_xscale("log")
    ax.set_xlabel("sigma")
    ax.set_ylabel("loss")
    fig.savefig(out_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_spectrogram(x, stft_cfg, out_path: str) -> str | None:
    """A spectrogram PNG of ``x`` (its first item) with the window and hop
    of ``stft_cfg`` (``win_size``, ``hop_size``; 1024 and 256 by
    default)."""
    plt = _mpl()
    if plt is None:
        return None
    import scipy.signal as ss

    x = _np(x)
    if x.ndim == 2:
        x = x[0]
    get = getattr(stft_cfg, "get", None)
    win = int(get("win_size", 1024)) if get else 1024
    hop = int(get("hop_size", 256)) if get else 256
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    f, t, S = ss.stft(x, nperseg=win, noverlap=win - hop)
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(20 * np.log10(np.abs(S) + 1e-8), origin="lower", aspect="auto",
              extent=[t[0], t[-1], f[0], f[-1]], cmap="magma", vmin=-100,
              vmax=0)
    ax.set_xlabel("frame")
    ax.set_ylabel("freq bin")
    fig.savefig(out_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return out_path


def save_trajectory(path: str, name: str, **arrays) -> str:
    """``<path>/<name>.npz``: the reverse process's trajectories (denoised
    estimates, score, filters, t), compressed."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, name + ".npz")
    np.savez_compressed(out, **{k: _np(v) for k, v in arrays.items()})
    return out


def plot_filter_response(params_list, freqs, out_path: str,
                         labels=None) -> str | None:
    """The magnitude responses (dB) of parametric filters [2, K] over
    ``freqs``, on a log frequency axis."""
    plt = _mpl()
    if plt is None:
        return None
    from babe_tpu_torch.ops.filters import design_filter

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    f = torch.as_tensor(_np(freqs), dtype=torch.float32)
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, p in enumerate(params_list):
        p = torch.as_tensor(_np(p), dtype=torch.float32)
        H = design_filter(p[0], p[1], f).numpy()
        ax.plot(f.numpy()[1:], 20 * np.log10(H[1:] + 1e-8),
                label=labels[i] if labels else f"filter {i}")
    ax.set_xscale("log")
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("magnitude (dB)")
    ax.legend()
    fig.savefig(out_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return out_path


def diffusion_spec_animation(dens, t, out_path: str, fs: int = 22050,
                             win: int = 1024, hop: int = 256,
                             max_frames: int = 12) -> str | None:
    """An animated GIF of the spectrograms of the denoised estimates
    ``dens`` [steps, B, T] (their first item) at up to ``max_frames``
    steps of the schedule ``t``; None without matplotlib or imageio."""
    plt = _mpl()
    if plt is None:
        return None
    try:
        import imageio.v2 as imageio
    except ImportError:
        return None
    import scipy.signal as ss

    dens, t = _np(dens), _np(t)
    steps = dens.shape[0]
    idx = np.linspace(0, steps - 1, min(steps, max_frames)).astype(int)
    frames = []
    for i in idx:
        _, _, S = ss.stft(dens[i, 0], fs=fs, nperseg=win, noverlap=win - hop)
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.imshow(20 * np.log10(np.abs(S) + 1e-8), origin="lower",
                  aspect="auto", cmap="magma", vmin=-100, vmax=0)
        ax.set_title(f"step {i}  sigma={float(t[i]):.4f}")
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3])
        plt.close(fig)
    imageio.mimsave(out_path, frames, duration=0.4)
    return out_path


class MetricsLogger:
    """``<path>/metrics.jsonl``, one record appended per ``log`` call."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = os.path.join(path, "metrics.jsonl")

    def log(self, data: dict, step: int | None = None):
        rec = dict(data)
        rec["_ts"] = time.time()
        if step is not None:
            rec["_step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
