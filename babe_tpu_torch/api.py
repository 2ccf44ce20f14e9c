"""Library API: load a checkpoint, restore audio, generate — in PyTorch.

Counterpart of ``babe_tpu/api.py``:

    from babe_tpu_torch.api import BABE

    model = BABE.load("exp/22k_8s-850000.ckpt")         # on "cuda"
    audio, info = model.enhance(x, 22050)               # zero-shot blind BWE
    audio, info = model.enhance(x, 22050, filter=(1000.0, -40.0))  # informed
    fc, A = model.estimate_filter(x, 22050)
    clips = model.generate(n=1, seed=0)

The model runs on the card unless ``device="cpu"`` is asked for.  This
slice serves inputs of at most one model segment at the model's sample
rate; longer inputs, other sample rates, the denoiser and int8 precision
raise ``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from babe_tpu_torch.config import default_config, make_config
from babe_tpu_torch.testers.tester import Tester, read_checkpoint


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 2:
        return audio.mean(axis=-1)
    return audio


def _flatten_overrides(d: dict, prefix: str) -> list[str]:
    out = []
    for k, v in (d or {}).items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_flatten_overrides(v, key))
        else:
            if isinstance(v, (list, tuple)):
                v = "[" + ",".join(str(x) for x in v) + "]"
            out.append(f"{key}={v}")
    return out


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "BABE: CUDA is not available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


class BABE:
    """A loaded CQTDiff+ restoration model with the BABE samplers."""

    def __init__(self, args, checkpoint: str, device="cuda"):
        from babe_tpu_torch.setup import setup_diff_parameters, setup_network

        self.device = _check_device(device)
        self.args = args
        self.fs = int(args.exp.sample_rate)
        self._ckpt = checkpoint
        model = setup_network(args)
        diff = setup_diff_parameters(args, cqt_hpf=model.apply_hpf_DC)
        self._tester = Tester(args, model, diff, device=self.device)
        self._tester.load_checkpoint(checkpoint)
        self._testers = {int(args.exp.audio_len): self._tester}

    def _tester_at(self, audio_len: int) -> Tester:
        """A tester whose CQT frame is built for ``audio_len`` samples and
        whose network is this model's (the weights are length-agnostic)."""
        if audio_len not in self._testers:
            from babe_tpu_torch.setup import setup_diff_parameters

            base = self._tester
            args = make_config(self.args.to_dict())
            args.exp["audio_len"] = audio_len
            model = base.model.with_audio_len(audio_len)
            diff = setup_diff_parameters(args, cqt_hpf=model.apply_hpf_DC)
            t = Tester(args, model, diff, device=self.device)
            t.loaded, t.it = True, base.it
            self._testers[audio_len] = t
        return self._testers[audio_len]

    @classmethod
    def load(cls, checkpoint: str, overrides: Sequence[str] = (),
             denoiser_checkpoint=None, precision: str | None = None,
             device="cuda") -> "BABE":
        """Build the model from a ``.ckpt`` pickle (its saved network, exp
        and diffusion config are adopted) and load the weights.
        ``overrides`` are dotted config assignments applied on top, e.g.
        ``"tester.T=20"``.  ``device`` defaults to the card."""
        if precision not in (None, "bf16"):
            raise NotImplementedError(
                f"precision={precision!r} is not ported yet (int8 with the "
                "fused int8 stage kernel comes in a later slice)")
        if denoiser_checkpoint is not None:
            raise NotImplementedError(
                "the STFT denoiser is not ported yet (a later slice)")
        _check_device(device)
        base: list[str] = []
        saved = read_checkpoint(checkpoint).get("args")
        if saved:
            net = dict(saved.get("network") or {})
            net.pop("callable", None)
            base += _flatten_overrides(net, "network")
            exp = saved.get("exp") or {}
            for k in ("audio_len", "sample_rate", "resample_factor"):
                if k in exp:
                    base.append(f"exp.{k}={exp[k]}")
            dp = dict(saved.get("diff_params") or {})
            dp.pop("callable", None)
            base += _flatten_overrides(dp, "diff_params")
            if "sigma_data" in dp and not isinstance(dp["sigma_data"], dict):
                base.append(f"tester.diff_params.sigma_data={dp['sigma_data']}")
        base.append("tester=blind_bwe")
        args = default_config(base + list(overrides))
        args.exp["remat"] = False
        return cls(args, checkpoint, device=device)

    # ------------------------------------------------------------- actions

    def generate(self, seconds: float | None = None, n: int = 1,
                 seed: int | None = None) -> np.ndarray:
        """Unconditional sampling: ``n`` clips of ``seconds`` (default: the
        model's segment length).  Returns [n, T] float32."""
        audio_len = (int(self.args.exp.audio_len) if seconds is None
                     else int(round(seconds * self.fs)))
        t = self._tester_at(audio_len)
        if seed is not None:
            t.seed(seed)
        out = t.sampler().predict_unconditional(t.next_key(), (n, audio_len))
        return out.float().cpu().numpy()

    def _prep(self, audio, fs) -> np.ndarray:
        x = np.atleast_2d(np.asarray(to_mono(np.asarray(audio)),
                                     dtype=np.float32))
        if int(fs or self.fs) != self.fs:
            raise NotImplementedError(
                f"input at {fs} Hz: resampling to the model's {self.fs} Hz "
                "is not ported yet (the DSP slice)")
        return x

    def estimate_filter(self, audio, fs: int | None = None,
                        seed: int | None = None):
        """Blind estimate of the lowpass degradation of ``audio``: (fc, A)
        breakpoint arrays (Hz, dB/octave)."""
        _, info = self.enhance(audio, fs, seed=seed, _estimate_only=True)
        return info["fc"], info["A"]

    def enhance(self, audio, fs: int | None = None, *, filter=None,
                denoise: bool = False, seed: int | None = None,
                _estimate_only: bool = False):
        """Restore ``audio`` (1-D or [1, T], at most one model segment).

        filter: None for zero-shot blind BWE (the filter is estimated), or
            ``(fc, A)`` breakpoints for informed BWE.
        Returns ``(enhanced [1, T], info)`` with the filter breakpoints in
        ``info['fc']``/``info['A']`` and the sample rate in ``info['fs']``.
        """
        if denoise:
            raise NotImplementedError(
                "denoise=True: the STFT denoiser is not ported yet")
        t = self._tester
        if seed is not None:
            t.seed(seed)
        x = self._prep(audio, fs)
        sn = t.args.tester.blind_bwe.get("sigma_norm", "None")
        std = float(np.std(x))
        gain = (float(sn) / std) if sn not in (None, "None") and std > 0 else 1.0
        x = x * gain
        segL, L = t.audio_len, x.shape[-1]
        if L > segL:
            raise NotImplementedError(
                f"input of {L} samples is longer than one model segment "
                f"({segL}); the autoregressive long-input loop is not "
                "ported yet")
        seg = np.pad(x, ((0, 0), (0, segL - L))) if L < segL else x
        y = torch.as_tensor(seg, device=self.device)
        s = t.sampler()
        if filter is None:
            pred, est = s.predict_blind_bwe(t.next_key(), y)
            est = est.cpu().numpy()
            fc, A = est[0], est[1]
            if _estimate_only:
                return None, {"fc": fc, "A": A, "fs": self.fs}
        else:
            fc = np.atleast_1d(np.asarray(filter[0], np.float32))
            A = np.atleast_1d(np.asarray(filter[1], np.float32))
            pred = s.predict_bwe(t.next_key(), y, np.stack([fc, A]), "fc_A")
        out = pred.float().cpu().numpy()[..., :L] / gain
        return out, {"fc": fc, "A": A, "fs": self.fs}
