"""Library API: load a checkpoint, restore audio, generate — in PyTorch.

Counterpart of ``babe_tpu/api.py``:

    from babe_tpu_torch.api import BABE

    model = BABE.load("exp/22k_8s-850000.ckpt")         # on "cuda"
    audio, info = model.enhance(x, fs)                  # zero-shot blind BWE
    audio, info = model.enhance(x, fs, filter=(1000.0, -40.0))  # informed
    fc, A = model.estimate_filter(x, fs)
    clips = model.generate(n=1, seed=0)
    model = BABE.load("MAESTRO_22k_8s-850000.pt")        # reference torch ckpt
    model8 = BABE.load("exp/22k_8s-850000.ckpt", precision="int8")
    model = BABE.load(ckpt, denoiser_checkpoint="denoiser.ckpt")
    audio, info = model.enhance(x, fs, denoise=True)    # STFT denoiser first

The model runs on the card unless ``device="cpu"`` is asked for.  With
``precision="int8"`` the network reads the JAX package's int8 knobs from
the environment (``BABE_INT8_SCALE``, ``BABE_INT8_MINC``,
``BABE_INT8_OPS``, ``BABE_INT8_FUSED``, ``BABE_INT8_BWD``; see
``models/cqtdiff.py``): by default its dilation stacks of at least 96
channels run the fused int8 stage (kernel K3,
``csrc/fused_stage_int8.cu``) and the rest stays in the model's compute
dtype (kernels K1 and K2).  The JAX API's own ``precision="int8"`` (the
unfused int8 convs, C8, and the guidance gradient's input cotangent in
int8) is ``BABE_INT8_FUSED=0 BABE_INT8_BWD=1``.  The precision and its
knobs belong to the loaded model, read once at load, so two models of
different precision live side by side in one process; ``precision=
"bf16"`` (or None) ignores the knobs.

``enhance`` takes a recording of any length at any sample rate: it is
resampled to the model's rate, optionally run through the STFT denoiser
(``denoise=True``, with ``denoiser_checkpoint=`` given at load), and
restored in one segment when it fits one, else by the autoregressive chunk
loop (``Tester._ar_loop``); a blind request estimates the filter on the
first segment.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from babe_tpu_torch.config import default_config, make_config
from babe_tpu_torch.models.cqtdiff import PRECISIONS
from babe_tpu_torch.ops.resample import resample
from babe_tpu_torch.testers.tester import Tester, checkpoint_args
from babe_tpu_torch.utils.device import check_device


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


class BABE:
    """A loaded CQTDiff+ restoration model with the BABE samplers."""

    def __init__(self, args, checkpoint: str, device="cuda",
                 precision: str | None = None, denoiser_checkpoint=None):
        from babe_tpu_torch.setup import setup_diff_parameters, setup_network

        self.device = check_device(device)
        self.args = args
        self.fs = int(args.exp.sample_rate)
        self._ckpt = checkpoint
        model = setup_network(args, precision=precision)
        diff = setup_diff_parameters(args, cqt_hpf=model.apply_hpf_DC)
        denoiser = None
        if denoiser_checkpoint is not None:
            from babe_tpu_torch.models.denoiser import setup_denoiser

            args.tester.denoiser["checkpoint_path"] = str(denoiser_checkpoint)
            denoiser = setup_denoiser(args, device=self.device)
        self._denoiser = denoiser
        # an LRU cache of testers by audio_len (each holds a CQT frame);
        # the native-length tester is pinned
        self._testers: OrderedDict[int, Tester] = OrderedDict()
        self._testers_maxsize = 4
        self._tester = Tester(args, model, diff, device=self.device,
                              denoiser=denoiser)
        self._tester.load_checkpoint(checkpoint)
        self._testers[int(args.exp.audio_len)] = self._tester

    def _tester_at(self, audio_len: int) -> Tester:
        """A tester whose CQT frame is built for ``audio_len`` samples and
        whose network is this model's (the weights are length-agnostic)."""
        native_len = int(self.args.exp.audio_len)
        if audio_len not in self._testers:
            from babe_tpu_torch.setup import setup_diff_parameters

            base = self._tester
            args = make_config(self.args.to_dict())
            args.exp["audio_len"] = audio_len
            model = base.model.with_audio_len(audio_len)
            diff = setup_diff_parameters(args, cqt_hpf=model.apply_hpf_DC)
            t = Tester(args, model, diff, device=self.device,
                       denoiser=self._denoiser)
            t.loaded, t.it = True, base.it
            self._testers[audio_len] = t
            while len(self._testers) > self._testers_maxsize:
                # evict the least recently used, never the native length
                old = next((k for k in self._testers if k != native_len),
                           None)
                if old is None:
                    break
                del self._testers[old]
        self._testers.move_to_end(audio_len)
        return self._testers[audio_len]

    @classmethod
    def load(cls, checkpoint: str, overrides: Sequence[str] = (),
             denoiser_checkpoint=None, precision: str | None = None,
             device="cuda") -> "BABE":
        """Build the model from a ``.ckpt`` pickle or an orbax checkpoint
        directory (its saved network, exp and diffusion config are adopted:
        a directory's from its ``train_args.json``, none without one), or
        from a reference ``.pt``
        torch checkpoint (built at the published flagship config with the
        checkpoint-compatible CQT frame, ``network=cqtdiff+_ckpt``), and
        load the weights.  ``overrides`` are dotted config assignments
        applied on top, e.g. ``"tester.T=20"``.  ``device`` defaults to the
        card.

        ``precision``: None or "bf16" serve in the model's compute dtype
        (bf16 at the flagship config, ``exp.use_bf16``); "int8" runs the
        convs the int8 knobs of the environment select (module doc) in
        int8, with per-output-channel weight scales quantized once per
        loaded set of weights: by default every dilation stack of at least
        96 channels through the fused int8 stage with analytic-bound
        activation scales, its guidance gradient straight-through (the
        exact stage's).  Another value raises ``ValueError``.

        ``denoiser_checkpoint``: a ``.ckpt`` pickle of the STFT denoiser
        (``{"params": tree}``, the JAX package's layout) or a reference
        ``.pt``, built at ``tester.denoiser``'s config on ``device``;
        ``enhance(..., denoise=True)`` needs it.  A path that does not
        exist warns and keeps a seeded init, as the JAX package does."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be 'bf16', 'int8' or None, "
                             f"got {precision!r}")
        check_device(device)
        base: list[str] = []
        saved = checkpoint_args(checkpoint)
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
        elif checkpoint.endswith(".pt"):
            base.append("network=cqtdiff+_ckpt")
        base.append("tester=blind_bwe")
        args = default_config(base + list(overrides))
        args.exp["remat"] = False
        return cls(args, checkpoint, device=device, precision=precision,
                   denoiser_checkpoint=denoiser_checkpoint)

    @property
    def precision(self) -> str | None:
        """The loaded network's precision (None, "bf16" or "int8")."""
        return self._tester.model.net.precision

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
        # over several processes whose count divides n, each samples its
        # rows and every process returns the batch
        out = t.unconditional(t.next_key(), (n, audio_len))
        return out.float().cpu().numpy()

    def _prep(self, audio, fs) -> np.ndarray:
        """Mono float32 [1, T] at the model's sample rate."""
        x = np.atleast_2d(np.asarray(to_mono(np.asarray(audio)),
                                     dtype=np.float32))
        in_fs = int(fs or self.fs)
        if in_fs != self.fs:
            x = resample(torch.as_tensor(x, device=self.device), in_fs,
                         self.fs).cpu().numpy()
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
        """Restore ``audio`` (1-D or [1, T], any length, any sample rate).

        filter: None for zero-shot blind BWE (the filter is estimated on
            the first segment), or ``(fc, A)`` breakpoints for informed BWE.
        denoise: run the STFT denoiser first (needs
            ``denoiser_checkpoint=`` at load).
        Returns ``(enhanced [1, T] at the model's sample rate, info)`` with
        the filter breakpoints in ``info['fc']``/``info['A']`` and the model's
        sample rate in ``info['fs']``.
        """
        t = self._tester
        if seed is not None:
            t.seed(seed)
        x = self._prep(audio, fs)
        if denoise:
            if self._denoiser is None:
                raise ValueError(
                    "denoise=True needs denoiser_checkpoint= at load()")
            x = t.apply_denoiser(torch.as_tensor(x, device=self.device))
            x = x.cpu().numpy()
        # normalise like the blind tester (sigma_norm), undone at the end
        sn = t.args.tester.blind_bwe.get("sigma_norm", "None")
        std = float(np.std(x))
        gain = (float(sn) / std) if sn not in (None, "None") and std > 0 else 1.0
        x = x * gain
        segL, L = t.audio_len, x.shape[-1]
        if filter is not None:
            fc = np.atleast_1d(np.asarray(filter[0], np.float32))
            A = np.atleast_1d(np.asarray(filter[1], np.float32))
        else:
            seg = x[..., :segL]
            if seg.shape[-1] < segL:
                seg = np.pad(seg, ((0, 0), (0, segL - seg.shape[-1])))
            pred, est = t.sampler().predict_blind_bwe(
                t.next_key(), torch.as_tensor(seg, device=self.device))
            fc, A = est.cpu().numpy()
            if _estimate_only:
                return None, {"fc": fc, "A": A, "fs": self.fs}
            if L <= segL:
                out = pred.float().cpu().numpy()[..., :L] / gain
                return out, {"fc": fc, "A": A, "fs": self.fs}
        est = np.stack([fc, A])
        if L <= segL:
            seg = np.pad(x, ((0, 0), (0, segL - L))) if L < segL else x
            out = t.sampler().predict_bwe(
                t.next_key(), torch.as_tensor(seg, device=self.device), est,
                "fc_A").float().cpu().numpy()[..., :L]
        else:
            out = t._ar_loop(x, est, "fc_A")[..., :L]
        return out / gain, {"fc": fc, "A": A, "fs": self.fs}
