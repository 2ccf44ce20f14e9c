"""The tester core the library API runs on, in PyTorch.

Counterpart of the parts of ``babe_tpu/testers/tester.py`` that
``api.BABE`` uses: construction (tester-side EDM, sampler and blind
configs), noise streams, checkpoint loading with a shape check against the
built model, the sampler factory, the STFT denoiser chain, the
autoregressive long-input loop (``_ar_loop``) and the whole-recording mode
that composes them (``test_real_blind_bwe_complete``).  The other
experiment modes (inpainting, formal tests, MUSHRA, ...) belong to later
slices of the port.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from babe_tpu_torch.data.wavio import read_wav, to_mono
from babe_tpu_torch.diffusion.edm import EDM, EDMParams
from babe_tpu_torch.ops.resample import resample
from babe_tpu_torch.sampling.blind import BlindConfig, BlindSampler
from babe_tpu_torch.sampling.heun import SamplerConfig
from babe_tpu_torch.utils.logging import MetricsLogger, write_audio_file
from babe_tpu_torch.utils.weights import _flatten, load_flax, to_flax

# samples dropped from the end of every autoregressive chunk's prediction
AR_DISCARD_END = 200

ORBAX_EXT = ".orbax"


class _Record(tuple):
    """Stand-in for a class a checkpoint pickle names outside numpy and the
    standard library: optax's state classes, which are named tuples
    (``ScaleByAdamState(count, mu, nu)``, ``ScaleByScheduleState(count)``,
    ``EmptyState()``).  It keeps their fields in order, so the trainer
    resumes Adam's state from a JAX checkpoint without importing optax."""

    qualname = "?"

    def __new__(cls, *fields, **kwargs):
        return super().__new__(cls, fields)

    def __setstate__(self, state):
        pass

    def __repr__(self):
        return f"{self.qualname}{tuple.__repr__(self)}"


class _WeightsUnpickler(pickle.Unpickler):
    _ALLOWED = ("numpy", "builtins", "collections", "copyreg", "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] in self._ALLOWED:
            return super().find_class(module, name)
        return type(name, (_Record,), {"qualname": f"{module}.{name}"})


def read_checkpoint(path: str) -> dict:
    """The payload dict of a ``.ckpt`` pickle written by either package."""
    if path.endswith(".pt"):
        raise NotImplementedError(
            "loading reference .pt torch checkpoints is not ported yet")
    if path.rstrip("/").endswith(ORBAX_EXT) or os.path.isdir(path):
        raise NotImplementedError(
            "loading orbax checkpoint directories is not ported yet")
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path!r}")
    with open(path, "rb") as f:
        try:
            payload = _WeightsUnpickler(f).load()
        except Exception as e:
            raise ValueError(
                f"checkpoint {path!r} is not a readable .ckpt pickle "
                f"({type(e).__name__}: {e})") from e
    if not isinstance(payload, dict):
        raise ValueError(f"checkpoint {path!r} does not hold a state dict "
                         f"(got {type(payload).__name__})")
    return payload


class Tester:
    def __init__(self, args, model, diff_params: EDM, device="cuda",
                 denoiser=None):
        self.args = args
        self.model = model
        self.denoiser = denoiser  # models.denoiser.MultiStageDenoiser
        self.device = torch.device(device)
        self.it = 0
        self.gen = torch.Generator().manual_seed(
            int(args.exp.get("seed", 42)) + 1)
        tcfg = args.tester
        if bool(tcfg.diff_params.get("same_as_training", True)):
            self.edm = diff_params
        else:
            self.edm = EDM(EDMParams.from_config(tcfg.diff_params))
        self.loaded = False
        self.scfg = SamplerConfig.from_args(args)
        self.blind_cfg = BlindConfig.from_args(args)
        self.fs = int(args.exp.sample_rate)
        self.audio_len = int(args.exp.audio_len)
        self._outputs = os.path.join(str(args.model_dir), "outputs")
        # the output folder of each mode this slice ports
        self.paths = {"complete": os.path.join(self._outputs, "complete")}
        self._metrics = None

    @property
    def metrics(self) -> MetricsLogger:
        """``<model_dir>/outputs/metrics.jsonl``, made at its first use."""
        if self._metrics is None:
            self._metrics = MetricsLogger(self._outputs)
        return self._metrics

    # ------------------------------------------------------------- plumbing

    def seed(self, seed: int) -> None:
        self.gen = torch.Generator().manual_seed(int(seed))

    def next_key(self) -> torch.Generator:
        """A fresh device generator, seeded from the tester's stream."""
        s = int(torch.randint(0, 2**62, (1,), generator=self.gen))
        return torch.Generator(device=self.device).manual_seed(s)

    def load_checkpoint(self, path: str):
        """Load a ``.ckpt`` pickle (the EMA weights when present)."""
        payload = read_checkpoint(path)
        src = payload.get("ema", payload.get("params"))
        if src is None:
            raise ValueError(f"checkpoint {path!r} holds no 'ema' or "
                             f"'params' entry")
        template = to_flax(self.model.net)[0]
        self._check_ckpt_compat(template, src, payload, path)
        self.set_variables(src, payload.get("buffers", {}),
                           it=int(payload.get("it", 0)))

    def _check_ckpt_compat(self, template, src, payload, path):
        """Fail at load time, naming the mismatched parameters and the
        config keys the checkpoint was trained with that differ."""
        t_leaves = {k: tuple(v.shape) for k, v in _flatten(template).items()}
        s_leaves = {k: tuple(np.shape(v)) for k, v in _flatten(src).items()}
        bad = [f"  {k}: checkpoint {s_leaves.get(k)} vs model "
               f"{t_leaves.get(k)}"
               for k in sorted(set(t_leaves) | set(s_leaves))
               if t_leaves.get(k) != s_leaves.get(k)]
        hints = []
        saved_args = payload.get("args") or {}
        saved_net = saved_args.get("network", {})
        cur_net = self.args.network.to_dict()
        for key in sorted(set(saved_net) | set(cur_net)):
            if key in ("layout_pin",):
                continue
            if key in saved_net and saved_net.get(key) != cur_net.get(key):
                hints.append(f"  network.{key}: trained with "
                             f"{saved_net.get(key)!r}, building with "
                             f"{cur_net.get(key)!r}")
        saved_len = (saved_args.get("exp") or {}).get("audio_len")
        if saved_len is not None and int(saved_len) != self.audio_len:
            hints.append(f"  exp.audio_len: trained with {saved_len}, "
                         f"building with {self.audio_len}")
        if bad:
            raise ValueError(
                f"checkpoint {path} does not fit the built model — "
                f"{len(bad)} parameter shape mismatch(es):\n"
                + "\n".join(bad[:8]) + ("\n  ..." if len(bad) > 8 else "")
                + ("\nconfig differences vs the checkpoint's training "
                   "args:\n" + "\n".join(hints) if hints else ""))
        if hints:
            print("NOTE: checkpoint fits, but its recorded training config "
                  "differs from the current one:\n" + "\n".join(hints))

    def set_variables(self, params, buffers, it: int = 0):
        """Install JAX-format weights; the network is frozen (inference
        takes gradients with respect to the input only)."""
        load_flax(self.model.net, params, buffers)
        self.model.to(self.device)
        self.model.net.requires_grad_(False)
        self.it = it
        self.loaded = True

    def _denoiser_fn(self):
        assert self.loaded, "load a checkpoint first"
        if self.scfg.filter_out_cqt_DC_Nyq:
            # hpf folded into the denoiser's spectrum pass
            return self.model.fused_denoiser(self.edm), None
        den = lambda x, sigma: self.edm.denoiser(  # noqa: E731
            x, self.model.apply, sigma)
        return den, self.model.apply_hpf_DC

    def sampler(self) -> BlindSampler:
        den, hpf = self._denoiser_fn()
        return BlindSampler(den, self.edm, self.scfg, self.blind_cfg,
                            hpf=hpf, device=self.device)

    # ------------------------------------------------------------- helpers

    def _host(self, t: torch.Tensor) -> np.ndarray:
        return t.float().cpu().numpy()

    def apply_denoiser(self, x: torch.Tensor) -> torch.Tensor:
        """Chunked overlap-add denoising with a hamming cross-fade."""
        assert self.denoiser is not None
        return self.denoiser.apply_chunked_ola(x)

    # ------------------------------------------- long-form (AR) restoration

    def _ar_loop(self, degraded: np.ndarray, est_filter, ftype: str):
        """Informed BWE of a whole recording [1, L] in chunks of one
        segment: each chunk after the first continues the previous
        prediction over ``complete_recording.overlap`` seconds (an
        inpainting observation, feathered over 50 samples when
        ``inpaint_DC`` is on), and every chunk's last 200 predicted samples
        are discarded.  The last chunk is zero-padded to a segment."""
        cr = self.args.tester.complete_recording
        segL = self.audio_len
        overlap = int(float(cr.overlap) * self.fs)
        discard_end = AR_DISCARD_END
        s = self.sampler()
        dev = self.device
        smooth = 50 if bool(cr.get("inpaint_DC", False)) else 0
        mask = np.ones((1, segL), np.float32)
        mask[:, overlap:] = 0

        def run_ar(seg, y_masked, m):
            return self._host(s.predict_bwe_AR(
                self.next_key(), torch.as_tensor(seg, device=dev), y_masked,
                est_filter, ftype, m, smooth_mask_size=smooth))

        L = degraded.shape[-1]
        final = np.zeros_like(degraded)
        ix = 0
        seg = torch.as_tensor(degraded[..., :segL], device=dev)
        pred = self._host(s.predict_bwe(self.next_key(), seg, est_filter,
                                        ftype))
        prev = pred[..., : segL - discard_end]
        final[..., : segL - discard_end] = prev
        ix += segL - overlap - discard_end
        while ix < L - segL - discard_end:
            y_masked = np.zeros((1, segL), np.float32)
            y_masked[..., :overlap] = prev[..., segL - overlap - discard_end:]
            pred = run_ar(degraded[..., ix : ix + segL], y_masked, mask)
            prev = pred[..., : segL - discard_end]
            final[..., ix : ix + segL - discard_end] = prev
            ix += segL - overlap - discard_end
        # the last (possibly short) chunk: its overlap comes from the whole
        # previous prediction's tail, and past the data it is zero-padded
        seg = degraded[..., ix:]
        y_masked = np.zeros((1, segL), np.float32)
        y_masked[..., :overlap] = pred[..., -overlap:]
        last_mask = mask.copy()
        if seg.shape[-1] < segL:
            seg_zp = np.pad(seg, ((0, 0), (0, segL - seg.shape[-1])))
            y_masked[..., seg.shape[-1]:] = seg_zp[..., seg.shape[-1]:]
            last_mask[..., seg.shape[-1]:] = 0
        else:
            seg_zp = seg[..., :segL]
        pred = run_ar(seg_zp, y_masked, last_mask)
        final[..., ix:] = pred[..., : seg.shape[-1]]
        return final

    def test_real_blind_bwe_complete(self, typefilter="fc_A",
                                     use_denoiser=None):
        """Whole-recording restoration of ``complete_recording.path``:
        resample -> optional denoise -> normalise to
        ``complete_recording.std`` -> optional extra noise at
        ``SNR_extra_noise`` dB -> blind filter estimate on
        ``n_segments_blindstep`` segments as one batch -> ``_ar_loop`` ->
        undo the gain -> write the wav under ``paths['complete']``.
        Returns (restored [1, L], estimated filter [2, K])."""
        cr = self.args.tester.complete_recording
        filename = str(cr.path)
        d, fs = read_wav(filename)
        degraded = np.atleast_2d(to_mono(d)).astype(np.float32)
        if fs != self.fs:
            degraded = self._host(resample(
                torch.as_tensor(degraded, device=self.device), fs, self.fs))

        if use_denoiser is None:
            use_denoiser = bool(cr.get("use_denoiser", False))
        if use_denoiser and self.denoiser is not None:
            degraded = self._host(self.apply_denoiser(
                torch.as_tensor(degraded, device=self.device)))

        std = degraded.std(-1, keepdims=True)
        target_std = float(cr.get("std", 0.1))
        degraded = target_std * degraded / std

        snr_extra = cr.get("SNR_extra_noise", "None")
        if snr_extra not in (None, "None"):
            snr = 10 ** (float(snr_extra) / 10)
            sigma = np.sqrt(target_std**2 / snr)
            degraded = degraded + sigma * np.random.default_rng(
                0).standard_normal(degraded.shape).astype(np.float32)

        segL = self.audio_len
        ix_first = int(self.fs * float(cr.get("ix_start", 0)))
        nseg = int(cr.get("n_segments_blindstep", 1))
        rng = np.random.default_rng(0)
        ys = [degraded[..., ix_first : ix_first + segL]]
        for _ in range(nseg - 1):
            ix = int(rng.integers(0, degraded.shape[-1] - segL))
            ys.append(degraded[..., ix : ix + segL])
        y = torch.as_tensor(np.concatenate(ys, axis=0), device=self.device)

        _, est_filter = self.sampler().predict_blind_bwe(self.next_key(), y)
        est_filter = self._host(est_filter)
        self.metrics.log({"mode": "complete",
                          "fc_est": est_filter[0].tolist(),
                          "A_est": est_filter[1].tolist()})

        final = self._ar_loop(degraded, est_filter, "fc_A")
        final = final * std / target_std
        n = os.path.splitext(os.path.basename(filename))[0] + typefilter
        write_audio_file(final, self.fs, n + ".reconstructed",
                         self.paths["complete"])
        return final, est_filter
