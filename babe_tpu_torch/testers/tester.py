"""The experiment runner ("tester"), in PyTorch.

Counterpart of ``babe_tpu/testers/tester.py``: one runner for every
experiment mode of the reference's tester classes, dispatched by
``dodajob`` over ``tester.modes``:

  unconditional            ``sample_unconditional``
  inpainting               ``test_inpainting`` (a gap in each test item)
  bwe                      ``test_bwe`` (informed: firwin, cheby1, biquad,
                           resample, decimate or the parametric fc_A)
  blind_bwe                ``test_blind_bwe`` (synthetic fc_A degradation,
                           LSD and filter dB-MSE records)
  real_blind_bwe           ``test_real_blind_bwe`` (a recordings folder)
  real_blind_bwe_complete  ``test_real_blind_bwe_complete`` (the chunk loop)
  formal_test_bwe          ``formal_test_bwe`` (a folder, overlap-add or
                           autoregressive, resumable)
  formal_test_bwe_small    ``formal_test_bwe_small`` (filter dB-MSE)
  mushra                   ``test_mushra`` (listening-test stimuli)
  declipping, phase_retrieval, comp_sens

Each mode writes the JAX mode's files (wavs, ``.npz`` trajectories,
``.npy`` sweeps, plots when matplotlib is installed) and
``<model_dir>/outputs/metrics.jsonl`` records with its keys.  The samplers
run eagerly on the tester's device; noise comes from one seeded
``torch.Generator`` stream (``next_key``).  The tester also carries what
``api.BABE`` runs on: checkpoint loading with a shape check against the
built model (``.ckpt`` pickles of either package, and the reference's
``.pt`` torch checkpoints through ``utils/torch_ckpt.py``, with the frame
self-check), the sampler factory, the STFT denoiser chain and the
autoregressive long-input loop (``_ar_loop``).

Over a mesh of several processes (``parallel/mesh.py``; the JAX tester's
evaluation mesh) ``unconditional`` spreads its clips where their count
divides the ranks, ``bwe`` and ``blind_bwe`` spread their test items, and
``formal_test_bwe`` its OLA chunk batches (informed) or chunks (blind),
over the ranks, each rank drawing every unit's keys so that the key stream
is the one-process run's; a count that does not divide the ranks runs
unsharded on every rank, with a note.  The results are gathered to rank
0, which alone writes files.  The other modes run on rank 0 alone (the
generator's state is handed from rank 0 to the others before each
sharded mode).
"""

from __future__ import annotations

import glob as _glob
import os
import pickle

import numpy as np
import torch

from babe_tpu_torch.data.wavio import read_wav, to_mono
from babe_tpu_torch.diffusion.edm import EDM, EDMParams
from babe_tpu_torch.ops.filters import design_filter, filter_db_mse
from babe_tpu_torch.ops.fir import get_FIR_lowpass
from babe_tpu_torch.ops.resample import resample
from babe_tpu_torch.ops.stft import apply_filter, rfftfreq
from babe_tpu_torch.parallel.mesh import (broadcast_object, gather_batch,
                                          gather_objects, make_mesh)
from babe_tpu_torch.sampling import degradations as D
from babe_tpu_torch.sampling.blind import BlindConfig, BlindSampler
from babe_tpu_torch.sampling.heun import SamplerConfig
from babe_tpu_torch.utils import logging as ulog
from babe_tpu_torch.utils.logging import MetricsLogger, write_audio_file
from babe_tpu_torch.utils.metrics import lsd, lsd_high_band
from babe_tpu_torch.utils.orbax_dir import (is_orbax, orbax_top_keys,
                                            read_orbax, read_sidecar_args)
from babe_tpu_torch.utils.torch_ckpt import (convert_state_dict,
                                             extract_network_state,
                                             fill_variables,
                                             read_torch_checkpoint)
from babe_tpu_torch.utils.weights import _flatten, load_flax, to_flax

# samples dropped from the end of every autoregressive chunk's prediction
AR_DISCARD_END = 200


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


def read_checkpoint(path: str, top=None) -> dict:
    """The payload dict of a ``.ckpt`` pickle written by either package, of
    an orbax checkpoint directory (``utils/orbax_dir.py``: only the
    top-level entries ``top`` when given, and ``args`` from its sidecar
    when it has one), or the unpickled dict of a reference ``.pt`` torch
    checkpoint."""
    if path.endswith(".pt"):
        if not os.path.exists(path):
            raise FileNotFoundError(f"checkpoint not found: {path!r}")
        return read_torch_checkpoint(path)
    if is_orbax(path):
        payload = read_orbax(path, top=top)
        args = read_sidecar_args(path)
        if args is not None:
            payload["args"] = args
        return payload
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


def checkpoint_args(path: str):
    """The training args a checkpoint carries, or None: a ``.ckpt``'s
    ``args``, an orbax directory's sidecar (not its arrays), none for a
    ``.pt`` (the JAX package's ``api._peek_saved_args``)."""
    if is_orbax(path):
        return read_sidecar_args(path)
    if path.endswith(".pt"):
        return None
    return read_checkpoint(path).get("args")


# the modes that spread their items over the ranks of a mesh
SHARDED_MODES = ("unconditional", "bwe", "blind_bwe", "formal_test_bwe")


class Tester:
    def __init__(self, args, model, diff_params: EDM, device="cuda",
                 test_set=None, denoiser=None, mesh=None):
        """``mesh``: the processes the sharded modes spread over (every
        process of the group by default)."""
        self.args = args
        self.model = model
        self.test_set = test_set  # items (audio, fs, name)
        self.denoiser = denoiser  # models.denoiser.MultiStageDenoiser
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            device=self.device)
        self._queued: list[int] | None = None  # a unit's key seeds
        self._unsharded_warned: set[int] = set()
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
        self.paths = {mode: os.path.join(self._outputs, mode) for mode in (
            "unconditional", "bwe", "inpainting", "blind_bwe",
            "real_blind_bwe", "complete", "formal", "mushra")}
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

    def _next_seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self.gen))

    def next_key(self) -> torch.Generator:
        """A fresh device generator, seeded from the tester's stream (or,
        inside a sharded unit, from the seeds drawn for it)."""
        s = self._queued.pop(0) if self._queued else self._next_seed()
        return torch.Generator(device=self.device).manual_seed(s)

    def _share(self, n: int) -> range:
        """The units of ``n`` this rank runs: its contiguous share, or all
        of them where ``n`` does not divide the ranks (noted once per
        ``n``)."""
        m = self.mesh
        if m.size == 1:
            return range(n)
        if n % m.size:
            if n not in self._unsharded_warned:
                self._unsharded_warned.add(n)
                print(f"NOTE: {n} units do not divide {m.size} processes; "
                      f"every process runs them all, unsharded")
            return range(n)
        r = m.rows(n)
        return range(r.start, r.stop)

    def _sharded(self, n: int, keys_per_unit: int, run) -> list:
        """``run(k)`` for this rank's units k of ``n``, each drawing its
        ``keys_per_unit`` keys as a one-process run would (every rank
        draws every unit's seeds, in order); every unit's result, in
        order, on every rank."""
        seeds = [[self._next_seed() for _ in range(keys_per_unit)]
                 for _ in range(n)]
        mine = self._share(n)
        outs = []
        for k in mine:
            self._queued = list(seeds[k])
            try:
                outs.append(run(k))
            finally:
                self._queued = None
        if len(mine) == n:
            return outs
        return [o for part in gather_objects(self.mesh, outs) for o in part]

    def _item(self, i: int):
        """Test item ``i`` as (i, [1, audio_len] float32 on the device,
        name without extension)."""
        original, fs, name = self.test_set[i]
        return (i, self._dev(self.resample_audio(original, fs)),
                os.path.splitext(name)[0])

    def load_checkpoint(self, path: str):
        """Load a ``.ckpt`` pickle or an orbax checkpoint directory (the EMA
        weights when present) or a reference ``.pt`` torch checkpoint."""
        if path.endswith(".pt"):
            return self._load_torch_checkpoint(path)
        top = None
        if is_orbax(path):  # decode only what serving reads
            keys = orbax_top_keys(path)
            top = ("ema" if "ema" in keys else "params", "buffers", "it")
        payload = read_checkpoint(path, top=top)
        src = payload.get("ema", payload.get("params"))
        if src is None:
            raise ValueError(f"checkpoint {path!r} holds no 'ema' or "
                             f"'params' entry")
        template = to_flax(self.model.net)[0]
        self._check_ckpt_compat(template, src, payload, path)
        self.set_variables(src, payload.get("buffers", {}),
                           it=int(payload.get("it", 0)))

    def _load_torch_checkpoint(self, path: str):
        """A reference ``.pt``: the EMA weights when present (then network,
        ema_model, state_dict, model), converted to the JAX layout and
        filled into the built network with a strict shape check that names
        the first mismatching keys; ``it`` carried over.  With the
        ``oct_pow2`` or ``compat`` frame the frame self-check runs; with
        the ``native`` frame a warning says that the published weights need
        the checkpoint-compatible frame."""
        mode = self.model.cqt.mode
        if mode == "native":
            print("WARNING: loading a PyTorch checkpoint with the 'native' "
                  "CQT frame. Published reference weights were trained with "
                  "the cqt_nsgt_pytorch frame — use network=cqtdiff+_ckpt "
                  "(network.cqt.mode=oct_pow2) for faithful reconstruction.")
        ckpt = read_checkpoint(path)
        converted = convert_state_dict(extract_network_state(ckpt,
                                                             prefer="ema"))
        params, buffers = to_flax(self.model.net)
        v = fill_variables({"params": params, "buffers": buffers}, converted,
                           strict=True)
        it = int(ckpt.get("it", 0)) if isinstance(ckpt, dict) else 0
        self.set_variables(v["params"], v.get("buffers", {}), it=it)
        if mode in ("oct_pow2", "compat"):
            self._frame_self_check()

    def _frame_self_check(self) -> float:
        """At sigma = sigma_data the EDM preconditioning gives cskip = 1/2,
        so half of D(x) comes from the network: trained weights with the
        frame they were trained with return D(x) ~ x on a clean in-band
        signal (one tone per octave of the CQT ladder at the data's RMS),
        a relative residual well under 0.35; a wrong frame or untrained
        weights give about 0.5 or more, and a warning says so.  Returns
        the residual."""
        den, hpf = self._denoiser_fn()
        sigma_data = float(self.edm.p.sigma_data)
        freqs = np.asarray(self.model.cqt.freqs)
        bpo = self.model.cqt.bins_per_oct
        t_ax = np.arange(self.audio_len) / self.fs
        x = np.sum([np.sin(2 * np.pi * f * t_ax)
                    for f in freqs[bpo // 2::bpo]], axis=0)
        x = torch.as_tensor((x / np.std(x) * sigma_data)[None],
                            dtype=torch.float32, device=self.device)
        if hpf is not None:
            x = hpf(x)
        sig = torch.full((1, 1), sigma_data, device=self.device)
        with torch.no_grad():
            x_hat = den(x, sig)
        resid = float(torch.linalg.norm(x_hat - x) / torch.linalg.norm(x))
        if resid > 0.35:
            print(f"WARNING: frame self-check FAILED (relative denoiser "
                  f"residual {resid:.3f} at sigma={sigma_data:g}; trained "
                  f"weights + matching CQT frame should give << 0.35, a "
                  f"wrong frame or untrained weights give ~0.5+). If these "
                  f"are published weights, the oct_pow2 frame likely "
                  f"mismatches the cqt_nsgt_pytorch frame they were trained "
                  f"with.")
        else:
            print(f"frame self-check OK (denoiser residual {resid:.3f} at "
                  f"sigma={sigma_data:g})")
        return resid

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

    def _dev(self, x) -> torch.Tensor:
        """A tensor or an array as float32 on the tester's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def resample_audio(self, seg, fs: int) -> np.ndarray:
        """[1, audio_len] at the model's rate: resampled, then cropped or
        zero-padded."""
        seg = np.atleast_2d(np.asarray(seg, dtype=np.float32))
        if fs != self.fs:
            seg = self._host(resample(self._dev(seg), int(fs), self.fs))
        if seg.shape[-1] < self.audio_len:
            seg = np.pad(seg, ((0, 0), (0, self.audio_len - seg.shape[-1])))
        return seg[..., : self.audio_len]

    def apply_lowpass_fcA(self, seg, params) -> torch.Tensor:
        """``seg`` low-passed by the parametric filter ``params`` [2, K]."""
        nfft = self.blind_cfg.nfft
        freqs = self._dev(rfftfreq(nfft, self.fs))
        H = design_filter(self._dev(params[0]), self._dev(params[1]), freqs)
        return apply_filter(self._dev(seg), H, nfft)

    def _test_filter(self) -> np.ndarray:
        tf = self.args.tester.blind_bwe.test_filter
        return np.asarray([np.atleast_1d(tf.fc), np.atleast_1d(tf.A)],
                          dtype=np.float32)

    def _prepare_informed_filter(self, typefilter: str):
        if typefilter == "fc_A":
            return self._test_filter(), "fc_A"
        return D.prepare_filter(self.args, self.fs)

    def _maybe_add_snr_noise(self, y: torch.Tensor, snr_db) -> torch.Tensor:
        """y plus white noise at ``snr_db`` dB per item (None: y)."""
        if snr_db in (None, "None"):
            return y
        snr = 10 ** (float(snr_db) / 10)
        sigma = torch.sqrt(y.var(-1, correction=0, keepdim=True) / snr)
        return y + sigma * torch.randn(y.shape, generator=self.next_key(),
                                       device=y.device)

    def _items(self):
        """The test set's items as (index, [1, audio_len] float32 on the
        device, name without extension)."""
        for i in range(len(self.test_set)):
            yield self._item(i)

    def _recordings(self, path: str, num: int | None = None) -> list[str]:
        files = sorted(_glob.glob(os.path.join(path, "*.wav")))
        return files if num is None else files[:num]

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

    # ---------------------------------------------------------------- modes

    def sample_unconditional(self) -> np.ndarray:
        """``tester.unconditional.num_samples`` clips of its ``audio_len``,
        written as one wav."""
        ucfg = self.args.tester.unconditional
        shape = (int(ucfg.num_samples), int(ucfg.audio_len))
        preds = self._host(self.unconditional(self.next_key(), shape))
        if self.mesh.is_main:
            write_audio_file(preds, self.fs, "unconditional",
                             self.paths["unconditional"])
        return preds

    def unconditional(self, gen, shape) -> torch.Tensor:
        """``predict_unconditional(gen, shape)``; over a mesh whose size
        divides the clips, each rank samples its rows and the batch is
        gathered (the JAX tester's data-parallel ``out_shardings``)."""
        m, s = self.mesh, self.sampler()
        if m.size == 1 or shape[0] % m.size:
            return s.predict_unconditional(gen, shape)
        return gather_batch(m, s.predict_unconditional_rows(
            gen, shape, m.rows(shape[0])))

    def test_inpainting(self):
        """Restore a gap of ``inpainting.gap_length`` ms in each test item
        (centred, or from ``start_gap_idx`` ms; at most half a segment)."""
        if self.test_set is None:
            print("No test set specified, skipping inpainting test")
            return None
        icfg = self.args.tester.inpainting
        gap = int(float(icfg.gap_length) * self.fs / 1000)
        gap = min(gap, self.audio_len // 2)
        start = icfg.get("start_gap_idx", None)
        start = ((self.audio_len - gap) // 2 if start in (None, "None")
                 else int(float(start) * self.fs / 1000))
        mask = np.ones((1, self.audio_len), np.float32)
        mask[:, start : start + gap] = 0.0
        mask = self._dev(mask)
        s = self.sampler()
        outs = []
        for _, seg, n in self._items():
            pred = self._host(s.predict_inpainting(self.next_key(),
                                                   seg * mask, mask))
            outs.append(pred)
            write_audio_file(pred, self.fs, n, self.paths["inpainting"])
        return np.concatenate(outs, 0) if outs else None

    def test_bwe(self, typefilter=None, test_filter_fit=None,
                 compute_sweep=None):
        """Informed BWE over the test set with the filter of
        ``bandwidth_extension.filter`` (or the test filter for 'fc_A').
        With ``test_filter_fit`` the fitted filter's trajectory is saved
        per item, with ``compute_sweep`` also the (fc, A) landscape as
        ``data_norms<i>.npy`` / ``data_grads<i>.npy``."""
        if self.test_set is None:
            print("No test set specified, skipping bwe test")
            return None
        be = self.args.tester.bandwidth_extension
        if test_filter_fit is None:
            test_filter_fit = bool(be.get("test_filter_fit", False))
        if compute_sweep is None:
            compute_sweep = bool(be.get("compute_sweep", False))
        typefilter = typefilter or be.filter.type
        filt, ftype = self._prepare_informed_filter(typefilter)
        path = self.paths["bwe"]
        os.makedirs(path, exist_ok=True)
        s = self.sampler()
        snr = self.args.tester.blind_bwe.get("SNR_observations", "None")

        def run(k):
            i, seg, n = self._item(k)
            if ftype == "fc_A":
                y = self.apply_lowpass_fcA(seg, filt)
            else:
                y = D.degradation_from_filter(filt, ftype)(seg)
            y = self._maybe_add_snr_noise(y, snr)
            out = s.predict_bwe(self.next_key(), y, filt, ftype,
                                test_filter_fit=test_filter_fit,
                                compute_sweep=compute_sweep)
            rec = {"i": i, "n": n, "seg": self._host(seg),
                   "y": self._host(y),
                   "pred": self._host(out[0] if test_filter_fit else out)}
            if test_filter_fit:
                rec.update(zip(("dens", "t", "filts"), (
                    self._host(v) for v in out[1:4])))
                if compute_sweep:
                    rec["norms"], rec["grads"] = (self._host(v)
                                                  for v in out[4:6])
            return rec

        recs = self._sharded(len(self.test_set),
                             1 + (snr not in (None, "None")), run)
        if self.mesh.is_main:
            for rec in recs:
                self._write_bwe(rec, path, filt, ftype)
        outs = [rec["pred"] for rec in recs]
        return np.concatenate(outs, 0) if outs else None

    def _write_bwe(self, rec: dict, path: str, filt, ftype: str) -> None:
        """The files of one ``test_bwe`` item."""
        i, n = rec["i"], rec["n"]
        if "filts" in rec:
            if "norms" in rec:
                np.save(os.path.join(path, f"data_norms{i}.npy"),
                        rec["norms"])
                np.save(os.path.join(path, f"data_grads{i}.npy"),
                        rec["grads"])
            filts = rec["filts"]
            ulog.save_trajectory(path, n + "_filter_fit",
                                 denoised=rec["dens"], t=rec["t"],
                                 filters=filts)
            parametric = ftype == "fc_A"  # plotted beside the fit
            ulog.plot_filter_response(
                [filts[-1], filt] if parametric else [filts[-1]],
                rfftfreq(self.blind_cfg.nfft, self.fs),
                os.path.join(path, n + "_fitted_filter.png"),
                labels=(["fitted", "reference"] if parametric
                        else ["fitted"]))
        write_audio_file(rec["seg"], self.fs, n, path + "_original")
        write_audio_file(rec["y"], self.fs, n, path + "_degraded")
        write_audio_file(rec["pred"], self.fs, n, path + "_reconstructed")

    def test_blind_bwe(self, typefilter="fc_A", compute_sweep=False):
        """Blind BWE of each test item low-passed by the test filter: one
        ``metrics.jsonl`` record per item (filter dB-MSE, LSD and high-band
        LSD of the reconstruction and of the degraded input, the estimated
        filter), its wavs, its trajectory and plots."""
        if self.test_set is None:
            print("No test set specified, skipping blind bwe test")
            return None
        bb = self.args.tester.blind_bwe
        da_filter = self._test_filter()
        freqs = self._dev(rfftfreq(self.blind_cfg.nfft, self.fs))
        fc0 = float(da_filter[0][0])
        path = self.paths["blind_bwe"]
        s = self.sampler()
        snr = bb.get("SNR_observations", "None")

        def run(k):
            i, seg, n = self._item(k)
            sn = bb.get("sigma_norm", "None")
            if sn not in (None, "None"):
                seg = float(sn) * seg / seg.std(-1, correction=0,
                                                 keepdim=True)
            gain = float(bb.get("gain_boost", 0) or 0)
            if gain != 0:
                seg = seg * 10 ** (gain / 20)
            y = self.apply_lowpass_fcA(seg, da_filter)
            y = self._maybe_add_snr_noise(y, snr)
            pred, est, dens, t, filts, scores = s.predict_blind_bwe(
                self.next_key(), y, rid=True)
            y_est = self.apply_lowpass_fcA(seg, est)
            record = {
                "mode": "blind_bwe", "item": n,
                "filter_db_mse": float(filter_db_mse(self._dev(da_filter),
                                                     est, freqs)),
                "lsd": float(lsd(seg, pred).mean()),
                "lsd_high_band": float(lsd_high_band(seg, pred, self.fs,
                                                     fc0).mean()),
                # the degraded input's: the numbers BWE must beat
                "lsd_degraded": float(lsd(seg, y).mean()),
                "lsd_high_band_degraded": float(lsd_high_band(
                    seg, y, self.fs, fc0).mean()),
                "fc_est": self._host(est[0]).tolist(),
                "A_est": self._host(est[1]).tolist()}
            host = {k_: self._host(v) for k_, v in (
                ("original", seg), ("degraded", y), ("reconstructed", pred),
                ("estimate", y_est), ("est", est), ("dens", dens), ("t", t),
                ("filts", filts), ("scores", scores))}
            return i, n, record, host

        out = self._sharded(len(self.test_set),
                            1 + (snr not in (None, "None")), run)
        if self.mesh.is_main:
            for i, n, record, h in out:
                self.metrics.log(record, step=i)
                for tag in ("original", "degraded", "reconstructed",
                            "estimate"):
                    write_audio_file(h[tag], self.fs, n, path + "_" + tag)
                ulog.save_trajectory(path, n + "_rid", denoised=h["dens"],
                                     t=h["t"], filters=h["filts"],
                                     score=h["scores"])
                ulog.diffusion_spec_animation(
                    h["dens"], h["t"], os.path.join(path, n + "_anim.gif"),
                    fs=self.fs)
                ulog.plot_filter_response(
                    [h["est"], da_filter],
                    rfftfreq(self.blind_cfg.nfft, self.fs),
                    os.path.join(path, n + "_filter.png"),
                    labels=["estimated", "reference"])
        return [(h["reconstructed"], h["est"]) for _, _, _, h in out]

    def test_real_blind_bwe(self, typefilter="fc_A", compute_sweep=False):
        """Blind BWE of the first ``real_recordings.num_samples`` wavs of
        ``real_recordings.path`` (their first segment)."""
        bb = self.args.tester.blind_bwe
        files = self._recordings(str(bb.real_recordings.path),
                                 int(bb.real_recordings.num_samples))
        if not files:
            print("no real recordings found, skipping")
            return None
        path = self.paths["real_blind_bwe"]
        s = self.sampler()
        results = []
        for i, f in enumerate(files):
            d, fs = read_wav(f)
            n = os.path.splitext(os.path.basename(f))[0] + typefilter
            seg = self._dev(self.resample_audio(to_mono(d), fs))
            sn = bb.get("sigma_norm", "None")
            if sn not in (None, "None"):
                seg = float(sn) * seg / seg.std(-1, correction=0,
                                                 keepdim=True)
            pred, est, dens, t, filts, scores = s.predict_blind_bwe(
                self.next_key(), seg, rid=True)
            write_audio_file(seg, self.fs, n, path + "_degraded")
            write_audio_file(pred, self.fs, n, path + "_reconstructed")
            ulog.save_trajectory(path, n + "_rid", denoised=dens, t=t,
                                 filters=filts, score=scores)
            self.metrics.log({"mode": "real_blind_bwe", "item": n,
                              "fc_est": self._host(est[0]).tolist(),
                              "A_est": self._host(est[1]).tolist()}, step=i)
            results.append((self._host(pred), self._host(est)))
        return results

    def formal_test_bwe(self, typefilter=None, blind=False,
                        robustness=False):
        """Restore every wav of ``formal_test.path`` into
        ``formal_test.folder`` (a file already there is skipped): degrade
        it with the informed filter (``robustness``: the robustness
        firwin) at its own rate, resample, then either the chunk loop
        (``use_AR``, informed) or independent segments cross-faded over
        ``OLA`` samples with a periodic hann, each blind (batch 1, its own
        filter, pickled beside the wav) or informed (``chunk_batch``
        segments a sampler run).  A tail longer than the last segment keeps
        the degraded input, cross-faded over ``OLA`` samples."""
        ft = self.args.tester.formal_test
        typefilter = typefilter or self.args.tester.bandwidth_extension.filter.type
        filt, ftype = self._prepare_informed_filter(typefilter)
        if robustness:
            rf = ft.robustness_filter
            filt = get_FIR_lowpass(int(rf.order), float(rf.fc),
                                   float(rf.beta), self.fs)
            ftype = "firwin"
        filenames = self._recordings(str(ft.path))
        path_out = str(ft.folder)
        os.makedirs(path_out, exist_ok=True)
        segL = self.audio_len
        discard_end = AR_DISCARD_END
        use_ar = bool(ft.get("use_AR", False))
        OLA = int(ft.get("OLA", 2048))
        s = self.sampler()
        hann = np.hanning(2 * OLA + 1)[:-1].astype(np.float32)

        for filename in filenames:
            n = os.path.splitext(os.path.basename(filename))[0]
            if os.path.exists(os.path.join(path_out, n + ".wav")):
                continue
            d, fs = read_wav(filename)
            Dg = self._dev(np.atleast_2d(to_mono(d)))
            if ftype == "fc_A":
                degraded = self.apply_lowpass_fcA(Dg, filt)
            else:
                degraded = D.degradation_from_filter(filt, ftype)(Dg)
            if fs != self.fs:
                degraded = resample(degraded, fs, self.fs)
            degraded = self._host(degraded)
            L = degraded.shape[-1]
            if L < segL:
                print(f"SKIPPED {filename}: length {L} < segment length "
                      f"{segL} (formal_test_bwe requires at least one full "
                      "segment)")
                continue
            final = np.zeros_like(degraded)
            filter_data = []
            if use_ar and not blind:
                final = self._ar_loop(degraded, filt, ftype)
            else:
                hop = segL - discard_end - OLA
                starts = list(range(0, max(L - segL - discard_end, 1), hop))
                tail_ix = starts[-1] + hop
                segs = [degraded[0, ix : ix + segL] for ix in starts]
                tail = degraded[0, tail_ix:]
                tail_len = tail.shape[-1]
                segs.append(np.pad(tail, (0, segL - tail_len))
                            if tail_len < segL else tail[:segL])
                segs = np.stack(segs)  # [n_chunks, segL]
                if blind:
                    # each chunk its own request: its own noise, filter
                    # fit and guidance normalisation; the chunks spread
                    # over the ranks
                    def blind_chunk(row):
                        pred, est = s.predict_blind_bwe(
                            self.next_key(), self._dev(segs[row : row + 1]))
                        return self._host(pred)[0], self._host(est)

                    out = self._sharded(segs.shape[0], 1, blind_chunk)
                    preds = np.stack([p for p, _ in out])
                    filter_data = [((row,), est)
                                   for row, (_, est) in enumerate(out)]
                else:
                    # full batches of cb (the last one padded with copies
                    # of the last segment): the guidance is normalised
                    # over each batch, as in the JAX package; the batches
                    # spread over the ranks
                    cb = max(int(ft.get("chunk_batch", 4)), 1)
                    reps = -segs.shape[0] % cb
                    segs_in = np.concatenate([segs, segs[-1:].repeat(reps,
                                                                     0)], 0)
                    preds = np.concatenate(self._sharded(
                        segs_in.shape[0] // cb, 1,
                        lambda k: self._host(s.predict_bwe(
                            self.next_key(),
                            self._dev(segs_in[k * cb : (k + 1) * cb]), filt,
                            ftype))), 0)
                    preds = preds[: segs.shape[0]]
                for row, ix in enumerate(starts):
                    win = preds[row, : segL - discard_end].copy()
                    if row > 0:
                        win[:OLA] *= hann[:OLA]
                    win[-OLA:] *= hann[OLA:]
                    if row == 0:
                        final[0, : segL - discard_end] = win
                    else:
                        final[0, ix : ix + segL - discard_end] += win
                # the tail can outrun the last segment by up to
                # discard_end samples: the prediction covers segL of them,
                # the rest keeps the degraded input, cross-faded linearly
                m = min(tail_len, segL)
                win = preds[-1, :m].copy()
                win[:OLA] *= hann[:OLA]
                final[0, tail_ix : tail_ix + m] += win
                if tail_len > segL:
                    final[0, tail_ix + segL:] = degraded[0, tail_ix + segL:]
                    xf = min(int(OLA), segL, tail_ix + segL)
                    if xf > 1:
                        sp = tail_ix + segL - xf
                        ramp = np.linspace(1.0, 0.0, xf, endpoint=False,
                                           dtype=np.float32)
                        final[0, sp : sp + xf] = (
                            final[0, sp : sp + xf] * ramp
                            + degraded[0, sp : sp + xf] * (1.0 - ramp))
            if not self.mesh.is_main:
                continue
            write_audio_file(final, self.fs, n, path_out)
            if blind:
                with open(os.path.join(path_out, n + ".filter_data.pkl"),
                          "wb") as f:
                    pickle.dump(filter_data, f)

    def formal_test_bwe_small(self):
        """Blind BWE of each wav of ``formal_test.path`` (one segment,
        low-passed by the test filter) into ``formal_test.folder``, with
        the filter dB-MSE per item; returns the dB-MSEs."""
        ft = self.args.tester.formal_test
        da_filter = self._test_filter()
        path_out = str(ft.folder)
        os.makedirs(path_out, exist_ok=True)
        s = self.sampler()
        freqs = self._dev(rfftfreq(self.blind_cfg.nfft, self.fs))
        mses = []
        for i, filename in enumerate(self._recordings(str(ft.path))):
            n = os.path.splitext(os.path.basename(filename))[0]
            if os.path.exists(os.path.join(path_out, n + ".wav")):
                continue
            d, fs = read_wav(filename)
            seg = self._dev(self.resample_audio(to_mono(d), fs))
            y = self.apply_lowpass_fcA(seg, da_filter)
            pred, est = s.predict_blind_bwe(self.next_key(), y)
            mse = float(filter_db_mse(self._dev(da_filter), est, freqs))
            mses.append(mse)
            self.metrics.log({"mode": "formal_small", "item": n,
                              "filter_db_mse": mse}, step=i)
            write_audio_file(pred, self.fs, n, path_out)
        if mses:
            print(f"filter dB-MSE mean over {len(mses)} items: "
                  f"{np.mean(mses):.3f}")
        return mses

    def test_mushra(self, typefilter="fc_A", compute_sweep=False):
        """MUSHRA stimuli from the recordings folder: per item the original
        (the hidden reference, its first segment at the file's own rate),
        the degraded anchor (the test filter), the blind reconstruction and
        the estimated filter re-applied to the original, plus the
        trajectory; with ``compute_sweep`` also ``data_t<i>.npy``,
        ``data_denoised<i>.npy`` and ``data_filters<i>.npy``."""
        bb = self.args.tester.blind_bwe
        files = self._recordings(str(bb.real_recordings.path),
                                 int(bb.real_recordings.num_samples))
        da_filter = self._test_filter()
        path = self.paths["mushra"]
        os.makedirs(path, exist_ok=True)
        s = self.sampler()
        for i, f in enumerate(files):
            d, fs = read_wav(f)
            n = os.path.splitext(os.path.basename(f))[0] + typefilter
            seg = np.asarray(to_mono(d), np.float32)[None, : self.audio_len]
            if seg.shape[-1] < self.audio_len:
                seg = np.pad(seg, ((0, 0), (0, self.audio_len
                                            - seg.shape[-1])))
            seg = self._dev(seg)
            y = self.apply_lowpass_fcA(seg, da_filter)
            y = self._maybe_add_snr_noise(y, bb.get("SNR_observations",
                                                    "None"))
            pred, est, dens, t, filts, scores = s.predict_blind_bwe(
                self.next_key(), y, rid=True)
            y_est = self.apply_lowpass_fcA(seg, est)
            for tag, audio in (("original", seg), ("degraded", y),
                               ("reconstructed", pred),
                               ("degraded_estimate", y_est)):
                write_audio_file(audio, self.fs, n, path + "_" + tag)
            ulog.save_trajectory(path, n + "_rid", denoised=dens, t=t,
                                 filters=filts, score=scores)
            if compute_sweep:
                for key, v in (("t", t), ("denoised", dens),
                               ("filters", filts)):
                    np.save(os.path.join(path, f"data_{key}{i}.npy"),
                            self._host(v))

    # ------------------------------------------- additional inverse problems

    def test_declipping(self):
        """Declipping of each test item clipped at the level that gives
        ``declipping.SDR`` dB."""
        if self.test_set is None:
            return None
        sdr = float(self.args.tester.declipping.get("SDR", 3))
        s = self.sampler()
        outs = []
        for _, seg, n in self._items():
            level = seg.std(correction=0) * 10 ** (-sdr / 20) * 2
            y = torch.clamp(seg, -level, level)
            pred = self._host(s.predict_declipping(self.next_key(), y,
                                                   level))
            outs.append(pred)
            write_audio_file(pred, self.fs, n, self.paths["bwe"]
                             + "_declipped")
        return np.concatenate(outs, 0) if outs else None

    def test_phase_retrieval(self):
        """Phase retrieval from each test item's STFT magnitude
        (``phase_retrieval.win_size``, ``hop_size``)."""
        if self.test_set is None:
            return None
        pr = self.args.tester.phase_retrieval
        win, hop = int(pr.win_size), int(pr.hop_size)
        s = self.sampler()
        outs = []
        for _, seg, n in self._items():
            y_mag = D.make_stft_mag(win, hop)(seg)
            pred = self._host(s.predict_phase_retrieval(self.next_key(),
                                                        y_mag, win, hop))
            outs.append(pred)
            write_audio_file(pred, self.fs, n, self.paths["bwe"] + "_pr")
        return np.concatenate(outs, 0) if outs else None

    def test_comp_sens(self):
        """Compressive sensing: each test item observed at a random
        ``comp_sens.percentage`` % of its samples (one mask from a
        generator seeded 0)."""
        if self.test_set is None:
            return None
        pct = float(self.args.tester.comp_sens.get("percentage", 5))
        gen = torch.Generator().manual_seed(0)
        mask = self._dev((torch.rand((1, self.audio_len), generator=gen)
                          < pct / 100.0).float())
        s = self.sampler()
        outs = []
        for _, seg, n in self._items():
            pred = self._host(s.predict_compsens(self.next_key(), seg * mask,
                                                 mask))
            outs.append(pred)
            write_audio_file(pred, self.fs, n, self.paths["bwe"] + "_cs")
        return np.concatenate(outs, 0) if outs else None

    # ------------------------------------------------------------- dispatch

    def dodajob(self) -> dict:
        """Run every mode of ``tester.modes`` in order; returns each mode's
        result.  An unknown mode raises ``NotImplementedError``."""
        ft = self.args.tester.get("formal_test", {}) or {}
        runs = {
            "unconditional": self.sample_unconditional,
            "inpainting": self.test_inpainting,
            "bwe": self.test_bwe,
            "blind_bwe": self.test_blind_bwe,
            "real_blind_bwe": self.test_real_blind_bwe,
            "real_blind_bwe_complete": self.test_real_blind_bwe_complete,
            "formal_test_bwe": lambda: self.formal_test_bwe(
                blind=bool(ft.get("blind", False)),
                robustness=bool(ft.get("robustness", False))),
            "declipping": self.test_declipping,
            "phase_retrieval": self.test_phase_retrieval,
            "comp_sens": self.test_comp_sens,
            "formal_test_bwe_small": self.formal_test_bwe_small,
            "mushra": lambda: self.test_mushra(compute_sweep=bool(
                self.args.tester.blind_bwe.get("compute_sweep", False))),
        }
        results = {}
        for mode in list(self.args.tester.modes):
            if mode not in runs:
                raise NotImplementedError(f"tester mode {mode!r}")
            if self.mesh.size > 1:
                if mode not in SHARDED_MODES:
                    if self.mesh.is_main:  # rank 0 alone
                        results[mode] = runs[mode]()
                    continue
                # rank 0's key stream, which the unsharded modes moved on
                self.gen.set_state(broadcast_object(self.mesh,
                                                    self.gen.get_state()))
            results[mode] = runs[mode]()
        self.close()
        return results

    def close(self):
        """The JAX tester's ``close`` releases its metrics file; the port's
        logger appends and closes the file at every record, so nothing is
        left open.  Idempotent."""
