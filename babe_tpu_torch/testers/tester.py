"""The tester core the library API runs on, in PyTorch.

Counterpart of the parts of ``babe_tpu/testers/tester.py`` that
``api.BABE`` uses: construction (tester-side EDM, sampler and blind
configs), noise streams, checkpoint loading with a shape check against the
built model, and the sampler factory.  The experiment modes (inpainting,
formal tests, MUSHRA, the autoregressive long-input loop, ...) belong to
later slices of the port.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from babe_tpu_torch.diffusion.edm import EDM, EDMParams
from babe_tpu_torch.sampling.blind import BlindConfig, BlindSampler
from babe_tpu_torch.sampling.heun import SamplerConfig
from babe_tpu_torch.utils.weights import _flatten, load_flax, to_flax

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
    def __init__(self, args, model, diff_params: EDM, device="cuda"):
        self.args = args
        self.model = model
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
