"""The port's ``BABE.enhance`` against the JAX package's on one ``.ckpt``
(tiny reseeded weights) and one denoiser ``.ckpt`` (the port's seeded
init, written in the JAX layout by the bridge): a
44.1 kHz input of 2.5 model segments, blind and informed, each with and
without ``denoise=True``, so every request runs the resampler, the long
chunk loop and (with ``denoise``) the chunked STFT denoiser.

The JAX tester's key stream is replayed as in
``tests/test_torch_longform.py`` (``_Draws``, ``replay``), with
``tester.diff_params.Schurn=0``.  Tolerance 1e-3 relative to the largest
value, on the audio and on the filter parameters.  The informed requests
are in ``tests/test_torch_enhance_informed.py`` (on this file's fixture).

The JAX tester caches its chunk-loop programs by name with the filter of
their first call closed in (``babe_tpu/testers/tester.py``, ``_ar_loop``),
so a second long request with another filter would reuse the first one's;
``_jax_enhance`` drops those programs unless the filter is the same."""

import pickle

import jax
import numpy as np
import pytest
import torch

from babe_tpu.api import BABE as JBABE
from babe_tpu_torch.api import BABE
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.models.denoiser import MultiStageDenoiser as TDenoiser
from babe_tpu_torch.utils.weights import denoiser_to_flax
from test_torch_longform import SEG, _Draws, _recording, replay, tiny_weights
from test_torch_sampling import TINY, _close

NET = [o for o in TINY if o.startswith(("exp.", "network."))]
# exp.use_bf16 is not adopted from a checkpoint: fp32 is asked for here
OVERRIDES = [o for o in TINY if o.startswith("tester.")] + [
    "exp.use_bf16=false",
    "tester.complete_recording.overlap=0.02",
    "tester.denoiser.depth=2", "tester.denoiser.num_tfc=2",
    "tester.denoiser.num_stages=2", "tester.denoiser.f_dim=65",
    "tester.denoiser.stft_win_size=128", "tester.denoiser.stft_hop_size=32",
    "tester.denoiser.segment_size=0.2",
    "tester.denoiser.sample_rate_denoiser=22050"]
L_MODEL = int(2.5 * SEG)  # samples at the model's 22.05 kHz


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX BABE, port BABE) over the same checkpoint and denoiser."""
    tmp = tmp_path_factory.mktemp("enhance")
    args = tconfig(NET + [f"model_dir={tmp}"])
    params, buffers = tiny_weights(args)
    ckpt = str(tmp / "tiny.ckpt")
    with open(ckpt, "wb") as f:
        pickle.dump({"it": 3, "params": params, "buffers": buffers,
                     "ema": params, "args": args.to_dict()}, f)
    den = TDenoiser(depth=2, num_tfc=2, num_stages=2, f_dim=65,
                    stft_win_size=128, stft_hop_size=32, segment_seconds=0.2,
                    seed=1, device="cpu")
    dpath = str(tmp / "den.ckpt")
    with open(dpath, "wb") as f:
        pickle.dump({"params": denoiser_to_flax(den.net)}, f)
    ov = OVERRIDES + [f"model_dir={tmp}"]
    jm = JBABE.load(ckpt, overrides=ov, denoiser_checkpoint=dpath)
    tm = BABE.load(ckpt, overrides=ov, denoiser_checkpoint=dpath,
                   device="cpu")
    jm._ar_filter = "none yet"
    return jm, tm


def _jax_enhance(jm, x, fs, filter, denoise, seed):
    t = jm._tester
    if filter is None or filter != jm._ar_filter:
        for name in [k for k in t._jit_cache if k.startswith("ar_")]:
            del t._jit_cache[name]
    jm._ar_filter = filter
    return jm.enhance(x, fs, filter=filter, denoise=denoise, seed=seed)


def check_enhance(models, monkeypatch, filt, denoise):
    """One request through both packages, held to 1e-3."""
    jm, tm = models
    rng = np.random.default_rng(5)
    x = np.repeat(_recording(rng, L_MODEL)[0], 2)  # 44.1 kHz
    seed = 4
    ref, rinfo = _jax_enhance(jm, x, 44100, filt, denoise, seed)
    draws = _Draws(jm._tester, jax.random.PRNGKey(seed))
    replay(tm._tester, draws, monkeypatch)
    out, info = tm.enhance(x, 44100, filter=filt, denoise=denoise, seed=seed)
    assert draws.calls == ([] if filt else ["blind"]) + ["first", "AR", "AR"]
    assert out.shape == np.asarray(ref).shape == (1, L_MODEL)
    assert info["fs"] == rinfo["fs"] == 22050
    _close(info["fc"], rinfo["fc"], 1e-3)
    _close(info["A"], rinfo["A"], 1e-3)
    _close(out, ref, 1e-3)


@pytest.mark.parametrize("denoise", [False, True])
def test_blind_enhance_matches_jax(models, monkeypatch, denoise):
    """Blind: the filter estimated on the first segment, then the loop."""
    check_enhance(models, monkeypatch, None, denoise)
