"""The port's whole-recording mode ``Tester.test_real_blind_bwe_complete``
against the JAX package's, on the tiny reseeded weights and the replayed
JAX key stream of ``tests/test_torch_longform.py``: a 44.1 kHz wav of 2.6
model segments is resampled, normalised to ``complete_recording.std``, its
filter estimated blind on two segments in one batch (the first at
``ix_start``, the second drawn from ``default_rng(0)``), restored by the
chunk loop, the gain undone and the wav written.  Tolerance 1e-3 relative
to the largest value, on the audio and on the filter parameters."""

import jax
import numpy as np
import pytest
import torch

from babe_tpu_torch.data.wavio import read_wav, write_wav
from test_torch_longform import SEG, _Draws, _recording, replay, testers
from test_torch_sampling import _close

__all__ = ["testers"]  # the fixture, shared with the long-form tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_real_blind_bwe_complete_matches(testers, rng, monkeypatch):
    jt, tt, tmp = testers
    L = int(2.6 * SEG)
    x = _recording(rng, L)
    up = np.repeat(x[0], 2)  # 44.1 kHz: each sample held twice
    write_wav(str(tmp / "rec.wav"), 4.0 * up, 44100)
    jt.key = jax.random.PRNGKey(9)
    draws = _Draws(jt, jt.key)
    jt._jit_cache.clear()
    ref, ref_est = jt.test_real_blind_bwe_complete()
    replay(tt, draws, monkeypatch)
    out, est = tt.test_real_blind_bwe_complete()
    assert draws.calls == ["blind", "first", "AR", "AR"]
    assert est.shape == np.asarray(ref_est).shape == (2, 2)
    _close(est[0], np.asarray(ref_est)[0], 1e-3)  # fc, Hz
    _close(est[1], np.asarray(ref_est)[1], 1e-3)  # A, dB/octave
    assert out.shape == np.asarray(ref).shape == (1, L)
    _close(out, ref, 1e-3)
    wav, fs = read_wav(str(tmp / "port" / "outputs" / "complete"
                           / "recfc_A.reconstructed.wav"))
    assert fs == 22050 and wav.shape == (L,)
    assert "fc_est" in (tmp / "port" / "outputs" / "metrics.jsonl").read_text()
