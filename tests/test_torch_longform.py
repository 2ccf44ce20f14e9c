"""The port's long-form restoration against the JAX package on the same
(reseeded) tiny weights: the feathered inpainting mask, the autoregressive
step ``predict_bwe_AR`` and the chunk loop ``Tester._ar_loop`` on a 2.6-segment
input.  ``tests/test_torch_complete.py`` and ``tests/test_torch_enhance.py``
reuse its fixture and replay.

Noise: ``tester.diff_params.Schurn=0`` makes every stochastic time move a
no-op, so a sampler run is fixed by its first draw.  The JAX tester's key
stream is replayed here (``_Draws``): each sampler call of the port takes
the next key, as the JAX tester's ``next_key`` hands it to its own call,
and starts from the JAX sampler's first draw for that key on the port's
own observation (given as ``x_init``; nothing in the port changes for it).

Tolerances: the smooth mask bit-exact (both are host numpy); trajectories
and filter parameters 1e-3 relative to the largest value, as
``tests/test_torch_sampling.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.diffusion.edm import EDM as JEDM
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu.sampling.blind import prepare_smooth_mask as jmask
from babe_tpu.testers.tester import Tester as JTester
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.diffusion.edm import EDM as TEDM
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.sampling.blind import prepare_smooth_mask as tmask
from babe_tpu_torch.testers.tester import Tester as TTester
from babe_tpu_torch.utils.weights import to_flax
from test_torch_sampling import TINY, _close, _observation, _reseed

SEG = 4096
OVERLAP = int(0.02 * 22050)  # 441 samples
FILT = np.asarray([[800.0], [-30.0]], np.float32)
LONG = TINY + ["tester.complete_recording.overlap=0.02",
               "tester.complete_recording.inpaint_DC=true",
               "tester.complete_recording.n_segments_blindstep=2",
               "tester.complete_recording.ix_start=0"]


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
def testers(tmp_path_factory):
    """A JAX tester and a port tester (device='cpu') over the same tiny
    reseeded weights, each writing under its own model_dir; both read the
    recording ``<tmp>/rec.wav``."""
    tmp = tmp_path_factory.mktemp("long")
    ov = LONG + [f"tester.complete_recording.path={tmp / 'rec.wav'}"]
    jargs = jconfig(ov + [f"model_dir={tmp / 'jax'}"])
    targs = tconfig(ov + [f"model_dir={tmp / 'port'}"])
    params, buffers = tiny_weights(targs)
    jm = JModel.from_config(jargs)
    jt = JTester(jargs, jm, JEDM.from_config(jargs, cqt_hpf=jm.apply_hpf_DC))
    jt.set_variables(jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, buffers))
    tm = TModel.from_config(targs)
    tt = TTester(targs, tm, TEDM.from_config(targs, cqt_hpf=tm.apply_hpf_DC),
                 device="cpu")
    tt.set_variables(params, buffers)
    return jt, tt, tmp


def tiny_weights(targs):
    """JAX-layout (params, buffers) of the tiny network: the port's seeded
    init (the same tree as the JAX init's, made without tracing the JAX
    model), every weight then reseeded from numpy."""
    net = TModel.from_config(targs).init(seed=0, device="cpu").net
    params, buffers = to_flax(net)
    return _reseed(params, np.random.default_rng(11)), buffers


class _Draws:
    """The JAX tester's key stream from ``key``: ``x_init(y)`` takes the
    next key (``next_key``'s split) and returns the JAX sampler's first draw
    for it, the warm start y + N(0, 1) t[0]."""

    def __init__(self, jt, key):
        self.key = key
        self.t0 = jt.edm.create_schedule_from_initial_t(jt.scfg.start_sigma,
                                                        jt.scfg.T)[0]
        self.calls = []

    def x_init(self, y: torch.Tensor, what: str) -> torch.Tensor:
        self.key, k = jax.random.split(self.key)
        _, k0 = jax.random.split(k)
        noise = np.array(jax.random.normal(k0, tuple(y.shape)) * self.t0)
        self.calls.append(what)
        return y + torch.as_tensor(noise)


def replay(tt, draws, monkeypatch):
    """Make every sampler of ``tt`` start from ``draws`` (a test-side
    wrapper of its entry points that fills in ``x_init``)."""
    make = tt.sampler

    def sampler():
        s = make()
        bwe, ar, blind = s.predict_bwe, s.predict_bwe_AR, s.predict_blind_bwe

        def predict_bwe(gen, y, filt, ftype):
            return bwe(gen, y, filt, ftype, x_init=draws.x_init(y, "first"))

        def predict_bwe_AR(gen, ylpf, y_masked, filt, ftype, mask, **kw):
            m = torch.as_tensor(mask, dtype=torch.float32)
            ym = torch.as_tensor(y_masked, dtype=torch.float32)
            y = m * ym + (1 - m) * ylpf  # the step's composite observation
            return ar(gen, ylpf, y_masked, filt, ftype, mask,
                      x_init=draws.x_init(y, "AR"), **kw)

        def predict_blind_bwe(gen, y):
            return blind(gen, y, x_init=draws.x_init(y, "blind"))

        s.predict_bwe, s.predict_bwe_AR = predict_bwe, predict_bwe_AR
        s.predict_blind_bwe = predict_blind_bwe
        return s

    monkeypatch.setattr(tt, "sampler", sampler)


def _masks():
    """The loop's overlap mask, its last-chunk mask with the data ending
    inside the overlap, and a gap (a 1->0 and a 0->1 step) in a batch of
    two."""
    m = np.ones((1, SEG), np.float32)
    m[:, OVERLAP:] = 0
    last = m.copy()
    last[:, 300:] = 0
    gap = np.ones((2, SEG), np.float32)
    gap[:, 1000:2000] = 0
    return [m, last, gap]


def _edge_masks():
    """Steps within one window of either end, or a mask that starts at 0
    (a 1->0 step at sample 0): the reference's slices there are shorter
    than the window, and numpy refuses the assignment."""
    early = np.ones((1, SEG), np.float32)
    early[:, 20:] = 0
    late = np.zeros((1, SEG), np.float32)
    late[:, SEG - 30:] = 1
    return [early, late, np.zeros((1, SEG), np.float32)]


@pytest.mark.parametrize("size", [50, 10])
def test_prepare_smooth_mask_bit_exact(size):
    for m in _masks():
        out = tmask(m, size)
        ref = np.asarray(jmask(jnp.asarray(m), size))
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert not np.array_equal(out, m)
        np.testing.assert_array_equal(out, ref)
    for m in _edge_masks():
        for fn in (tmask, lambda mm, sz: jmask(jnp.asarray(mm), sz)):
            with pytest.raises(ValueError, match="broadcast"):
                fn(m, 50)


@pytest.mark.parametrize("smooth", [True, False])
def test_predict_bwe_AR_matches(testers, rng, smooth):
    """One autoregressive step at T = 3: the previous chunk's tail over the
    overlap, the low-passed observation after it."""
    jt, tt, _ = testers
    ylpf = _observation(rng)
    y_masked = np.zeros((1, SEG), np.float32)
    y_masked[:, :OVERLAP] = 0.05 * rng.standard_normal(OVERLAP)
    mask = _masks()[0]
    sm = jmask(jnp.asarray(mask), 50) if smooth else None
    key = jax.random.PRNGKey(7)
    js = jt.sampler()
    ref = jax.jit(lambda k, yy, ym, m, s: js.predict_bwe_AR(
        k, yy, ym, jnp.asarray(FILT), "fc_A", m, smooth_mask=s))(
        key, jnp.asarray(ylpf), jnp.asarray(y_masked), jnp.asarray(mask),
        sm)
    # the JAX sampler's first draw for this key, on the composite
    y = torch.as_tensor(mask * y_masked + (1 - mask) * ylpf)
    _, k0 = jax.random.split(key)
    t0 = jt.edm.create_schedule_from_initial_t(jt.scfg.start_sigma,
                                               jt.scfg.T)[0]
    x0 = y + torch.as_tensor(np.array(jax.random.normal(k0, y.shape) * t0))
    # the port feathers the mask itself from its size
    out = tt.sampler().predict_bwe_AR(
        None, torch.as_tensor(ylpf), y_masked, FILT, "fc_A", mask,
        smooth_mask_size=50 if smooth else 0, x_init=x0)
    _close(out.numpy(), ref, 1e-3)
    if smooth:  # the feathered overlap holds the previous chunk's tail
        held = np.asarray(ref)[0, :OVERLAP - 50]
        _close(held, y_masked[0, :OVERLAP - 50], 1e-3)


def _recording(rng, L):
    return np.concatenate([_observation(rng) for _ in range(-(-L // SEG))],
                          axis=-1)[..., :L]


def test_ar_loop_matches(testers, rng, monkeypatch):
    """2.6 segments: the first chunk, one middle chunk and a zero-padded
    last chunk, with the feathered overlap (inpaint_DC)."""
    jt, tt, _ = testers
    L = int(2.6 * SEG)
    x = _recording(rng, L)
    jt.key = jax.random.PRNGKey(3)
    draws = _Draws(jt, jt.key)
    jt._jit_cache.clear()  # its AR programs close over the filter
    ref = jt._ar_loop(x, jnp.asarray(FILT), "fc_A")
    replay(tt, draws, monkeypatch)
    out = tt._ar_loop(x, FILT, "fc_A")
    assert draws.calls == ["first", "AR", "AR"]
    assert out.shape == (1, L) and np.isfinite(out).all()
    _close(out, ref, 1e-3)
