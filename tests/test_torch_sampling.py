"""The port's EDM schedule, Heun sampler, filter fit and BABE blind sampler
against the JAX package, on the tiny network with the same (reseeded)
weights.  Noise: Schurn = 0 makes every stochastic time move a no-op, and
the initial state is the JAX sampler's own first draw, fed to the port as
``x_init``; so both trajectories are deterministic and comparable.

Tolerances: schedules 1e-6 relative (both float32); short trajectories in
fp32 at 1e-3 relative to the largest value (each Heun stage re-uses the
previous stage's output, and the guidance normalisation divides by a norm,
so summation-order differences grow a little per stage); filter parameters
at 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu.ops import filters as jfilt
from babe_tpu.ops import stft as jstft
from babe_tpu.testers.tester import Tester as JTester
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.ops import filters as tfilt
from babe_tpu_torch.ops import stft as tstft
from babe_tpu_torch.testers.tester import Tester as TTester

L = 4096
TINY = [
    "exp.audio_len=4096", "exp.use_bf16=false", "network.Ns=[8,8,16]",
    "network.num_dils=[1,1,2]", "network.emb_dim=32",
    "network.attention_layers=[0,0,0,0]", "network.cqt.num_octs=3",
    "network.cqt.bins_per_oct=8", "tester.blind_bwe.NFFT=512",
    "tester.blind_bwe.optimization.max_iter=4",
    "tester.blind_bwe.initial_conditions.fc=[300,500]",
    "tester.blind_bwe.initial_conditions.A=[-20,-30]",
    "tester.diff_params.Schurn=0", "tester.T=3",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers, and idle intra-op threads would spin against them (these
    shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def _reseed(tree, rng):
    def leaf(path, v):
        v = np.asarray(v)
        if "gamma" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        fan = int(np.prod(v.shape[:-1])) if v.ndim > 1 else 1
        return (rng.standard_normal(v.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def testers(tmp_path_factory):
    """A JAX tester and a port tester (device='cpu') over the same tiny
    reseeded weights."""
    rng = np.random.default_rng(11)
    tmp = str(tmp_path_factory.mktemp("samp"))
    ov = TINY + [f"model_dir={tmp}"]
    jargs, targs = jconfig(ov), tconfig(ov)
    from babe_tpu.diffusion.edm import EDM as JEDM
    from babe_tpu_torch.diffusion.edm import EDM as TEDM

    jm = JModel.from_config(jargs)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = _reseed(v["params"], rng)
    jt = JTester(jargs, jm, JEDM.from_config(jargs, cqt_hpf=jm.apply_hpf_DC))
    jt.set_variables(jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, v["buffers"]))
    tm = TModel.from_config(targs)
    tt = TTester(targs, tm, TEDM.from_config(targs, cqt_hpf=tm.apply_hpf_DC),
                 device="cpu")
    tt.set_variables(params, v["buffers"])
    return jt, tt


def _observation(rng):
    """Low-passed noise: the parametric filter at fc 800 Hz, -30 dB/oct."""
    x = (0.05 * rng.standard_normal((1, L))).astype(np.float32)
    f = jnp.asarray(jstft.rfftfreq(512, 22050.0))
    H = jfilt.design_filter(jnp.asarray([800.0]), jnp.asarray([-30.0]), f)
    return np.array(jstft.apply_filter(jnp.asarray(x), H, 512))


def test_edm_schedules_match(testers):
    jt, tt = testers
    for T in (3, 35):
        _close(tt.edm.create_schedule(T).numpy(),
               jt.edm.create_schedule(T), 1e-6)
        t = tt.edm.create_schedule_from_initial_t(0.2, T)
        _close(t.numpy(), jt.edm.create_schedule_from_initial_t(0.2, T),
               1e-6)
        _close(tt.edm.get_gamma(t).numpy(),
               jt.edm.get_gamma(jnp.asarray(t.numpy())), 1e-6)


def test_unconditional_trajectory_matches(testers, rng):
    """Heun, order 2, T=3 (5 network evaluations), Schurn=0."""
    jt, tt = testers
    x0 = (0.3 * rng.standard_normal((1, L))).astype(np.float32)
    js = jt.sampler()
    ref = jax.jit(lambda x: js.predict_unconditional(
        jax.random.PRNGKey(1), (1, L), x_init=x))(jnp.asarray(x0))
    out = tt.sampler().predict_unconditional(None, (1, L),
                                             x_init=torch.as_tensor(x0))
    _close(out.numpy(), ref, 1e-3)


def test_fit_params_matches(testers, rng):
    jt, tt = testers
    js, ts = jt.sampler(), tt.sampler()
    shape = (1, 257, 10)
    X = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    f = np.linspace(1.0, 0.05, 257)[None, :, None]
    Y = X * f * (1 + 0.1 * rng.standard_normal(shape))
    X, Y = X.astype(np.complex64), Y.astype(np.complex64)
    p0 = np.asarray([[300.0, 500.0], [-20.0, -30.0]], np.float32)
    ref = jax.jit(js.fit_params)(jnp.asarray(X), jnp.asarray(Y),
                                 jnp.asarray(p0))
    out = ts.fit_params(torch.as_tensor(X), torch.as_tensor(Y),
                        torch.as_tensor(p0))
    ref = np.asarray(ref)
    _close(out[0].numpy(), ref[0], 1e-3)
    _close(out[1].numpy(), ref[1], 1e-3)


def _jax_warm_start(jt, key, y):
    """The JAX sampler's first draw: y + N(0,1) * t[0]."""
    _, k0 = jax.random.split(key)
    t = jt.edm.create_schedule_from_initial_t(jt.scfg.start_sigma,
                                              jt.scfg.T)
    return np.array(y + jax.random.normal(k0, y.shape) * t[0])


def test_blind_bwe_matches(testers, rng):
    """predict_blind_bwe at T=3 with max_iter 4: the restored signal and the
    estimated filter parameters."""
    jt, tt = testers
    y = _observation(rng)
    key = jax.random.PRNGKey(5)
    x0 = _jax_warm_start(jt, key, jnp.asarray(y))
    js = jt.sampler()
    rx, rp = jax.jit(lambda k, yy: js.predict_blind_bwe(k, yy))(
        key, jnp.asarray(y))
    x, p = tt.sampler().predict_blind_bwe(None, torch.as_tensor(y),
                                          x_init=torch.as_tensor(x0))
    rp = np.asarray(rp)
    assert not np.allclose(rp, tt.blind_cfg.initial_params().numpy())
    _close(p[0].numpy(), rp[0], 1e-3)  # fc, Hz
    _close(p[1].numpy(), rp[1], 1e-3)  # A, dB/octave
    _close(x.numpy(), rx, 1e-3)
    assert np.isfinite(x.numpy()).all()


def test_informed_bwe_matches(testers, rng):
    jt, tt = testers
    y = _observation(rng)
    key = jax.random.PRNGKey(6)
    x0 = _jax_warm_start(jt, key, jnp.asarray(y))
    filt = np.asarray([[800.0], [-30.0]], np.float32)
    js = jt.sampler()
    deg = lambda xx: js.degradation_fcA(xx, jnp.asarray(filt))  # noqa: E731
    ref = jax.jit(lambda k, yy, xi: js.predict_conditional(
        k, yy, deg, x_init=xi))(key, jnp.asarray(y), jnp.asarray(x0))
    out = tt.sampler().predict_bwe(None, torch.as_tensor(y), filt, "fc_A",
                                   x_init=torch.as_tensor(x0))
    _close(out.numpy(), ref, 1e-3)


def test_design_filter_and_stft_filter_match(rng):
    f = jstft.rfftfreq(512, 22050.0)
    fc = np.asarray([300.0, 900.0, 2500.0], np.float32)
    A = np.asarray([-10.0, -25.0, -40.0], np.float32)
    wts = rng.standard_normal(f.shape).astype(np.float32)

    def jl(fc_, A_):
        return jnp.sum(wts * jfilt.design_filter(fc_, A_, jnp.asarray(f)))

    fct = torch.as_tensor(fc).requires_grad_(True)
    At = torch.as_tensor(A).requires_grad_(True)
    H = tfilt.design_filter(fct, At, torch.as_tensor(f))
    _close(H.detach().numpy(),
           jfilt.design_filter(jnp.asarray(fc), jnp.asarray(A),
                               jnp.asarray(f)), 1e-5)
    gfc, gA = torch.autograd.grad((torch.as_tensor(wts) * H).sum(),
                                  (fct, At))
    rfc, rA = jax.grad(jl, argnums=(0, 1))(jnp.asarray(fc), jnp.asarray(A))
    _close(gfc.numpy(), rfc, 1e-4)
    _close(gA.numpy(), rA, 1e-4)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    _close(tstft.apply_filter(torch.as_tensor(x), H.detach(), 512).numpy(),
           jstft.apply_filter(jnp.asarray(x), jnp.asarray(H.detach().numpy()),
                              512), 1e-5)
