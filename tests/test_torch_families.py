"""The diffusion families and training options of the port beyond plain EDM
against the JAX package, on the CPU: the A-weighting FIR and the
A-weighted loss, EDMEps (its conversions, eps denoiser and DDIM reverse
process), EDMPD (boundaries, ODE step, distillation loss, distilled
sampler, and a trainer step with a teacher), ``remat_policy=save_convs``,
the trainer's heavy-logging demos and the blind sampler's
``sigma_den_estimate``.

Both packages get the same numpy-seeded inputs, weights bridged from the
JAX ``init`` (reseeded so the 1e-7-initialised gates carry signal) and the
same draws: the port through its ``j``/``noise``/``z_init``/``den_noise``
arguments, the JAX side through its own keys replayed or its draws
replaced on the instance.

Tolerances: taps at 1e-6 and conversions at 1e-6 relative (float32); the
A-weighted loss at 1e-5 relative; network paths (eps denoiser, DDIM, PD
loss and sampler) at ``test_torch_model.py``'s 2e-4 relative to the largest
value; the trainer step at ``test_torch_train.py``'s (params and EMA 1e-5,
Adam's moments 2e-3); the guided evaluation at ``test_torch_sampling.py``'s
1e-3; ``save_convs`` gradients at 1e-6 of ``full``'s and no remat's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.diffusion.edm import EDM as JEDM
from babe_tpu.diffusion.edm_eps import EDMEps as JEps
from babe_tpu.diffusion.edm_pd import EDMPD as JPD
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu.ops import aweighting as jaw
from babe_tpu.testers.tester import Tester as JTester
from babe_tpu.training.trainer import TrainState, make_optimizer
from babe_tpu.training.trainer import make_train_step
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.data.wavio import write_wav
from babe_tpu_torch.diffusion.edm import EDM as TEDM
from babe_tpu_torch.diffusion.edm_eps import EDMEps as TEps
from babe_tpu_torch.diffusion.edm_pd import EDMPD as TPD
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.ops import aweighting as taw
from babe_tpu_torch.ops import conv_kernels as ck
from babe_tpu_torch.setup import setup_diff_parameters
from babe_tpu_torch.testers.tester import Tester as TTester
from babe_tpu_torch.train import main as train_main
from babe_tpu_torch.training.trainer import Trainer as TTrainer
from babe_tpu_torch.utils.weights import load_flax, to_flax

L = 4096
TOL = 2e-4
NET = ["network.Ns=[8,8,16]", "network.num_dils=[1,1,2]",
       "network.emb_dim=32", "network.attention_layers=[0,0,0,0]",
       "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8"]
TINY = [f"exp.audio_len={L}", "exp.use_bf16=false", "exp.remat=false"] + NET


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
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
def nets():
    """The tiny network in both packages with two sets of reseeded weights
    (a student and a teacher): (jax model, [jax variables], port models)."""
    args = tconfig(TINY)
    jm = JModel.from_config(jconfig(TINY))
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), batch=1))
    jvs, tms = [], []
    for seed in (1, 2):
        p = _reseed(v["params"], np.random.default_rng(seed))
        jvs.append(jax.tree.map(jnp.asarray,
                                {"params": p, "buffers": v["buffers"]}))
        tm = TModel.from_config(args).init(seed=0, device="cpu")
        load_flax(tm.net, p, v["buffers"])
        tm.net.requires_grad_(False)
        tms.append(tm)
    return jm, jvs, tms


def _jnet(jm, jv):
    return lambda x, cn: jm.apply(jv, x, cn)


# ------------------------------------------------------------ A-weighting


@pytest.mark.parametrize("fs", [16000.0, 22050.0, 44100.0])
def test_aweighting_taps_match_jax(fs):
    got, want = taw.aweighting_fir(fs, 101), jaw.aweighting_fir(fs, 101)
    assert got.shape == (101,) and got.dtype == np.float32
    _close(got, want, 1e-6)
    np.testing.assert_array_equal(taw.hp_fir(0.9), jaw.hp_fir(0.9))
    np.testing.assert_array_equal(taw.fd_fir(0.9), jaw.fd_fir(0.9))


def test_aweighted_loss_matches_jax():
    """diff_params=edm_aweighting: the loss with the DC correction, then
    the FIR, on fixed sigma and noise (a cheap affine net)."""
    ov = TINY + ["diff_params=edm_aweighting"]
    targs, jargs = tconfig(ov), jconfig(ov)
    tm, jm = TModel.from_config(targs), JModel.from_config(jargs)
    tedm = setup_diff_parameters(targs, cqt_hpf=tm.apply_hpf_DC)
    jedm = JEDM.from_config(jargs, cqt_hpf=jm.apply_hpf_DC)
    assert type(tedm) is TEDM and tedm.use_aweighting
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((3, L))).astype(np.float32)
    sigma = np.asarray([[0.01], [0.3], [2.0]], np.float32)
    noise = (rng.standard_normal((3, L)) * sigma).astype(np.float32)
    jedm.sample_ptrain_safe = lambda key, n: jnp.asarray(sigma[:, 0])
    jedm.sample_prior = lambda key, shape, s: jnp.asarray(noise)
    net = lambda xx, cn: 0.5 * xx + cn  # noqa: E731
    for dc in (False, True):
        e2, _ = tedm.loss_fn(None, net, torch.as_tensor(x), dc,
                             sigma=torch.as_tensor(sigma),
                             noise=torch.as_tensor(noise))
        je2, _ = jedm.loss_fn(jax.random.PRNGKey(0), net, jnp.asarray(x),
                              use_cqt_DC_correction=dc)
        _close(e2.numpy(), je2, 1e-5)


# ------------------------------------------------------------------ EDMEps


def _eps_pair(T=4):
    ov = TINY + ["diff_params=edm_eps", f"diff_params.T={T}"]
    targs, jargs = tconfig(ov), jconfig(ov)
    te = setup_diff_parameters(targs)
    je = JEps.from_config(jargs)
    assert type(te) is TEps and te.T == je.T == T
    return te, je


def test_eps_conversions_match_jax():
    te, je = _eps_pair()
    t = np.linspace(-0.2, 1.2, 57).astype(np.float32)
    sig = np.geomspace(1e-4, 10.0, 41).astype(np.float32)
    g = np.linspace(-14.0, 6.0, 61).astype(np.float32)
    tt, ts, tg = (torch.as_tensor(v) for v in (t, sig, g))
    jt, js, jg = (jnp.asarray(v) for v in (t, sig, g))
    for got, want in (
            (te.logsnr_linear(tt), je.logsnr_linear(jt)),
            (te.gamma_2_as(tg), je.gamma_2_as(jg)),
            (te.gamma2logas(tg), je.gamma2logas(jg)),
            ((te.gamma_to_t(tg),), (je.gamma_to_t(jg),)),
            ((te.t_to_gamma(tt),), (je.t_to_gamma(jt),)),
            ((te.gamma_to_sigma(tg),), (je.gamma_to_sigma(jg),)),
            ((te.sigma_to_gamma(ts),), (je.sigma_to_gamma(js),)),
            ((te.sigma_to_t(ts),), (je.sigma_to_t(js),))):
        for a, b in zip(got, want):
            _close(a.numpy(), b, 1e-6)


def test_eps_denoiser_and_ddim_match_jax(nets):
    """The eps denoiser at three sigmas, and a T = 4 DDIM run from the same
    initial noise, on the tiny network."""
    jm, jvs, tms = nets
    te, je = _eps_pair(T=4)
    jnet, tnet = _jnet(jm, jvs[0]), tms[0].apply
    rng = np.random.default_rng(4)
    x = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    sigma = np.asarray([[0.05], [1.5]], np.float32)
    got = te.denoiser(torch.as_tensor(x), tnet, torch.as_tensor(sigma))
    _close(got.numpy(), je.denoiser(jnp.asarray(x), jnet,
                                    jnp.asarray(sigma)), TOL)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda k: je.reverse_process_ddim(k, (1, L), jnet))(key)
    z0 = np.array(jax.random.normal(key, (1, L)))
    got = te.reverse_process_ddim(None, (1, L), tnet,
                                  z_init=torch.as_tensor(z0))
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), want, TOL)


# ------------------------------------------------------------------- EDMPD


def _pd_pair(bT):
    ov = TINY + ["diff_params=edm_PD", f"diff_params.PD.boundaries.T={bT}"]
    targs, jargs = tconfig(ov), jconfig(ov)
    tm, jm = TModel.from_config(targs), JModel.from_config(jargs)
    tp = setup_diff_parameters(targs, cqt_hpf=tm.apply_hpf_DC)
    jp = JPD.from_config(jargs, cqt_hpf=jm.apply_hpf_DC)
    assert type(tp) is TPD
    _close(tp.boundaries.numpy(), jp.boundaries, 1e-6)
    return tp, jp


@pytest.mark.parametrize("bT,stage", [(8, 0), (8, 1), (2, 0)])
def test_pd_ode_update_and_loss_match_jax(nets, bT, stage, monkeypatch):
    """ode_update, and loss_fn_PD with the same step pairs j and noise
    (boundaries.T = 2: the three-boundary branch)."""
    jm, jvs, tms = nets
    tp, jp = _pd_pair(bT)
    rng = np.random.default_rng(6 + stage)
    x = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    sched = np.asarray(jp.boundaries)[::2**stage][::-1]
    n = sched.shape[0]
    j = np.asarray([[1], [max(1, n // 2 - 1)]], np.int32)
    i = (2 * j + 1) if n > 3 else np.full((2, 1), 2)
    noise = (rng.standard_normal((2, L)) * sched[i]).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(j))
    jp.sample_prior = lambda key, shape, s: jnp.asarray(noise)
    student, teacher = (_jnet(jm, jvs[0]), _jnet(jm, jvs[1]))
    je2, jsig = jp.loss_fn_PD(jax.random.PRNGKey(0), student, teacher,
                              jnp.asarray(x), stage)
    te2, tsig = tp.loss_fn_PD(None, tms[0].apply, tms[1].apply,
                              torch.as_tensor(x), stage,
                              j=torch.as_tensor(j), noise=torch.as_tensor(
                                  noise))
    _close(tsig.numpy(), jsig, 1e-6)
    _close(te2.numpy(), je2, TOL)
    z = torch.as_tensor(x + noise)
    s0, s1 = float(sched[i[0, 0]]), float(sched[i[0, 0] - 1])
    _close(tp.ode_update(z, s1, s0, tms[1].apply).numpy(),
           jp.ode_update(jnp.asarray(z.numpy()), s1, s0, teacher), TOL)


def test_pd_sample_matches_jax(nets):
    jm, jvs, tms = nets
    tp, jp = _pd_pair(2)
    key = jax.random.PRNGKey(7)
    want = jp.PD_sample(key, 1, L, _jnet(jm, jvs[0]), stage=0)
    z0 = np.array(jax.random.normal(key, (1, L)))
    got = tp.PD_sample(None, 1, L, tms[0].apply, stage=0,
                       z_init=torch.as_tensor(z0))
    _close(got.numpy(), want, TOL)


TRAIN = TINY + ["diff_params=edm_PD", "diff_params.PD.boundaries.T=8",
                "exp.batch=2", "exp.seed=3", "exp.resume=false",
                "exp.lr=1e-3", "exp.lr_rampup_it=1", "exp.ema_rate=0.999",
                "exp.ema_rampup=8", "tester.do_test=false",
                "logging.num_sigma_bins=6"]


def test_pd_trainer_step_matches_jax(nets, tmp_path, monkeypatch):
    """One trainer step with a teacher against the JAX train step with
    teacher_apply, on the same weights and draws: the loss, the gradient
    norm, params, EMA and Adam's moments (the first update runs at
    learning rate 0, the schedule's count before its increment, so the
    moments carry the step's gradients)."""
    jm, jvs, tms = nets
    args = tconfig([f"model_dir={tmp_path}"] + TRAIN)
    m = TModel.from_config(args)
    tr = TTrainer(args, None, m, setup_diff_parameters(
        args, cqt_hpf=m.apply_hpf_DC), device="cpu", teacher=tms[1])
    load_flax(tr.net, jax.tree.map(np.asarray, jvs[0]["params"]),
              jvs[0]["buffers"])
    for k, p in tr.params.items():
        tr.ema[k].copy_(p.detach())
    rng = np.random.default_rng(8)
    x = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    j = np.asarray([[2], [3]], np.int32)
    sched = np.asarray(tr.edm.boundaries)[::-1]
    noise = (rng.standard_normal((2, L)) * sched[2 * j + 1]).astype(
        np.float32)
    met = tr.train_step(x, noise=torch.as_tensor(noise),
                        j=torch.as_tensor(j))

    jargs = jconfig([f"model_dir={tmp_path}"] + TRAIN)
    jedm = JPD.from_config(jargs, cqt_hpf=jm.apply_hpf_DC)
    jedm.sample_prior = lambda key, shape, s: jnp.asarray(noise)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(j))
    opt = make_optimizer(jargs.exp)
    step = jax.jit(make_train_step(jm, jedm, opt, jargs.exp, 6,
                                   teacher_apply=_jnet(jm, jvs[1])))
    params = jvs[0]["params"]
    st = TrainState(params=params, buffers=jvs[0]["buffers"],
                    opt_state=opt.init(params), ema=params,
                    it=jnp.asarray(0, jnp.int32))
    st, jmet = step(st, jnp.asarray(x), jax.random.PRNGKey(0))
    assert tr.it == int(st.it) == 1 and not met["nonfinite"]
    _close(float(met["loss"]), float(jmet["loss"]), 1e-5)
    _close(float(met["grad_norm"]), float(jmet["grad_norm"]), 2e-3)

    def flat(tree):
        return {".".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}

    adam = st.opt_state[-1][0]
    want = {"params": flat(st.params), "ema": flat(st.ema),
            "mu": flat(adam.mu), "nu": flat(adam.nu)}
    got = {"params": {k: p.detach() for k, p in tr.params.items()},
           "ema": tr.ema, "mu": tr.mu, "nu": tr.nu}
    tol = {"params": 1e-5, "ema": 1e-5, "mu": 2e-3, "nu": 2e-3}
    for what in want:
        assert set(got[what]) == set(want[what])
        for k, v in got[what].items():
            _close(v.numpy(), want[what][k], tol[what])
    assert max(float(v.abs().max()) for v in tr.mu.values()) > 0


def test_a_teacher_needs_pd_diff_params(nets, tmp_path):
    args = tconfig([f"model_dir={tmp_path}"] + TINY)
    m = TModel.from_config(args)
    with pytest.raises(ValueError, match="EDMPD"):
        TTrainer(args, None, m, TEDM.from_config(args), device="cpu",
                 teacher=nets[2][1])


# -------------------------------------------------------------- save_convs


def test_save_convs_gradients_and_no_second_conv_forward(monkeypatch):
    """One training loss's gradients under remat_policy=save_convs equal
    those of "full" and of no remat, and the recompute runs no Conv2d's
    conv again (each conv's computation counted; the blocks' Conv2d calls
    counted by forward hooks) and no fused stage's forward again (each
    stage's forward counted: once a stage in a step, not twice)."""
    from babe_tpu_torch.models.blocks import Conv2d, ResnetBlock

    ov = TINY + ["network.attention_layers=[0,1,1,1]",
                 "network.attention_dict.num_heads=2",
                 "network.attention_dict.rel_pos_num_buckets=8",
                 "network.attention_dict.rel_pos_max_distance=16"]
    args = tconfig(ov)
    m = TModel.from_config(args).init(seed=0, device="cpu")
    p, b = to_flax(m.net)
    load_flax(m.net, _reseed(p, np.random.default_rng(9)), b)
    edm = TEDM.from_config(args, cqt_hpf=m.apply_hpf_DC)
    rng = np.random.default_rng(10)
    x = torch.as_tensor((0.1 * rng.standard_normal((2, L))).astype(
        np.float32))
    sigma = torch.tensor([[0.05], [0.8]])
    noise = torch.as_tensor(rng.standard_normal((2, L)).astype(
        np.float32)) * sigma
    computed, called = [0], [0]
    orig = ck._taped

    def counting(compute):
        def run():
            computed[0] += 1
            return compute()
        return orig(run)

    monkeypatch.setattr(ck, "_taped", counting)
    stage_fwd, orig_parts = [0], ck._dil_stage_parts

    def counting_parts(*a):
        stage_fwd[0] += 1
        return orig_parts(*a)

    monkeypatch.setattr(ck, "_dil_stage_parts", counting_parts)
    n_stages = sum(blk.num_dils for blk in m.net.modules()
                   if isinstance(blk, ResnetBlock) and blk.fused)
    in_blocks = [c for blk in m.net.modules() if isinstance(blk, ResnetBlock)
                 for c in blk.modules() if isinstance(c, Conv2d)]
    for c in in_blocks:
        c.register_forward_hook(lambda *a: called.__setitem__(
            0, called[0] + 1))
    n_outside = sum(isinstance(c, Conv2d) for c in m.net.modules()) - len(
        in_blocks)
    grads, counts = {}, {}
    for remat, policy in ((False, "full"), (True, "full"),
                          (True, "save_convs")):
        m.net.remat, m.net.remat_policy = remat, policy
        m.net.zero_grad(set_to_none=True)
        computed[0] = called[0] = stage_fwd[0] = 0
        e2, _ = edm.loss_fn(None, m.apply, x, True, sigma=sigma, noise=noise)
        e2.mean().backward()
        grads[remat, policy] = {k: q.grad.clone()
                                for k, q in m.net.named_parameters()}
        counts[remat, policy] = (computed[0], called[0], stage_fwd[0])
    # the fused (5,3) stacks call no Conv2d (their stages read the
    # kernels); the other Conv2d of the blocks run once a forward
    n = counts[False, "full"][1]
    assert 0 < n < len(in_blocks) and n_outside == 3
    assert counts[False, "full"] == (n + n_outside, n, n_stages)
    # the recompute calls the blocks' Conv2d again (each block's recompute
    # stops once it has what its backward needs, so a block's last Conv2d
    # may not return to its hook); under "full" each computes its conv
    # again, under "save_convs" none does
    assert counts[True, "full"][0] == 2 * n + n_outside
    assert counts[True, "save_convs"][0] == n + n_outside
    assert counts[True, "save_convs"][1] > n
    # the fused stages: "full" runs each stage's forward again in the
    # recompute, "save_convs" forms y from the kept conv output
    assert n_stages > 0
    assert counts[True, "full"][2] == 2 * n_stages
    assert counts[True, "save_convs"][2] == n_stages
    ref = grads[False, "full"]
    for key in ((True, "full"), (True, "save_convs")):
        for k, g in grads[key].items():
            _close(g.numpy(), ref[k].numpy(), 1e-6)


# ------------------------------------------------------------ the CLIs


@pytest.mark.parametrize("family", ["edm_aweighting", "edm_eps", "edm_PD"])
def test_families_train_and_serve_through_the_clis(family, tmp_path):
    """``python -m babe_tpu_torch.train`` one step with each family (PD
    with a teacher .ckpt the trainer's save_checkpoint wrote from a seeded
    init), then ``python -m babe_tpu_torch.test`` unconditional on the
    written checkpoint: the family's class on both sides, a finite wav."""
    from babe_tpu_torch import test as tcli
    from babe_tpu_torch.data.wavio import read_wav

    rng = np.random.default_rng(14)
    wav = tmp_path / "wavs"
    wav.mkdir()
    write_wav(str(wav / "w.wav"),
              0.1 * rng.standard_normal(20000).astype(np.float32), 44100)
    exp = tmp_path / "exp"
    ov = [f"diff_params={family}", "exp.audio_len=4096", "exp.batch=2",
          "exp.resume=false"] + NET
    extra = []
    if family == "edm_PD":
        targs = tconfig([f"model_dir={tmp_path / 'teacher'}"] + TINY)
        m = TModel.from_config(targs)
        ckpt = TTrainer(targs, None, m, TEDM.from_config(targs),
                        device="cpu").save_checkpoint()
        extra = [f"diff_params.PD.teacher_checkpoint={ckpt}"]
    tr = train_main(["device=cpu", f"model_dir={exp}", "dset=musicnet",
                     f"dset.path={wav}", "exp.total_its=1",
                     "logging.log_interval=1", "tester.do_test=false"]
                    + ov + extra)
    want = {"edm_aweighting": TEDM, "edm_eps": TEps, "edm_PD": TPD}[family]
    assert type(tr.edm) is want and tr.it == 1
    assert (tr.teacher is not None) == (family == "edm_PD")
    targs = tconfig([f"model_dir={exp}", "tester=only_uncond",
                     "tester.checkpoint=22k_8s-1.ckpt", "tester.T=2",
                     "tester.unconditional.num_samples=1",
                     "tester.unconditional.audio_len=4096"] + ov)
    tcli._main(targs, device="cpu", overrides=[])
    out = exp / "outputs" / "unconditional"
    files = sorted(os.listdir(out))
    assert files, "no unconditional wav"
    audio, _ = read_wav(str(out / files[0]))
    assert np.isfinite(audio).all()


# ----------------------------------------------------------- heavy logging


def test_heavy_logging_demos_leave_the_training_draws(tmp_path):
    """``python -m babe_tpu_torch.train`` for 2 steps with a demo after
    each (strict): the spectrogram PNGs are written, and the params and EMA
    equal those of the same run without demos."""
    rng = np.random.default_rng(11)
    wav = tmp_path / "wavs"
    wav.mkdir()
    for i in range(2):
        write_wav(str(wav / f"w{i}.wav"),
                  0.1 * rng.standard_normal(20000).astype(np.float32), 44100)
    base = ["device=cpu", "dset=musicnet", f"dset.path={wav}",
            f"dset.test.path={tmp_path / 'none'}", "exp.audio_len=4096",
            "exp.batch=2", "exp.total_its=2", "exp.resume=false",
            "logging.log_interval=1", "logging.save_model=false",
            "logging.heavy_log_interval=1", "logging.strict_demos=true",
            "tester.T=3", "tester.unconditional.num_samples=1",
            "tester.unconditional.audio_len=4096",
            "tester.modes=[blind_bwe,inpainting,bwe]"] + NET
    runs = []
    for demos in (True, False):
        d = tmp_path / f"exp_{demos}"
        runs.append(train_main(base + [f"model_dir={d}",
                                       f"tester.do_test={str(demos).lower()}"]))
        pngs = sorted(os.listdir(d / "train_logs"))
        want = ["uncond_spec_it1.png", "uncond_spec_it2.png"]
        assert all(f in pngs for f in want) == demos, pngs
    with_demos, without = runs
    assert with_demos.tester is not None and without.tester is None
    assert with_demos.tester.it == 2
    for k in with_demos.params:
        assert torch.equal(with_demos.params[k], without.params[k]), k
        assert torch.equal(with_demos.ema[k], without.ema[k]), k


# ------------------------------------------------------- sigma_den_estimate


def test_sigma_den_estimate_guided_evaluation_matches_jax(nets, tmp_path):
    """blind_bwe.sigma_den_estimate = 0.01: the first guided evaluation of
    the JAX blind sampler (its score, filter and denoised estimate, under
    rid) against the port's ``_stage`` on the same start and on the noise
    the JAX key stream drew for the fit."""
    jm, jvs, tms = nets
    ov = TINY + [f"model_dir={tmp_path}", "tester.blind_bwe.NFFT=512",
                 "tester.blind_bwe.optimization.max_iter=4",
                 "tester.blind_bwe.initial_conditions.fc=[300,500]",
                 "tester.blind_bwe.initial_conditions.A=[-20,-30]",
                 "tester.diff_params.Schurn=0", "tester.T=2",
                 "tester.blind_bwe.sigma_den_estimate=0.01"]
    jargs, targs = jconfig(ov), tconfig(ov)
    jt = JTester(jargs, jm, JEDM.from_config(jargs, cqt_hpf=jm.apply_hpf_DC))
    jt.set_variables(jvs[0]["params"], jvs[0]["buffers"])
    tt = TTester(targs, tms[0], TEDM.from_config(
        targs, cqt_hpf=tms[0].apply_hpf_DC), device="cpu")
    tt.set_variables(*to_flax(tms[0].net))
    assert tt.blind_cfg.sigma_den_estimate == 0.01
    rng = np.random.default_rng(12)
    y = (0.05 * rng.standard_normal((1, L))).astype(np.float32)
    key = jax.random.PRNGKey(13)
    js = jt.sampler()
    _, _, dens, t, filts, scores = jax.jit(
        lambda k, yy: js.predict_blind_bwe(k, yy, rid=True))(
            key, jnp.asarray(y))
    # the key stream: the start, then per half step the time move's draw,
    # then the stage's draw for the fit's noise
    key, k0 = jax.random.split(key)
    x0 = np.asarray(jnp.asarray(y) + jax.random.normal(k0, y.shape) * t[0])
    key, _ = jax.random.split(key)
    _, kn = jax.random.split(key)
    den_noise = np.array(jax.random.normal(kn, y.shape))
    ts = tt.sampler()
    yt = torch.as_tensor(y)
    from babe_tpu_torch.ops.stft import apply_stft
    sc, params, x_den = ts._stage(
        torch.as_tensor(x0), float(t[0]),
        tt.blind_cfg.initial_params(), yt, apply_stft(yt, 512), None,
        den_noise=torch.as_tensor(den_noise))
    filt0 = np.asarray(filts[0])
    assert not np.allclose(filt0, tt.blind_cfg.initial_params().numpy())
    _close(params.numpy(), filt0, 1e-3)
    _close(x_den.numpy(), dens[0], 1e-3)
    _close(sc.numpy(), scores[0], 1e-3)
