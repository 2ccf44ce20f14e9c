"""Training in the port (``babe_tpu_torch.training``, ``python -m
babe_tpu_torch.train``) against the JAX package, on the CPU.

Both packages read the same ``conf/`` YAMLs with the same overrides.  JAX's
random draws (training sigmas, noise) differ from torch's, so where a step
is compared both sides get the same sigma and noise from numpy: the port
through ``train_step``/``loss_fn`` arguments, the JAX EDM through its
``sample_ptrain_safe``/``sample_prior`` replaced on the instance.  Weights
cross through the weight bridge; the gates are opened (every weight drawn
at O(1/sqrt(fan_in))), since the EDM init's 1e-7 gates would leave the
dilated convs' weight gradients at ~0 and any dw would pass.

Tolerances: losses at 1e-5 relative; gradients per parameter at 2e-3 of
that parameter's largest gradient, and at 1e-6 of the largest gradient of
the whole model for parameters whose gradients are that small (fp32 sums
over 4096-sample segments, taken in other orders on each side); Adam's
moments at 1e-6 relative (the same fp32 operations in the same order), the
params and the EMA after three updates at 2e-5 (see the test); a resumed
step's params and EMA at 1e-5 and its moments at the gradients' 2e-3 (the
step's gradients differ as above); the
same-device determinism and remat checks exactly or at 1e-6."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.data import datasets as jds
from babe_tpu.diffusion.edm import EDM as JEDM
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu.ops import resample as jrs
from babe_tpu.parallel.mesh import make_mesh
from babe_tpu.testers.tester import Tester as JTester
from babe_tpu.training.trainer import Trainer as JTrainer
from babe_tpu.training.trainer import make_optimizer
from babe_tpu_torch.api import BABE
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.data import datasets as tds
from babe_tpu_torch.data.wavio import write_wav
from babe_tpu_torch.diffusion.edm import EDM as TEDM
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.ops import resample as trs
from babe_tpu_torch.train import main as train_main
from babe_tpu_torch.training.trainer import Trainer as TTrainer
from babe_tpu_torch.utils.weights import from_flax, load_flax, to_flax

L = 4096
NET = ["network.Ns=[8,8,16]", "network.num_dils=[1,1,2]",
       "network.emb_dim=32", "network.attention_layers=[0,0,0,0]",
       "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8"]
TINY = [f"exp.audio_len={L}", "exp.use_bf16=false", "exp.remat=false",
        "exp.resample_factor=1", "exp.batch=2", "exp.seed=3",
        "exp.resume=false", "exp.lr=1e-3", "exp.lr_rampup_it=2",
        "exp.ema_rate=0.999", "exp.ema_rampup=8", "exp.exp_name=tiny",
        "tester.do_test=false", "logging.log_interval=1",
        "logging.freq_cqt_logging=0", "logging.save_model=false",
        "logging.num_sigma_bins=6"] + NET


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
    """O(1/sqrt(fan_in)) weights for every leaf (gates opened), GroupNorm
    gains around 1."""
    def leaf(path, v):
        v = np.asarray(v)
        if "gamma" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        fan = int(np.prod(v.shape[:-1])) if v.ndim > 1 else 1
        return (rng.standard_normal(v.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _fixed_draws(jedm, sigma, noise):
    """The JAX EDM with its training draws replaced by the given sigma
    [N,1] and noise [N,T] (already scaled by sigma)."""
    jedm.sample_ptrain_safe = lambda key, n: jnp.asarray(sigma[:, 0])
    jedm.sample_prior = lambda key, shape, s: jnp.asarray(noise)
    return jedm


def _draws(rng, n, T=L):
    sigma = np.exp(rng.uniform(np.log(1e-3), np.log(1.0), (n, 1))).astype(
        np.float32)
    noise = (rng.standard_normal((n, T)) * sigma).astype(np.float32)
    x = (0.1 * rng.standard_normal((n, T))).astype(np.float32)
    return x, sigma, noise


def _grad_map(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _hold_grads(port_net, jgrads):
    """Every parameter's gradient against JAX's (see the module doc)."""
    ref = _grad_map(jgrads)
    grads = {k: p.grad.numpy() for k, p in port_net.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(np.abs(v).max()) for v in ref.values())
    for k, g in grads.items():
        scale = max(float(np.abs(ref[k]).max()), 1e-6 / 2e-3 * top)
        err = float(np.abs(g - ref[k]).max())
        assert err <= 2e-3 * scale, (k, err, scale)


def _models(overrides, seed):
    """Both packages' model from one config, with the same opened weights
    (drawn by the port's seeded init, reseeded with numpy)."""
    targs = tconfig(overrides)
    tm = TModel.from_config(targs).init(seed=0, device="cpu")
    p, b = to_flax(tm.net)
    p = _reseed(p, np.random.default_rng(seed))
    load_flax(tm.net, p, b)
    return targs, tm, JModel.from_config(jconfig(overrides)), {
        "params": p, "buffers": b}


@pytest.mark.parametrize("which", ["tiny", "flagship widths"])
def test_loss_and_every_gradient_match_jax(which):
    """The training loss (with the CQT DC correction) and the gradient of
    every parameter against jax.value_and_grad of the JAX model, at the
    tiny config and at flagship widths (the three deepest levels of the
    flagship network: 128-256-256 channels, 5-6-7 dilations, 64 bins per
    octave) on 4096 samples."""
    ov = [f"exp.audio_len={L}", "exp.use_bf16=false", "exp.remat=false",
          "exp.use_cqt_DC_correction=true"]
    ov += NET if which == "tiny" else [
        "network.Ns=[128,256,256]", "network.num_dils=[5,6,7]",
        "network.cqt.num_octs=3"]
    targs, tm, jm, v = _models(ov, 5)
    x, sigma, noise = _draws(np.random.default_rng(1), 2)
    tedm = TEDM.from_config(targs, cqt_hpf=tm.apply_hpf_DC)
    e2, _ = tedm.loss_fn(None, tm.apply, torch.as_tensor(x), True,
                         sigma=torch.as_tensor(sigma),
                         noise=torch.as_tensor(noise))
    loss = e2.mean()
    loss.backward()
    loss = float(loss.detach())
    jedm = _fixed_draws(JEDM.from_config(jconfig(ov),
                                         cqt_hpf=jm.apply_hpf_DC),
                        sigma, noise)

    def jloss(p):
        net = lambda xx, cn: jm.apply(  # noqa: E731
            {"params": p, "buffers": v["buffers"]}, xx, cn)
        e, _ = jedm.loss_fn(jax.random.PRNGKey(0), net, jnp.asarray(x),
                            use_cqt_DC_correction=True)
        return e.mean()

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(v["params"])
    _close(loss, float(jval), 1e-5)
    _hold_grads(tm.net, jgrads)


def test_edm_training_half_matches_jax(monkeypatch):
    """sample_ptrain_safe and sample_ptrain_lognormal (on the same uniform
    and normal draws), the preconditioning and the loss with the DC
    correction, with sigma and noise passed in."""
    args = tconfig(TINY)
    tm = TModel.from_config(args)
    tedm = TEDM.from_config(args, cqt_hpf=tm.apply_hpf_DC)
    jm = JModel.from_config(jconfig(TINY))
    jedm = JEDM.from_config(jconfig(TINY), cqt_hpf=jm.apply_hpf_DC)
    a = torch.rand(5, generator=torch.Generator().manual_seed(9))
    n = torch.randn(5, generator=torch.Generator().manual_seed(9))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(a.numpy()))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(n.numpy()))
    key = jax.random.PRNGKey(0)
    _close(tedm.sample_ptrain_safe(torch.Generator().manual_seed(9), 5),
           jedm.sample_ptrain_safe(key, 5), 1e-6)
    _close(tedm.sample_ptrain_lognormal(torch.Generator().manual_seed(9), 5),
           jedm.sample_ptrain_lognormal(key, 5), 1e-6)
    monkeypatch.undo()
    x, sigma, noise = _draws(np.random.default_rng(2), 3)
    tx, ts, tn = (torch.as_tensor(v) for v in (x, sigma, noise))
    _fixed_draws(jedm, sigma, noise)
    got = tedm.prepare_train_preconditioning(None, tx, ts, tn)
    want = jedm.prepare_train_preconditioning(key, jnp.asarray(x),
                                              jnp.asarray(sigma))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-6)
    net_t = lambda xx, cn: 0.5 * xx + cn  # noqa: E731
    for dc in (False, True):
        e2, s = tedm.loss_fn(None, net_t, tx, dc, sigma=ts, noise=tn)
        je2, js = jedm.loss_fn(key, net_t, jnp.asarray(x),
                               use_cqt_DC_correction=dc)
        _close(e2.numpy(), je2, 1e-5)
        _close(s.numpy(), np.asarray(js), 0)


@pytest.fixture
def trainer(tmp_path):
    """A port trainer at the tiny config on the CPU."""
    def make(extra=(), dset=None):
        args = tconfig([f"model_dir={tmp_path}"] + TINY + list(extra))
        m = TModel.from_config(args)
        return TTrainer(args, dset, m, TEDM.from_config(
            args, cqt_hpf=m.apply_hpf_DC), device="cpu")
    return make


def _state(tr):
    return ({k: p.detach().clone() for k, p in tr.params.items()},
            {k: v.clone() for k, v in tr.ema.items()},
            {k: v.clone() for k, v in tr.mu.items()},
            {k: v.clone() for k, v in tr.nu.items()},
            (tr.count, tr.sched_count, tr.it))


def test_optimizer_and_ema_match_optax(trainer):
    """Three updates from the same gradients against the JAX trainer's
    optax chain: the first at learning rate 0 (the schedule's count before
    its increment), the clip on the first and third (norm above
    max_grad_norm) and not on the second; the EMA with its warm-up."""
    tr = trainer()
    rng = np.random.default_rng(4)
    params = {k: p.detach().numpy().copy() for k, p in tr.params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = make_optimizer(tr.args.exp)
    st = opt.init(jp)
    update = jax.jit(opt.update)
    ema = dict(jp)
    for step, norm in enumerate((5.0, 0.3, 2.0)):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        tot = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                          for v in g.values()))
        g = {k: (v * (norm / tot)).astype(np.float32) for k, v in g.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        # the same norm on both sides: the update's arithmetic is compared,
        # not two summation orders of the norm
        gn = torch.tensor(float(optax.global_norm(jg)))
        tr._apply_update({k: torch.as_tensor(v) for k, v in g.items()}, gn)
        upd, st = update(jg, st, jp)
        jp = optax.apply_updates(jp, upd)
        t = jnp.float32(step) * tr.batch_size
        s = jnp.where(t < tr.ema_rampup,
                      jnp.clip(t / tr.ema_rampup, 0.0, tr.ema_rate),
                      tr.ema_rate)
        ema = {k: e * s + jp[k] * (1.0 - s) for k, e in ema.items()}
        if step == 0:
            for k, p in tr.params.items():
                np.testing.assert_array_equal(p.detach().numpy(), params[k])
    adam = st[-1][0]
    assert tr.count == int(adam.count) == 3 and tr.it == 3
    assert tr.sched_count == int(st[-1][1].count) == 3
    for k in params:
        # params and EMA at 2e-5: both frameworks' fp32 runs land 1e-5 from
        # a float64 replay (Adam's bias correction 1 - b2^t keeps three
        # digits at t <= 3), each its own way
        _close(tr.params[k].detach().numpy(), jp[k], 2e-5)
        _close(tr.ema[k].numpy(), ema[k], 2e-5)
        _close(tr.mu[k].numpy(), adam.mu[k], 1e-6)
        _close(tr.nu[k].numpy(), adam.nu[k], 1e-6)


def test_nonfinite_step_changes_nothing_and_repeats_halt(trainer):
    tr = trainer(["logging.max_consecutive_nonfinite=2"])
    x, sigma, noise = _draws(np.random.default_rng(5), 2)
    tr.train_step(x, torch.as_tensor(sigma), torch.as_tensor(noise))
    before = _state(tr)
    bad = x.copy()
    bad[0, 7] = np.nan
    m = tr.train_step(bad, torch.as_tensor(sigma), torch.as_tensor(noise))
    assert m["nonfinite"]
    after = _state(tr)
    assert before[4] == after[4]
    for b, a in zip(before[:4], after[:4]):
        for k in b:
            assert torch.equal(b[k], a[k]), k

    def nan_stream():
        while True:
            yield np.full((2, L), np.nan, np.float32)

    tr.dset = nan_stream()
    with pytest.raises(RuntimeError, match="non-finite"):
        tr.training_loop(max_its=10)
    assert tr.it == 1


def test_accumulation_is_the_mean_of_the_rounds(trainer):
    tr = trainer(["exp.num_accumulation_rounds=2"])
    x, sigma, noise = _draws(np.random.default_rng(6), 4)
    tx, ts, tn = (torch.as_tensor(v) for v in (x, sigma, noise))
    loss, grads, e2, sig = tr._grads(tx, ts, tn)
    assert e2.shape == (4, L) and sig.shape == (4, 1)
    tr.num_accum = 1
    parts = [tr._grads(tx[i:i + 2], ts[i:i + 2], tn[i:i + 2])
             for i in (0, 2)]
    _close(float(loss), (float(parts[0][0]) + float(parts[1][0])) / 2, 1e-6)
    for k, g in grads.items():
        _close(g.numpy(), ((parts[0][1][k] + parts[1][1][k]) / 2).numpy(),
               1e-6)


def test_sigma_bins_match_jax(trainer):
    """The sigma-binned loss sums, squares and counts, binned as the JAX
    step bins them (searchsorted on float32 logspace edges)."""
    tr = trainer()
    edm = tr.edm
    x, _, noise = _draws(np.random.default_rng(7), 2)
    for sig in ([[edm.p.sigma_min], [0.05]], [[edm.p.sigma_max], [1e-3]]):
        sigma = np.asarray(sig, np.float32)
        m = tr._step(torch.as_tensor(x), torch.as_tensor(sigma),
                     torch.as_tensor(noise))
        e2, _ = edm.loss_fn(None, tr.model.apply, torch.as_tensor(x),
                            sigma=torch.as_tensor(sigma),
                            noise=torch.as_tensor(noise))
        per = e2.detach().mean(1).numpy()
        edges = jnp.logspace(jnp.log10(edm.p.sigma_min),
                             jnp.log10(edm.p.sigma_max), 6)
        idx = np.asarray(jnp.searchsorted(edges, jnp.asarray(sigma[:, 0])))
        want = np.zeros(7)
        np.add.at(want, idx, 1.0)
        np.testing.assert_array_equal(m["sigma_bin_counts"].numpy(), want)
        sums = np.zeros(7)
        np.add.at(sums, idx, per)
        _close(m["sigma_bin_sums"].numpy(), sums, 1e-4)


def test_remat_gives_the_same_gradients(trainer):
    x, sigma, noise = _draws(np.random.default_rng(8), 2)
    grads = []
    for remat in (False, True):
        tr = trainer([f"exp.remat={str(remat).lower()}"])
        assert tr.net.remat == remat
        _, g, _, _ = tr._grads(*(torch.as_tensor(v)
                                 for v in (x, sigma, noise)))
        grads.append(g)
    for k in grads[0]:
        _close(grads[1][k].numpy(), grads[0][k].numpy(), 1e-6)


def test_same_seed_is_deterministic(trainer):
    """The same exp.seed and data give bit-identical params after two steps
    on the CPU; the same init with another stream of draws does not."""
    x = _draws(np.random.default_rng(9), 2)[0]
    runs = []
    for other_draws in (False, False, True):
        tr = trainer()
        if other_draws:
            tr.gen = torch.Generator().manual_seed(123)
        for _ in range(2):
            tr.train_step(x)
        runs.append(_state(tr)[0])
    a, b, c = runs
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert any(not torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("rates", [(2, 1), (320, 147)])
def test_resample_matches_jax(rates):
    x = np.random.default_rng(10).standard_normal((2, 3000)).astype(
        np.float32)
    _close(trs.resample(torch.as_tensor(x), *rates).numpy(),
           jrs.resample(jnp.asarray(x), *rates), 1e-5)


def test_resample_batch_matches_jax():
    x = np.random.default_rng(11).standard_normal((3, 6000)).astype(
        np.float32)
    fs = np.asarray([44100, 48000, 22050])
    _close(trs.resample_batch(torch.as_tensor(x), fs, 22050, 2500).numpy(),
           jrs.resample_batch(jnp.asarray(x), fs, 22050, 2500), 1e-5)


def test_dataset_crops_match_jax(tmp_path):
    """One seed gives the same files and crops in both packages: the
    dataset classes directly, and setup_dataset's batches (the JAX one on
    its Python path)."""
    rng = np.random.default_rng(12)
    wav = tmp_path / "wavs"
    wav.mkdir()
    for i, n in enumerate((9000, 12000, 15000)):
        write_wav(str(wav / f"w{i}.wav"),
                  0.3 * rng.standard_normal(n).astype(np.float32), 44100)
    ov = ["dset=musicnet", f"dset.path={wav}", "exp.audio_len=1000",
          "exp.resample_factor=2", "exp.batch=3", "dset.native_loader=false"]
    targs, jargs = tconfig(ov), jconfig(ov)
    t_it = iter(tds.AudioFolderDataset(targs.dset, seg_len=2000, seed=7))
    j_it = iter(jds.AudioFolderDataset(jargs.dset, seg_len=2000, seed=7))
    for _ in range(20):
        np.testing.assert_array_equal(next(t_it), next(j_it))
    tb, jb = tds.setup_dataset(targs), jds.setup_dataset(jargs)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(tb), next(jb))
    finally:
        tb.close()
        jb.close()


def _jax_trainer(tmp, overrides, dset, sigma, noise):
    args = jconfig([f"model_dir={tmp}"] + overrides)
    m = JModel.from_config(args)
    edm = _fixed_draws(JEDM.from_config(args, cqt_hpf=m.apply_hpf_DC),
                       sigma, noise)
    return JTrainer(args, dset, m, edm, mesh=make_mesh(1))


def test_checkpoints_cross_packages(trainer, tmp_path):
    """A port .ckpt is read by the JAX tester and by the port's BABE.load
    with the same EMA; the port resumes from a .ckpt the JAX trainer wrote
    (params, EMA, Adam's moments and counts, it) and its next step matches
    the JAX trainer's next step."""
    x, sigma, noise = _draws(np.random.default_rng(13), 2)
    tr = trainer()
    for _ in range(2):
        tr.train_step(x, torch.as_tensor(sigma), torch.as_tensor(noise))
    path = tr.save_checkpoint()
    assert os.path.basename(path) == "tiny-2.ckpt"
    jargs = jconfig(TINY)
    jt = JTester(jargs, JModel.from_config(jargs), JEDM.from_config(jargs))
    jt.load_checkpoint(path)
    ema = _grad_map(jt.variables["params"])
    for k, v in tr.ema.items():
        np.testing.assert_array_equal(ema[k], v.numpy())
    assert jt.it == 2
    b = BABE.load(path, device="cpu")
    for k, p in b._tester.model.net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), tr.ema[k].numpy())

    jdir = tmp_path / "jax"

    def stream():
        while True:
            yield x

    jtr = _jax_trainer(jdir, TINY, stream(), sigma, noise)
    rng = np.random.default_rng(14)
    jtr.state = jtr.state.replace(
        params=_reseed(jtr.state.params, rng))
    for _ in range(2):
        jtr.train_step()
    jtr.save_checkpoint()
    jtr.train_step()
    port = trainer(["exp.resume=true", f"model_dir={jdir}"])
    assert port._resumed and port.it == 2 and port.count == 2
    port.train_step(x, torch.as_tensor(sigma), torch.as_tensor(noise))
    assert port.it == int(jtr.state.it) == 3
    want = {"params": _grad_map(jtr.state.params),
            "ema": _grad_map(jtr.state.ema),
            "mu": _grad_map(jtr.state.opt_state[-1][0].mu),
            "nu": _grad_map(jtr.state.opt_state[-1][0].nu)}
    got = {"params": {k: p.detach() for k, p in port.params.items()},
           "ema": port.ema, "mu": port.mu, "nu": port.nu}
    tol = {"params": 1e-5, "ema": 1e-5, "mu": 2e-3, "nu": 2e-3}
    for what in want:
        for k, v in got[what].items():
            _close(v.numpy(), want[what][k], tol[what])


def test_train_cli_on_the_cpu(tmp_path):
    """``python -m babe_tpu_torch.train`` with the tiny overrides and
    device=cpu: 44.1 kHz wavs resampled by 2, two steps, a checkpoint."""
    rng = np.random.default_rng(15)
    wav = tmp_path / "wavs"
    wav.mkdir()
    for i in range(2):
        write_wav(str(wav / f"w{i}.wav"),
                  0.1 * rng.standard_normal(20000).astype(np.float32), 44100)
    tr = train_main(["device=cpu", f"model_dir={tmp_path / 'exp'}",
                     "dset=musicnet", f"dset.path={wav}", "exp.audio_len=4096",
                     "exp.batch=2", "exp.total_its=2", "exp.resume=false",
                     "tester.do_test=false", "logging.log_interval=1"] + NET)
    assert tr.it == 2
    ckpt = tmp_path / "exp" / "22k_8s-2.ckpt"
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"it", "params", "buffers", "opt_state", "ema",
                            "args"}
    assert all(bool(torch.isfinite(v).all()) for v in from_flax(
        payload["params"]).values())
