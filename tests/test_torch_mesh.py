"""Data parallelism in the port (``babe_tpu_torch/parallel/mesh.py``)
against the JAX package's mesh and against the port's own one-process
runs, on the CPU.

``mesh_for_batch`` raises exactly where the JAX package's does.  Two
processes joined by gloo on 127.0.0.1 (``tests/torch_mesh_worker.py``)
run what one process runs, from the JAX package's seeded
``CQTDiffPlus.init`` (reseeded so that every gate and weight carries a
gradient) carried across by ``utils/weights.py``: two training steps of
the tiny network at batch 4, split 2 + 2, whose draws the trainer makes
for the global batch on every rank, and informed BWE over two tester
items through ``Tester.dodajob``, one item a rank.

Tolerances: the training losses at 1e-6 relative, and the parameters and
EMA after the second step (the first has learning rate 0) at 1e-3 of the
learning rate, absolute.  The two runs differ only in the order of fp32
sums (the batch's halves summed by the all-reduce).  Adam's first update,
lr * g / (|g| + eps), moves under a relative change d of the gradient by
at most lr * d / 4 (at |g| = eps), and the smallest gradients carry the
largest relative rounding: 3.9e-5 of lr was measured, the bar allows
d up to 4e-3.  The informed BWE
item for item bit for bit (one item a sampler run either way), and the
wavs rank 0 writes byte for byte."""

import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu.parallel import mesh as jmesh
from babe_tpu_torch.parallel import mesh as tmesh

L = 4096
LR = 1e-3
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_worker.py")
OVERRIDES = [f"exp.audio_len={L}", "exp.use_bf16=false", "exp.remat=false",
             "exp.resample_factor=1", "exp.batch=4", "exp.seed=3",
             "exp.resume=false", f"exp.lr={LR}", "exp.lr_rampup_it=1",
             "exp.ema_rate=0.999", "exp.ema_rampup=8", "exp.exp_name=mesh",
             "tester.do_test=false", "logging.save_model=false",
             "network.Ns=[8,8,16]", "network.num_dils=[1,1,2]",
             "network.emb_dim=32", "network.attention_layers=[0,0,0,0]",
             "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8",
             "tester.T=3", "tester.modes=[bwe]",
             "tester.bandwidth_extension.filter.order=64"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_batch,n", [(4, 3), (4, 2), (4, 4), (6, 4),
                                       (8, 1), (3, 2)])
def test_mesh_for_batch_raises_where_jax_does(n_batch, n):
    try:
        jmesh.mesh_for_batch(n_batch, n)
        jax_raised = False
    except ValueError:
        jax_raised = True
    if jax_raised:
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            tmesh.mesh_for_batch(n_batch, n, device="cpu")
    else:
        m = tmesh.mesh_for_batch(n_batch, n, device="cpu")
        # one process: JAX's device list sliced to n, here the one process
        assert (m.size, m.rank, m.axis) == (1, 0, "dp")


def test_one_process_helpers_are_identities():
    m = tmesh.make_mesh(device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    assert m.rows(4) == slice(0, 4) and m.is_main
    assert torch.equal(tmesh.shard_batch(m, {"x": x})["x"], x)
    assert tmesh.gather_batch(m, x) is x
    assert tmesh.all_reduce_sum(m, [x])[0] is x
    assert tmesh.init_distributed() == 1
    with pytest.raises(ValueError, match="do not split"):
        tmesh.Mesh(2, 1, "dp", torch.device("cpu")).rows(3)
    assert tmesh.Mesh(2, 1, "dp", torch.device("cpu")).rows(4) == slice(2, 4)


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
def runs(tmp_path_factory):
    """Each job with one process and with two; rank 0's outputs."""
    d = str(tmp_path_factory.mktemp("mesh"))
    jm = JModel.from_config(jconfig(OVERRIDES))
    v = jm.init(jax.random.PRNGKey(0), batch=1)
    params = _reseed(v["params"], np.random.default_rng(5))
    rng = np.random.default_rng(6)
    t = np.arange(L) / 22050.0
    audio = [(0.3 * np.sin(2 * np.pi * f * t)
              + 0.05 * rng.standard_normal(L)).astype(np.float32)
             for f in (330.0, 550.0, 770.0, 990.0)]
    for name, obj in (
            ("weights", {"params": jax.tree.map(np.asarray, params),
                         "buffers": jax.tree.map(np.asarray,
                                                 v.get("buffers", {}))}),
            ("overrides", OVERRIDES), ("batch", np.stack(audio)),
            ("items", [(audio[i], 22050, f"item{i}.wav") for i in (0, 1)])):
        with open(os.path.join(d, f"{name}.pkl"), "wb") as f:
            pickle.dump(obj, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = {}
    for job in ("train", "bwe"):
        for world in (1, 2):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            procs = [subprocess.Popen(
                [sys.executable, WORKER, job, str(r), str(world), str(port),
                 d], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(world)]
            logs = [p.communicate(timeout=240)[0] for p in procs]
            assert all(p.returncode == 0 for p in procs), "\n".join(logs)
            with open(os.path.join(d, f"out_{job}_{world}.pkl"), "rb") as f:
                out[job, world] = pickle.load(f)
    return d, out


def test_two_process_training_step_equals_one_process(runs):
    _, out = runs
    one, two = out["train", 1], out["train", 2]
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6)
    for key in ("params", "ema"):
        assert set(one[key]) == set(two[key])
        worst = max(float(np.abs(two[key][k] - one[key][k]).max())
                    for k in one[key])
        assert worst <= 1e-3 * LR, (key, worst)
    # the step moved the weights
    moved = max(float(np.abs(one["params"][k] - one["ema"][k]).max())
                for k in one["params"])
    assert moved > 0.1 * LR


def test_two_process_informed_bwe_equals_one_process(runs):
    d, out = runs
    one, two = out["bwe", 1]["bwe"], out["bwe", 2]["bwe"]
    assert one.shape == two.shape == (2, L) and np.isfinite(one).all()
    np.testing.assert_array_equal(two, one)
    for tag in ("_original", "_degraded", "_reconstructed"):
        for i in (0, 1):
            paths = [os.path.join(d, f"w{w}", "outputs", f"bwe{tag}",
                                  f"item{i}.wav") for w in (1, 2)]
            with open(paths[0], "rb") as f1, open(paths[1], "rb") as f2:
                assert f1.read() == f2.read(), paths


def test_a_joined_mesh_of_one_changes_no_pd_step(tmp_path):
    """A mesh over a gloo group of one process runs the trainer's
    collective path (the global draws, here EDMPD's step pairs and noise,
    the rows, the scaled loss, the all-reduce, the gathers): two steps with
    a PD teacher equal the plain trainer's bit for bit."""
    import torch.distributed as dist

    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm_pd import EDMPD
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.training.trainer import Trainer

    args = default_config(OVERRIDES + ["diff_params=edm_PD",
                                       f"model_dir={tmp_path}"])
    teacher = CQTDiffPlus.from_config(args).init(seed=1, device="cpu")
    teacher.net.requires_grad_(False)
    x = np.random.default_rng(8).standard_normal((4, L)).astype(np.float32)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        joined = tmesh.make_mesh(device="cpu")
        plain = tmesh.Mesh(1, 0, "dp", torch.device("cpu"))
        assert joined.joined and not plain.joined
        runs = []
        for mesh in (plain, joined):
            model = CQTDiffPlus.from_config(args)
            tr = Trainer(args, None, model, EDMPD.from_config(
                args, cqt_hpf=model.apply_hpf_DC), device="cpu",
                teacher=teacher, mesh=mesh)
            losses = [tr.train_step(x)["loss"] for _ in range(2)]
            runs.append((losses, {k: p.detach().clone()
                                  for k, p in tr.params.items()}))
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
