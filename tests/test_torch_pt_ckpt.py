"""Reference ``.pt`` torch checkpoints in the port against the JAX package:
the conversion (``utils/torch_ckpt.py``), the tester's ``.pt`` branch (EMA
first, ``it`` carried, a strict shape check naming the key, the frame
self-check), the denoiser's ``.pt`` (``network`` first, non-strict),
``BABE.load("*.pt")`` and ``python -m babe_tpu_torch.test`` on a ``.pt``.

The published checkpoints are not in the repository and nothing is
downloaded: the tests build a reference-format state dict from the tiny
model's JAX tree with an inverse name map of their own
(``reference_state_dict``), which the first test holds to the JAX
package's converter (convert + fill must give the tree back exactly).

Tolerances: weights exactly (the same numbers cross both converters); the
denoiser's output at 1e-5 of its largest value (fp32 sums in another
order, as in test_torch_model.py)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babe_tpu.config import default_config as jconfig
from babe_tpu.diffusion.edm import EDM as JEDM
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu.models.denoiser import MultiStageDenoiser as JDenoiser
from babe_tpu.models.denoiser import setup_denoiser as jsetup_denoiser
from babe_tpu.testers.tester import Tester as JTester
from babe_tpu.utils import torch_ckpt as jtc
from babe_tpu_torch.api import BABE
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.diffusion.edm import EDM as TEDM
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.models.denoiser import setup_denoiser
from babe_tpu_torch import test as tcli
from babe_tpu_torch.testers.tester import Tester as TTester
from babe_tpu_torch.utils import torch_ckpt as ttc
from babe_tpu_torch.utils.weights import denoiser_to_flax, to_flax

OUT_TOL = 1e-5
NET = ["exp.audio_len=4096", "exp.use_bf16=false", "exp.remat=false",
       "network.Ns=[8,8,16]", "network.num_dils=[1,1,2]",
       "network.emb_dim=32", "network.attention_layers=[0,0,0,0]",
       "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8",
       "network.cqt.mode=oct_pow2"]
TESTER = ["tester.T=2", "tester.blind_bwe.optimization.max_iter=3",
          "tester.blind_bwe.initial_conditions.fc=[300]",
          "tester.blind_bwe.initial_conditions.A=[-20]",
          "tester.blind_bwe.NFFT=512", "tester.unconditional.num_samples=1",
          "tester.unconditional.audio_len=4096"]
# keys the converter drops: the fixed resampling kernels and the frequency
# encodings' random features
DROPPED = {"downsamplerT.kernel": (1, 1, 8), "upsamplerF.kernel": (1, 1, 8),
           "freq_encodings.0.RFF_freq": (1, 32)}
DEN = ["tester.denoiser.depth=2", "tester.denoiser.num_tfc=2",
       "tester.denoiser.f_dim=65", "tester.denoiser.stft_win_size=128",
       "tester.denoiser.stft_hop_size=32",
       "tester.denoiser.segment_size=0.2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module_name(name: str) -> str:
    """A JAX module name under the reference's: trailing ``_<n>`` indices
    become ``.<n>`` (``downs_0_2`` -> ``downs.0.2``, ``H_0_0`` -> ``H.0.0``);
    ``finalblock_conv2`` is two modules there."""
    if name == "finalblock_conv2":
        return "finalblock.conv2"
    m = re.fullmatch(r"(.*?)((?:_\d+)+)", name)
    return name if m is None else m.group(1) + m.group(2).replace("_", ".")


def reference_state_dict(params, buffers=None) -> dict:
    """JAX-layout trees -> a torch state dict under the reference's key
    names and layouts (the inverse of convert_state_dict + fill_variables):
    the Conv2d wrappers' ``conv`` level dropped, kernels as ``weight`` in
    torch's layouts, GroupNorm gains (1, C, 1, 1), the denoiser's
    ``freq_encoding_fembeddings`` as ``freq_encoding.fembeddings``."""
    sd = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            v = np.asarray(v, np.float32)
            mods = [_module_name(p) for p in path if p != "conv"]
            if k == "kernel":
                k = "weight"
                v = {4: lambda a: a.transpose(3, 2, 0, 1),
                     3: lambda a: a.transpose(2, 1, 0),
                     2: lambda a: a.T}[v.ndim](v)
            elif k == "gamma":
                v = v.reshape(1, -1, 1, 1)
            elif k == "freq_encoding_fembeddings":
                mods, k = mods + ["freq_encoding"], "fembeddings"
            sd[".".join(mods + [k])] = torch.from_numpy(np.array(v))

    walk(params, [])
    walk(buffers or {}, [])
    return sd


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _equal_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def jtiny():
    """The tiny network's JAX init (params, buffers) and its reference
    state dict, with the dropped keys added."""
    args = jconfig(NET + TESTER)
    v = JModel.from_config(args).init(jax.random.PRNGKey(0), batch=1)
    params = jax.tree.map(np.asarray, v["params"])
    buffers = jax.tree.map(np.asarray, v["buffers"])
    sd = reference_state_dict(params, buffers)
    for k, shape in DROPPED.items():
        sd[k] = torch.ones(shape)
    return args, params, buffers, sd


def test_inverse_map_round_trips_through_both_converters(jtiny):
    """The test's own inverse map: JAX convert_state_dict + fill_variables
    give the JAX tree back exactly, and so does the port's pair; the two
    converters agree key for key."""
    args, params, buffers, sd = jtiny
    assert "downs.0.2.H.0.weight" in sd and "embedding.MLP.0.weight" in sd
    assert tuple(sd["downs.0.2.norm.0.gamma"].shape) == (1, 8, 1, 1)
    template = {"params": params, "buffers": buffers}
    jfill = jtc.fill_variables(template, jtc.convert_state_dict(sd))
    _equal_trees(jfill, template)
    conv = ttc.convert_state_dict(sd)
    _equal_trees(conv, jtc.convert_state_dict(sd))
    _equal_trees(ttc.fill_variables(template, conv), template)


def _other(sd):
    return {k: 2.0 * v + 1.0 for k, v in sd.items()}


def _port_tester():
    targs = tconfig(NET + TESTER)
    tm = TModel.from_config(targs)
    return tm, TTester(targs, tm, TEDM.from_config(
        targs, cqt_hpf=tm.apply_hpf_DC), device="cpu")


def test_tester_loads_pt_as_jax_does(jtiny, tmp_path, capsys):
    """The EMA weights win over the network's, ``it`` is carried, the frame
    self-check warns on these untrained weights in both packages, and the
    loaded network's denoiser output agrees with the JAX tester's."""
    args, params, buffers, sd = jtiny
    p = str(tmp_path / "ref.pt")
    torch.save({"it": 42, "ema": sd, "network": _other(sd)}, p)
    jm = JModel.from_config(args)
    jt = JTester(args, jm, JEDM.from_config(args, cqt_hpf=jm.apply_hpf_DC),
                 test_set=None)
    jt.load_checkpoint(p)
    jout = capsys.readouterr().out
    tm, tt = _port_tester()
    tt.load_checkpoint(p)
    tout = capsys.readouterr().out
    assert jt.it == tt.it == 42
    for out in (jout, tout):
        assert "WARNING: frame self-check FAILED" in out, out
    tparams, tbuffers = to_flax(tm.net)
    _equal_trees({"params": tparams, "buffers": tbuffers},
                 {"params": params, "buffers": buffers})
    x = (0.05 * np.random.default_rng(3).standard_normal((1, 4096))).astype(
        np.float32)
    sig = np.full((1, 1), 0.3, np.float32)
    jden, _ = jt._denoiser_fn()
    tden, _ = tt._denoiser_fn()
    ref = np.asarray(jax.jit(jden)(jnp.asarray(x), jnp.asarray(sig)))
    out = tden(torch.as_tensor(x), torch.as_tensor(sig)).detach().numpy()
    assert np.abs(out - ref).max() <= OUT_TOL * np.abs(ref).max()


def test_prefixed_state_dict_and_the_prefer_order(jtiny, tmp_path):
    """One state dict with ``diffusion_ema.`` and ``diffusion.`` prefixed
    keys: the EMA's win; without an EMA entry the ``network`` one loads;
    both packages extract the same dict from each."""
    _, params, buffers, sd = jtiny
    other = _other(sd)
    cases = [({"it": 7, "state_dict": {
        **{f"diffusion_ema.{k}": v for k, v in sd.items()},
        **{f"diffusion.{k}": v for k, v in other.items()}}}, sd),
        ({"network": sd, "model": other}, sd)]
    tm, tt = _port_tester()
    for ckpt, want in cases:
        got = ttc.extract_network_state(ckpt)
        assert set(got) == set(want) == set(jtc.extract_network_state(ckpt))
        p = str(tmp_path / "v.pt")
        torch.save(ckpt, p)
        tt.load_checkpoint(p)
        assert tt.it == ckpt.get("it", 0)
        tparams, tbuffers = to_flax(tm.net)
        _equal_trees({"params": tparams, "buffers": tbuffers},
                     {"params": params, "buffers": buffers})


def test_wrong_shape_raises_naming_the_key(jtiny, tmp_path):
    _, _, _, sd = jtiny
    bad = dict(sd)
    bad["downs.1.2.H.0.weight"] = torch.zeros(8, 8, 5, 1)
    p = str(tmp_path / "bad.pt")
    torch.save({"ema": bad}, p)
    _, tt = _port_tester()
    with pytest.raises(ValueError, match="downs_1_2/H_0/conv/kernel"):
        tt.load_checkpoint(p)
    # a key the model does not have fails the strict fill, naming it
    torch.save({"ema": {**sd, "extra.weight": torch.ones(2, 2)}}, p)
    with pytest.raises(ValueError, match="extra"):
        tt.load_checkpoint(p)
    # as does a key the model has and the checkpoint lacks
    short = dict(sd)
    del short["embedding.MLP.0.bias"]
    torch.save({"ema": short}, p)
    with pytest.raises(ValueError, match="embedding"):
        tt.load_checkpoint(p)


def test_denoiser_pt_matches_jax_setup_denoiser(tmp_path):
    """A reference denoiser ``.pt`` (``network`` preferred over ``ema``, a
    merged ``finalblock.conv2`` name) gives the JAX ``setup_denoiser``'s
    weights exactly; the fill is non-strict, as there."""
    jd = JDenoiser.from_config(jconfig(DEN).tester.denoiser)
    params = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(1))["params"])
    sd = reference_state_dict(params)
    assert "finalblock.conv2.weight" in sd
    assert "freq_encoding.fembeddings" in sd
    p = str(tmp_path / "den.pt")
    torch.save({"network": sd, "ema": _other(sd)}, p)
    ov = DEN + [f"tester.denoiser.checkpoint_path={p}"]
    _, jv = jsetup_denoiser(jconfig(ov))
    _equal_trees(jv["params"], params)
    den = setup_denoiser(tconfig(ov), device="cpu")
    _equal_trees(denoiser_to_flax(den.net), params)
    # non-strict: a missing entry keeps the init, the rest loads
    short = dict(sd)
    del short["finalblock.conv2.bias"]
    torch.save({"network": short}, p)
    den = setup_denoiser(tconfig(ov), device="cpu")
    got = _flat(denoiser_to_flax(den.net))
    for k, v in _flat(params).items():
        if "finalblock_conv2" not in k or "bias" not in k:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_babe_load_pt_builds_the_checkpoint_frame(jtiny, tmp_path):
    """BABE.load of a ``.pt`` builds network=cqtdiff+_ckpt (the oct_pow2
    frame) under the overrides, loads the EMA weights and serves a blind
    request; ``python -m babe_tpu_torch.test`` takes the same file."""
    _, params, buffers, sd = jtiny
    p = str(tmp_path / "ref.pt")
    torch.save({"it": 42, "ema": sd}, p)
    over = [o for o in NET if not o.startswith("network.cqt.mode")] + TESTER
    m = BABE.load(p, overrides=over, device="cpu")
    t = m._tester
    assert t.model.cqt.mode == "oct_pow2" and t.it == 42
    tparams, _ = to_flax(t.model.net)
    _equal_trees(tparams, params)
    x = (0.05 * np.sin(2 * np.pi * 330 * np.arange(4096) / 22050)).astype(
        np.float32)
    out, info = m.enhance(x, 22050, seed=0)
    assert out.shape == (1, 4096) and np.isfinite(out).all()
    argv = over + [f"model_dir={tmp_path}", f"tester.checkpoint={p}",
                   "network=cqtdiff+_ckpt", "tester=only_uncond",
                   "tester.modes=[unconditional]"]
    res = tcli._main(tconfig(argv), device="cpu", overrides=argv)
    assert os.path.exists(tmp_path / "outputs")
    assert res is not None
