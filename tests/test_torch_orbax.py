"""Orbax checkpoint directories in the port (``babe_tpu_torch/native``,
``utils/orbax_dir.py``, the trainer, the tester and ``BABE.load``) against
orbax, tensorstore and zstandard, which only the tests import, on the CPU.

  * the zstd decoder against ``zstandard`` (every listed size, random and
    structured bytes, levels 1, 3, 9 and 19, with and without the content
    checksum, multi-frame, skippable and streamed frames, and frames made
    by hand for the forms the compressor rarely picks), equal byte for
    byte; every single-byte flip of a checksummed frame raises or decodes
    to the original, every truncation raises; CRC-32C against its known
    vectors;
  * the OCDBT B-tree against tensorstore's own listing and reads (one key,
    many keys with interior nodes, values stored inline and indirectly);
    zarr arrays against tensorstore (chunk grids, F order, missing chunks);
    ``read_orbax`` against ``StandardCheckpointer().restore`` in both
    layouts, leaf for leaf, bit-equal, the same Python types;
  * the committed fixture (``tests/torch_orbax_fixture.py``) against the
    payload remade from its seed;
  * the JAX trainer at the tiny config with ``exp.ckpt_backend=orbax``
    (it only saves and resumes: no JAX step): the port resumes what it
    wrote, it resumes what the port wrote, the JAX tester and
    ``BABE.load`` serve it, all bit-equal, and the port's ``_METADATA``
    equals orbax's;
  * ``babe_tpu_torch/`` and ``chip_smoke.py`` import none of orbax,
    tensorstore, zstandard, msgpack, jax, flax, optax or babe_tpu.
"""

import json
import os
import re
import shutil
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from babe_tpu.config import default_config as jconfig
from babe_tpu.diffusion.edm import EDM as JEDM
from babe_tpu.models.cqtdiff import CQTDiffPlus as JModel
from babe_tpu.parallel.mesh import make_mesh
from babe_tpu.testers.tester import Tester as JTester
from babe_tpu.training.trainer import Trainer as JTrainer
from babe_tpu_torch import native
from babe_tpu_torch.api import BABE
from babe_tpu_torch.config import default_config as tconfig
from babe_tpu_torch.diffusion.edm import EDM as TEDM
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus as TModel
from babe_tpu_torch.training.trainer import Trainer as TTrainer
from babe_tpu_torch.utils.orbax_dir import _Files, _Ocdbt, read_orbax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_orbax_fixture as fixture  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = ["network.Ns=[8,8,16]", "network.num_dils=[1,1,2]",
       "network.emb_dim=32", "network.attention_layers=[0,0,0,0]",
       "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8"]
TINY = ["exp.audio_len=4096", "exp.use_bf16=false", "exp.remat=false",
        "exp.resample_factor=1", "exp.batch=2", "exp.seed=3",
        "exp.resume=false", "exp.exp_name=tiny", "tester.do_test=false",
        "logging.save_model=false", "exp.ckpt_backend=orbax"] + NET
MAGIC = struct.pack("<I", 0xFD2FB528)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads here: the suite shares the CPU among several
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ zstd


def _structured(n: int, rng) -> bytes:
    """Runs of zeros, ramps, a small alphabet, a repeated word, smooth
    floats and random bytes: every literal and sequence form."""
    parts, total = [], 0
    while total < n:
        k, kind = int(rng.integers(1, 5000)), int(rng.integers(0, 6))
        if kind == 0:
            b = bytes(k)
        elif kind == 1:
            b = np.arange(k, dtype=np.uint8).tobytes()
        elif kind == 2:
            b = rng.integers(0, 16, k, dtype=np.uint8).tobytes()
        elif kind == 3:
            b = (b"abcdefgh" * (k // 8 + 1))[:k]
        elif kind == 4:
            b = np.cumsum(rng.standard_normal(k // 4 + 1)).astype(
                np.float32).tobytes()[:k]
        else:
            b = rng.bytes(k)
        parts.append(b)
        total += k
    return b"".join(parts)[:n]


SIZES = [0, 1, 127 * 1024, 128 * 1024 + 1, 1 << 20]


@pytest.mark.parametrize("kind", ["random", "structured"])
@pytest.mark.parametrize("size", SIZES)
def test_zstd_matches_zstandard(size, kind):
    rng = np.random.default_rng(size + len(kind))
    data = rng.bytes(size) if kind == "random" else _structured(size, rng)
    for level in (1, 3, 9, 19):
        for checksum in (False, True):
            c = zstandard.ZstdCompressor(
                level=level, write_checksum=checksum).compress(data)
            assert native.zstd_decompress(c) == data, (level, checksum)
            assert native.zstd_frame_content_size(c) == size
            out = bytearray(size)
            assert native.zstd_decompress_into(c, out) == size
            assert out == data


def _bh(size: int, typ: int, last: bool) -> bytes:
    return ((size << 3) | (typ << 1) | int(last)).to_bytes(3, "little")


def _hand_frames() -> list[bytes]:
    """Frames of the forms the compressor rarely writes: 32512 sequences in
    one block (the 3-byte count) as matches of 3 bytes reaching back into
    the raw block before it, with repeat offsets after literal lengths of
    0; RLE literals with no sequences."""
    seqs = bytes([0x00, 0xFF, 0x00, 0x00, 0x54, 0, 0, 0, 0x01])
    rle = bytes([(10 << 3) | 1, ord("z"), 0x00])
    return [MAGIC + bytes([0x00, 0x38]) + _bh(4, 0, False) + b"abcd"
            + _bh(len(seqs), 2, True) + seqs,
            MAGIC + bytes([0x00, 0x38]) + _bh(len(rle), 2, True) + rle]


def test_zstd_frames_of_every_form():
    """Multi-frame input, skippable frames, streamed frames (no content
    size), the hand-made frames, large matches and literal runs, each
    against zstandard; then every form the decoder knows was met."""
    before = native.zstd_features()
    rng = np.random.default_rng(5)
    ref = zstandard.ZstdDecompressor()
    cases = []
    for level in (1, 3, 9, 19):
        for data in (rng.bytes(3000), _structured(300000, rng),
                     bytes(200000) + bytes([7]) * 150000,
                     rng.integers(0, 16, 20000, dtype=np.uint8).tobytes()):
            cases.append((zstandard.ZstdCompressor(level=level).compress(
                data), data))
    streamed = zstandard.ZstdCompressor(level=3).compressobj()
    data = _structured(400000, rng)
    cases.append((streamed.compress(data) + streamed.flush(), data))
    for f in _hand_frames():
        cases.append((f, ref.decompressobj().decompress(f)))
    skip = struct.pack("<II", 0x184D2A5E, 6) + b"orbax!"
    a, b = rng.bytes(777), _structured(5000, rng)
    c = zstandard.ZstdCompressor(level=9, write_checksum=True)
    cases.append((skip + c.compress(a) + skip + c.compress(b) + skip, a + b))
    for src, want in cases:
        assert native.zstd_decompress(src) == want
    assert native.zstd_frame_content_size(cases[-1][0]) == len(a) + len(b)
    assert native.zstd_frame_content_size(cases[-4][0]) is None  # streamed
    after = native.zstd_features()
    unmet = [k for k in native.FEATURES if after[k] == before[k]]
    assert not unmet, unmet


def test_zstd_rejects_corrupt_truncated_and_dictionary_frames():
    """A single flipped byte anywhere in a checksummed frame raises or
    decodes to the original (never other bytes); every truncation raises;
    so do a dictionary frame, a checksum mismatch, a bad magic number and
    empty input."""
    rng = np.random.default_rng(6)
    data = _structured(6000, rng) + rng.bytes(500)
    frame = zstandard.ZstdCompressor(level=19,
                                     write_checksum=True).compress(data)
    raised = 0
    for i in range(len(frame)):
        bad = bytearray(frame)
        bad[i] ^= 0x5A
        try:
            out = native.zstd_decompress(bytes(bad))
        except ValueError:
            raised += 1
            continue
        assert out == data, i
    assert raised >= len(frame) - 8
    for n in range(len(frame)):
        with pytest.raises(ValueError):
            native.zstd_decompress(frame[:n])
    mismatch = frame[:-4] + bytes(b ^ 1 for b in frame[-4:])
    with pytest.raises(ValueError, match="checksum mismatch"):
        native.zstd_decompress(mismatch)
    dic = MAGIC + bytes([0x01, 0x38, 0x2A]) + _bh(3, 0, True) + b"abc"
    with pytest.raises(ValueError, match="dictionary"):
        native.zstd_decompress(dic)
    with pytest.raises(ValueError, match="magic"):
        native.zstd_decompress(b"\x00" * 16)
    with pytest.raises(ValueError):
        native.zstd_decompress(b"")
    with pytest.raises(ValueError, match="not the 10 expected"):
        native.zstd_decompress_into(
            zstandard.ZstdCompressor().compress(b"x" * 9), bytearray(10))


def test_crc32c_vectors():
    """RFC 3720's CRC-32C vectors, continuation, and an OCDBT file's."""
    assert native.crc32c(b"") == 0
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(bytes(32)) == 0x8A9136AA
    assert native.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert native.crc32c(bytes(range(32))) == 0x46DD794E
    assert native.crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C
    big = np.random.default_rng(7).bytes(100003)
    assert native.crc32c(big[50001:], native.crc32c(big[:50001])) \
        == native.crc32c(big)
    with open(os.path.join(fixture.FIXTURE, "manifest.ocdbt"), "rb") as f:
        raw = f.read()
    assert native.crc32c(raw[:-4]) == struct.unpack("<I", raw[-4:])[0]
    assert native.xxh64(b"") == 0xEF46DB3751D8E999


# ------------------------------------------------------------------ OCDBT


@pytest.mark.parametrize("case", ["one", "many", "large"])
def test_ocdbt_btree_matches_tensorstore(tmp_path, case):
    """Keys and values of an OCDBT store written by tensorstore (nodes cut
    small so that "many" has interior nodes; values over 8 bytes stored
    indirectly in data files), read by the port's B-tree walk."""
    rng = np.random.default_rng(len(case))
    n = {"one": 1, "many": 300, "large": 6}[case]
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_decoded_node_bytes": 400,
                   "max_inline_value_bytes": 8}}).result()
    with ts.Transaction() as txn:
        for i in range(n):
            size = int(rng.integers(0, 40)) if case != "large" else 300000
            kv.with_transaction(txn)[f"k{i:04d}.w/{i % 7}.0"] = rng.bytes(
                size)
    store = _Ocdbt(_Files(str(tmp_path)))
    keys = sorted(k.decode() for k in kv.list().result())
    assert sorted(store.entries) == keys and len(keys) == n
    assert store.height > 0 if case == "many" else store.height >= 0
    for k in keys:
        assert bytes(store.get(k)) == kv.read(k).result().value, k


def _zarr(path, chunks, order, compressor, fill, data, skip=()):
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": path},
            "metadata": {"shape": list(data.shape), "chunks": chunks,
                         "dtype": data.dtype.str, "order": order,
                         "compressor": compressor, "fill_value": fill}}
    arr = ts.open(spec, create=True).result()
    grid = [range(0, s, c) for s, c in zip(data.shape, chunks)]
    for lo in np.array(np.meshgrid(*grid, indexing="ij")).reshape(
            len(chunks), -1).T:
        if tuple(lo) in skip:
            continue
        sl = tuple(slice(a, min(a + c, s))
                   for a, c, s in zip(lo, chunks, data.shape))
        arr[sl] = data[sl]
    return arr.read().result()


def test_zarr_chunk_grids_order_and_fill(tmp_path):
    """Zarr arrays written by tensorstore: a grid of ragged chunks in C and
    F order, zstd and no compressor, two chunks never written (their
    fill value), as leaves of a hand-written plain-layout checkpoint."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((5, 7, 3)).astype("<f4")
    b = rng.integers(-9, 9, (9, 4)).astype("<i2")
    want = {
        "w": _zarr(str(tmp_path / "w"), [2, 3, 2], "F",
                   {"id": "zstd", "level": 3}, 1.5, a, skip={(0, 3, 0)}),
        "g": {"b": _zarr(str(tmp_path / "g.b"), [4, 3], "C", None, 7, b,
                         skip={(4, 0)})}}
    assert want["w"][0, 3, 0] == 1.5 and want["g"]["b"][4, 0] == 7
    tree = {str(k): {"key_metadata": [{"key": x, "key_type": 2} for x in k],
                     "value_metadata": {"value_type": "np.ndarray",
                                        "skip_deserialize": False}}
            for k in (("w",), ("g", "b"))}
    with open(tmp_path / "_METADATA", "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": False,
                   "use_zarr3": False}, f)
    got = read_orbax(str(tmp_path))
    np.testing.assert_array_equal(got["w"], want["w"])
    np.testing.assert_array_equal(got["g"]["b"], want["g"]["b"])
    assert got["g"]["b"].dtype == np.dtype("<i2")
    meta = json.loads((tmp_path / "w" / ".zarray").read_text())
    meta["compressor"] = {"id": "blosc"}
    (tmp_path / "w" / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="blosc"):
        read_orbax(str(tmp_path))
    with open(tmp_path / "_METADATA", "w") as f:
        json.dump({"tree_metadata": tree, "use_zarr3": True}, f)
    with pytest.raises(NotImplementedError, match="zarr v3"):
        read_orbax(str(tmp_path))


def _same(a, b, where=""):
    """Leaf for leaf: the same Python types, dtypes, shapes and bits."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}.{i}")
    elif isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, (where, a, b)


def _varied_payload(rng) -> dict:
    leaves = {f"l{i:03d}": rng.standard_normal(int(rng.integers(1, 40))
                                               ).astype(np.float32)
              for i in range(150)}
    return {"it": 12, "lr": 0.25, "none": None, "empty": {}, "nothing": [],
            "unit": (), "state": optax.EmptyState(),
            "big": rng.standard_normal((64, 300)).astype(np.float32),
            "zeros": np.zeros((128, 33), np.float32),
            "ints": {"i8": np.arange(-20, 20, dtype=np.int8),
                     "i32": np.asarray(5, np.int32),
                     "i64": rng.integers(-2**40, 2**40, (3, 2)),
                     "u8": rng.integers(0, 255, 77).astype(np.uint8),
                     "b": rng.random(9) > 0.5},
            "half": rng.standard_normal((4, 5)).astype(np.float16),
            "f64": rng.standard_normal(6),
            "seq": [np.ones(3, np.float32), (np.zeros(2),
                                             {"deep": np.eye(3)})],
            "many": leaves}


@pytest.mark.parametrize("ocdbt", [True, False], ids=["ocdbt", "plain"])
def test_read_orbax_equals_orbax_restore(tmp_path, ocdbt):
    """A payload of every kind of leaf, saved by orbax in each layout:
    ``read_orbax`` returns what ``StandardCheckpointer().restore`` returns
    without a template."""
    path = str(tmp_path / "c.orbax")
    ckptr = ocp.Checkpointer(ocp.StandardCheckpointHandler(
        use_ocdbt=ocdbt))
    ckptr.save(path, _varied_payload(np.random.default_rng(9)))
    ref = ocp.StandardCheckpointer().restore(path)
    got = read_orbax(path)
    _same(got, ref)
    assert os.path.exists(os.path.join(path, "manifest.ocdbt")) == ocdbt
    part = read_orbax(path, top=("it", "big"))
    assert set(part) == {"it", "big"}


def test_ocdbt_crc_is_checked(tmp_path):
    """A flipped byte in a B-tree node or in a manifest fails its
    CRC-32C."""
    root = tmp_path / "f.orbax"
    shutil.copytree(fixture.FIXTURE, root)
    read_orbax(str(root))
    for rel in ("manifest.ocdbt", os.path.join("d", os.listdir(
            root / "d")[0])):
        raw = bytearray((root / rel).read_bytes())
        raw[len(raw) // 2] ^= 1
        (root / rel).write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="CRC-32C"):
            read_orbax(str(root))
        raw[len(raw) // 2] ^= 1
        (root / rel).write_bytes(bytes(raw))


def _orbax_form(tree):
    """A payload as orbax restores it: named tuples as dicts of their
    fields (an empty one None), tuples as lists."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ({k: _orbax_form(getattr(tree, k)) for k in tree._fields}
                if tree else None)
    if isinstance(tree, dict):
        return {k: _orbax_form(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_orbax_form(v) for v in tree]
    return tree


def test_fixture_decodes_to_its_seed():
    """The committed fixture is the payload of its seed, written by orbax
    (OCDBT), and its digests are that payload's."""
    want = _orbax_form(fixture.payload())
    got = read_orbax(fixture.FIXTURE)
    _same(got, want)
    with open(fixture.DIGESTS) as f:
        rec = json.load(f)
    assert rec["seed"] == fixture.SEED
    assert rec["leaves"] == fixture.leaf_digests(want)
    assert os.path.exists(os.path.join(fixture.FIXTURE, "manifest.ocdbt"))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(fixture.FIXTURE) for f in fs)
    assert total == rec["directory_bytes"]
    assert total + os.path.getsize(fixture.DIGESTS) < 256 * 1024


# ------------------------------------------------------------ the trainers


def _grad_map(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _randomized(tree, rng):
    """Random arrays of the tree's leaves' shapes and dtypes (counts from
    1 to 49)."""
    def leaf(x):
        if np.issubdtype(x.dtype, np.floating):
            return jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))
        return jnp.asarray(rng.integers(1, 50, x.shape).astype(x.dtype))
    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX trainer at the tiny config with the orbax backend, its state
    drawn at random (it only saves and resumes), and its checkpoint.

    The JAX model's ``init`` traces and compiles its program at every call
    (about 14 s here); the trainer and the tester take only shapes from it
    (the state is drawn afterwards), so for this module it returns random
    variables of the shapes ``jax.eval_shape`` gives (about 1 s)."""
    jdir = tmp_path_factory.mktemp("jax")
    args = jconfig([f"model_dir={jdir}"] + TINY)
    m = JModel.from_config(args)
    edm = JEDM.from_config(args, cqt_hpf=m.apply_hpf_DC)
    rng = np.random.default_rng(10)
    variables = _randomized(jax.eval_shape(
        lambda k: m.init(k, batch=1), jax.random.PRNGKey(0)), rng)
    mp = pytest.MonkeyPatch()
    mp.setattr(m, "init", lambda key, batch=1: variables)
    jtr = JTrainer(args, iter(()), m, edm, mesh=make_mesh(1))
    s = jtr.state
    jtr.state = s.replace(params=_randomized(s.params, rng),
                          buffers=_randomized(s.buffers, rng),
                          opt_state=_randomized(s.opt_state, rng),
                          ema=_randomized(s.ema, rng),
                          it=jnp.asarray(37, jnp.int32))
    path = jtr.save_checkpoint()
    yield jtr, path, args
    mp.undo()


def _port_state(tr):
    return {"params": {k: p.detach().numpy() for k, p in tr.params.items()},
            "buffers": {k: b.numpy() for k, b in tr.net.named_buffers()},
            "ema": {k: v.numpy() for k, v in tr.ema.items()},
            "mu": {k: v.numpy() for k, v in tr.mu.items()},
            "nu": {k: v.numpy() for k, v in tr.nu.items()},
            "counts": (tr.count, tr.sched_count, tr.it)}


def _jax_state(s):
    adam, sched = s.opt_state[-1]
    return {"params": _grad_map(s.params), "buffers": _grad_map(s.buffers),
            "ema": _grad_map(s.ema), "mu": _grad_map(adam.mu),
            "nu": _grad_map(adam.nu),
            "counts": (int(adam.count), int(sched.count), int(s.it))}


def _equal_maps(a, b, what=""):
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _equal_states(a, b):
    assert a["counts"] == b["counts"]
    for what in ("params", "buffers", "ema", "mu", "nu"):
        _equal_maps(a[what], b[what], what)


def _port(model_dir, extra=()):
    args = tconfig([f"model_dir={model_dir}"] + TINY + list(extra))
    m = TModel.from_config(args)
    return TTrainer(args, None, m, TEDM.from_config(
        args, cqt_hpf=m.apply_hpf_DC), device="cpu")


def test_port_resumes_what_the_jax_trainer_wrote(jax_side):
    """The JAX trainer's orbax directory (OCDBT) resumes the port's
    trainer: params, buffers, EMA, Adam's moments and counts and ``it``,
    bit-equal; BABE.load serves its EMA."""
    jtr, path, args = jax_side
    assert os.path.basename(path) == "tiny-37.orbax"
    port = _port(args.model_dir, ["exp.resume=true"])
    assert port._resumed and port._latest_ckpt == path
    _equal_states(_port_state(port), _jax_state(jtr.state))
    b = BABE.load(path, device="cpu")
    _equal_maps({k: p.detach().numpy()
                 for k, p in b._tester.model.net.named_parameters()},
                _grad_map(jtr.state.ema))
    assert b._tester.it == 37 and list(b.args.network.Ns) == [8, 8, 16]


def test_jax_restores_what_the_port_wrote(jax_side, tmp_path):
    """The port's orbax directory (plain layout, raw zstd blocks) resumes
    the JAX trainer and loads in the JAX tester, bit-equal, and its
    ``_METADATA`` is the one orbax wrote for the JAX trainer's payload."""
    jtr, jpath, args = jax_side
    port = _port(tmp_path)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for d in (port.params, port.ema, port.mu, port.nu):
            for v in d.values():
                v.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(v.shape)).astype(np.float32)))
    port.count, port.sched_count, port.it = 11, 12, 13
    path = port.save_checkpoint()
    assert path == os.path.join(str(tmp_path), "tiny-13.orbax")
    with open(os.path.join(path, "_METADATA")) as f:
        mine = json.load(f)
    with open(os.path.join(jpath, "_METADATA")) as f:
        theirs = json.load(f)
    assert mine["tree_metadata"] == theirs["tree_metadata"]
    assert not mine["use_ocdbt"] and theirs["use_ocdbt"]
    want = _port_state(port)
    assert jtr.resume_from_checkpoint(path)
    _equal_states(_jax_state(jtr.state), want)
    jt = JTester(jtr.args, jtr.model, jtr.edm)
    jt.load_checkpoint(path)
    assert jt.it == 13
    _equal_maps(_grad_map(jt.variables["params"]), want["ema"])
    _equal_maps(_grad_map(jt.variables["buffers"]), want["buffers"])
    b = BABE.load(path, device="cpu")
    _equal_maps({k: p.detach().numpy()
                 for k, p in b._tester.model.net.named_parameters()},
                want["ema"])


def test_resume_takes_both_extensions_and_skips_unnumbered(tmp_path):
    """The resume glob takes the highest iteration over ``.ckpt`` and
    ``.orbax`` (the JAX regex), and a ``-best`` copy of either kind does
    not break it."""
    a = _port(tmp_path, ["exp.ckpt_backend=pickle"])
    a.it = 5
    a.save_checkpoint()
    b = _port(tmp_path)
    b.it = 3
    b.save_checkpoint()
    (tmp_path / "tiny-best.ckpt").write_bytes(b"not a checkpoint")
    (tmp_path / "tiny-best.orbax").mkdir()
    r = _port(tmp_path, ["exp.resume=true"])
    assert r._resumed and r.it == 5
    assert r._latest_ckpt.endswith("tiny-5.ckpt")
    c = _port(tmp_path)
    c.it = 9
    c.save_checkpoint()
    r = _port(tmp_path, ["exp.resume=true", "exp.ckpt_backend=pickle"])
    assert r.it == 9 and r._latest_ckpt.endswith("tiny-9.orbax")
    for p in tmp_path.glob("tiny-[0-9]*"):
        shutil.rmtree(p) if p.is_dir() else p.unlink()
    assert not _port(tmp_path, ["exp.resume=true"])._resumed
    with pytest.raises(ValueError, match="must be 'pickle' or 'orbax'"):
        _port(tmp_path, ["exp.ckpt_backend=msgpack"])


def test_port_imports_no_jax_or_orbax():
    """``babe_tpu_torch/`` and ``chip_smoke.py`` import none of orbax,
    tensorstore, zstandard, msgpack, jax, flax, optax or the JAX
    package."""
    rx = re.compile(r"^\s*(?:import|from)\s+(orbax|tensorstore|zstandard|"
                    r"msgpack|jax|jaxlib|flax|optax|babe_tpu)(?:[.\s,]|$)",
                    re.M)
    found = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "babe_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            text = f.read()
        found += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                  for m in rx.finditer(text)]
    assert len(files) > 40 and not found, found
