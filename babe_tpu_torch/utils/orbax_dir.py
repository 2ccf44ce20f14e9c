"""Orbax checkpoint directories, read and written without orbax.

The JAX trainer's ``exp.ckpt_backend=orbax`` saves its state payload with
``orbax.checkpoint.StandardCheckpointer`` (``babe_tpu/training/trainer.py``
``save_checkpoint``) into ``<exp_name>-<it>.orbax/``, with the run's args
beside it in ``train_args.json``.  Such a directory holds:

  * ``_METADATA``: JSON, ``tree_metadata`` maps each leaf's key path to its
    keys (``key_type`` 2: a dict key or a named tuple's field, 1: a sequence
    index) and its ``value_type`` (``np.ndarray``, ``scalar``, or ``None``,
    ``Dict``, ``List``, ``Tuple`` for the empty ones, which store nothing);
    ``use_ocdbt`` and ``use_zarr3`` say how the arrays are stored;
  * each array as a zarr v2 array named by its key path joined with ``.``
    (``params.w/.zarray`` and its chunks ``params.w/0.0``), each chunk a
    zstd frame;
  * with ``use_ocdbt`` (orbax's default) those zarr keys live in an OCDBT
    key-value store (tensorstore's B-tree format): ``manifest.ocdbt`` at the
    root, B-tree nodes under ``d/`` and the values under
    ``ocdbt.process_<i>/d/``; without it they are plain files.

``read_orbax`` reads both layouts and returns what
``ocp.StandardCheckpointer().restore(path)`` returns without a template:
nested dicts and lists of numpy arrays, Python ints and floats for the
``scalar`` leaves, and ``None``, ``{}``, ``[]`` or ``()`` for the empty
ones.  OCDBT files are framed (magic, length, version, compression) and end
in a CRC-32C, which is checked for every manifest and node read.  The zstd
frames are decoded by the host C++ of ``babe_tpu_torch/native``, arrays in
parallel threads.

``write_orbax`` writes the plain layout (``use_ocdbt: false``), which
orbax restores as well: the ``.zarray`` that orbax writes (zstd level 1),
each chunk a zstd frame of raw blocks (so no compressor is needed), the
``_METADATA`` that orbax writes for the same tree, ``_CHECKPOINT_METADATA``
and the args sidecar, into a temporary sibling renamed into place.

Not read: zarr v3 (``use_zarr3: true``), codecs other than zstd or none,
zarr filters, and OCDBT manifests of the ``numbered`` kind; each raises
naming what is missing.  The JAX trainer writes none of them.
"""

from __future__ import annotations

import itertools
import json
import mmap
import os
import shutil
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from babe_tpu_torch import native

ORBAX_EXT = ".orbax"
ORBAX_ARGS_SIDECAR = "train_args.json"

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_KEY_DICT, _KEY_SEQUENCE = 2, 1
_EMPTY = {"None": None, "Dict": dict, "List": list, "Tuple": tuple}
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
_BLOCK = 128 * 1024  # the largest zstd block
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def is_orbax(path: str) -> bool:
    """Whether a checkpoint path names an orbax directory (by its suffix, or
    by being a directory)."""
    return path.rstrip("/").endswith(ORBAX_EXT) or os.path.isdir(path)


# ------------------------------------------------------------------ OCDBT


class _Bytes:
    """A cursor over a decoded OCDBT body."""

    def __init__(self, buf: bytes, what: str):
        self.b, self.i, self.what = buf, 0, what

    def _need(self, n: int) -> None:
        if self.i + n > len(self.b):
            raise ValueError(f"{self.what}: truncated")

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            self._need(1)
            c = self.b[self.i]
            self.i += 1
            out |= (c & 0x7F) << shift
            if c < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.i += 1
        return self.b[self.i - 1]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.i += n
        return self.b[self.i - n:self.i]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]


def _unframe(buf, magic: int, what: str) -> bytes:
    """The body of an OCDBT manifest or node: magic (big-endian), length,
    version, compression (0 none, 1 zstd), body, CRC-32C of all before."""
    buf = memoryview(buf)
    if len(buf) < 18:
        raise ValueError(f"{what}: truncated ({len(buf)} bytes)")
    got_magic, length = struct.unpack(">I", buf[:4])[0], struct.unpack(
        "<Q", buf[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: bad magic {got_magic:08x}, expected "
                         f"{magic:08x}")
    if length != len(buf):
        raise ValueError(f"{what}: says {length} bytes, has {len(buf)}")
    crc = struct.unpack("<I", buf[-4:])[0]
    if native.crc32c(buf[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Bytes(bytes(buf[12:min(len(buf) - 4, 32)]), what)
    version, comp = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} is not "
                         f"supported")
    body = buf[12 + head.i:-4]
    if comp == 0:
        return bytes(body)
    if comp == 1:
        return native.zstd_decompress(body)
    raise ValueError(f"{what}: unknown compression {comp}")


def _data_files(r: _Bytes) -> list[str]:
    """A data file table: prefix-coded paths (each the base path and the
    relative path run together)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the paths are used whole
    out: list[bytes] = []
    for k in range(n):
        if k and prefix[k] > len(out[-1]):
            raise ValueError(f"{r.what}: bad data file prefix")
        out.append((out[-1][:prefix[k]] if k else b"") + r.take(suffix[k]))
    paths = [p.decode() for p in out]
    for p in paths:
        if os.path.isabs(p) or ".." in p.split("/"):
            raise ValueError(f"{r.what}: data file path {p!r} leaves the "
                             f"checkpoint")
    return paths


def _keys(r: _Bytes, n: int, with_subtree: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if with_subtree else None
    keys: list[bytes] = []
    for k in range(n):
        if k and prefix[k] > len(keys[-1]):
            raise ValueError(f"{r.what}: bad key prefix")
        keys.append((keys[-1][:prefix[k]] if k else b"") + r.take(suffix[k]))
    return keys, common


class _Files:
    """Read-only maps of the checkpoint's files, opened once each."""

    def __init__(self, root: str):
        self.root = root
        self._maps: dict[str, memoryview] = {}
        self._lock = threading.Lock()

    def view(self, rel: str) -> memoryview:
        with self._lock:
            if rel not in self._maps:
                path = os.path.join(self.root, rel)
                with open(path, "rb") as f:
                    size = os.fstat(f.fileno()).st_size
                    self._maps[rel] = memoryview(
                        mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ)
                        if size else b"")
            return self._maps[rel]

    def region(self, rel: str, offset: int, length: int) -> memoryview:
        v = self.view(rel)
        if offset + length > len(v):
            raise ValueError(f"{rel}: range {offset}+{length} beyond its "
                             f"{len(v)} bytes")
        return v[offset:offset + length]


class _Ocdbt:
    """The keys of an OCDBT store, each an inline value or a (file,
    offset, length) reference, from the latest version of its B-tree
    (orbax merges its processes' stores into the root manifest's)."""

    def __init__(self, files: _Files):
        self.files = files
        self.entries: dict[str, object] = {}
        self.height = -1  # the root node's (-1: an empty tree)
        rel = "manifest.ocdbt"
        r = _Bytes(_unframe(files.view(rel), _MANIFEST_MAGIC, rel), rel)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise NotImplementedError(f"{rel}: OCDBT manifests of the "
                                      f"numbered kind are not supported")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.byte()  # version tree arity (log2)
        if r.varint() == 1:  # node compression zstd, and its level
            r.u32()
        files_ = _data_files(r)
        n = r.varint()
        if n == 0:
            return
        r.varints(n)  # generation numbers
        heights = [r.byte() for _ in range(n)]
        fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics
        # the last inline version is the latest; older ones and the version
        # tree's nodes are not needed
        if ln[-1] >= 2 ** 64 - 1:  # an empty tree
            return
        self.height = heights[-1]
        self._node(files_[fid[-1]], off[-1], ln[-1], b"", heights[-1])

    def _node(self, rel: str, offset: int, length: int, prefix: bytes,
              height: int) -> None:
        what = f"{rel}@{offset}"
        body = _unframe(self.files.region(rel, offset, length), _NODE_MAGIC,
                        what)
        r = _Bytes(body, what)
        if r.byte() != height:
            raise ValueError(f"{what}: node height does not match its parent")
        files_ = _data_files(r)
        n = r.varint()
        if height == 0:
            keys, _ = _keys(r, n, False)
            lengths = r.varints(n)
            kinds = r.varints(n)
            indirect = [k for k in range(n) if kinds[k] == 1]
            if any(kinds[k] not in (0, 1) for k in range(n)):
                raise ValueError(f"{what}: unknown value kind")
            fids = r.varints(len(indirect))
            offs = r.varints(len(indirect))
            ref = dict(zip(indirect, zip(fids, offs)))
            for k in range(n):
                key = (prefix + keys[k]).decode()
                if k in ref:
                    f, o = ref[k]
                    self.entries[key] = (files_[f], o, lengths[k])
                else:
                    self.entries[key] = r.take(lengths[k])
            if r.i != len(body):
                raise ValueError(f"{what}: bytes after the leaf entries")
            return
        keys, common = _keys(r, n, True)
        fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
        for k in range(n):
            if common[k] > len(keys[k]):
                raise ValueError(f"{what}: bad subtree prefix")
            self._node(files_[fid[k]], off[k], ln[k],
                       prefix + keys[k][:common[k]], height - 1)

    def get(self, key: str):
        v = self.entries.get(key)
        if isinstance(v, tuple):
            return self.files.region(*v)
        return v


class _Plain:
    """Zarr keys as files under the checkpoint directory."""

    def __init__(self, files: _Files):
        self.files = files

    def get(self, key: str):
        if not os.path.exists(os.path.join(self.files.root, key)):
            return None
        return self.files.view(key)


def _store(path: str, meta: dict):
    files = _Files(path)
    if not meta.get("use_ocdbt", False):
        return _Plain(files)
    if not os.path.exists(os.path.join(path, "manifest.ocdbt")):
        raise ValueError(f"{path}: _METADATA says OCDBT, but there is no "
                         f"manifest.ocdbt")
    return _Ocdbt(files)


# ------------------------------------------------------------------ zarr


def _fill(fill):
    """A zarr v2 fill value (null reads as 0)."""
    if fill is None:
        return 0
    if isinstance(fill, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}.get(fill, 0)
    return fill


def _read_array(store, name: str) -> np.ndarray:
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"array {name!r}: no .zarray")
    z = json.loads(bytes(raw))
    if z.get("zarr_format") != 2:
        raise NotImplementedError(f"array {name!r}: zarr format "
                                  f"{z.get('zarr_format')} is not supported")
    if z.get("filters"):
        raise NotImplementedError(f"array {name!r}: zarr filters "
                                  f"{z['filters']} are not supported")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise NotImplementedError(f"array {name!r}: codec {comp.get('id')!r}"
                                  f" is not supported (only zstd or none)")
    dtype = np.dtype(z["dtype"])
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    order = z.get("order", "C")
    sep = z.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    whole = chunks == shape and order == "C"
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = store.get(key)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        if data is None:
            out[region] = _fill(z.get("fill_value"))
            continue
        buf = out if whole else np.empty(nbytes, np.uint8)
        if comp is None:
            if len(data) != nbytes:
                raise ValueError(f"chunk {key!r}: {len(data)} bytes, "
                                 f"expected {nbytes}")
            native.byte_view(buf)[:] = native.byte_view(data)
        else:
            try:
                native.zstd_decompress_into(data, buf)
            except ValueError as e:
                raise ValueError(f"chunk {key!r}: {e}") from e
        if not whole:
            chunk = buf.view(dtype).reshape(chunks, order=order)
            out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
    return out


# ------------------------------------------------------------------ trees


def _tree_entries(meta: dict):
    """(keys, key types, value type) per leaf of ``_METADATA``."""
    out = []
    for name, ent in meta["tree_metadata"].items():
        km = ent["key_metadata"]
        keys = [str(k["key"]) for k in km]
        types = [int(k["key_type"]) for k in km]
        bad = [t for t in types if t not in (_KEY_DICT, _KEY_SEQUENCE)]
        if bad:
            raise NotImplementedError(f"leaf {name}: key type {bad[0]} is "
                                      f"not supported")
        out.append((keys, types, ent["value_metadata"]["value_type"]))
    return out


def _assemble(entries) -> dict:
    """Nested dicts and lists from (keys, key types, value) leaves."""
    root: dict = {}
    seqs: set[int] = set()  # ids of the dicts that stand for sequences
    for keys, types, value in entries:
        node = root
        for i, (k, t) in enumerate(zip(keys, types)):
            key = int(k) if t == _KEY_SEQUENCE else k
            if i == len(keys) - 1:
                node[key] = value
                break
            if key not in node:
                node[key] = {}
                if types[i + 1] == _KEY_SEQUENCE:
                    seqs.add(id(node[key]))
            node = node[key]

    def finish(v):
        if isinstance(v, dict):
            d = {k: finish(x) for k, x in v.items()}
            if id(v) in seqs:
                if sorted(d) != list(range(len(d))):
                    raise ValueError(f"sequence indices {sorted(d)} are not "
                                     f"0..{len(d) - 1}")
                return [d[i] for i in range(len(d))]
            return d
        return v

    return finish(root)


def read_metadata(path: str) -> dict:
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{path}: zarr v3 arrays (use_zarr3) are "
                                  f"not supported")
    if "tree_metadata" not in meta:
        raise ValueError(f"{path}: _METADATA has no tree_metadata")
    return meta


def orbax_top_keys(path: str) -> list[str]:
    """The top-level keys of an orbax checkpoint's tree (from _METADATA
    alone)."""
    meta = read_metadata(path.rstrip("/"))
    return list(dict.fromkeys(keys[0] for keys, _, _ in _tree_entries(meta)))


def read_orbax(path: str, top=None) -> dict:
    """An orbax checkpoint directory as the tree orbax restores without a
    template.  ``top``: only the leaves under these top-level keys (all
    when None).  Arrays are decoded on up to 8 threads."""
    path = path.rstrip("/")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint not found: {path!r}")
    meta = read_metadata(path)
    entries = [e for e in _tree_entries(meta)
               if top is None or e[0][0] in top]
    for _, _, vt in entries:
        if vt not in _ARRAY_TYPES and vt not in _EMPTY:
            raise NotImplementedError(f"{path}: value type {vt!r} is not "
                                      f"supported")
    store = _store(path, meta)
    names = [".".join(k) for k, _, vt in entries if vt in _ARRAY_TYPES]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        arrays = dict(zip(names, pool.map(lambda a: _read_array(store, a),
                                          names)))
    leaves = []
    for keys, types, vt in entries:
        if vt in _EMPTY:
            v = None if vt == "None" else _EMPTY[vt]()
        else:
            v = arrays[".".join(keys)]
            if vt == "scalar":
                v = v.item()
        leaves.append((keys, types, v))
    return _assemble(leaves)


def stored_chunks(path: str) -> dict[str, bytes]:
    """Every zarr chunk of an orbax checkpoint directory of the OCDBT
    layout as stored (zstd frames), by key: the decoder's input, for
    timing it on frames that orbax wrote."""
    path = path.rstrip("/")
    store = _store(path, read_metadata(path))
    if not isinstance(store, _Ocdbt):
        raise ValueError(f"{path}: not of the OCDBT layout")
    return {k: bytes(store.get(k)) for k in sorted(store.entries)
            if not k.endswith("/.zarray")}


# ------------------------------------------------------------------ writer


def _flatten(tree, keys=(), types=()):
    """(keys, key types, leaf) in the order jax flattens the tree: dict keys
    sorted, sequences in order."""
    if isinstance(tree, dict) and tree:
        for k in sorted(tree, key=str):
            yield from _flatten(tree[k], keys + (str(k),), types + (_KEY_DICT,))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + (str(i),), types + (_KEY_SEQUENCE,))
    else:
        yield keys, types, tree


def _value_type(v) -> tuple[str, np.ndarray | None]:
    if v is None:
        return "None", None
    if isinstance(v, dict):
        return "Dict", None
    if isinstance(v, list):
        return "List", None
    if isinstance(v, tuple):
        return "Tuple", None
    if isinstance(v, bool) or not isinstance(v, (int, float, np.ndarray,
                                                 np.generic)):
        raise TypeError(f"cannot store a {type(v).__name__} in an orbax "
                        f"checkpoint")
    if isinstance(v, int):
        return "scalar", np.asarray(v, np.int64)
    if isinstance(v, float):
        return "scalar", np.asarray(v, np.float64)
    return "np.ndarray", np.asarray(v, order="C")


def _zstd_raw(buf: memoryview):
    """A zstd frame of raw blocks holding ``buf``: single segment, 8-byte
    content size."""
    n = len(buf)
    yield struct.pack("<IBQ", 0xFD2FB528, 0xE0, n)
    if n == 0:
        yield (1).to_bytes(3, "little")
        return
    for s in range(0, n, _BLOCK):
        e = min(s + _BLOCK, n)
        yield (((e - s) << 3) | int(e == n)).to_bytes(3, "little")
        yield buf[s:e]


def _write_array(root: str, name: str, a: np.ndarray) -> int:
    d = os.path.join(root, name)
    os.makedirs(d)
    zarray = {"chunks": list(a.shape),
              "compressor": {"id": "zstd", "level": 1},
              "dimension_separator": ".", "dtype": a.dtype.str,
              "fill_value": None, "filters": None, "order": "C",
              "shape": list(a.shape), "zarr_format": 2}
    with open(os.path.join(d, ".zarray"), "w") as f:
        json.dump(zarray, f, separators=(",", ":"))
    chunk = ".".join("0" for _ in a.shape) or "0"
    nbytes = 0
    with open(os.path.join(d, chunk), "wb") as f:
        for part in _zstd_raw(memoryview(a.reshape(-1).view(np.uint8))):
            nbytes += f.write(part)
    return nbytes


def write_orbax(path: str, payload: dict, args: dict | None = None) -> str:
    """Write ``payload`` (nested dicts and lists or tuples of numpy arrays,
    Python ints and floats, and None or empty containers) as an orbax
    checkpoint directory of the plain layout, with ``args`` as its
    ``train_args.json`` sidecar; replaces what is at ``path``.  Returns
    the absolute path."""
    path = os.path.abspath(path.rstrip("/"))
    t_init = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tree = {}
    try:
        for keys, types, v in _flatten(payload):
            if not keys:
                raise TypeError("the payload must be a non-empty dict")
            vt, arr = _value_type(v)
            tree[str(keys)] = {
                "key_metadata": [{"key": k, "key_type": t}
                                 for k, t in zip(keys, types)],
                "value_metadata": {"value_type": vt,
                                   "skip_deserialize": arr is None}}
            if arr is not None:
                _write_array(tmp, ".".join(keys), arr)
        meta = {"tree_metadata": tree, "use_ocdbt": False,
                "use_zarr3": False,
                "store_array_data_equal_to_fill_value": True,
                "custom_metadata": None}
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump(meta, f)
        if args is not None:
            with open(os.path.join(tmp, ORBAX_ARGS_SIDECAR), "w") as f:
                json.dump(args, f, default=str)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": t_init,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def read_sidecar_args(path: str):
    """The args in an orbax directory's ``train_args.json``, or None when
    it has none (as the JAX package's ``_peek_saved_args``)."""
    side = os.path.join(path.rstrip("/"), ORBAX_ARGS_SIDECAR)
    if not os.path.exists(side):
        return None
    try:
        with open(side) as f:
            return json.load(f)
    except Exception as e:
        raise ValueError(
            f"checkpoint args sidecar {side!r} is unreadable "
            f"({type(e).__name__}: {e}); the checkpoint directory is "
            f"corrupt or was written by an incompatible version") from e
