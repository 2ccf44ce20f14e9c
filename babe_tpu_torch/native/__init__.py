"""Host C++ of the port, built with g++ at first use and bound with ctypes.

Counterpart of ``babe_tpu/native/`` (the JAX package's C++ wav loader):
here the host code is what reading orbax checkpoint directories needs
(``utils/orbax_dir.py``), ``zstd.cpp``:

  * ``zstd_decompress`` / ``zstd_decompress_into``: a Zstandard decoder
    (RFC 8878: skippable frames, raw, RLE and compressed blocks, raw, RLE,
    Huffman and treeless literals in one or four streams, predefined, RLE,
    FSE and repeated sequence tables, the content checksum), without
    dictionaries;
  * ``crc32c``: CRC-32C (Castagnoli), with SSE4.2 where the host has it;
  * ``xxh64``: the hash whose low 32 bits are a frame's content checksum.

A malformed, truncated or dictionary frame and a checksum mismatch raise
``ValueError`` with the decoder's reason.  The library is compiled from the
sources into ``<repo>/build/native/``, its name keyed on a digest of the
sources and flags, so an edited source rebuilds and a stale build is never
loaded.  A failed build raises with the compiler's log.  The calls release
the GIL (ctypes does), so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("zstd.cpp",)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
_P, _N = ctypes.c_void_p, ctypes.c_size_t

# the decoder's feature counters, in the order of zstd.cpp's enum Feature
FEATURES = ("frame", "skippable", "checksum", "no_fcs", "single_segment",
            "block_raw", "block_rle", "block_compressed", "lit_raw",
            "lit_rle", "lit_compressed", "lit_treeless", "lit_1stream",
            "lit_4streams", "huf_direct", "huf_fse", "seq_none",
            "seq_predefined", "seq_rle", "seq_fse", "seq_repeat",
            "repeat_offset", "repeat_offset_ll0", "long_nseq")


def _digest() -> str:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for fn in SOURCES:
        with open(os.path.join(_HERE, fn), "rb") as f:
            h.update(fn.encode() + f.read())
    return h.hexdigest()[:12]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"libbabe_native-{_digest()}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *FLAGS, *(os.path.join(_HERE, s) for s in SOURCES), "-o",
           tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host code of the orbax "
                           "reader needs a C++ compiler") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {', '.join(SOURCES)}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded library, built first unless a build of these sources
    exists."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            so = ctypes.CDLL(path)
            so.babe_crc32c.argtypes = [_P, _N, ctypes.c_uint32]
            so.babe_crc32c.restype = ctypes.c_uint32
            so.babe_xxh64.argtypes = [_P, _N, ctypes.c_uint64]
            so.babe_xxh64.restype = ctypes.c_uint64
            so.babe_zstd_error.restype = ctypes.c_char_p
            so.babe_zstd_content_size.argtypes = [_P, _N]
            so.babe_zstd_content_size.restype = ctypes.c_int64
            so.babe_zstd_decompress_into.argtypes = [_P, _N, _P, _N]
            so.babe_zstd_decompress_into.restype = ctypes.c_int64
            so.babe_zstd_decompress.argtypes = [_P, _N,
                                                ctypes.POINTER(_P)]
            so.babe_zstd_decompress.restype = ctypes.c_int64
            so.babe_free.argtypes = [_P]
            so.babe_zstd_feature_count.restype = ctypes.c_int
            so.babe_zstd_features.argtypes = [_P]
            _LIB = so
        return _LIB


def byte_view(buf) -> np.ndarray:
    """A uint8 view of any buffer (bytes, bytearray, memoryview, mmap,
    numpy array), without a copy."""
    if isinstance(buf, np.ndarray):
        return buf.reshape(-1).view(np.uint8)
    return np.frombuffer(buf, np.uint8)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data if a.size else 0


def _raise(so) -> None:
    raise ValueError(f"zstd: {so.babe_zstd_error().decode()}")


def crc32c(buf, crc: int = 0) -> int:
    """CRC-32C of ``buf``, continuing from ``crc`` (0 to start)."""
    a = byte_view(buf)
    return int(lib().babe_crc32c(_ptr(a), a.size, crc))


def xxh64(buf, seed: int = 0) -> int:
    a = byte_view(buf)
    return int(lib().babe_xxh64(_ptr(a), a.size, seed))


def zstd_frame_content_size(src) -> int | None:
    """The decoded size that the frames of ``src`` declare, summed (None
    when a frame does not declare it); walks the frames' block headers."""
    a = byte_view(src)
    so = lib()
    n = so.babe_zstd_content_size(_ptr(a), a.size)
    if n == -2:
        _raise(so)
    return None if n < 0 else int(n)


def zstd_decompress(src) -> bytes:
    """Every frame of ``src`` decoded, concatenated (skippable frames
    skipped)."""
    a = byte_view(src)
    so = lib()
    out = _P()
    n = so.babe_zstd_decompress(_ptr(a), a.size, ctypes.byref(out))
    if n < 0:
        _raise(so)
    try:
        return ctypes.string_at(out.value, n) if n else b""
    finally:
        so.babe_free(out)


def zstd_decompress_into(src, out) -> int:
    """Decode every frame of ``src`` into the writable buffer ``out`` (a
    numpy array or a bytearray), which must hold exactly what they decode
    to; returns the bytes written."""
    if isinstance(out, np.ndarray) and not out.flags.c_contiguous:
        raise ValueError("zstd_decompress_into: the output is not "
                         "contiguous")
    a, o = byte_view(src), byte_view(out)
    if not o.flags.writeable:
        raise ValueError("zstd_decompress_into: the output is read-only")
    so = lib()
    n = so.babe_zstd_decompress_into(_ptr(a), a.size, _ptr(o), o.size)
    if n < 0:
        _raise(so)
    if n != o.size:
        raise ValueError(f"zstd: the frames decode to {n} bytes, "
                         f"not the {o.size} expected")
    return int(n)


def zstd_features() -> dict[str, int]:
    """How often the decoder has met each form of the format in this
    process (its feature counters)."""
    so = lib()
    n = so.babe_zstd_feature_count()
    buf = (ctypes.c_uint64 * n)()
    so.babe_zstd_features(buf)
    return dict(zip(FEATURES, buf))
