"""Build and bind the hand-written CUDA kernels (``babe_tpu_torch/csrc``).

Each source compiles with ``nvcc`` for sm_90a into a plain-C shared library
under ``<repo>/build/kernels/`` at first use and is loaded with ctypes.  The
library name carries a hash of the sources, so an edited kernel rebuilds and
a stale build is never picked up.  ``build()`` starts one ``nvcc`` per source,
all at once.

Four kernels: ``conv5x3`` (K1, ``csrc/conv5x3.cu``), ``fused_stage`` (K2)
and ``fused_stage_bwd`` (K2's backward), both in ``csrc/fused_stage.cu``,
and ``filter_fit`` (the blind sampler's filter fit, ``csrc/filter_fit.cu``).
The launchers here take tensors, check them, launch on PyTorch's current
stream and raise when the launch status is not ``cudaSuccess``.  They count
their launches in ``LAUNCHES``; nothing else touches the counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel -> (source in csrc/, C entry point, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "conv5x3": ("conv5x3", "babe_conv5x3", [_P] * 4 + [_I] * 7 + [_P]),
    "fused_stage": ("fused_stage", "babe_fused_stage",
                    [_P] * 8 + [_I] * 6 + [_P]),
    "fused_stage_bwd": ("fused_stage", "babe_fused_stage_bwd",
                        [_P] * 11 + [_I] * 6 + [_P]),
    "filter_fit": ("filter_fit", "babe_filter_fit",
                   [_P] * 5 + [_I] * 3 + [_F] * 4 + [_I] * 3 + [_F] * 4
                   + [_P]),
}
SOURCES = tuple(sorted({src for src, _, _ in KERNELS.values()}))

LAUNCHES = {k: 0 for k in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha1()
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(ARCH_FLAGS).encode() + name.encode())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named sources (one nvcc each, in parallel) unless a build
    of the same sources exists, and load them.  Returns seconds per source."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = _lib_path(n)
            if os.path.exists(out):
                BUILD_SECONDS[n] = 0.0
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
                   "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[n] = log
            BUILD_SECONDS[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
            os.replace(tmp, out)
        for n in todo:
            lib = ctypes.CDLL(_lib_path(n))
            for src, fn, argtypes in KERNELS.values():
                if src == n:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _LIBS[n] = lib
        return dict(BUILD_SECONDS)


def _entry(kernel: str):
    src, fn, _ = KERNELS[kernel]
    if src not in _LIBS:
        build((src,))
    return getattr(_LIBS[src], fn)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, what: str, dtype=None, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _status(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tap_major(w: torch.Tensor) -> torch.Tensor:
    """(5, 3, C, N) HWIO -> (15, N, C): the tensor-core tile's layout."""
    return w.permute(0, 1, 3, 2).reshape(15, w.shape[3], w.shape[2]) \
        .contiguous()


def launch_conv5x3(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """K1 on the card: x (B,F,T,C), w (5,3,C,N) of x's dtype -> (B,F,T,N)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv5x3: unsupported dtype {x.dtype}")
    _check(x, "conv5x3 x")
    B, F, T, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (5, 3, C):
        raise ValueError(f"conv5x3: w must be (5,3,{C},N), got {tuple(w.shape)}")
    _check(w, "conv5x3 w", x.dtype)
    N = w.shape[3]
    y = torch.empty((B, F, T, N), dtype=x.dtype, device=x.device)
    fn = _entry("conv5x3")
    wt = _tap_major(w)
    rc = fn(x.data_ptr(), w.data_ptr(), wt.data_ptr(), y.data_ptr(), B, F, T,
            C, N, int(d), _DTYPES[x.dtype], _stream(x))
    _status("conv5x3", rc)
    LAUNCHES["conv5x3"] += 1
    return y


def launch_fused_stage(x, a, s, w, d: int, want_conv: bool = False):
    """K2 on the card.  Returns (y, mom, c) with c the rounded conv output
    when ``want_conv`` (else None)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_stage: unsupported dtype {x.dtype}")
    _check(x, "fused_stage x")
    B, F, T, C = x.shape
    _check(a, "fused_stage a", torch.float32, (B, C))
    _check(s, "fused_stage s", torch.float32, (B, C))
    _check(w, "fused_stage w", x.dtype, (5, 3, C, C))
    y = torch.empty_like(x)
    mom = torch.zeros((2, B, C), dtype=torch.float32, device=x.device)
    c = torch.empty_like(x) if want_conv else None
    fn = _entry("fused_stage")
    wt = _tap_major(w)
    rc = fn(x.data_ptr(), a.data_ptr(), s.data_ptr(), w.data_ptr(),
            wt.data_ptr(), y.data_ptr(), mom.data_ptr(),
            None if c is None else c.data_ptr(), B, F, T, C, int(d),
            _DTYPES[x.dtype], _stream(x))
    _status("fused_stage", rc)
    LAUNCHES["fused_stage"] += 1
    return y, mom, c


def launch_fused_stage_bwd(g_y, g_mom, y, x, c, a, s, w_t, d: int):
    """K2's backward on the card: the conv transpose of one stage (w_t is
    the flipped, io-swapped kernel) with the vjp's elementwise chain fused
    around it.  Returns (dx, ds, da)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_stage_bwd: unsupported dtype {x.dtype}")
    B, F, T, C = x.shape
    for t, what in ((g_y, "g_y"), (y, "y"), (x, "x"), (c, "c")):
        _check(t, f"fused_stage_bwd {what}", x.dtype, (B, F, T, C))
    _check(g_mom, "fused_stage_bwd g_mom", torch.float32, (2, B, C))
    _check(a, "fused_stage_bwd a", torch.float32, (B, C))
    _check(s, "fused_stage_bwd s", torch.float32, (B, C))
    _check(w_t, "fused_stage_bwd w_t", x.dtype, (5, 3, C, C))
    dx = torch.empty_like(x)
    dsda = torch.zeros((2, B, C), dtype=torch.float32, device=x.device)
    fn = _entry("fused_stage_bwd")
    w_tt = _tap_major(w_t)
    rc = fn(g_y.data_ptr(), g_mom.data_ptr(), y.data_ptr(), x.data_ptr(),
            c.data_ptr(), a.data_ptr(), s.data_ptr(), w_t.data_ptr(),
            w_tt.data_ptr(), dx.data_ptr(), dsda.data_ptr(), B, F, T, C,
            int(d), _DTYPES[x.dtype], _stream(x))
    _status("fused_stage_bwd", rc)
    LAUNCHES["fused_stage_bwd"] += 1
    return dx, dsda[0], dsda[1]


def launch_filter_fit(stats: torch.Tensor, freqs: torch.Tensor,
                      p0: torch.Tensor, cfg, iters: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The blind filter fit on the card, all iterations in one launch.
    stats (3, F) fp32 (the fit's per-bin a, b, c), freqs (F,) ascending,
    p0 (2, K) fp32; cfg carries the optimiser settings (a BlindConfig);
    ``iters``, an optional int32 (1,) tensor, receives the iterations run.
    Returns the fitted (2, K) parameters."""
    F = freqs.shape[0]
    _check(stats, "filter_fit stats", torch.float32, (3, F))
    _check(freqs, "filter_fit freqs", torch.float32, (F,))
    _check(p0, "filter_fit p0", torch.float32)
    if p0.dim() != 2 or p0.shape[0] != 2:
        raise ValueError(
            f"filter_fit: p0 must be (2, K), got {tuple(p0.shape)}")
    if iters is not None:
        _check(iters, "filter_fit iters", torch.int32, (1,))
    K = p0.shape[1]
    out = torch.empty_like(p0)
    fn = _entry("filter_fit")
    rc = fn(stats.data_ptr(), freqs.data_ptr(), p0.data_ptr(), out.data_ptr(),
            None if iters is None else iters.data_ptr(), F, K,
            int(cfg.max_iter), float(cfg.mu[0]), float(cfg.mu[1]),
            float(cfg.tol[0]), float(cfg.tol[1]), int(cfg.clamp_fc),
            int(cfg.clamp_A), int(cfg.only_negative_A), float(cfg.fcmin),
            float(cfg.fcmax), float(cfg.Amin), float(cfg.Amax), _stream(p0))
    _status("filter_fit", rc)
    LAUNCHES["filter_fit"] += 1
    return out
