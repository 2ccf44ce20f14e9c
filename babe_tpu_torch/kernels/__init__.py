"""Build and bind the hand-written CUDA kernels (``babe_tpu_torch/csrc``).

Each source compiles with ``nvcc`` for sm_90a into a plain-C shared library
under ``<repo>/build/kernels/`` at first use and is loaded with ctypes.  The
library name carries a hash of the sources, so an edited kernel rebuilds and
a stale build is never picked up.  ``build()`` starts one ``nvcc`` per source,
all at once.

Eighteen kernels: ``conv5x3`` (K1, ``csrc/conv5x3.cu``), ``fused_stage``
(K2), its operand pass ``stage_fwd_operand`` and ``fused_stage_bwd``
(K2's backward), all in ``csrc/fused_stage.cu``, ``filter_fit`` (the
blind sampler's filter fit, ``csrc/filter_fit.cu``), ``fused_stage_int8``
(K3, the int8 stage) and its operand pass ``stage_int8_operand``, both in
``csrc/fused_stage_int8.cu``, the int8 probe's ``probe_gemm`` (P1, the
TMA + wgmma GEMM of ``csrc/probe_gemm_sm90.cuh``, cut by
``probe_gemm_plan``) and ``probe_stage`` (P2, the stage engine's main
loop, cut by ``probe_stage_plan``), both built from
``csrc/probe_int8.cu``, ``dilated_conv``
(K4, any odd kernel and both dilations, ``csrc/dilated_conv.cu``: a TMA +
wgmma implicit GEMM or an older tile, by ``dilated_conv_route`` and
``dilated_conv_plan``), and
in ``csrc/conv_dw.cu`` the weight-gradient GEMM, counted as ``conv_dw``
(the dw of K1 and K4) or as ``fused_stage_dw`` (the dw of K2, after its
operand pass ``stage_dw_operands``, which also forms the input of K2's
backward engine), and the unfused int8 path's: ``conv_int8`` (C8, the
int8 (5,3) conv with its rescale, ``csrc/conv_int8.cu``: an s8 TMA +
wgmma implicit GEMM on K4's ring, the stage engine's int8 loop at 96
channels, or a ``__dp4a`` tile, by ``conv_int8_route`` and
``conv_int8_plan``) and Q8's per-item
quantizers ``act_quant_dyn`` (the dynamic amax and the quantize in one
cooperative launch) and ``act_quant`` (at a given amax), both cut by
``q8_plan``, and the int32 rescale ``act_rescale`` (cut by
``rescale_plan``; ``csrc/quant_int8.cu``), and ``lfilter`` (the IIR
recursion of the cheby1 and biquad degradations, one row a thread, forward
or back to front: ``csrc/iir.cu``). Each call's route and cut is
made here and passed to the kernel: the GEMM's tiles, chunks and splits by
``dw_plan``, K1's route (tiles, narrow in, narrow out) by
``conv5x3_route`` and ``conv5x3_plan``, K2's, K2's backward's and K3's (a
tile or the sm_90a stage engine, ``csrc/stage_mma_sm90.cuh``) by
``stage_fwd_route``, ``stage_bwd_route``, ``stage_int8_route`` and
``stage_plan``. The launchers here take tensors, check them, launch on
PyTorch's current stream and raise when the launch status is not
``cudaSuccess``. Each build keeps ptxas's report beside the library
(``BUILD_LOG``, read by ``ptxas_report``). They count their launches in
``LAUNCHES`` (K4's and C8's also by route, in ``ROUTE_LAUNCHES``);
nothing else touches the counts.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel -> (source in csrc/, C entry point, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
KERNELS = {
    "conv5x3": ("conv5x3", "babe_conv5x3", [_P] * 4 + [_I] * 7
                + [_IP, _I, _P]),
    "fused_stage": ("fused_stage", "babe_fused_stage",
                    [_P] * 10 + [_I] * 6 + [_IP, _I, _P]),
    # the engine's input h = gelu(x*a), formed once per element
    "stage_fwd_operand": ("fused_stage", "babe_stage_fwd_operand",
                          [_P] * 3 + [_I] * 4 + [_P]),
    "fused_stage_bwd": ("fused_stage", "babe_fused_stage_bwd",
                        [_P] * 13 + [_I] * 6 + [_IP, _I, _P]),
    "filter_fit": ("filter_fit", "babe_filter_fit",
                   [_P] * 5 + [_I] * 3 + [_F] * 4 + [_I] * 3 + [_F] * 5
                   + [_P]),
    "fused_stage_int8": ("fused_stage_int8", "babe_fused_stage_int8",
                         [_P] * 10 + [_I] * 6 + [_IP, _I, _P]),
    # the engine's input q = int8(gelu6(x*a) * iv), formed once per element
    "stage_int8_operand": ("fused_stage_int8", "babe_stage_int8_operand",
                           [_P] * 4 + [_I] * 4 + [_P]),
    "probe_gemm": ("probe_int8", "babe_probe_gemm", [_P] * 3 + [_I] * 7
                   + [_P]),
    "probe_stage": ("probe_int8", "babe_probe_stage", [_P] * 3 + [_IP]
                    + [_I] * 10 + [_P]),
    "dilated_conv": ("dilated_conv", "babe_dilated_conv",
                     [_P] * 4 + [_I] * 10 + [_IP, _I, _P]),
    "conv_dw": ("conv_dw", "babe_conv_dw", [_P] * 4 + [_IP] + [_I] * 2
                + [_P]),
    # fused_stage_dw: the operand pass, then the conv_dw GEMM on its output
    "stage_dw_operands": ("conv_dw", "babe_stage_dw_operands",
                          [_P] * 8 + [_I] * 5 + [_P]),
    "fused_stage_dw": ("conv_dw", "babe_conv_dw", [_P] * 4 + [_IP]
                       + [_I] * 2 + [_P]),
    # the card's resident blocks for a cut (not a kernel launch)
    "dw_slots": ("conv_dw", "babe_dw_slots", [_I] * 5),
    # C8: the unfused int8 (5,3) conv and its rescale
    "conv_int8": ("conv_int8", "babe_conv_int8", [_P] * 6 + [_I] * 8
                  + [_IP, _I, _P]),
    # Q8: the dynamic per-item quantization (amax, grid barrier, quantize:
    # one cooperative launch), the quantize at a given per-item amax, the
    # rescale of an int32 product
    "act_quant_dyn": ("quant_int8", "babe_act_quant_dyn", [_P] * 4
                      + [_I, _LL, _I, _I, _LL, _I, _P]),
    "act_quant": ("quant_int8", "babe_act_quant", [_P] * 4
                  + [_I, _LL, _I, _I, _LL, _I, _P]),
    "act_rescale": ("quant_int8", "babe_act_rescale", [_P] * 3
                    + [_I] * 8 + [_P]),
    # act_quant_dyn's resident blocks per SM (not a kernel launch), and its
    # parts alone (launched only to time them)
    "q8_slots": ("quant_int8", "babe_act_quant_dyn_slots", [_I]),
    "q8_part": ("quant_int8", "babe_act_quant_dyn_part", [_P] * 4
                + [_I, _LL, _I, _I, _LL, _I, _I, _P]),
    # the IIR recursion (transposed direct form II), a row a thread
    "lfilter": ("iir", "babe_lfilter", [_P] * 4 + [_I, _LL, _I, _I, _P]),
}
SOURCES = tuple(sorted({src for src, _, _ in KERNELS.values()}))

# not kernels of a path: the occupancy queries and Q8's parts alone
LAUNCHES = {k: 0 for k in KERNELS
            if k not in ("dw_slots", "q8_slots", "q8_part")}
# K4's routes (csrc/dilated_conv.cu): the CUDA-core tile, the mma.sync
# tile, the TMA + wgmma implicit GEMM; C8's (csrc/conv_int8.cu): the
# __dp4a tile, the s8 TMA + wgmma implicit GEMM, the stage engine's int8
# loop; their launches by route beside their counts in LAUNCHES
K4_SIMT, K4_MMA, K4_TMA = 0, 1, 2
K4_ROUTES = ("simt", "mma", "tma")
C8_TILE, C8_TMA, C8_ENGINE = 0, 1, 2
C8_ROUTES = ("tile", "tma", "engine")
ROUTE_LAUNCHES = {"dilated_conv": dict.fromkeys(K4_ROUTES, 0),
                  "conv_int8": dict.fromkeys(C8_ROUTES, 0)}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counts in ROUTE_LAUNCHES.values():
        for k in counts:
            counts[k] = 0


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
                if os.path.exists(out + ".log"):
                    with open(out + ".log") as f:
                        BUILD_LOG[n] = f.read()
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
            with open(out + ".log", "w") as f:  # ptxas's report, kept
                f.write(log)
            os.replace(tmp, out)
        for n in todo:
            lib = ctypes.CDLL(_lib_path(n))
            for src, fn, argtypes in KERNELS.values():
                if src == n:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _LIBS[n] = lib
        return dict(BUILD_SECONDS)


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: its registers, stack
    frame and spill bytes, and whether ptxas serialized its wgmma (C7513).
    Keys are the mangled names ptxas prints."""
    out: dict[str, dict[str, int]] = {}
    name, serialized = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": -1, "stack": 0, "spill_stores":
                                  0, "spill_loads": 0, "c7513": 0})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:  # an entry's, or a called function's (not reported)
            name = m.group(1) if m.group(1) in out else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name in out:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
            continue
        if "C7513" in line:
            serialized.append(line)
    for k in out:
        out[k]["c7513"] = int(any(k in line for line in serialized))
    return out


def _entry(kernel: str):
    src, fn, _ = KERNELS[kernel]
    if src not in _LIBS:
        build((src,))
    return getattr(_LIBS[src], fn)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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
    """PyTorch's current stream on t's device, as a pointer: through the
    raw-stream query where torch has it, without making a Stream object
    each call."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def tap_major(w: torch.Tensor) -> torch.Tensor:
    """(KF, KT, C, N) HWIO -> (KF*KT, N, C): the tensor-core tile's
    layout."""
    kf, kt, C, N = w.shape
    return w.permute(0, 1, 3, 2).reshape(kf * kt, N, C).contiguous()


# ------------------------------------------------ K1's routes and cuts

# routes of csrc/conv5x3.cu: the tiles of conv5x3_mma.cuh/conv5x3_tile.cuh,
# or one of conv5x3_narrow.cuh's, and the constants it shares
K1_TILE, K1_NARROW_IN, K1_NARROW_OUT = 0, 1, 2
K1_POS = 128           # positions per narrow block
K1_PX = 24             # bf16 per staged pixel or weight row (16 + pad)
K1_RING = 3            # narrow out's cp.async ring
K1_OUT_UNITS = 7       # narrow out's 16-byte window units per thread
MAX_SMEM = 232448      # dynamic shared memory one block may use on sm_90


def _r128(n: int) -> int:
    return -(-n // 128) * 128


def _tile_rows(T: int, pos: int, lo: int) -> tuple[int, int]:
    """(TT, TF): a power of two TT >= min(T, pos), at least ``lo``, and TF
    = pos // TT rows of F, so TT * TF == pos positions."""
    TT = lo
    while TT < T and TT < pos:
        TT *= 2
    return TT, pos // TT


def conv5x3_route(dtype, C: int, N: int) -> int:
    """K1's route: bf16 with a narrow input (C <= 8, N <= 256: the pyramid
    convs, C = 2) or a narrow output (N <= 8, C a multiple of 8: their
    input gradients, N = 2) takes its narrow route; everything else the
    tiles (tensor cores for bf16 with T >= 16 and C >= 16, else CUDA
    cores)."""
    if dtype == torch.bfloat16:
        if C <= 8 and N <= 256:
            return K1_NARROW_IN
        if N <= 8 and C % 8 == 0:
            return K1_NARROW_OUT
    return K1_TILE


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """The cut of one K1 call, passed to the kernel as its K1Plan struct:
    these fields, all ints, in this order.  Narrow routes: block (gx, gy,
    b) owns the 128 positions f0 + q // TT, t0 + q % TT (q < 128, f0 = gy *
    TF, t0 = gx * TT).  Narrow in: an im2col of kp - 8 = 16 * ks columns
    (k = tap * C + c, zero past 15 * C) against ng groups of 32 output
    channels.  Narrow out: nch chunks of 16 input channels, each staged
    with its 5 * TF * (TT + 2) window pixels (``win_px``)."""
    route: int
    B: int
    F: int
    T: int
    C: int
    N: int
    d: int
    tt_log2: int = 0
    TT: int = 0
    TF: int = 0
    ng: int = 0
    kp: int = 0
    op: int = 0
    a_bytes: int = 0
    b_bytes: int = 0
    nch: int = 0
    win_px: int = 0
    stage_bytes: int = 0
    smem: int = 0
    gx: int = 0
    gy: int = 0
    gz: int = 0

    def meta(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in dataclasses.fields(self)]


def conv5x3_plan(dtype, B: int, F: int, T: int, C: int, N: int,
                 d: int) -> K1Plan:
    """The route and cut of one K1 call (see ``K1Plan``)."""
    route = conv5x3_route(dtype, C, N)
    if route == K1_TILE:
        return K1Plan(route, B, F, T, C, N, d)
    TT, TF = _tile_rows(T, K1_POS, 8)
    base = dict(route=route, B=B, F=F, T=T, C=C, N=N, d=d,
                tt_log2=TT.bit_length() - 1, TT=TT, TF=TF, gx=-(-T // TT),
                gy=-(-F // TF), gz=B)
    if route == K1_NARROW_IN:
        ng = -(-N // 32)
        kp = -(-15 * C // 16) * 16 + 8
        op = ng * 32 + 8
        a_bytes, b_bytes = _r128(K1_POS * kp * 2), _r128(ng * 32 * kp * 2)
        plan = K1Plan(**base, ng=ng, kp=kp, op=op, a_bytes=a_bytes,
                      b_bytes=b_bytes, smem=a_bytes + b_bytes
                      + K1_POS * op * 2)
    else:
        if F * T * C >= 2**31:
            raise ValueError(f"conv5x3: {F}x{T}x{C} elements per item "
                             f"exceed the narrow route's 32-bit offsets")
        win_px = 5 * TF * (TT + 2)
        assert win_px * 2 <= K1_OUT_UNITS * 256, win_px
        stage = _r128((15 * 8 + win_px) * K1_PX * 2)
        plan = K1Plan(**base, nch=-(-C // 16), win_px=win_px,
                      stage_bytes=stage, smem=K1_RING * stage)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"conv5x3: C={C} N={N} needs {plan.smem} bytes of "
                         f"shared memory on its narrow route")
    return plan


# (dtype, shape, d) -> (plan, its meta as a C int array)
_K1_PLANS: dict = {}


def launch_conv5x3(x: torch.Tensor, w: torch.Tensor, d: int,
                   transposed: bool = False) -> torch.Tensor:
    """K1 on the card: x (B,F,T,C), w (5,3,C,N) of x's dtype -> (B,F,T,N).
    With ``transposed`` w is (5,3,N,C), a forward kernel, and the conv runs
    with it flipped and io-swapped (a conv's input gradient); the layout
    each route reads is formed from w in one copy.  The route is
    ``conv5x3_route``'s."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv5x3: unsupported dtype {x.dtype}")
    _check(x, "conv5x3 x")
    B, F, T, C = x.shape
    io = 3 if transposed else 2
    if w.dim() != 4 or tuple(w.shape[:2]) != (5, 3) or w.shape[io] != C:
        raise ValueError(f"conv5x3: w must be (5,3,{C},N) or, transposed, "
                         f"(5,3,N,{C}), got {tuple(w.shape)}")
    _check(w, "conv5x3 w", x.dtype)
    N = w.shape[5 - io]
    key = (x.dtype, B, F, T, C, N, int(d))
    if key not in _K1_PLANS:
        plan = conv5x3_plan(x.dtype, B, F, T, C, N, int(d))
        meta = plan.meta()
        _K1_PLANS[key] = (plan, (ctypes.c_int * len(meta))(*meta), len(meta))
    plan, meta, n_meta = _K1_PLANS[key]
    y = torch.empty((B, F, T, N), dtype=x.dtype, device=x.device)
    fn = _entry("conv5x3")
    # the tap-major copy only where a route reads it (narrow out and the
    # tensor-core tile), the HWIO kernel where the others do; of a
    # transposed kernel, tap-major is w flipped
    tc_tile = (plan.route == K1_TILE and x.dtype == torch.bfloat16
               and T >= 16 and C >= 16)
    if plan.route == K1_NARROW_OUT or tc_tile:
        wt = (w.flip(0, 1).reshape(15, N, C) if transposed
              else tap_major(w))
    else:
        if transposed:
            w = w.flip(0, 1).transpose(2, 3).contiguous()
        wt = w
    rc = fn(x.data_ptr(), w.data_ptr(), wt.data_ptr(), y.data_ptr(), B, F, T,
            C, N, int(d), _DTYPES[x.dtype], meta, n_meta, _stream(x))
    _status("conv5x3", rc)
    LAUNCHES["conv5x3"] += 1
    return y


def launch_stage_fwd_operand(x: torch.Tensor, a: torch.Tensor
                             ) -> torch.Tensor:
    """The input of K2's engine on the card: h = gelu(x*a) (B,F,T,C) bf16,
    rounded in K2's order, one pass with 16-byte loads and stores (plain
    version ``ops/conv_kernels.stage_gelu_ref``).  C a multiple of 8."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"stage_fwd_operand: unsupported dtype {x.dtype}")
    _check(x, "stage_fwd_operand x")
    B, F, T, C = x.shape
    if C % 8:
        raise ValueError(f"stage_fwd_operand: C={C} is not a multiple of 8")
    _check(a, "stage_fwd_operand a", torch.float32, (B, C))
    h = torch.empty_like(x)
    rc = _entry("stage_fwd_operand")(x.data_ptr(), a.data_ptr(),
                                     h.data_ptr(), B, F, T, C, _stream(x))
    _status("stage_fwd_operand", rc)
    LAUNCHES["stage_fwd_operand"] += 1
    return h


def launch_fused_stage(x, a, s, w, d: int, want_conv: bool = False):
    """K2 on the card.  Returns (y, mom, c) with c the rounded conv output
    when ``want_conv`` (else None).  The route is ``stage_fwd_route``'s:
    on the engine, ``stage_fwd_operand`` forms its input first."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_stage: unsupported dtype {x.dtype}")
    _check(x, "fused_stage x")
    B, F, T, C = x.shape
    _check(a, "fused_stage a", torch.float32, (B, C))
    _check(s, "fused_stage s", torch.float32, (B, C))
    _check(w, "fused_stage w", x.dtype, (5, 3, C, C))
    plan, meta, n_meta = _stage_plan(STAGE_FWD, x.dtype, B, F, T, C, d)
    if plan.route == STAGE_ENGINE:
        h = launch_stage_fwd_operand(x, a)
        wt = wpk = stage_fwd_weights(w)
    else:
        h = wt = wpk = tap_major(w)
    y = torch.empty_like(x)
    mom = torch.zeros((2, B, C), dtype=torch.float32, device=x.device)
    c = torch.empty_like(x) if want_conv else None
    rc = _entry("fused_stage")(
        x.data_ptr(), a.data_ptr(), s.data_ptr(), w.data_ptr(),
        wt.data_ptr(), wpk.data_ptr(), h.data_ptr(), y.data_ptr(),
        mom.data_ptr(), None if c is None else c.data_ptr(), B, F, T, C,
        int(d), _DTYPES[x.dtype], meta, n_meta, _stream(x))
    _status("fused_stage", rc)
    LAUNCHES["fused_stage"] += 1
    return y, mom, c


# ---------------------------- the stage engine (K2, its backward, K3)

# routes of babe_fused_stage, babe_fused_stage_bwd and babe_fused_stage_int8:
# a tile (conv5x3_tile.cuh, conv5x3_mma.cuh; K3's own in
# fused_stage_int8.cu) or the sm_90a engine (stage_mma_sm90.cuh); the
# engine's modes and constants
STAGE_TILE, STAGE_ENGINE = 0, 1
STAGE_FWD, STAGE_BWD, STAGE_I8 = 0, 1, 2
STAGE_PROBE = 3        # P2's plans: the main loop alone (probe_int8.cu)
STAGE_C8 = 4           # C8's engine route (C = N = 96): the int8 loop
STAGE_KB = 32          # contraction bytes per ring stage (a k-step)
STAGE_KC = 16          # bf16 channels per ring stage (int8: 32)
STAGE_PX = 24          # bf16 per staged window pixel (16 + pad): 48 bytes
STAGE_RING = 5         # the cp.async ring
STAGE_POS = 128        # positions per block: two warpgroups of 64
STAGE_UNITS = 2        # 16-byte window units per thread (256 threads)
STAGE_MIN_C = {STAGE_FWD: 64, STAGE_BWD: 64, STAGE_I8: 96, STAGE_C8: 96}


def stage_route(mode: int, dtype, B: int, F: int, T: int, C: int,
                d: int) -> int:
    """The engine for bf16 (K3: bf16 x) at C a multiple of 32 in 64..256
    (K3: 96..256, the int8 stacks' channel floor) with rows of at least 16
    positions: every flagship stage, at any batch (C8: C = 96 alone, its
    one instantiation).  Else the tile."""
    if mode == STAGE_C8:
        return STAGE_ENGINE if C == 96 and T >= 16 else STAGE_TILE
    if (dtype == torch.bfloat16 and C % 32 == 0
            and STAGE_MIN_C[mode] <= C <= 256 and T >= 16):
        return STAGE_ENGINE
    return STAGE_TILE


def stage_fwd_route(dtype, B: int, F: int, T: int, C: int, d: int) -> int:
    """K2's route (see ``stage_route``)."""
    return stage_route(STAGE_FWD, dtype, B, F, T, C, d)


def stage_bwd_route(dtype, B: int, F: int, T: int, C: int, d: int) -> int:
    """K2's backward's route (see ``stage_route``): the engine or the kBwd
    tile."""
    return stage_route(STAGE_BWD, dtype, B, F, T, C, d)


def stage_int8_route(dtype, B: int, F: int, T: int, C: int, d: int) -> int:
    """K3's route for x of ``dtype`` (see ``stage_route``)."""
    return stage_route(STAGE_I8, dtype, B, F, T, C, d)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """The cut of one engine call, passed to the kernel as its StagePlan
    struct: these fields, all ints, in this order.  Engine: block (gx, gy,
    z) with z = b * splits + j owns the 128 positions f0 + q // TT, t0 + q
    % TT (q < 128, f0 = gy * TF, t0 = gx * TT) and output channels j * NT
    .. (j + 1) * NT, NT = C / splits; warpgroup w owns q in [64w, 64w +
    64), TF / 2 rows of F each when T < 64.  Ring stage it is channel chunk
    it // 5 (32 bytes: 16 bf16 or 32 int8 channels) at kernel row kf = it %
    5: the window of rows f0 + fr + (kf-2) d (fr < TF) and columns t0 - 1
    .. t0 + TT, and the 3 kt taps' weights."""
    route: int
    mode: int
    B: int
    F: int
    T: int
    C: int
    d: int
    splits: int = 1
    tt_log2: int = 0
    TT: int = 0
    TF: int = 0
    n_it: int = 0
    ring_bytes: int = 0
    stage_bytes: int = 0
    win_bytes: int = 0
    smem: int = 0
    gx: int = 0
    gy: int = 0
    gz: int = 0

    def meta(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in dataclasses.fields(self)]


def stage_splits(C: int) -> int:
    """Channel tiles per position block: two of 128 at C = 256, one
    elsewhere.  On an H100 two tiles were 8-15% faster per launch than one
    of 256 at every C = 256 stage, batch 1 and 4, in all three modes: twice
    the blocks for 132 SMs (the deepest stage has 112 blocks of 128
    positions at batch 1), each with half the accumulators."""
    return 2 if C == 256 else 1


def stage_plan(mode: int, dtype, B: int, F: int, T: int, C: int,
               d: int) -> StagePlan:
    """The route and cut of one K2, K2 backward or K3 call (``mode``; see
    ``StagePlan``)."""
    route = stage_route(mode, dtype, B, F, T, C, d)
    if route == STAGE_TILE:
        return StagePlan(route, mode, B, F, T, C, d)
    splits = stage_splits(C)
    NT = C // splits
    assert NT * splits == C and NT % 32 == 0 and NT >= STAGE_MIN_C[mode], (
        C, splits)
    TT, TF = _tile_rows(T, STAGE_POS, 16)
    assert TF * (TT + 2) * 2 <= STAGE_UNITS * 256
    win = _r128(TF * (TT + 2) * STAGE_PX * 2)
    stage = _r128(3 * NT * STAGE_KB + win)
    # the epilogue tile: bf16 rows of NT + 8, K3's fp32 and C8's int32
    # rows of NT + 4
    int8 = mode in (STAGE_I8, STAGE_C8)
    tile = STAGE_POS * (NT + 4) * 4 if int8 else STAGE_POS * (NT + 8) * 2
    ring = max(STAGE_RING * stage, _r128(tile))
    kc = 2 * STAGE_KC if int8 else STAGE_KC
    plan = StagePlan(route, mode, B, F, T, C, d, splits,
                     TT.bit_length() - 1, TT, TF, 5 * C // kc, ring, stage,
                     win, ring + 6 * NT * 4, -(-T // TT), -(-F // TF),
                     B * splits)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"stage engine: C={C} needs {plan.smem} bytes of "
                         f"shared memory")
    return plan


def stage_bwd_plan(dtype, B: int, F: int, T: int, C: int,
                   d: int) -> StagePlan:
    """The route and cut of one K2 backward (see ``StagePlan``)."""
    return stage_plan(STAGE_BWD, dtype, B, F, T, C, d)


def stage_bwd_weights(w: torch.Tensor) -> torch.Tensor:
    """The backward engine's weights from the stage's forward kernel w
    (5,3,C,C), in one permute: (kf, chunk, kt, C/8, 2, 8, 8), element [kf,
    ch, kt, g, h, r, e] = w[kf, kt, 8g + r, 16ch + 8h + e].  Per (kf,
    chunk) the 3 taps lie in the no-swizzle K-major layout of a wgmma B
    operand (output channel n = 8g + r, contraction channel k = 16ch + 8h +
    e); the kernel reads kernel row 4-kf and tap 2-kt of it, the
    transpose's flip."""
    C = w.shape[2]
    return w.reshape(5, 3, C // 8, 8, C // 16, 2, 8).permute(
        0, 4, 1, 2, 5, 3, 6).contiguous()


def stage_fwd_weights(w: torch.Tensor) -> torch.Tensor:
    """K2's engine weights from w (5,3,C,C): the backward's pack of the
    io-swapped kernel, element [kf, ch, kt, g, h, r, e] = w[kf, kt, 16ch +
    8h + e, 8g + r], read unflipped (B[k][n] = w[kf, kt, k, n])."""
    return stage_bwd_weights(w.transpose(2, 3))


def stage_tap_weights(wt: torch.Tensor) -> torch.Tensor:
    """The engine's weights from a tap-major kernel wt (15,C,C) [kf*3 + kt,
    n, c] of bf16 or int8, in one permute: (kf, chunk, kt, C/8, 2, 8, v)
    with v = 16 bytes of values (8 bf16, 16 int8), element [kf, ch, kt, g,
    h, r, e] = wt[3kf + kt, 8g + r, 2v ch + v h + e]: the no-swizzle
    K-major bytes every engine mode reads."""
    C, v = wt.shape[1], 16 // wt.element_size()
    return wt.reshape(5, 3, C // 8, 8, C // (2 * v), 2, v).permute(
        0, 4, 1, 2, 5, 3, 6).contiguous()


def stage_int8_weights(qwt: torch.Tensor) -> torch.Tensor:
    """K3's engine weights from its tap-major int8 kernel qwt (15,C,C)
    (``stage_tap_weights``: 16 int8 per core-matrix row, the same bytes as
    the bf16 packs)."""
    return stage_tap_weights(qwt)


# (mode, dtype, shape, d) -> (plan, its meta as a C int array, its length)
_STAGE_PLANS: dict = {}


def _stage_plan(mode: int, dtype, B: int, F: int, T: int, C: int, d: int):
    key = (mode, dtype, B, F, T, C, int(d))
    if key not in _STAGE_PLANS:
        plan = stage_plan(mode, dtype, B, F, T, C, int(d))
        meta = plan.meta()
        _STAGE_PLANS[key] = (plan, (ctypes.c_int * len(meta))(*meta),
                             len(meta))
    return _STAGE_PLANS[key]


def launch_fused_stage_bwd(g_y, g_mom, y, x, c, a, s, w, d: int, gc=None):
    """K2's backward on the card: the conv transpose of one stage (w is the
    stage's forward kernel (5,3,C,C); the route forms what it reads from it)
    with the vjp's elementwise chain fused around it.  Returns (dx, ds,
    da).  The route is ``stage_bwd_route``'s.  The engine reads the
    transpose's input g_pre * s: ``gc``, the second output of
    ``launch_stage_dw_operands`` on the same tensors, else that pass is
    launched here first."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_stage_bwd: unsupported dtype {x.dtype}")
    B, F, T, C = x.shape
    for t, what in ((g_y, "g_y"), (y, "y"), (x, "x"), (c, "c")):
        _check(t, f"fused_stage_bwd {what}", x.dtype, (B, F, T, C))
    _check(g_mom, "fused_stage_bwd g_mom", torch.float32, (2, B, C))
    _check(a, "fused_stage_bwd a", torch.float32, (B, C))
    _check(s, "fused_stage_bwd s", torch.float32, (B, C))
    _check(w, "fused_stage_bwd w", x.dtype, (5, 3, C, C))
    plan, meta, n_meta = _stage_plan(STAGE_BWD, x.dtype, B, F, T, C, d)
    if plan.route == STAGE_ENGINE:
        if gc is None:
            _, gc = launch_stage_dw_operands(x, a, s, y, g_y, g_mom)
        _check(gc, "fused_stage_bwd gc", x.dtype, (B, F, T, C))
        wpk = w_t = w_tt = stage_bwd_weights(w)
    else:
        gc = wpk = w_t = w.flip(0, 1).transpose(2, 3).contiguous()
        tc_tile = x.dtype == torch.bfloat16 and T >= 16 and C >= 16
        w_tt = tap_major(w_t) if tc_tile else w_t
    dx = torch.empty_like(x)
    dsda = torch.zeros((2, B, C), dtype=torch.float32, device=x.device)
    fn = _entry("fused_stage_bwd")
    rc = fn(g_y.data_ptr(), g_mom.data_ptr(), y.data_ptr(), x.data_ptr(),
            c.data_ptr(), a.data_ptr(), s.data_ptr(), w_t.data_ptr(),
            w_tt.data_ptr(), wpk.data_ptr(), gc.data_ptr(), dx.data_ptr(),
            dsda.data_ptr(), B, F, T, C, int(d), _DTYPES[x.dtype], meta,
            n_meta, _stream(x))
    _status("fused_stage_bwd", rc)
    LAUNCHES["fused_stage_bwd"] += 1
    return dx, dsda[0], dsda[1]


# the fit kernel's shapes (csrc/filter_fit.cu): breakpoints per launch, and
# bins: 17 per thread in registers, one block of 128 threads (256 above
# 17 x 128 bins)
FIT_MAX_K = 16
FIT_MAX_F = 17 * 256


def launch_filter_fit(stats: torch.Tensor, freqs: torch.Tensor,
                      p0: torch.Tensor, cfg,
                      iters: torch.Tensor | None = None) -> torch.Tensor:
    """The blind filter fit on the card, all iterations in one launch.
    stats (3, F) fp32 (the fit's per-bin a, b, c), freqs (F,) ascending,
    the rfft grid of ``cfg.nfft`` at ``cfg.sample_rate``; p0 (2, K) fp32;
    cfg carries the optimiser settings (a BlindConfig); ``iters``, an
    optional int32 (1,) tensor, receives the iterations run.  Returns the
    fitted (2, K) parameters."""
    F = freqs.shape[0]
    if p0.dim() != 2 or p0.shape[0] != 2:
        raise ValueError(
            f"filter_fit: p0 must be (2, K), got {tuple(p0.shape)}")
    K = p0.shape[1]
    if not (1 <= K <= FIT_MAX_K and 1 <= F <= FIT_MAX_F):
        raise ValueError(f"filter_fit: K={K} (1..{FIT_MAX_K}) and F={F} "
                         f"(1..{FIT_MAX_F}) are what the kernel takes")
    _check(stats, "filter_fit stats", torch.float32, (3, F))
    _check(freqs, "filter_fit freqs", torch.float32, (F,))
    _check(p0, "filter_fit p0", torch.float32)
    if iters is not None:
        _check(iters, "filter_fit iters", torch.int32, (1,))
    out = torch.empty_like(p0)
    fn = _entry("filter_fit")
    rc = fn(stats.data_ptr(), freqs.data_ptr(), p0.data_ptr(), out.data_ptr(),
            None if iters is None else iters.data_ptr(), F, K,
            int(cfg.max_iter), float(cfg.mu[0]), float(cfg.mu[1]),
            float(cfg.tol[0]), float(cfg.tol[1]), int(cfg.clamp_fc),
            int(cfg.clamp_A), int(cfg.only_negative_A), float(cfg.fcmin),
            float(cfg.fcmax), float(cfg.Amin), float(cfg.Amax),
            float(cfg.nfft) / float(cfg.sample_rate), _stream(p0))
    _status("filter_fit", rc)
    LAUNCHES["filter_fit"] += 1
    return out


def launch_stage_int8_operand(x: torch.Tensor, a: torch.Tensor,
                              iv: torch.Tensor) -> torch.Tensor:
    """The input of K3's engine on the card: q = clip(rint(gelu6(float(x)
    * a) * iv), +-127) (B,F,T,C) int8 from bf16 x, every step one rounded
    fp32 operation in the plain order (plain version
    ``ops/conv_kernels.stage_quant_ref``).  C a multiple of 16."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"stage_int8_operand: unsupported dtype {x.dtype}")
    _check(x, "stage_int8_operand x")
    B, F, T, C = x.shape
    if C % 16:
        raise ValueError(f"stage_int8_operand: C={C} is not a multiple of "
                         f"16")
    _check(a, "stage_int8_operand a", torch.float32, (B, C))
    _check(iv, "stage_int8_operand iv", torch.float32, (B,))
    q = torch.empty((B, F, T, C), dtype=torch.int8, device=x.device)
    rc = _entry("stage_int8_operand")(x.data_ptr(), a.data_ptr(),
                                      iv.data_ptr(), q.data_ptr(), B, F, T,
                                      C, _stream(x))
    _status("stage_int8_operand", rc)
    LAUNCHES["stage_int8_operand"] += 1
    return q


def launch_fused_stage_int8(x, a, iv, post, qwt, d: int,
                            want_q: bool = False):
    """K3 on the card: x (B,F,T,C) bf16 or fp32; a (B,C), iv (B,), post
    (B,C) fp32; qwt (15,C,C) int8 tap-major.  Returns (y in x's dtype,
    mom (3,B,C) fp32, q) with q the int8 conv input (B,F,T,C) when
    ``want_q`` (a check's view of the prologue; else None).  The route is
    ``stage_int8_route``'s: on the engine, ``stage_int8_operand`` forms q
    first."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_stage_int8: unsupported dtype {x.dtype}")
    _check(x, "fused_stage_int8 x")
    B, F, T, C = x.shape
    _check(a, "fused_stage_int8 a", torch.float32, (B, C))
    _check(iv, "fused_stage_int8 iv", torch.float32, (B,))
    _check(post, "fused_stage_int8 post", torch.float32, (B, C))
    _check(qwt, "fused_stage_int8 qwt", torch.int8, (15, C, C))
    plan, meta, n_meta = _stage_plan(STAGE_I8, x.dtype, B, F, T, C, d)
    q_out = None
    if plan.route == STAGE_ENGINE:
        q = launch_stage_int8_operand(x, a, iv)
        wpk = stage_int8_weights(qwt)
    else:
        q = wpk = qwt
        if want_q:
            q_out = torch.zeros((B, F, T, C), dtype=torch.int8,
                                device=x.device)
    y = torch.empty_like(x)
    mom = torch.zeros((3, B, C), dtype=torch.float32, device=x.device)
    rc = _entry("fused_stage_int8")(
        x.data_ptr(), a.data_ptr(), iv.data_ptr(), post.data_ptr(),
        qwt.data_ptr(), wpk.data_ptr(), q.data_ptr(), y.data_ptr(),
        mom.data_ptr(), None if q_out is None else q_out.data_ptr(), B, F,
        T, C, int(d), _DTYPES[x.dtype], meta, n_meta, _stream(x))
    _status("fused_stage_int8", rc)
    LAUNCHES["fused_stage_int8"] += 1
    if plan.route == STAGE_ENGINE:
        return y, mom, (q if want_q else None)
    return y, mom, q_out


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """P1's cut (csrc/probe_gemm_sm90.cuh): a block computes bm x bn
    outputs; the grid is gx x gy blocks; each repetition walks nk ring
    stages of 128 bytes of K."""
    bm: int
    bn: int
    gx: int
    gy: int
    nk: int


def probe_gemm_plan(M: int, K: int, N: int, dtype: torch.dtype,
                    sms: int = 132) -> GemmPlan:
    """The tile of a (M, K) @ (K, N) product: 64-row blocks, 64 columns
    when that gives at least 90% of a wave of ``sms`` blocks, else 32.
    Raises on a shape the kernel does not take: M or N below 1, or K not a
    positive whole number of 32-byte slices (16 bf16 or 32 int8 values)."""
    if dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"probe_gemm: unsupported dtype {dtype}")
    elem = 2 if dtype == torch.bfloat16 else 1
    step = 32 // elem
    if M < 1 or N < 1 or K < step or K % step:
        raise ValueError(f"probe_gemm: shape (M, K, N) = ({M}, {K}, {N}) "
                         f"not taken: M, N >= 1 and K a positive multiple "
                         f"of {step} for {dtype}")
    gx = -(-M // 64)
    bn = 64 if gx * -(-N // 64) >= 0.9 * sms else 32
    return GemmPlan(64, bn, gx, -(-N // bn), -(-K * elem // 128))


PROBE_NT = (64, 32)      # P2's channel tiles, widest first
PROBE_POS = 64           # positions per P2 block: one warpgroup
PROBE_SMS = 132          # the H100's SMs: P2's cut aims at a wave of them


def probe_stage_plan(BF: int, BT: int, C: int, d: int, dtype) -> StagePlan:
    """P2's cut (a StagePlan of mode STAGE_PROBE for the stage engine's
    loop over the staged rows, an input of (F, T) = (BF + 4d, BT + 16)):
    blocks of one warpgroup, 64 window positions (TF rows x TT columns of
    the BF x BT window, TT a power of two in 16..64) and NT output
    channels, the widest of PROBE_NT that gives at least 90% of a wave of
    PROBE_SMS blocks, else the narrowest; the engine's ring of STAGE_RING
    stages.  Raises on a shape the loop does not take: C not a positive multiple of 32, BF, BT or d below 1."""
    if dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"probe_stage: unsupported dtype {dtype}")
    if C < 32 or C % 32 or min(BF, BT, d) < 1:
        raise ValueError(f"probe_stage: (BF, BT, C, d) = ({BF}, {BT}, {C}, "
                         f"{d}) not taken: C a positive multiple of 32, "
                         f"BF, BT, d >= 1")
    elem = 2 if dtype == torch.bfloat16 else 1
    TT, TF = _tile_rows(BT, PROBE_POS, 16)
    assert TF * (TT + 2) * 2 <= STAGE_UNITS * 128
    gx, gy = -(-BT // TT), -(-BF // TF)
    NT = next((nt for nt in PROBE_NT
               if C % nt == 0 and gx * gy * (C // nt) >= 0.9 * PROBE_SMS),
              PROBE_NT[-1])
    win = _r128(TF * (TT + 2) * STAGE_PX * 2)
    stage = _r128(3 * NT * STAGE_KB + win)
    return StagePlan(STAGE_ENGINE, STAGE_PROBE, 1, BF + 4 * d, BT + 16, C, d,
                     C // NT, TT.bit_length() - 1, TT, TF,
                     5 * C * elem // STAGE_KB, STAGE_RING * stage, stage,
                     win, STAGE_RING * stage, gx, gy, C // NT)


def launch_probe_gemm(a: torch.Tensor, bt: torch.Tensor,
                      reps: int = 16) -> torch.Tensor:
    """P1 on the card: a (M,K) @ bt (N,K)^T, both bf16 (fp32 accumulate,
    bf16 out) or both int8 (int32 out), repeated ``reps`` times in the
    launch, each repetition's accumulator starting from the previous
    one's first value times a runtime 0 (so every repetition computes the
    same product).  The shape is checked (``probe_gemm_plan``) before
    anything else; both operands must be 16-byte aligned."""
    if a.dim() != 2 or bt.dim() != 2 or bt.shape[1] != a.shape[1]:
        raise ValueError(f"probe_gemm: a (M, K) and bt (N, K) expected, got "
                         f"{tuple(a.shape)} and {tuple(bt.shape)}")
    M, K = a.shape
    N = bt.shape[0]
    plan = probe_gemm_plan(M, K, N, a.dtype)
    _check(a, "probe_gemm a")
    _check(bt, "probe_gemm bt", a.dtype)
    if a.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("probe_gemm: operands must be 16-byte aligned")
    if reps < 1:
        raise ValueError(f"probe_gemm: reps={reps} must be at least 1")
    out = torch.empty((M, N), device=a.device, dtype=(
        torch.int32 if a.dtype == torch.int8 else torch.bfloat16))
    fn = _entry("probe_gemm")
    rc = fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(), M, K, N, int(reps),
            0, _DTYPES[a.dtype], plan.bn, _stream(a))
    _status("probe_gemm", rc)
    LAUNCHES["probe_gemm"] += 1
    return out


def launch_probe_stage(h: torch.Tensor, wt: torch.Tensor, BF: int, BT: int,
                       d: int, reps: int = 8,
                       wpk: torch.Tensor | None = None) -> torch.Tensor:
    """P2 on the card: staged rows h (BF+4d, BT+16, C) -> out (BF*BT, C),
    out[f*BT+t, n] = sum over (kf, kt, c) of h[f+kf*d, 7+kt+t, c] *
    wt[kf*3+kt, n, c], repeated ``reps`` times with a data dependency from
    each repetition's result into the next one's accumulator (scaled by a
    runtime 0, so every repetition computes the same product).  bf16 in,
    fp32 out, or int8 in, int32 out.  The kernel reads the engine's pack
    of wt: ``wpk``, ``stage_tap_weights(wt)`` made by the caller (a
    timing keeps the pack out of what it times), else made here.  The cut
    is ``probe_stage_plan``'s."""
    if h.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"probe_stage: unsupported dtype {h.dtype}")
    _check(h, "probe_stage h")
    nrows, BTw, C = h.shape
    if nrows < BF + 4 * d or BTw != BT + 16:
        raise ValueError(f"probe_stage: h must be ({BF + 4 * d}, {BT + 16}, "
                         f"C), got {tuple(h.shape)}")
    _check(wt, "probe_stage wt", h.dtype, (15, C, C))
    if reps < 1:
        raise ValueError(f"probe_stage: reps={reps} must be at least 1")
    key = ("probe", h.dtype, nrows, BF, BT, C, int(d))
    if key not in _STAGE_PLANS:
        plan = probe_stage_plan(BF, BT, C, int(d), h.dtype)
        # the plan's F covers BF + 4d rows; h may carry more below them
        plan = dataclasses.replace(plan, F=nrows)
        meta = plan.meta()
        _STAGE_PLANS[key] = (plan, (ctypes.c_int * len(meta))(*meta),
                             len(meta))
    _, meta, n_meta = _STAGE_PLANS[key]
    if wpk is None:
        wpk = stage_tap_weights(wt)
    _check(wpk, "probe_stage wpk", h.dtype, (5, C * h.element_size() // 32,
                                             3, C // 8, 2, 8,
                                             16 // h.element_size()))
    out = torch.empty((BF * BT, C), device=h.device, dtype=(
        torch.int32 if h.dtype == torch.int8 else torch.float32))
    fn = _entry("probe_stage")
    rc = fn(h.data_ptr(), wpk.data_ptr(), out.data_ptr(), meta, n_meta,
            nrows, BTw, C, int(BF), int(BT), int(d), int(reps), 0,
            _DTYPES[h.dtype], _stream(h))
    _status("probe_stage", rc)
    LAUNCHES["probe_stage"] += 1
    return out


# K4's TMA route (csrc/dilated_conv.cu): a block is two consumer
# warpgroups of at most 64 positions each; a ring stage holds their two A
# boxes (64 positions x 64 channels, 8 KiB each) and one B box (64
# channels x BN outputs)
K4_CHUNK = 64                    # channels per ring stage: 128 bytes
K4_ABOX = 64 * 128               # bytes of one warpgroup's A slot
K4_WIDTHS = (64, 96, 128, 256)   # BN, the block's outputs
K4_RING = 196608                 # ring bytes an SM's blocks share: two
                                 # blocks of BN <= 128, one of 256
# the mma tile's constants (mma_frag.cuh): positions and outputs per
# block, bf16 per staged pixel
K4_MMA_POS, K4_MMA_NB, K4_MMA_PX = 128, 64, 24


def dilated_conv_route(dtype, T: int, C: int, N: int, kf: int, kt: int,
                       dt: int) -> int:
    """K4's route: the TMA route for bf16 with C and N multiples of 8
    (every level shape and its dx; the 16-byte strides its tensor maps and
    stores need); else the mma tile for bf16 with rows of 16 and 16
    channels whose staged window fits shared memory; else CUDA cores."""
    if dtype == torch.bfloat16:
        if C % 8 == 0 and N % 8 == 0:
            return K4_TMA
        TF, TW = K4_MMA_POS // 16, 16 + (kt - 1) * dt
        smem = (TF * kf * TW + kf * kt * K4_MMA_NB) * K4_MMA_PX * 2
        if T >= 16 and C >= 16 and smem <= MAX_SMEM:
            return K4_MMA
    return K4_SIMT


@dataclasses.dataclass(frozen=True)
class DconvPlan:
    """The cut of one K4 call, passed to the kernel as its Plan struct:
    these fields, all ints, in this order.  TMA route: block (gx, gy, z)
    owns outputs n0 = (z % n_tiles) * bn .. n0 + bn of item z //
    n_tiles at the TT x 2TF positions from (f0, t0) = (gy * 2TF, gx *
    TT): warpgroup w the TF rows from f0 + w TF (its A box, TT * TF <= 64
    of its 64 rows).  It walks n_k = KF * KT * nch ring stages, tap =
    it // nch (kf = tap // KT, kt = tap % KT) and channels c0 = (it %
    nch) * 64 .. c0 + 64, in a ring of ``stages`` slots."""
    route: int
    B: int
    F: int
    T: int
    C: int
    N: int
    KF: int
    KT: int
    df: int
    dt: int
    TT: int = 0
    TF: int = 0
    bn: int = 0
    n_tiles: int = 0
    nch: int = 0
    n_k: int = 0
    stages: int = 0
    stage_bytes: int = 0
    smem: int = 0
    gx: int = 0
    gy: int = 0
    gz: int = 0

    def meta(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in dataclasses.fields(self)]


def _k4_box(F: int, T: int) -> tuple[int, int]:
    """(TT, TF) of the TMA route's A box: TF = 64 // TT rows of TT
    columns, covering F x T with the fewest blocks of two boxes (the widest
    TT among equals)."""
    best = None
    for TT in range(min(T, 64), 0, -1):
        TF = 64 // TT
        blocks = -(-T // TT) * -(-F // (2 * TF))
        if best is None or blocks < best[0]:
            best = (blocks, TT, TF)
    return best[1], best[2]


def dilated_conv_plan(dtype, B: int, F: int, T: int, C: int, N: int,
                      kshape, dilation) -> DconvPlan:
    """The route and cut of one K4 call (see ``DconvPlan``)."""
    kf, kt = (int(v) for v in kshape)
    df, dt = (int(v) for v in dilation)
    base = dict(B=B, F=F, T=T, C=C, N=N, KF=kf, KT=kt, df=df, dt=dt)
    route = dilated_conv_route(dtype, T, C, N, kf, kt, dt)
    if route != K4_TMA:
        return DconvPlan(route, **base)
    TT, TF = _k4_box(F, T)
    bn = next((w for w in K4_WIDTHS if w >= N), K4_WIDTHS[-1])
    n_tiles = -(-N // bn)
    nch = -(-C // K4_CHUNK)
    stage = 2 * K4_ABOX + bn * 128
    stages = min(8, K4_RING // (2 if bn <= 128 else 1) // stage)
    plan = DconvPlan(route, **base, TT=TT, TF=TF, bn=bn, n_tiles=n_tiles,
                     nch=nch, n_k=kf * kt * nch, stages=stages,
                     stage_bytes=stage, smem=stages * stage + 1024,
                     gx=-(-T // TT), gy=-(-F // (2 * TF)), gz=B * n_tiles)
    if plan.gy > 65535 or plan.gz > 65535:
        raise ValueError(f"dilated_conv: grid {plan.gx}x{plan.gy}x{plan.gz} "
                         f"too large for ({B},{F},{T},{C}) -> {N}")
    return plan


# (dtype, shape, kernel, dilation) -> (plan, its meta as a C int array,
# its length)
_K4_PLANS: dict = {}


def launch_dilated_conv(x: torch.Tensor, w: torch.Tensor,
                        dilation) -> torch.Tensor:
    """K4 on the card: x (B,F,T,C), w (KF,KT,C,N) of x's dtype with odd
    KF, KT <= 7, dilation (df, dt) -> (B,F,T,N).  The route is
    ``dilated_conv_route``'s, the cut ``dilated_conv_plan``'s; the
    tap-major copy of w is made only for the routes that read it."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dilated_conv: unsupported dtype {x.dtype}")
    _check(x, "dilated_conv x")
    B, F, T, C = x.shape
    if w.dim() != 4 or w.shape[2] != C:
        raise ValueError(f"dilated_conv: w must be (KF,KT,{C},N), got "
                         f"{tuple(w.shape)}")
    kf, kt, _, N = w.shape
    df, dt = (int(v) for v in dilation)
    if not (kf % 2 == 1 and kt % 2 == 1 and kf <= 7 and kt <= 7
            and df >= 1 and dt >= 1):
        raise ValueError(f"dilated_conv: kernel ({kf},{kt}) dilation "
                         f"({df},{dt}) not supported (odd sizes up to 7)")
    _check(w, "dilated_conv w", x.dtype)
    key = (x.dtype, B, F, T, C, N, kf, kt, df, dt)
    if key not in _K4_PLANS:
        plan = dilated_conv_plan(x.dtype, B, F, T, C, N, (kf, kt), (df, dt))
        meta = plan.meta()
        _K4_PLANS[key] = (plan, (ctypes.c_int * len(meta))(*meta), len(meta))
    plan, meta, n_meta = _K4_PLANS[key]
    wt = tap_major(w) if plan.route != K4_SIMT else w
    y = torch.empty((B, F, T, N), dtype=x.dtype, device=x.device)
    if plan.route == K4_TMA and any(t.data_ptr() % 16 for t in (x, wt, y)):
        raise ValueError("dilated_conv: the TMA route needs 16-byte aligned "
                         "tensors")
    fn = _entry("dilated_conv")
    rc = fn(x.data_ptr(), w.data_ptr(), wt.data_ptr(), y.data_ptr(), B, F, T,
            C, N, kf, kt, df, dt, _DTYPES[x.dtype], meta, n_meta, _stream(x))
    _status("dilated_conv", rc)
    LAUNCHES["dilated_conv"] += 1
    ROUTE_LAUNCHES["dilated_conv"][K4_ROUTES[plan.route]] += 1
    return y


# ------------------------------------------------ the weight-gradient GEMM

# routes of csrc/conv_dw.cu (see its head) and the constants it shares
DW_MMA, DW_SIMT, DW_FOLD = 0, 1, 2
DW_HEADER = 8          # ints before the chunk table
DW_STAGES = 3          # the tensor-core route's cp.async ring
DW_CHUNK = 128         # positions per chunk (tensor-core and simt routes)
DW_MAX_WARPS = 9
DW_SIMT_TILE = 64
DW_FOLD_ROWS, DW_FOLD_WIDE, DW_FOLD_LANES, DW_FOLD_CHUNK = 32, 64, 4, 64
DW_MAX_SMEM = MAX_SMEM
_SMS = 132             # the H100's SMs: one block each unless told more


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """The cut of one weight gradient, passed to the kernel as its Plan
    struct: these fields, all ints, in this order.

    Tensor-core and simt routes: block (s, tile) owns kernel row i, taps
    j0 .. j0+taps-1, input channels c0 .. c0+bm and outputs n0 .. n0+bn
    (``dw_tile``) and walks chunks seg[i] + s, seg[i] + s + splits, ... <
    seg[i+1] of the table.  A chunk (b, f0, nf_k, t0) holds pp positions:
    position p is G's (b, f0 + p // tl, t0 + p % tl) when p // tl < nf_k
    and t0 + p % tl < T, else padding (zero G).  Its X row for tap j is
    (b, f0 + p // tl + (i-PF)*df, t0 + p % tl + (j-PT)*dt), zero outside
    [0, T); the chunks of row i hold only f whose X row is inside [0, F).

    Fold route: block (s, group + groups * wide tile) owns folded rows
    group*32 .. +32 of the table and wide channels wt*64 .. +64, and walks
    position chunks s, s + splits, ... < n_chunks of 64 flattened (b, f, t)
    positions."""
    route: int
    B: int
    F: int
    T: int
    C: int
    N: int
    KF: int
    KT: int
    df: int
    dt: int
    bm: int = 0
    bn: int = 0
    c_tiles: int = 0
    n_tiles: int = 0
    taps: int = 0
    tap_groups: int = 0
    tl: int = 0
    nf: int = 0
    pp: int = 0
    xw: int = 0
    splits: int = 0
    narrow_x: int = 0
    wide: int = 0
    groups: int = 0
    wide_tiles: int = 0
    n_chunks: int = 0
    smem: int = 0
    threads: int = 0
    tiles: int = 0

    def meta(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in dataclasses.fields(self)]


def dw_route(dtype, C: int, N: int) -> int:
    """The tensor-core route for bf16 with both sides of at least 16
    channels in multiples of 8; the fold route when either side is under
    16 channels; else CUDA cores."""
    if min(C, N) < 16:
        return DW_FOLD
    if dtype == torch.bfloat16 and C % 8 == 0 and N % 8 == 0:
        return DW_MMA
    return DW_SIMT


def _first_divisor(width: int, choices) -> int:
    return next((c for c in choices if width % c == 0), choices[-1])


def dw_tile(plan: DwPlan, tile: int) -> tuple[int, int, int, int]:
    """(i, j0, c0, n0) of grid row ``tile`` (the kernel's tile_at)."""
    n0 = tile % plan.n_tiles * plan.bn
    tile //= plan.n_tiles
    c0 = tile % plan.c_tiles * plan.bm
    tile //= plan.c_tiles
    return (tile // plan.tap_groups, tile % plan.tap_groups * plan.taps, c0,
            n0)


def _dw_splits(tiles: int, most: int, slots: int) -> int:
    """Blocks per tile (at most ``most``, the most chunks of one tile): as
    many as make the last of at most 4 waves of ``slots`` resident blocks
    nearly full; fewer blocks (fewer atomics) unless clearly fuller."""
    best, best_eff = 1, 0.0
    for s in range(1, most + 1):
        waves = -(-tiles * s // slots)
        if waves > 4:
            break
        eff = tiles * s / (waves * slots)
        if eff > best_eff + 0.02:
            best, best_eff = s, eff
    return best


def dw_plan(B: int, F: int, T: int, C: int, N: int, kshape, dilation,
            route: int, slots=None) -> tuple[DwPlan, np.ndarray]:
    """The plan of one weight gradient and its int32 table (see
    ``DwPlan``).  ``slots(threads, smem)`` says how many blocks of that
    size the card holds at once (default: one per SM of an H100)."""
    slots = slots or (lambda threads, smem: _SMS)
    KF, KT = (int(v) for v in kshape)
    df, dt = (int(v) for v in dilation)
    base = dict(route=route, B=B, F=F, T=T, C=C, N=N, KF=KF, KT=KT, df=df,
                dt=dt)
    PF, PT = (KF - 1) // 2, (KT - 1) // 2
    if route == DW_FOLD:
        narrow_x = int(C < 16)
        Cn, wide = (C, N) if narrow_x else (N, C)
        rows = KF * KT * Cn
        groups = -(-rows // DW_FOLD_ROWS)
        table = np.full((groups * DW_FOLD_ROWS, 4), -1, np.int32)
        for r in range(rows):
            ij, ch = divmod(r, Cn)
            i, j = divmod(ij, KT)
            sf, st = (i - PF) * df, (j - PT) * dt
            if narrow_x:
                table[r] = (sf, st, ch, (ij * C + ch) * N)
            else:
                table[r] = (-sf, -st, ch, ij * C * N + ch)
        wide_tiles = -(-wide // DW_FOLD_WIDE)
        n_chunks = -(-(B * F * T) // DW_FOLD_CHUNK)
        tiles = groups * wide_tiles
        threads = DW_FOLD_WIDE * DW_FOLD_LANES
        splits = _dw_splits(tiles, n_chunks, slots(threads, 0))
        return DwPlan(**base, narrow_x=narrow_x, wide=wide, groups=groups,
                      wide_tiles=wide_tiles, n_chunks=n_chunks,
                      splits=splits, threads=threads,
                      tiles=tiles), table.reshape(-1)
    if route == DW_MMA:
        bm = _first_divisor(C, (128, 96, 64, 32))
        bn = _first_divisor(N, tuple(w for w in (96, 64, 32)
                                     if bm * w <= 32 * 32 * DW_MAX_WARPS))
        taps = 3
    else:
        bm = bn = DW_SIMT_TILE
        taps = KT
    tap_groups = -(-KT // taps)
    tl, nf = (DW_CHUNK, 1) if T >= DW_CHUNK else (T, DW_CHUNK // T)
    pp = -(-nf * tl // 16) * 16
    xw = tl + (KT - 1) * dt
    segs, parts = [0], []
    for i in range(KF):
        sh = (i - PF) * df
        flo, fhi = max(0, -sh), min(F, F - sh)
        f0 = np.arange(flo, fhi, nf) if flo < fhi else np.zeros(0, np.int64)
        t0 = np.arange(0, T, tl)
        b_, f_, t_ = np.meshgrid(np.arange(B), f0, t0, indexing="ij")
        ck = np.stack([b_, f_, np.minimum(nf, fhi - f_), t_], -1)
        parts.append(ck.reshape(-1, 4))
        segs.append(segs[-1] + len(parts[-1]))
    header = np.zeros(DW_HEADER, np.int64)
    header[:KF + 1] = segs
    table = np.concatenate([header] + [c.reshape(-1) for c in parts])
    c_tiles, n_tiles = -(-C // bm), -(-N // bn)
    tiles = KF * tap_groups * c_tiles * n_tiles
    if route == DW_MMA:
        XS, GS = 2 * bm + 16, 2 * bn + 16
        smem = DW_STAGES * (nf * xw * XS + pp * GS) + XS + 16
        threads = bm * bn // 32
    else:
        smem = 4 * DW_SIMT_TILE * (nf * xw + 2 + pp + 1)
        threads = 256
    if smem > DW_MAX_SMEM:
        raise ValueError(f"conv_dw: kernel ({KF},{KT}) dilation ({df},{dt}) "
                         f"needs {smem} bytes of shared memory")
    most = max(1, max(segs[i + 1] - segs[i] for i in range(KF)))
    splits = _dw_splits(tiles, most, slots(threads, smem))
    return DwPlan(**base, bm=bm, bn=bn, c_tiles=c_tiles, n_tiles=n_tiles,
                  taps=taps, tap_groups=tap_groups, tl=tl, nf=nf, pp=pp,
                  xw=xw, splits=splits, smem=smem, threads=threads,
                  tiles=tiles), table.astype(np.int32)


# (shape, kernel, dilation, route, device) -> (plan, meta array, table)
_DW_PLANS: dict = {}


def _dw_gemm(name: str, x: torch.Tensor, g: torch.Tensor, kshape,
             dilation) -> torch.Tensor:
    """One launch of the weight-gradient GEMM (checked tensors): dW
    (KF,KT,C,N) fp32."""
    B, F, T, C = x.shape
    N = g.shape[3]
    kf, kt = (int(v) for v in kshape)
    df, dt = (int(v) for v in dilation)
    if not (kf % 2 == 1 and kt % 2 == 1 and kf <= 7 and kt <= 7
            and df >= 1 and dt >= 1):
        raise ValueError(f"{name}: kernel ({kf},{kt}) dilation ({df},{dt}) "
                         f"not supported (odd sizes up to 7)")
    route = dw_route(x.dtype, C, N)
    key = (B, F, T, C, N, kf, kt, df, dt, route, x.device)
    if key not in _DW_PLANS:
        def slots(threads, smem):
            n = _entry("dw_slots")(route, threads, smem, kt,
                                   _DTYPES[x.dtype])
            if n <= 0:
                raise RuntimeError(f"{name}: occupancy query failed: "
                                   f"cudaError {-n}")
            return n

        plan, table = dw_plan(B, F, T, C, N, (kf, kt), (df, dt), route,
                              slots)
        meta = plan.meta()
        _DW_PLANS[key] = ((ctypes.c_int * len(meta))(*meta), len(meta),
                          torch.as_tensor(table).to(x.device))
    meta, n_meta, table = _DW_PLANS[key]
    dw = torch.zeros((kf, kt, C, N), dtype=torch.float32, device=x.device)
    rc = _entry(name)(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                      table.data_ptr(), meta, n_meta, _DTYPES[x.dtype],
                      _stream(x))
    _status(name, rc)
    LAUNCHES[name] += 1
    return dw


def launch_conv_dw(x: torch.Tensor, g: torch.Tensor, kshape,
                   dilation) -> torch.Tensor:
    """The weight gradient of a 'SAME' conv on the card: x (B,F,T,C) the
    conv's input, g (B,F,T,N) its output cotangent, both of one dtype.
    Returns dW (KF,KT,C,N) in fp32."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_dw: unsupported dtype {x.dtype}")
    _check(x, "conv_dw x")
    B, F, T, C = x.shape
    if g.dim() != 4 or tuple(g.shape[:3]) != (B, F, T):
        raise ValueError(f"conv_dw: g must be ({B},{F},{T},N), got "
                         f"{tuple(g.shape)}")
    _check(g, "conv_dw g", x.dtype)
    return _dw_gemm("conv_dw", x, g, kshape, dilation)


def launch_stage_dw_operands(x, a, s, y, g_y, g_mom):
    """The operands of one K2 stage's weight gradient on the card: h =
    gelu(x*a) and gc = g_pre*s (B,F,T,C) in x's dtype, rounded in K2's
    order (plain version ``ops/conv_kernels.stage_dw_operands_ref``)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stage_dw_operands: unsupported dtype {x.dtype}")
    _check(x, "stage_dw_operands x")
    B, F, T, C = x.shape
    for t, what in ((y, "y"), (g_y, "g_y")):
        _check(t, f"stage_dw_operands {what}", x.dtype, (B, F, T, C))
    _check(a, "stage_dw_operands a", torch.float32, (B, C))
    _check(s, "stage_dw_operands s", torch.float32, (B, C))
    _check(g_mom, "stage_dw_operands g_mom", torch.float32, (2, B, C))
    h, gc = torch.empty_like(x), torch.empty_like(x)
    rc = _entry("stage_dw_operands")(
        x.data_ptr(), a.data_ptr(), s.data_ptr(), y.data_ptr(),
        g_y.data_ptr(), g_mom.data_ptr(), h.data_ptr(), gc.data_ptr(), B, F,
        T, C, _DTYPES[x.dtype], _stream(x))
    _status("stage_dw_operands", rc)
    LAUNCHES["stage_dw_operands"] += 1
    return h, gc


def launch_fused_stage_dw(x, a, s, y, g_y, g_mom, d: int,
                          operands=None) -> torch.Tensor:
    """The weight gradient of one K2 stage on the card, in two launches:
    ``stage_dw_operands`` forms the conv input gelu(x*a) and the conv
    output's cotangent g_pre*s from the stage's input x, output y and the
    cotangents g_y, g_mom into scratch (unless ``operands``, that pass's
    (h, gc) on the same tensors, are given), then the weight-gradient GEMM
    (see ``ops/conv_kernels.dil_stage_dw_ref``).  Returns dW (5,3,C,C)
    fp32."""
    h, gc = operands or launch_stage_dw_operands(x, a, s, y, g_y, g_mom)
    return _dw_gemm("fused_stage_dw", h, gc, (5, 3), (int(d), 1))


# ----------------------------------- the unfused int8 path (C8, Q8)


# C8's TMA route (csrc/conv_int8.cu): K4's block and ring in int8 -- two
# consumer warpgroups of at most 64 positions each; a ring stage holds
# their two A boxes (64 positions x 128 channels, 8 KiB each) and one B box
# (128 channels x bn outputs)
C8_CHUNK = 128                   # int8 channels per ring stage: 128 bytes
C8_ABOX = 64 * 128               # bytes of one warpgroup's A slot
C8_WIDTHS = (64, 96, 128, 256)   # bn, the block's outputs


def conv_int8_route(B: int, F: int, T: int, C: int, N: int, d: int) -> int:
    """C8's route: the stage engine's int8 loop at C = N = 96 with rows of
    at least 16 positions (the flagship's 96-channel stages, where a
    128-channel TMA box is a quarter zero fill and the engine was faster on
    the card); else the TMA route wherever C and N are multiples of 16 (the
    16-byte strides its tensor maps need: the flagship's 128- and
    256-channel stages, the tiny network's 16 and 32 channels); else the
    ``__dp4a`` tile.  A TMA or engine call on tensors off 16-byte
    alignment raises (``launch_conv_int8``)."""
    if stage_route(STAGE_C8, torch.int8, B, F, T, C, d) == STAGE_ENGINE \
            and N == C:
        return C8_ENGINE
    return C8_TMA if C % 16 == 0 and N % 16 == 0 else C8_TILE


@dataclasses.dataclass(frozen=True)
class C8Plan:
    """The cut of one C8 call on the TMA route, passed to the kernel as its
    Plan struct: these fields, all ints, in this order.  Block (gx, gy, z)
    owns outputs n0 = (z % n_tiles) * bn .. n0 + bn of item z // n_tiles
    at the TT x 2TF positions from (f0, t0) = (gy * 2TF, gx * TT):
    warpgroup w the TF rows from f0 + w TF (its A box, TT * TF <= 64 of
    its 64 rows).  It walks n_k = 15 * nch ring stages, tap = it // nch
    (kf = tap // 3, kt = tap % 3) and channels c0 = (it % nch) * 128 .. c0
    + 128, in a ring of ``stages`` slots.  On the other routes only
    ``route`` is read (the engine's cut is ``stage_plan``'s)."""
    route: int
    B: int
    F: int
    T: int
    C: int
    N: int
    d: int
    TT: int = 0
    TF: int = 0
    bn: int = 0
    n_tiles: int = 0
    nch: int = 0
    n_k: int = 0
    stages: int = 0
    stage_bytes: int = 0
    smem: int = 0
    gx: int = 0
    gy: int = 0
    gz: int = 0

    def meta(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in dataclasses.fields(self)]


def c8_blocks(bn: int) -> int:
    """C8's TMA blocks an SM (K4's rule): two of bn <= 128, one of 256."""
    return 2 if bn <= 128 else 1


def conv_int8_plan(B: int, F: int, T: int, C: int, N: int, d: int,
                   route: int | None = None) -> C8Plan:
    """The route (``conv_int8_route``'s, or ``route``) and, on the TMA
    route, the cut of one C8 call (see ``C8Plan``): K4's A box
    (``_k4_box``); bn the narrowest width of C8_WIDTHS that holds N (else
    256, in several tiles; at N = 256 one tile of 256 ran faster than two
    of 128 on the card).  ``route`` may be given to time another
    route.  Raises for a grid past the card's limits or a route the shape
    cannot take."""
    base = dict(B=B, F=F, T=T, C=C, N=N, d=int(d))
    if route is None:
        route = conv_int8_route(B, F, T, C, N, d)
    if route == C8_ENGINE and conv_int8_route(B, F, T, C, N, d) != route:
        raise ValueError(f"conv_int8: the engine route takes C = N = 96 "
                         f"with T >= 16, not ({B},{F},{T},{C}) -> {N}")
    if route != C8_TMA:
        return C8Plan(route, **base)
    if C % 16 or N % 16:
        raise ValueError(f"conv_int8: the TMA route takes C and N multiples "
                         f"of 16, not C={C}, N={N}")
    TT, TF = _k4_box(F, T)
    bn = next((w for w in C8_WIDTHS if w >= N), C8_WIDTHS[-1])
    n_tiles = -(-N // bn)
    nch = -(-C // C8_CHUNK)
    stage = 2 * C8_ABOX + bn * C8_CHUNK
    stages = min(8, K4_RING // c8_blocks(bn) // stage)
    plan = C8Plan(route, **base, TT=TT, TF=TF, bn=bn, n_tiles=n_tiles,
                  nch=nch, n_k=15 * nch, stages=stages, stage_bytes=stage,
                  smem=stages * stage + 1024, gx=-(-T // TT),
                  gy=-(-F // (2 * TF)), gz=B * n_tiles)
    if plan.gy > 65535 or plan.gz > 65535:
        raise ValueError(f"conv_int8: grid {plan.gx}x{plan.gy}x{plan.gz} "
                         f"too large for ({B},{F},{T},{C}) -> {N}")
    return plan


def _c8_meta(plan: C8Plan):
    """The C int array the kernel reads for ``plan``: its own fields (TMA),
    the engine's StagePlan, or none (the tile), with its length."""
    if plan.route == C8_ENGINE:
        _, meta, n = _stage_plan(STAGE_C8, torch.int8, plan.B, plan.F,
                                 plan.T, plan.C, plan.d)
        return meta, n
    if plan.route == C8_TMA:
        m = plan.meta()
        return (ctypes.c_int * len(m))(*m), len(m)
    return None, 0


# (B, F, T, C, N, d) -> (plan, its meta as a C int array, its length)
_C8_PLANS: dict = {}


def _c8_plan(B: int, F: int, T: int, C: int, N: int, d: int):
    key = (B, F, T, C, N, d)
    if key not in _C8_PLANS:
        plan = conv_int8_plan(B, F, T, C, N, d)
        _C8_PLANS[key] = (plan, *_c8_meta(plan))
    return _C8_PLANS[key]


def launch_conv_int8(q: torch.Tensor, qwt: torch.Tensor,
                     scale: torch.Tensor, d: int, dtype,
                     want_acc: bool = False, plan: C8Plan | None = None):
    """C8 on the card: the 'SAME' (5,3) conv at dilation (d,1) of int8 q
    (B,F,T,C) with the tap-major int8 kernel qwt (15,N,C), rescaled by
    scale (B,N) fp32 into ``dtype`` (fp32 or bf16).  Returns out (B,F,T,N),
    or (out, the int32 accumulator) with ``want_acc``.  The route and cut
    are ``conv_int8_plan``'s (``plan``, made for this call's shape, to time
    another cut): the TMA route reads qwt as it is, through a tensor map,
    the engine its pack (``stage_int8_weights``); both raise for a tensor
    off 16-byte alignment."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_int8: unsupported output dtype {dtype}")
    _check(q, "conv_int8 q", torch.int8)
    B, F, T, C = q.shape
    N = qwt.shape[1]
    d = int(d)
    _check(qwt, "conv_int8 qwt", torch.int8, (15, N, C))
    _check(scale, "conv_int8 scale", torch.float32, (B, N))
    if plan is None:
        plan, meta, n_meta = _c8_plan(B, F, T, C, N, d)
    else:
        got = (plan.B, plan.F, plan.T, plan.C, plan.N, plan.d)
        if got != (B, F, T, C, N, d):
            raise ValueError(f"conv_int8: a plan for {got}, not "
                             f"{(B, F, T, C, N, d)}")
        meta, n_meta = _c8_meta(plan)
    wpk = stage_int8_weights(qwt) if plan.route == C8_ENGINE else qwt
    out = torch.empty((B, F, T, N), dtype=dtype, device=q.device)
    acc = (torch.empty((B, F, T, N), dtype=torch.int32, device=q.device)
           if want_acc else None)
    ptrs = (q.data_ptr(), qwt.data_ptr(), wpk.data_ptr(), scale.data_ptr(),
            out.data_ptr(), None if acc is None else acc.data_ptr())
    if plan.route != C8_TILE and (
            ptrs[0] | ptrs[1] | ptrs[3] | ptrs[4] | (ptrs[5] or 0)) % 16:
        raise ValueError(f"conv_int8: the {C8_ROUTES[plan.route]} route "
                         f"needs 16-byte aligned tensors")
    rc = _entry("conv_int8")(*ptrs, B, F, T, C, N, d, _DTYPES[dtype],
                             plan.route, meta, n_meta, _stream(q))
    _status("conv_int8", rc)
    LAUNCHES["conv_int8"] += 1
    ROUTE_LAUNCHES["conv_int8"][C8_ROUTES[plan.route]] += 1
    return (out, acc) if want_acc else out


# Q8's cut (csrc/quant_int8.cu): 1024 threads a block, 16 elements a
# step (one 16-byte store of int8), at least one step a thread per unit
Q8_THREADS = 1024
Q8_GROUP = 16
Q8_MIN_CHUNK = Q8_THREADS * Q8_GROUP
Q8_PARTS = {"scale": 1, "partial": 2}


@dataclasses.dataclass(frozen=True)
class Q8Plan:
    """Q8's cut of x (B, per_b): each item in ``per_item`` units of
    ``chunk`` elements (a multiple of Q8_GROUP; an item's last unit
    shorter), unit u = (item u // per_item, its u % per_item-th chunk);
    ``grid`` blocks, block k taking units k, k + grid, ... (one each when
    per_item > 1, where all B * per_item must be resident)."""
    B: int
    per_b: int
    grid: int
    per_item: int
    chunk: int

    @property
    def units(self) -> int:
        return self.B * self.per_item

    def block_units(self, k: int) -> range:
        return range(k, self.units, self.grid)

    def span(self, u: int) -> tuple[int, int]:
        """Unit u's elements [lo, hi) of the flattened x."""
        b, j = divmod(u, self.per_item)
        lo = j * self.chunk
        return b * self.per_b + lo, b * self.per_b + min(lo + self.chunk,
                                                         self.per_b)


def q8_plan(B: int, per_b: int, dtype, sms: int,
            blocks_per_sm: int) -> Q8Plan:
    """Q8's cut for x (B, per_b) in ``dtype`` on a card of ``sms`` SMs holding
    ``blocks_per_sm`` of act_quant_dyn's blocks each: the resident
    blocks shared among the items (no more per item than its elements
    fill at one step a thread), units of whole 16-element steps; with more
    items than resident blocks one unit per item, the blocks walking
    them."""
    if B <= 0 or per_b <= 0:
        raise ValueError(f"q8_plan: empty x ({B}, {per_b})")
    resident = sms * blocks_per_sm
    if resident <= 0:
        raise ValueError(f"q8_plan: no resident blocks ({sms} SMs x "
                         f"{blocks_per_sm})")
    per_item = max(1, min(resident // B, -(-per_b // Q8_MIN_CHUNK)))
    per_unit = -(-per_b // per_item)
    chunk = -(-per_unit // Q8_GROUP) * Q8_GROUP
    per_item = -(-per_b // chunk)
    return Q8Plan(B, per_b, min(B * per_item, resident), per_item, chunk)


# per device: (SMs, {dtype: act_quant_dyn's resident blocks per SM}, the
# partials' workspace); per (device, dtype, B, numel): the plan
_Q8_STATE: dict = {}
_Q8_PLANS: dict = {}


def q8_prepare(device) -> None:
    """Ask the card's occupancy for act_quant_dyn in both dtypes and make
    the partials' workspace (one float per resident block), once per
    device.  The first Q8 call on a device does it; a CUDA graph capture
    cannot (its allocations would come from the graph's private pool), so
    a capture whose first Q8 call it holds raises unless this, or one
    eager Q8 call, came first.  The workspace serves one stream (or one
    captured graph) at a time."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device in _Q8_STATE:
        return
    per_sm = {}
    for dtype in (torch.float32, torch.bfloat16):
        n = _entry("q8_slots")(_DTYPES[dtype])
        if n <= 0:
            raise RuntimeError(f"act_quant_dyn: occupancy query failed: "
                               f"cudaError {-n}")
        per_sm[dtype] = n
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    partial = torch.empty((sms * max(per_sm.values()),), dtype=torch.float32,
                          device=device)
    _Q8_STATE[device] = (sms, per_sm, partial)


def _q8_state(device):
    if device not in _Q8_STATE:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "Q8: the first call on a device inside a CUDA graph "
                "capture; call kernels.q8_prepare(device) (or one eager "
                "Q8 call) before capturing")
        q8_prepare(device)
    return _Q8_STATE[device]


def q8_cut(x: torch.Tensor, name: str = "q8"):
    """(plan, partials workspace) for x (B, ...) on its card, from
    ``q8_prepare``'s state; the plan cached per (device, dtype, shape)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    _check(x, f"{name} x")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty x {tuple(x.shape)}")
    sms, per_sm, partial = _q8_state(x.device)
    B = x.shape[0]
    key = (x.device, x.dtype, B, x.numel())
    if key not in _Q8_PLANS:
        _Q8_PLANS[key] = q8_plan(B, x.numel() // B, x.dtype, sms,
                                 per_sm[x.dtype])
    return _Q8_PLANS[key], partial


def launch_act_quant_dyn(x: torch.Tensor):
    """Q8's dynamic per-item quantization on the card, one cooperative
    launch: x (B, ...) fp32 or bf16 -> (q int8 like x, s (B,) fp32) at a =
    max(max |x[b]|, 1e-20), s = a/127, q = clip(rint(float(x) * (127/a)),
    +-127) (plain version ``ops/conv_kernels.quant_act_per_item`` on the
    CPU).  A grid the card cannot hold at once raises."""
    plan, partial = q8_cut(x, "act_quant_dyn")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((plan.B,), dtype=torch.float32, device=x.device)
    rc = _entry("act_quant_dyn")(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), partial.data_ptr(),
        plan.B, plan.per_b, _DTYPES[x.dtype], plan.per_item, plan.chunk,
        plan.grid, _stream(x))
    _status("act_quant_dyn", rc)
    LAUNCHES["act_quant_dyn"] += 1
    return q, s


def launch_act_quant_dyn_part(x: torch.Tensor, upto: str):
    """act_quant_dyn stopped early, to time or check its parts (counted
    nowhere: no path runs it): "scale" (phase 1, the barrier and s; no q)
    or "partial" (phase 1 alone).  Returns (s, the partials' workspace):
    after "partial", slot u holds unit u's max (``Q8Plan.span``), or,
    where blocks walk items (per_item 1, B > grid), slot k block k's last
    item's."""
    if upto not in Q8_PARTS:
        raise ValueError(f"act_quant_dyn part: {upto!r} is not one of "
                         f"{sorted(Q8_PARTS)}")
    plan, partial = q8_cut(x, "act_quant_dyn part")
    s = torch.empty((plan.B,), dtype=torch.float32, device=x.device)
    rc = _entry("q8_part")(
        x.data_ptr(), None, s.data_ptr(), partial.data_ptr(), plan.B,
        plan.per_b, _DTYPES[x.dtype], plan.per_item, plan.chunk, plan.grid,
        Q8_PARTS[upto], _stream(x))
    _status("act_quant_dyn part", rc)
    return s, partial


def launch_act_quant(x: torch.Tensor, amax: torch.Tensor):
    """Q8's quantizer on the card: x (B, ...) fp32 or bf16 at the per-item
    amax (B,) fp32 -> (q int8 like x, s (B,) fp32), a = max(amax, 1e-20),
    s = a/127, q = clip(rint(float(x) * (127 / a)), +-127) (plain version
    ``ops/conv_kernels.quant_act_ref``); act_quant_dyn's phase 2 on its
    cut."""
    plan, _ = q8_cut(x, "act_quant")
    _check(amax, "act_quant amax", torch.float32, (plan.B,))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((plan.B,), dtype=torch.float32, device=x.device)
    rc = _entry("act_quant")(x.data_ptr(), amax.data_ptr(), q.data_ptr(),
                             s.data_ptr(), plan.B, plan.per_b,
                             _DTYPES[x.dtype], plan.per_item, plan.chunk,
                             plan.grid, _stream(x))
    _status("act_quant", rc)
    LAUNCHES["act_quant"] += 1
    return q, s


# the rescale's cut (csrc/quant_int8.cu, act_rescale): at most 256
# threads a block, each taking up to RESCALE_ROWS rows once the grid has
# RESCALE_BLOCKS blocks
RESCALE_THREADS = 256
RESCALE_ROWS = 8
RESCALE_BLOCKS = 528   # four blocks an SM of the H100's 132


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    """act_rescale's cut of acc (B, rows, N): a grid of gx x B blocks of
    ``threads``, block (x, b) taking rows [x rows_blk, (x + 1) rows_blk) of
    item b.  ``vec``: thread t takes channels 8 (t % R) .. + 8 of rows t //
    R, t // R + P, ... of its block (R = N / 8, P = threads / R); else warp
    w takes rows w, w + 8, ... and its lanes the channels."""
    B: int
    rows: int
    N: int
    vec: bool
    threads: int
    rows_blk: int
    gx: int

    def thread_cells(self, t: int) -> tuple[range, range]:
        """(rows, channels) of block 0's thread t, per item: the kernel's
        walk, for the tests' mirror."""
        if self.vec:
            R = self.N // 8
            P = self.threads // R
            if t // R >= P:
                return range(0), range(0)
            return (range(t // R, self.rows_blk, P),
                    range(8 * (t % R), 8 * (t % R) + 8))
        return (range(t // 32, self.rows_blk, self.threads // 32),
                range(t % 32, self.N, 32))


def rescale_plan(B: int, rows: int, N: int, vec: bool) -> RescalePlan:
    """The cut of one act_rescale call (``RescalePlan``): vec (N a multiple
    of 8, the tensors 16-byte aligned) takes R = N / 8 threads a row and P
    = 256 // R rows a pass; each thread walks more rows (up to
    RESCALE_ROWS) only while the grid keeps RESCALE_BLOCKS blocks."""
    if B <= 0 or rows <= 0 or N <= 0 or B > 65535 or rows >= 2**31:
        raise ValueError(f"act_rescale: no cut for ({B}, {rows}, {N})")
    vec = bool(vec) and N % 8 == 0 and N // 8 <= RESCALE_THREADS
    if vec:
        R = N // 8
        P = RESCALE_THREADS // R
        threads = R * P
    else:
        P, threads = RESCALE_THREADS // 32, RESCALE_THREADS
    per_thread = max(1, min(RESCALE_ROWS,
                            rows // (P * max(1, RESCALE_BLOCKS // B))))
    rows_blk = P * per_thread
    return RescalePlan(B, rows, N, vec, threads, rows_blk, -(-rows // rows_blk))


# (B, rows, N, vec) -> plan
_RESCALE_PLANS: dict = {}


def launch_act_rescale(acc: torch.Tensor, scale: torch.Tensor,
                       dtype) -> torch.Tensor:
    """Q8's rescale on the card: acc (B, ..., N) int32 with scale (B, N)
    fp32 -> float(acc) * scale[b, n] in ``dtype`` (fp32 or bf16; plain
    version ``ops/conv_kernels.int8_rescale_ref``), on ``rescale_plan``'s
    cut: 8 channels a thread where N is a multiple of 8 and acc 16-byte
    aligned, else one element a thread."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"act_rescale: unsupported output dtype {dtype}")
    _check(acc, "act_rescale acc", torch.int32)
    B, N = acc.shape[0], acc.shape[-1]
    _check(scale, "act_rescale scale", torch.float32, (B, N))
    out = torch.empty_like(acc, dtype=dtype)
    if acc.numel() == 0:
        return out
    rows = acc.numel() // (B * N)
    a_p, o_p = acc.data_ptr(), out.data_ptr()
    vec = N % 8 == 0 and (a_p | o_p) % 16 == 0
    key = (B, rows, N, vec)
    plan = _RESCALE_PLANS.get(key)
    if plan is None:
        plan = _RESCALE_PLANS[key] = rescale_plan(B, rows, N, vec)
    rc = _entry("act_rescale")(a_p, scale.data_ptr(), o_p, B, rows, N,
                               _DTYPES[dtype], int(plan.vec), plan.threads,
                               plan.rows_blk, plan.gx, _stream(acc))
    _status("act_rescale", rc)
    LAUNCHES["act_rescale"] += 1
    return out


# ------------------------------------------------- the IIR recursion

IIR_REG_N = 16  # coefficients per side held in registers; more: scratch


def launch_lfilter(x: torch.Tensor, coef: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """The IIR recursion on the card: x (R, L) fp32 rows, coef (2n,) fp32
    (b then a, both divided by a[0]); ``reverse`` filters each row back to
    front (reads and writes reversed).  Returns y (R, L)."""
    if x.dim() != 2:
        raise ValueError(f"lfilter: x must be (R, L), got {tuple(x.shape)}")
    _check(x, "lfilter x", torch.float32)
    _check(coef, "lfilter coef", torch.float32)
    if coef.dim() != 1 or coef.numel() % 2 or coef.numel() < 4:
        raise ValueError(f"lfilter: coef must hold b then a, n >= 2 each, "
                         f"got {tuple(coef.shape)}")
    R, L = x.shape
    n = coef.numel() // 2
    y = torch.empty_like(x)
    scratch = (torch.empty((R, n - 1), dtype=torch.float32, device=x.device)
               if n > IIR_REG_N else None)
    rc = _entry("lfilter")(x.data_ptr(), y.data_ptr(), coef.data_ptr(),
                           None if scratch is None else scratch.data_ptr(),
                           R, L, n, int(bool(reverse)), _stream(x))
    _status("lfilter", rc)
    LAUNCHES["lfilter"] += 1
    return y
