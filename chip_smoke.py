#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``babe_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every default phase
    python3 chip_smoke.py --phases identify,profile   # a time breakdown

Phases (any failure exits non-zero; no phase catches and carries on):

  1. identify   the card (nvidia-smi name and power limit), torch and CUDA
                versions, and the kernel build (one nvcc per source, all
                started together) with its time and ptxas resource lines.
  2. kernels    every hand kernel against its plain PyTorch version on
                the card, in bf16 and fp32, at every shape the flagship
                paths give it: K1 (conv5x3) at each pyramid conv and its
                transpose, K2 (fused dilation stage, moments included) and
                its backward kernel at each (C, d, F, T) stage of the
                network on the full 184184-sample segment, each line
                naming the route the call took (a bf16 main-path shape
                off K1's narrow routes or off the stage engine of K2 or
                K2's backward fails; K2's engine lines also hold its
                operand pass), then both at their edge shapes (K1_EDGE,
                STAGE_BWD_EDGE), K3 (the int8 stage) at each stage of at
                least 96 channels and one of 100 channels, with the share
                of int8 conv inputs that differ from the plain version's
                (a bf16 main-path shape off K3's engine fails); then K2
                and K3 at their own edge shapes (STAGE_FWD_EDGE,
                K3_EDGE) and K2 in fp32 at every stage shape over the
                seeds K2_FP32_SEEDS (K2's fp32 conv output and y are held
                to the plain version run in float64 on the same inputs,
                within K2_FP32_RATIO of the plain fp32 version's own
                error); K4 (the
                general dilated conv) at tests/test_pallas_conv.py's shapes
                with kernels (3,3), (5,3), (7,3), (3,5) and dilations up to
                (4,1) and (2,2), and
                at the five level shapes of pallas_conv.py's table (batch
                4), then through its entry point (forward and dx) at those
                shapes with its launches counted; the weight gradients
                conv_dw (the 7 pyramid convs and their transposed shapes)
                and fused_stage_dw with its operand pass
                stage_dw_operands (every distinct stage shape) at the
                training batch (4 x 184184 samples), then both at the edge
                shapes of their cut (rows spanning chunks, ragged T, 96
                channels, the folded narrow side, d = 64 on F = 384) and
                conv_dw at K4's kernels with dt = 2.  Each shape also gets
                its time, its bound, the plain version's time and a cuDNN
                yardstick (a conv, or its weight gradient; bf16 for K3: no
                PyTorch call computes an int8 conv).
  3. probe      the int8 probe's kernels (P1 GEMM, P2 stage core) against
                their plain versions (int8 bit-exact), then the probe entry
                point (``babe_tpu_torch.tools.probe_int8``) at its four shapes
                in bf16 and int8, with its launches counted.
  4. check      the model on the card against the same model on the CPU
                (plain path, itself held to the JAX package by the tests):
                denoiser output and guidance gradient at the tiny config in
                fp32 and at the flagship widths on a short segment in fp32,
                bf16 and int8, and int8 against the CPU's int8 with the
                CPU's run forced onto the card's at every int8 stage; then
                the gradients of every parameter for one training step
                (fixed sigma and noise, remat, opened gates) in fp32 and
                bf16.
  5. requests   the flagship model from a seed, written as a JAX-format
                .ckpt, loaded twice with ``BABE.load`` on the card (bf16 and
                ``precision="int8"``), each answering two blind ``enhance``
                requests and one informed one on 184184 samples of seeded
                low-passed audio.  The launch counters are zeroed just before
                each model's requests and read just after.
  6. train      ``python -m babe_tpu_torch.train``'s main at the flagship
                config (seeded 44.1 kHz wavs, exp=maestro22k_8s: batch 4,
                184184 samples, resample factor 2, remat, bf16) for 5
                steps, 2 untimed: s/step, audio-seconds trained per second,
                peak memory, the device's busy share over one profiled
                step, each step's launches held to the network's counts
                (remat recompute included), params and EMA that moved,
                then the written .ckpt loaded with BABE.load on the card
                answering one blind request.
  7. quality    the same-seed 35-step unconditional trajectory of the
                flagship model (110250 samples, batch 4, gates opened with
                N(0, 0.02^2)) in bf16 and in int8: the waveform's relative
                divergence and the LSD between the two, reported, not gated.

The last two lines are the kernels line and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BF16 = 989e12   # H100 SXM dense tensor-core bf16, FLOP/s
PEAK_INT8 = 1979e12  # H100 SXM dense tensor-core int8, OP/s
PEAK_FP32 = 67e12    # H100 SXM fp32 outside the tensor cores, FLOP/s
HBM_BPS = 3.35e12    # H100 SXM HBM3, bytes/s
# bf16 outputs may differ from the plain version by a rounding flip of the
# last stored bit (the sums run in another order): 4 bf16 ulps of the
# largest value bound the max error; fp32 differs by summation order only
TOL = {"bfloat16": {"max_rel": 4 * 2.0**-8, "l2_rel": 4e-3},
       "float32": {"max_rel": 2e-5, "l2_rel": 2e-6}}
REPLACES = {
    "conv5x3": "babe_tpu/ops/conv_kernels.py:449",
    "fused_stage": "babe_tpu/ops/conv_kernels.py:809",
    # the backward of K2's custom vjp (_fused_bwd, the vjp of _dil_stage_ref)
    "fused_stage_bwd": "babe_tpu/ops/conv_kernels.py:1090",
    # no Pallas kernel: the lax.while_loop of fit_params (XLA on the TPU)
    "filter_fit": "babe_tpu/sampling/blind.py:157",
    "fused_stage_int8": "babe_tpu/ops/conv_kernels.py:1162",
    # the prologues of K2 and K3 (gelu(x*a), and its int8 quantization),
    # formed once per element for the stage engine
    "stage_fwd_operand": "babe_tpu/ops/conv_kernels.py:809",
    "stage_int8_operand": "babe_tpu/ops/conv_kernels.py:1162",
    "probe_gemm": "tools/probe_pallas_int8.py:50",
    "probe_stage": "tools/probe_pallas_int8.py:97",
    "dilated_conv": "babe_tpu/ops/pallas_conv.py:44",
    # the weight halves of the custom vjps (XLA on the TPU): K1's
    # linear_transpose of conv_xla in w, and K2's vjp of _dil_stage_ref
    "conv_dw": "babe_tpu/ops/conv_kernels.py:600",
    "fused_stage_dw": "babe_tpu/ops/conv_kernels.py:1090",
    # the prologues of that vjp (gelu(x*a), and the cotangent of the conv
    # output), formed for the weight gradient's GEMM
    "stage_dw_operands": "babe_tpu/ops/conv_kernels.py:1090",
}
SOURCES = {
    "conv5x3": "babe_tpu_torch/csrc/conv5x3.cu",
    "fused_stage": "babe_tpu_torch/csrc/fused_stage.cu",
    "fused_stage_bwd": "babe_tpu_torch/csrc/fused_stage.cu",
    "filter_fit": "babe_tpu_torch/csrc/filter_fit.cu",
    "fused_stage_int8": "babe_tpu_torch/csrc/fused_stage_int8.cu",
    "stage_fwd_operand": "babe_tpu_torch/csrc/fused_stage.cu",
    "stage_int8_operand": "babe_tpu_torch/csrc/fused_stage_int8.cu",
    "probe_gemm": "babe_tpu_torch/csrc/probe_int8.cu",
    "probe_stage": "babe_tpu_torch/csrc/probe_int8.cu",
    "dilated_conv": "babe_tpu_torch/csrc/dilated_conv.cu",
    "conv_dw": "babe_tpu_torch/csrc/conv_dw.cu",
    "stage_dw_operands": "babe_tpu_torch/csrc/conv_dw.cu",
    "fused_stage_dw": "babe_tpu_torch/csrc/conv_dw.cu",
}
# what each kernel's ms, plain_ms, bound_ms and library_ms sum over
PER = {
    "filter_fit": "one guided evaluation of a blind request, fp32",
    "fused_stage": "one guided evaluation, bf16, main-path shapes, its "
                   "operand pass included; library_ms is a cuDNN conv (the "
                   "conv alone)",
    "stage_fwd_operand": "one guided evaluation, bf16, main-path shapes: "
                         "the 75 stages' operand passes (also inside "
                         "fused_stage's ms); no PyTorch call computes them",
    "stage_int8_operand": "one guided evaluation of an int8 request, bf16 "
                          "carrier, main-path shapes: the 68 stages' "
                          "operand passes (also inside fused_stage_int8's "
                          "ms); no PyTorch call computes them",
    "fused_stage_int8": "one guided evaluation of an int8 request, bf16 "
                        "carrier, main-path shapes, its operand pass "
                        "included; library_ms is a bf16 "
                        "cuDNN conv (no PyTorch call computes an int8 conv)",
    "probe_gemm": "one product at each of 2 shapes x (bf16, int8), timed "
                  "over launches of 16 repetitions; library_ms is cuBLAS "
                  "(a @ b, torch._int_mm)",
    "probe_stage": "one product at each of 2 shapes x (bf16, int8), timed "
                   "over launches of 8 repetitions",
    "dilated_conv": "one forward at each of the five level shapes of "
                    "pallas_conv.py's table (batch 4, kernel (5,3), N = C), "
                    "bf16; launches: its entry point's forward and dx at "
                    "those shapes; library_ms is cuDNN F.conv2d",
    "conv_dw": "one training step (flagship, batch 4, 184184 samples), "
               "bf16: the 7 pyramid convs' weight gradients; library_ms is "
               "cuDNN's weight gradient (aten.convolution_backward)",
    "stage_dw_operands": "one training step (flagship, batch 4, 184184 "
                         "samples), bf16: the 75 stages' operand passes "
                         "(also inside fused_stage_dw's ms); no PyTorch "
                         "call computes them",
    "fused_stage_dw": "one training step (flagship, batch 4, 184184 "
                      "samples), bf16: the 75 stages' weight gradients, "
                      "each its operand pass and its GEMM; library_ms is "
                      "cuDNN's weight gradient of the same conv (without "
                      "the prologues)",
}
# where each kernel's launch count comes from
LAUNCHES_FROM = {
    "probe_gemm": "the probe run", "probe_stage": "the probe run",
    "fused_stage_int8": "the int8 requests",
    "stage_int8_operand": "the int8 requests",
    "dilated_conv": "the K4 entry-point run of the kernels phase",
    "conv_dw": "the train phase (all its steps)",
    "stage_dw_operands": "the train phase (all its steps)",
    "fused_stage_dw": "the train phase (all its steps)",
}
# the weight gradients are summed over up to 2.9M positions in another
# order than the plain version's (fp32 partials added by atomics): both
# dtypes give fp32 dW, held at these bars
DW_TOL = {"max_rel": 1e-4, "l2_rel": 5e-5}
# the kernels the train phase must launch, each an exact count per step
TRAIN_PATH = ("conv5x3", "fused_stage", "stage_fwd_operand",
              "fused_stage_bwd", "conv_dw", "stage_dw_operands",
              "fused_stage_dw")
DW_KERNELS = ("conv_dw", "stage_dw_operands", "fused_stage_dw")
# the kernels each request path must launch; the probe's run on its own path
BF16_PATH = ("conv5x3", "fused_stage", "stage_fwd_operand",
             "fused_stage_bwd", "filter_fit", "stage_dw_operands")
INT8_PATH = BF16_PATH + ("fused_stage_int8", "stage_int8_operand")
PROBE_PATH = ("probe_gemm", "probe_stage")


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int = 5, warm: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def errs(out, ref) -> tuple[float, float, float]:
    """(max abs error, max abs error / max |ref|, relative L2 error)."""
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    scale = max(float(r.abs().max()), 1e-30)
    l2 = float((o - r).norm() / max(float(r.norm()), 1e-30))
    return float(d.max()), float(d.max()) / scale, l2


def within(e, dtype_name: str) -> bool:
    tol = TOL[dtype_name]
    return e[1] <= tol["max_rel"] and e[2] <= tol["l2_rel"]


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least time for the work at the card's peak rate for ``dtype``'s
    operations (bf16, int8 or fp32) and its memory rate."""
    import torch

    peak = {torch.bfloat16: PEAK_BF16, torch.int8: PEAK_INT8}.get(
        dtype, PEAK_FP32)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ------------------------------------------------------------------ shapes


def flagship_shapes(cqt, Ns, num_dils):
    """The (5,3) convs of one guided evaluation of the flagship network.

    Returns (k2, k1): k2 maps (F, T, C, d) -> stages per evaluation (each
    runs K2 forward and its backward kernel once); k1 maps
    (F, T, C, N, d, role) -> launches per evaluation (the forward pyramid
    convs and their transposes; the stage shapes with 0)."""
    n = len(Ns)
    Mtop = cqt.M[-1]
    k2, k1 = {}, {}

    def add(dct, key, k=1):
        dct[key] = dct.get(key, 0) + k

    def stages(F, T, C, nd):
        for i in range(nd):
            add(k2, (F, T, C, 2**i))
            # K1 at the stage's square shape: off the path since the stage
            # backward has its own kernel, kept as a check (count 0)
            add(k1, (F, T, C, C, 2**i, "stage shape"), 0)

    for i in range(n):
        F, T = 64 * (i + 1), Mtop >> i
        stages(F, T, Ns[i], num_dils[i])
        Tp = T // 2 if i < n - 1 else T
        add(k1, (F, Tp, 2, Ns[i], 1, "pyramid fwd"))
        add(k1, (F, Tp, Ns[i], 2, 1, "pyramid dx"))
    stages(64 * n, Mtop >> (n - 1), Ns[-1], num_dils[-1])
    for j in range(n - 1, -1, -1):
        C = Ns[j - 1] if j > 0 else Ns[0]
        stages(64 * (j + 1), Mtop >> j, C, num_dils[j])
    return k2, k1


# ------------------------------------------------------------------ phases


def phase_identify(kernels):
    import torch

    log(f"card: {smi_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        f"(one nvcc per source, in parallel; per source "
        f"{ {k: round(v, 1) for k, v in kernels.BUILD_SECONDS.items()} })")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            # the stage engine's and operand passes' entries name the
            # register and spill lines that follow them
            if ("registers" in line or "spill" in line or "C7513" in line
                    or ("Compiling entry" in line and "stage_" in line)):
                log(f"  ptxas[{name}]: {line.strip()}")


def phase_kernels(results: dict):
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck
    from babe_tpu_torch.ops.cqt import get_cqt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    Ns, num_dils = (64, 96, 96, 128, 128, 256, 256), (2, 3, 4, 5, 6, 7, 7)
    k2_shapes, k1_shapes = flagship_shapes(get_cqt(7, 64, 22050.0, 184184),
                                           Ns, num_dils)
    g = torch.Generator(device=dev).manual_seed(0)
    g8 = torch.Generator(device=dev).manual_seed(8)  # K3's own stream
    g9 = torch.Generator(device=dev).manual_seed(9)  # the edge shapes' own
    ok = True
    agg = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "max_abs_err": 0.0, "flops": 0.0,
                  "bytes": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "shapes": 0}
           for name in SOURCES if name not in PROBE_PATH}
    # K3 runs every stage of at least 96 channels; one 100-channel shape
    # (not on the path) checks channels that are not a multiple of 32
    k3_shapes = {k: c for k, c in k2_shapes.items() if k[2] >= 96}
    F0, T0, _, _ = min(k3_shapes)
    k3_shapes[(F0, T0, 100, 2)] = 0

    def library_conv(x, w, d):
        return _library_conv(x, w, (d, 1))

    def account(name, count, dtype, t_k, t_p, t_l, flops, nbytes, e,
                op_dtype=None):
        """Add one shape's numbers, times its launches per evaluation, to
        the kernel's bf16 totals; op_dtype is the type of its products."""
        if dtype != torch.bfloat16:
            return
        a = agg[name]
        op_dtype = op_dtype or dtype
        b, _ = bound_ms(flops, nbytes, op_dtype)
        a["ms"] += count * t_k
        a["plain_ms"] += count * t_p
        a["library_ms"] += count * t_l
        a["bound_ms"] += count * b
        a["flops"] += count * flops
        a["bytes"] += count * nbytes
        a["ops_ms"] += count * bound_ms(flops, 0.0, op_dtype)[0]
        a["bytes_ms"] += count * 1e3 * nbytes / HBM_BPS
        a["max_abs_err"] = max(a["max_abs_err"], e[0])
        a["shapes"] += 1

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        isz = torch.tensor([], dtype=dtype).element_size()
        for (F, T, C, N, d, role), count in sorted(k1_shapes.items()):
            x = torch.randn((1, F, T, C), generator=g, device=dev).to(dtype)
            w = (torch.randn((5, 3, C, N), generator=g, device=dev)
                 / math.sqrt(15 * C)).to(dtype)
            # a transposed-weight call (an input gradient) runs as the
            # main path runs it, from the forward kernel wf
            tr = role != "pyramid fwd"
            wf = w.transpose(2, 3).contiguous() if tr else w
            if tr:
                w = ck._flip_io(wf)
            y = kernels.launch_conv5x3(x, wf, d, transposed=tr)
            ref = ck.conv_ref(x, w, d)
            torch.cuda.synchronize()
            e = errs(y, ref)
            if tr:  # the kernel w given as is gives the same
                e = max(e, errs(kernels.launch_conv5x3(x, w, d), ref))
            route = K1_ROUTES[kernels.conv5x3_route(dtype, C, N)]
            # the main path's bf16 shapes take the narrow routes
            good = within(e, dn) and (dtype != torch.bfloat16 or count == 0
                                      or route != "tile")
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_conv5x3(
                x, wf, d, transposed=tr))
            t_p = cuda_time(lambda: ck.conv_ref(x, w, d), reps=2)
            t_l = cuda_time(library_conv(x, w, d))
            flops = 2.0 * F * T * C * N * 15
            nbytes = (F * T * (C + N) + 15 * C * N) * isz
            b, by = bound_ms(flops, nbytes, dtype)
            log(f"K1 {dn:8s} [{route}] {role:11s} F={F:3d} T={T:4d} "
                f"C={C:3d} N={N:3d} d={d:2d} x{count:2d}: max_abs="
                f"{e[0]:.3e} max_rel={e[1]:.2e} l2_rel={e[2]:.2e} "
                f"{'ok' if good else 'FAIL'} | "
                f"ms={t_k:.4f} bound={b:.4f}({by}) plain={t_p:.4f} "
                f"cudnn={t_l:.4f}")
            account("conv5x3", count, dtype, t_k, t_p, t_l, flops, nbytes, e)
        for (F, T, C, d), count in sorted(k2_shapes.items()):
            x = torch.randn((1, F, T, C), generator=g, device=dev).to(dtype)
            w = (torch.randn((5, 3, C, C), generator=g, device=dev)
                 / math.sqrt(15 * C)).to(dtype)
            a = 0.5 + torch.rand((1, C), generator=g, device=dev)
            s = torch.randn((1, C), generator=g, device=dev)
            good, line, (ey, eh), y, c = _stage_fwd_case(
                x, a, s, w, d, main_path=True)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_fused_stage(
                x, a, s, w, d, want_conv=True))
            t_p = cuda_time(lambda: ck._dil_stage_parts(x, a, s, w, d),
                            reps=2)
            t_l = cuda_time(library_conv(x, w, d))
            flops = 2.0 * F * T * C * C * 15
            nbytes = (3 * F * T * C + 15 * C * C) * isz + 4 * 4 * C
            b, by = bound_ms(flops, nbytes, dtype)
            line += (f" x{count} | ms={t_k:.4f} bound={b:.4f}({by}) "
                     f"plain={t_p:.4f} cudnn={t_l:.4f}")
            if kernels.stage_fwd_route(dtype, 1, F, T, C, d) == (
                    kernels.STAGE_ENGINE):
                # the engine's operand pass alone: x read, h written, about
                # 30 fp32 operations per element (the gelu polynomial and
                # the roundings)
                t_o = cuda_time(lambda: kernels.launch_stage_fwd_operand(
                    x, a))
                t_op = cuda_time(lambda: ck.stage_gelu_ref(x, a), reps=2)
                o_flops, o_bytes = 30.0 * F * T * C, 2 * F * T * C * isz
                bo, byo = bound_ms(o_flops, o_bytes, torch.float32)
                line += (f"; operand pass ms={t_o:.4f} bound={bo:.4f}"
                         f"({byo}) plain={t_op:.4f}")
                account("stage_fwd_operand", count, dtype, t_o, t_op, 0.0,
                        o_flops, o_bytes, eh, op_dtype=torch.float32)
            log(line)
            account("fused_stage", count, dtype, t_k, t_p, t_l, flops,
                    nbytes, ey)
            # the stage's backward: cotangents of y and of the moments;
            # its time includes the engine's operand pass
            good, line, edx, args = _stage_bwd_case(x, a, s, w, y, c, d, g,
                                                    main_path=True)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_fused_stage_bwd(
                *args, w, d))
            t_p = cuda_time(lambda: ck.dil_stage_bwd_ref(
                x, a, s, w, y, c, args[0], args[1], d), reps=2)
            t_l = cuda_time(library_conv(x, ck._flip_io(w), d))
            nbytes = (5 * F * T * C + 15 * C * C) * isz + 6 * 4 * C
            b, by = bound_ms(flops, nbytes, dtype)
            log(f"{line} x{count} | ms={t_k:.4f} bound={b:.4f}({by}) "
                f"plain={t_p:.4f} cudnn={t_l:.4f}")
            account("fused_stage_bwd", count, dtype, t_k, t_p, t_l, flops,
                    nbytes, edx)
        ok &= _kernel_edges(dtype, g9)
        for (F, T, C, d), count in sorted(k3_shapes.items()):
            ok &= _kernel_int8_stage(1, F, T, C, d, count, dtype, g8,
                                     account, library_conv)
    # drawn after every earlier edge check, so those keep their inputs
    for dtype in (torch.bfloat16, torch.float32):
        ok &= _stage_fwd_edges(dtype, g9)
    ok &= _k2_fp32_evidence(k2_shapes)
    ok &= _kernel_filter_fit(agg["filter_fit"])
    ok &= _kernel_k4(account, results)
    ok &= _kernel_dw(account, k1_shapes, k2_shapes)
    for name in ("stage_dw_operands", "stage_fwd_operand",
                 "stage_int8_operand"):
        agg[name]["library_ms"] = None
    for name, a in agg.items():
        if name == "filter_fit":
            continue  # logged by _kernel_filter_fit
        per = ("one training step" if name in DW_KERNELS
               else "one forward at each level shape" if name ==
               "dilated_conv" else "guided evaluation")
        lib = ("none" if a["library_ms"] is None
               else f"{a['library_ms']:.3f}")
        log(f"{name}: per {per} (bf16, main-path shapes and "
            f"counts) ms={a['ms']:.3f} bound_ms={a['bound_ms']:.3f} "
            f"plain_ms={a['plain_ms']:.3f} cudnn_ms={lib}"
            f"{' (bf16 conv)' if name == 'fused_stage_int8' else ''} "
            f"achieved={a['flops'] / max(a['ms'], 1e-9) / 1e9:.1f} TOP/s")
    results.update(agg)
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version "
                           f"beyond the stated tolerance {TOL}")


K1_ROUTES = ("tile", "narrow in", "narrow out")
STAGE_ROUTES = ("tile", "engine")
# K1's edge shapes (B, F, T, C, N, d) beside the pyramid convs (each of
# which the main loop checks, C = 2 -> N and N -> 2): 3 input channels, 1
# output channel, a ragged T at batch 2, T under 8, the widest narrow side
K1_EDGE = [(1, 40, 20, 3, 64, 2), (1, 64, 70, 64, 1, 1),
           (2, 48, 20, 2, 96, 4), (2, 48, 20, 96, 2, 4),
           (1, 24, 5, 8, 256, 1), (1, 24, 5, 256, 8, 1)]
# K2's backward's edge shapes (B, F, T, C, d): ragged T (20, 70), T = 8
# (the tile), C = 96 and C = 100 (the tile), d = 64 on F = 384 and 448,
# the largest and the deepest stage at batch 4
STAGE_BWD_EDGE = [(1, 48, 20, 64, 1), (1, 64, 70, 128, 4), (1, 64, 8, 64, 2),
                  (1, 64, 40, 96, 2), (1, 64, 40, 100, 2),
                  (1, 384, 64, 256, 64), (1, 448, 32, 256, 64),
                  (4, 64, 2048, 64, 1), (4, 448, 32, 256, 64)]


def _stage_fwd_case(x, a, s, w, d, main_path=False):
    """K2 at one stage against ``_dil_stage_parts`` on the same inputs: y
    and the conv output within TOL (in fp32 TOL's max_rel, and in place of
    its l2_rel each within K2_FP32_RATIO times the plain fp32 version's own
    relative L2 error against the plain version in float64,
    ``_k2_f64_errors``), the moments to a relative L2 error of 1e-3 in
    bf16 (fp32 sums of 3M rounded values in another order) or 1e-5 in
    fp32; on the engine its operand pass h against ``stage_gelu_ref``
    within TOL; on a main-path bf16 shape it must take the engine.
    Returns (good, log line, (y's errors, h's or None), y, c)."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    B, F, T, C = x.shape
    dtype = x.dtype
    dn = str(dtype).split(".")[-1]
    route = STAGE_ROUTES[kernels.stage_fwd_route(dtype, B, F, T, C, d)]
    y, mom, c = kernels.launch_fused_stage(x, a, s, w, d, want_conv=True)
    ry, rmom, rc = ck._dil_stage_parts(x, a, s, w, d)
    torch.cuda.synchronize()
    ey, ec, em = errs(y, ry), errs(c, rc), errs(mom, rmom)
    line = (f"K2 {dn:8s} [{route}] B={B} F={F:3d} T={T:4d} C={C:3d} "
            f"d={d:2d}: y max_abs={ey[0]:.3e} max_rel={ey[1]:.2e} "
            f"l2_rel={ey[2]:.2e}; conv l2_rel={ec[2]:.2e}; mom l2_rel="
            f"{em[2]:.2e}")
    if dtype == torch.bfloat16:
        good = within(ey, dn) and within(ec, dn) and em[2] <= 1e-3
    else:
        kc, pc, ky, py = _k2_f64_errors(x, a, s, w, d, y, c)
        good = (max(ey[1], ec[1]) <= TOL[dn]["max_rel"]
                and kc <= K2_FP32_RATIO * pc and ky <= K2_FP32_RATIO * py
                and em[2] <= 1e-5)
        line += (f"; vs float64: conv l2_rel kernel {kc:.2e} plain "
                 f"{pc:.2e}, y kernel {ky:.2e} plain {py:.2e}")
    eh = None
    if route == "engine":
        h = kernels.launch_stage_fwd_operand(x, a)
        rh = ck.stage_gelu_ref(x, a)
        torch.cuda.synchronize()
        eh = errs(h, rh)
        good &= within(eh, dn)
        line += (f"; h flips {int((h != rh).sum())} max_rel="
                 f"{eh[1]:.2e}")
    if main_path and dtype == torch.bfloat16 and route != "engine":
        good = False
    return good, f"{line} {'ok' if good else 'FAIL'}", (ey, eh), y, c


def _stage_bwd_case(x, a, s, w, y, c, d, g, main_path=False):
    """K2's backward at one stage against ``dil_stage_bwd_ref`` on the
    same inputs, with seeded cotangents of y and of the moments: dx within
    TOL, da and ds within red_tol (their fp32 atomics sum in another
    order); on a main-path bf16 shape it must take the engine.  Returns
    (good, log line, dx's errors, the launcher's leading arguments)."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    B, F, T, C = x.shape
    dtype, dev = x.dtype, x.device
    dn = str(dtype).split(".")[-1]
    gy = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
    gm = torch.randn((2, B, C), generator=g, device=dev) / (F * T)
    args = (gy, gm, y, x, c, a, s)
    dx, ds, da = kernels.launch_fused_stage_bwd(*args, w, d)
    rdx, rda, rds = ck.dil_stage_bwd_ref(x, a, s, w, y, c, gy, gm, d)
    torch.cuda.synchronize()
    edx, eda, eds = errs(dx, rdx), errs(da, rda), errs(ds, rds)
    red_tol = 2e-3 if dtype == torch.bfloat16 else 1e-5
    route = STAGE_ROUTES[kernels.stage_bwd_route(dtype, B, F, T, C, d)]
    good = (within(edx, dn) and eda[2] <= red_tol and eds[2] <= red_tol
            and not (main_path and dtype == torch.bfloat16
                     and route != "engine"))
    return good, (f"K2bwd {dn:8s} [{route}] B={B} F={F:3d} T={T:4d} "
                  f"C={C:3d} d={d:2d}: dx max_abs={edx[0]:.3e} max_rel="
                  f"{edx[1]:.2e} l2_rel={edx[2]:.2e}; da l2_rel="
                  f"{eda[2]:.2e}; ds l2_rel={eds[2]:.2e} "
                  f"{'ok' if good else 'FAIL'}"), edx, args


def _kernel_edges(dtype, g) -> bool:
    """K1 at ``K1_EDGE`` and K2's backward at ``STAGE_BWD_EDGE`` against
    their plain versions (the stage's y and conv output from its plain
    forward), checked and logged with the route each took."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    dev = torch.device("cuda")
    dn = str(dtype).split(".")[-1]
    ok = True
    for B, F, T, C, N, d in K1_EDGE:
        x = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
        w = (torch.randn((5, 3, C, N), generator=g, device=dev)
             / math.sqrt(15 * C)).to(dtype)
        y = kernels.launch_conv5x3(x, w, d)
        ref = ck.conv_ref(x, w, d)
        torch.cuda.synchronize()
        e = errs(y, ref)
        good = within(e, dn)
        ok &= good
        log(f"K1 {dn:8s} [{K1_ROUTES[kernels.conv5x3_route(dtype, C, N)]}]"
            f" edge B={B} F={F:3d} T={T:4d} C={C:3d} N={N:3d} d={d:2d}: "
            f"max_abs={e[0]:.3e} max_rel={e[1]:.2e} l2_rel={e[2]:.2e} "
            f"{'ok' if good else 'FAIL'}")
    for B, F, T, C, d in STAGE_BWD_EDGE:
        x = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
        w = (torch.randn((5, 3, C, C), generator=g, device=dev)
             / math.sqrt(15 * C)).to(dtype)
        a = 0.5 + torch.rand((B, C), generator=g, device=dev)
        s = torch.randn((B, C), generator=g, device=dev)
        y, _, c = ck._dil_stage_parts(x, a, s, w, d)
        good, line, _, _ = _stage_bwd_case(x, a, s, w, y, c, d, g)
        ok &= good
        log(f"{line} (edge)")
    return ok


# K2's forward's edge shapes (B, F, T, C, d), those of its backward:
# ragged T (20, 70), T = 8 (the tile), C = 96 (the engine) and C = 100
# (the tile), d = 64 on F = 384 and 448, the largest and the deepest stage
# at batch 4
STAGE_FWD_EDGE = STAGE_BWD_EDGE
# K3's (B, F, T, C, d): ragged T (20, 70) on the engine's narrowest and
# next widths, T = 8 (the tile), C = 96 (the engine) and C = 100 (the
# tile), d = 64 on F = 384 and 448, the largest int8 stage and the
# deepest at batch 4
K3_EDGE = [(1, 48, 20, 96, 1), (1, 64, 70, 128, 4), (1, 64, 8, 96, 2),
           (1, 64, 40, 96, 2), (1, 64, 40, 100, 2), (1, 384, 64, 256, 64),
           (1, 448, 32, 256, 64), (4, 128, 1024, 96, 1),
           (4, 448, 32, 256, 64)]


def _stage_fwd_edges(dtype, g) -> bool:
    """K2 at ``STAGE_FWD_EDGE`` and K3 at ``K3_EDGE`` against their plain
    versions, checked and logged with the route each took."""
    import torch

    dev = torch.device("cuda")
    ok = True
    for B, F, T, C, d in STAGE_FWD_EDGE:
        x = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
        w = (torch.randn((5, 3, C, C), generator=g, device=dev)
             / math.sqrt(15 * C)).to(dtype)
        a = 0.5 + torch.rand((B, C), generator=g, device=dev)
        s = torch.randn((B, C), generator=g, device=dev)
        good, line, _, _, _ = _stage_fwd_case(x, a, s, w, d)
        ok &= good
        log(f"{line} (edge)")
    for B, F, T, C, d in K3_EDGE:
        ok &= _kernel_int8_stage(B, F, T, C, d, 0, dtype, g, None, None,
                                 edge=True)
    return ok


# the fixed seeds of K2's fp32 evidence: every flagship stage shape is
# drawn once per seed from its own generator
K2_FP32_SEEDS = (101, 102, 103, 104, 105)
# K2's fp32 conv output and y are held to the plain version run in float64
# on the same inputs: each relative L2 error at most this many times the
# plain fp32 version's own.  A fixed bar against the plain fp32 version
# (TOL's l2_rel, 2e-6) measured how two fp32 roundings of the same math
# differ, each 1e-6 to 2e-6 from float64 (PERF.md, section 6)
K2_FP32_RATIO = 2.0


def _conv_f64(x, w, d):
    """The (5,3) 'SAME' conv at dilation (d,1) of float64 x and w, summed
    in float64."""
    import torch

    B, F, T, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 2 * d, 2 * d))
    acc = torch.zeros((B, F, T, w.shape[3]), dtype=torch.float64,
                      device=x.device)
    for kf in range(5):
        for kt in range(3):
            acc += torch.matmul(xp[:, kf * d:kf * d + F, kt:kt + T, :],
                                w[kf, kt])
    return acc


def _k2_f64_errors(x, a, s, w, d, y, c):
    """K2's fp32 conv output c and y (the kernel's) against the plain
    version run in float64 on the same fp32 inputs (the gelu polynomial,
    the conv and the residual all in float64), beside the plain fp32
    version's own errors.  Relative L2 errors: (kernel c, plain c, kernel
    y, plain y)."""
    import torch

    from babe_tpu_torch.ops import conv_kernels as ck

    ry, _, rc = ck._dil_stage_parts(x, a, s, w, d)
    x64 = x.double()
    u = x64 * a.double()[:, None, None, :]
    z = torch.clamp(u * 0.7071067811865475, -3.2, 3.2)
    c64 = _conv_f64(0.5 * u * (1.0 + ck._erf_poly(z)), w.double(), d)
    y64 = (x64 + c64 * s.double()[:, None, None, :]) / math.sqrt(2.0)
    return (errs(c, c64)[2], errs(rc, c64)[2], errs(y, y64)[2],
            errs(ry, y64)[2])


def _k2_sums_errors(x, a, w, d):
    """The conv's fp32 sums alone: the tile's (K1's fp32 route, the same
    summation as K2's fp32 tile) and the plain version's, each on the plain
    version's h, against a float64 conv of that h.  Relative L2 errors:
    (tile, plain)."""
    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    h = ck.stage_gelu_ref(x, a)
    ch64 = _conv_f64(h.double(), w.double(), d)
    return (errs(kernels.launch_conv5x3(h, w, d), ch64)[2],
            errs(ck.conv_ref(h, w, d), ch64)[2])


def _k2_fp32_evidence(k2_shapes) -> bool:
    """K2 in fp32 (the kFwd tile) at every flagship stage shape and every
    seed of ``K2_FP32_SEEDS``, held to the plain version in float64 beside
    the plain fp32 version's own error (``_k2_f64_errors``: each within
    K2_FP32_RATIO of it), and the conv's sums alone (``_k2_sums_errors``,
    logged); one line per shape with the largest ratio over the seeds."""
    import torch

    from babe_tpu_torch import kernels

    dev = torch.device("cuda")
    worst = [0.0, 0.0, 0.0]
    ok = True
    for (F, T, C, d) in sorted(k2_shapes):
        rows = []
        for seed in K2_FP32_SEEDS:
            g = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn((1, F, T, C), generator=g, device=dev)
            w = torch.randn((5, 3, C, C), generator=g, device=dev) / (
                math.sqrt(15 * C))
            a = 0.5 + torch.rand((1, C), generator=g, device=dev)
            s = torch.randn((1, C), generator=g, device=dev)
            y, _, c = kernels.launch_fused_stage(x, a, s, w, d,
                                                 want_conv=True)
            rows.append(_k2_f64_errors(x, a, s, w, d, y, c)
                        + _k2_sums_errors(x, a, w, d))
        ratio = [max(r[i] / r[i + 1] for r in rows) for i in (0, 2, 4)]
        worst = [max(v, r) for v, r in zip(worst, ratio)]
        good = max(ratio[:2]) <= K2_FP32_RATIO
        ok &= good

        def col(i):
            return "/".join(f"{r[i]:.2e}" for r in rows)
        log(f"K2 float32 vs float64 F={F:3d} T={T:4d} C={C:3d} d={d:2d}: "
            f"conv kernel {col(0)} plain {col(1)} (ratio <= {ratio[0]:.2f})"
            f"; y kernel {col(2)} plain {col(3)} (<= {ratio[1]:.2f}); "
            f"sums alone tile {col(4)} plain {col(5)} (<= {ratio[2]:.2f})"
            f" {'ok' if good else 'FAIL'}")
    log(f"K2 float32 vs float64 over {len(k2_shapes)} shapes x seeds "
        f"{K2_FP32_SEEDS}: the largest ratio of the kernel's relative L2 "
        f"error to the plain fp32 version's: conv {worst[0]:.2f}, y "
        f"{worst[1]:.2f}, the conv's sums alone {worst[2]:.2f} (bar "
        f"{K2_FP32_RATIO:g} on conv and y)")
    return ok


def _library_conv(x, w, dil):
    """cuDNN's conv of x (B,F,T,C) with the HWIO kernel w, 'SAME'."""
    import torch
    import torch.nn.functional as Fnn

    kf, kt = w.shape[:2]
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = ((kf - 1) // 2 * dil[0], (kt - 1) // 2 * dil[1])
    return lambda: Fnn.conv2d(xc, wc, padding=pad, dilation=dil)


def _library_wgrad(x, g, kshape, dil):
    """cuDNN's weight gradient (only) of the 'SAME' conv of x (B,F,T,C)
    with output cotangent g (B,F,T,N)."""
    import torch

    kf, kt = kshape
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    w = torch.empty((g.shape[3], x.shape[3], kf, kt), dtype=x.dtype,
                    device=x.device).contiguous(
                        memory_format=torch.channels_last)
    pad = [(kf - 1) // 2 * dil[0], (kt - 1) // 2 * dil[1]]
    return lambda: torch.ops.aten.convolution_backward(
        gc, xc, w, None, [1, 1], pad, list(dil), False, [0, 0], 1,
        [False, True, False])


# K4's shapes: tests/test_pallas_conv.py's (B, F, T, C, N) at four kernels
# and four dilations, then the five level shapes of pallas_conv.py's table
# (F, T, C, df) at batch 4 with the (5,3) kernel
K4_SMALL = [(2, 16, 64, 8, 8, kf, kt, dil)
            for kf, kt in ((3, 3), (5, 3), (7, 3), (3, 5))
            for dil in ((1, 1), (2, 1), (4, 1), (2, 2))]
K4_LEVELS = [(4, F, T, C, C, 5, 3, (df, 1)) for F, T, C, df in (
    (64, 1280, 64, 2), (128, 640, 96, 4), (256, 160, 128, 16),
    (384, 40, 256, 32), (448, 20, 256, 64))]


def _kernel_k4(account, results) -> bool:
    """K4 against its plain version (``conv_ref``) at K4_SMALL and
    K4_LEVELS in bf16 and fp32, with times at the level shapes; then its
    entry point ``dilated_conv_nhwc`` (forward and dx, the weight frozen)
    at the level shapes, with the counters zeroed just before and read just
    after: K4's launches."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import pallas_conv as pc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        isz = torch.tensor([], dtype=dtype).element_size()
        for B, F, T, C, N, kf, kt, dil in K4_SMALL + K4_LEVELS:
            x = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
            w = (torch.randn((kf, kt, C, N), generator=g, device=dev)
                 / math.sqrt(kf * kt * C)).to(dtype)
            y = kernels.launch_dilated_conv(x, w, dil)
            ref = pc.conv_ref(x, w, dil)
            torch.cuda.synchronize()
            e = errs(y, ref)
            good = within(e, dn)
            ok &= good
            line = (f"K4 {dn:8s} B={B} F={F:3d} T={T:4d} C={C:3d} N={N:3d} "
                    f"k=({kf},{kt}) dil={dil}: max_abs={e[0]:.3e} "
                    f"max_rel={e[1]:.2e} l2_rel={e[2]:.2e} "
                    f"{'ok' if good else 'FAIL'}")
            if B == 4:
                t_k = cuda_time(lambda: kernels.launch_dilated_conv(
                    x, w, dil))
                t_p = cuda_time(lambda: pc.conv_ref(x, w, dil), reps=2)
                t_l = cuda_time(_library_conv(x, w, dil))
                flops = 2.0 * B * F * T * kf * kt * C * N
                nbytes = (B * F * T * (C + N) + kf * kt * C * N) * isz
                b, by = bound_ms(flops, nbytes, dtype)
                line += (f" | ms={t_k:.4f} bound={b:.4f}({by}) "
                         f"plain={t_p:.4f} cudnn={t_l:.4f}")
                account("dilated_conv", 1, dtype, t_k, t_p, t_l, flops,
                        nbytes, e)
            log(line)
    kernels.reset_launch_counts()
    for B, F, T, C, N, kf, kt, dil in K4_LEVELS:
        x = torch.randn((B, F, T, C), generator=g, device=dev,
                        dtype=torch.bfloat16, requires_grad=True)
        w = torch.randn((kf, kt, C, N), generator=g, device=dev) / math.sqrt(
            kf * kt * C)
        pc.dilated_conv_nhwc(x, w, dil).backward(torch.ones(
            (B, F, T, N), device=dev, dtype=torch.bfloat16))
        ok &= bool(torch.isfinite(x.grad).all())
    torch.cuda.synchronize()
    n = kernels.LAUNCHES["dilated_conv"]
    log(f"K4 entry point (dilated_conv_nhwc, forward + dx at the "
        f"{len(K4_LEVELS)} level shapes): {n} launches")
    if n != 2 * len(K4_LEVELS):
        raise RuntimeError(f"K4's entry point launched it {n} times, not "
                           f"{2 * len(K4_LEVELS)}")
    results.setdefault("launches", {})["dilated_conv"] = n
    return ok


# conv_dw's edge shapes (B, F, T, C, N, kernel, dilation): chunks that
# span f rows (T = 32), a ragged T (20, 80), 96 channels, the folded narrow
# side (C = 2, N = 2), d = 64 on F = 384 (the rows outside the image are
# skipped), then K4's kernels at dt = 2 on the fold and tensor-core routes
DW_EDGE = [(2, 64, 32, 96, 96, (5, 3), (2, 1)),
           (2, 48, 20, 64, 128, (5, 3), (1, 1)),
           (1, 64, 80, 96, 64, (5, 3), (4, 1)),
           (2, 40, 20, 2, 96, (5, 3), (1, 1)),
           (2, 40, 20, 96, 2, (5, 3), (1, 1)),
           (1, 384, 32, 256, 256, (5, 3), (64, 1))] + [
    (2, 16, 64, C, C, k, (2, 2)) for k in ((3, 3), (7, 3), (3, 5))
    for C in (8, 64)]
# fused_stage_dw's edge shapes (B, F, T, C, d): T = 32 at 96 channels, a
# ragged T, d = 64 on F = 384 at T = 32, channels that no tile divides
# (24) and the fold route (8)
DW_STAGE_EDGE = [(2, 64, 32, 96, 2), (2, 48, 20, 64, 1),
                 (1, 384, 32, 256, 64), (1, 40, 20, 24, 1),
                 (1, 16, 40, 8, 2)]


def _kernel_dw(account, k1_shapes, k2_shapes, B: int = 4) -> bool:
    """The weight-gradient kernels against their plain versions, bf16 and
    fp32: at the training batch (B = 4, 184184 samples) ``conv_dw`` at the
    7 pyramid convs (1 per step) and at their 7 transposed shapes (C = Ns,
    N = 2; a check, count 0), ``fused_stage_dw`` and its operand pass
    ``stage_dw_operands`` at every distinct stage shape (its stages per
    step), each with its time, bound, plain time and cuDNN's weight
    gradient; then both at their edge shapes (``DW_EDGE``,
    ``DW_STAGE_EDGE``), checked only."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    ok = True

    def judge(what, dw, ref, dn):
        e = errs(dw, ref)
        good = e[1] <= DW_TOL["max_rel"] and e[2] <= DW_TOL["l2_rel"]
        return e, good, (f"{what} {dn:8s}: max_abs={e[0]:.3e} max_rel="
                         f"{e[1]:.2e} l2_rel={e[2]:.2e} "
                         f"{'ok' if good else 'FAIL'}")

    def route(dtype, C, N):
        return ("mma", "simt", "fold")[kernels.dw_route(dtype, C, N)]

    def conv_case(Bc, F, T, C, N, ks, dil, dtype, dn):
        x = torch.randn((Bc, F, T, C), generator=g, device=dev).to(dtype)
        gy = torch.randn((Bc, F, T, N), generator=g, device=dev).to(dtype)
        dw = kernels.launch_conv_dw(x, gy, ks, dil)
        ref = ck.conv_dw_ref(x, gy, ks, dil)
        torch.cuda.synchronize()
        return x, gy, judge(
            f"conv_dw [{route(dtype, C, N)}] B={Bc} F={F:3d} T={T:4d} "
            f"C={C:3d} N={N:3d} k={ks} dil={dil}", dw, ref, dn)

    def stage_case(Bs, F, T, C, d, dtype, dn):
        x = torch.randn((Bs, F, T, C), generator=g, device=dev).to(dtype)
        w = (torch.randn((5, 3, C, C), generator=g, device=dev)
             / math.sqrt(15 * C)).to(dtype)
        a = 0.5 + torch.rand((Bs, C), generator=g, device=dev)
        s = torch.randn((Bs, C), generator=g, device=dev)  # opened gate
        y, _ = ck.dil_stage_ref(x, a, s, w, d)
        gy = torch.randn((Bs, F, T, C), generator=g, device=dev).to(dtype)
        gm = torch.randn((2, Bs, C), generator=g, device=dev) / (F * T)
        args = (x, a, s, y, gy, gm)
        h, gc = kernels.launch_stage_dw_operands(*args)
        rh, rgc = ck.stage_dw_operands_ref(*args)
        dw = kernels.launch_fused_stage_dw(*args, d)
        ref = ck.dil_stage_dw_ref(*args, d)
        torch.cuda.synchronize()
        eo = max(errs(h, rh), errs(gc, rgc), key=lambda e: e[1])
        good_o = within(errs(h, rh), dn) and within(errs(gc, rgc), dn)
        e, good, line = judge(
            f"fused_stage_dw [{route(dtype, C, C)}] B={Bs} F={F:3d} "
            f"T={T:4d} C={C:3d} d={d:2d}", dw, ref, dn)
        line += (f"; operands h, g_pre*s max_rel={eo[1]:.2e} l2_rel="
                 f"{eo[2]:.2e} {'ok' if good_o else 'FAIL'}")
        return args, (e, eo), good and good_o, line

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        isz = torch.tensor([], dtype=dtype).element_size()
        for (F, T, C, N, d, role), count in sorted(k1_shapes.items()):
            if role == "stage shape":
                continue
            count = 1 if role == "pyramid fwd" else 0
            x, gy, (e, good, line) = conv_case(B, F, T, C, N, (5, 3), (d, 1),
                                               dtype, dn)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_conv_dw(
                x, gy, (5, 3), (d, 1)))
            t_p = cuda_time(lambda: ck.conv_dw_ref(x, gy, (5, 3), (d, 1)),
                            reps=2)
            t_l = cuda_time(_library_wgrad(x, gy, (5, 3), (d, 1)))
            flops = 2.0 * B * F * T * 15 * C * N
            nbytes = B * F * T * (C + N) * isz + 15 * C * N * 4
            b, by = bound_ms(flops, nbytes, dtype)
            log(f"{line} {role} x{count} | ms={t_k:.4f} bound={b:.4f}({by}) "
                f"plain={t_p:.4f} cudnn={t_l:.4f}")
            account("conv_dw", count, dtype, t_k, t_p, t_l, flops, nbytes, e)
        for (F, T, C, d), count in sorted(k2_shapes.items()):
            args, (e, eo), good, line = stage_case(B, F, T, C, d, dtype, dn)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_fused_stage_dw(*args, d))
            t_p = cuda_time(lambda: ck.dil_stage_dw_ref(*args, d), reps=2)
            t_o = cuda_time(lambda: kernels.launch_stage_dw_operands(*args))
            t_op = cuda_time(lambda: ck.stage_dw_operands_ref(*args), reps=2)
            h, gc = ck.stage_dw_operands_ref(*args)
            t_l = cuda_time(_library_wgrad(h, gc, (5, 3), (d, 1)))
            del h, gc
            n_el = B * F * T * C
            flops = 2.0 * n_el * 15 * C
            nbytes = 3 * n_el * isz + 4 * 4 * B * C + 15 * C * C * 4
            b, by = bound_ms(flops, nbytes, dtype)
            # the operand pass: x, y, g_y read, h, g_pre*s written; about
            # 40 fp32 operations per element (the gelu polynomial, the
            # fold of the moments' cotangent and the roundings)
            o_flops, o_bytes = 40.0 * n_el, 5 * n_el * isz + 4 * 4 * B * C
            bo, byo = bound_ms(o_flops, o_bytes, torch.float32)
            log(f"{line} x{count} | ms={t_k:.4f} bound={b:.4f}({by}) "
                f"plain={t_p:.4f} cudnn={t_l:.4f}; operand pass "
                f"ms={t_o:.4f} bound={bo:.4f}({byo}) plain={t_op:.4f}")
            account("fused_stage_dw", count, dtype, t_k, t_p, t_l, flops,
                    nbytes, e)
            account("stage_dw_operands", count, dtype, t_o, t_op, 0.0,
                    o_flops, o_bytes, eo, op_dtype=torch.float32)
        for Bc, F, T, C, N, ks, dil in DW_EDGE:
            _, _, (e, good, line) = conv_case(Bc, F, T, C, N, ks, dil, dtype,
                                              dn)
            ok &= good
            log(f"{line} (edge)")
        for Bs, F, T, C, d in DW_STAGE_EDGE:
            _, _, good, line = stage_case(Bs, F, T, C, d, dtype, dn)
            ok &= good
            log(f"{line} (edge)")
    return ok


def _kernel_int8_stage(B, F, T, C, d, count, dtype, g, account,
                       library_conv, edge=False) -> bool:
    """K3 at one stage shape against its plain version on the same inputs:
    the share of int8 conv inputs that differ (at most 1e-4); y within TOL
    when none differs, else at a relative L2 error of 1e-3; the amax row to
    1e-6 relative and the sums to 1e-5 (1e-4 with flips); a bf16 main-path
    shape must take the engine.  Except at an edge shape, in bf16 it also
    times the kernel (its operand pass included), the plain version and a
    bf16 cuDNN conv, and the engine's operand pass alone."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    dev = torch.device("cuda")
    dn = str(dtype).split(".")[-1]
    x = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
    w = torch.randn((5, 3, C, C), generator=g, device=dev) / math.sqrt(15 * C)
    a = 0.5 + torch.rand((B, C), generator=g, device=dev)
    s = torch.randn((B, C), generator=g, device=dev)
    qw, sw = ck.quant_weight_per_cout(w)
    qwt = kernels.tap_major(qw)
    bound = 1.02 * (x.float() * a[:, None, None, :]).abs().amax((1, 2, 3))
    iv, post = ck.int8_scales(bound, s, sw)
    route = STAGE_ROUTES[kernels.stage_int8_route(dtype, B, F, T, C, d)]
    y, mom, q = kernels.launch_fused_stage_int8(x, a, iv, post, qwt, d,
                                                want_q=True)
    ry, rmom, rq = ck._int8_stage_parts(x, a, iv, post, qw, d)
    torch.cuda.synchronize()
    flips = int((q != rq).sum())
    share = flips / q.numel()
    ey, esum = errs(y, ry), errs(mom[:2], rmom[:2])
    amax_rel = float((mom[2] - rmom[2]).abs().max()
                     / rmom[2].abs().max().clamp(min=1e-30))
    good = (share <= 1e-4 and amax_rel <= 1e-6
            and (within(ey, dn) if flips == 0 else ey[2] <= 1e-3)
            and esum[2] <= (1e-5 if flips == 0 else 1e-4)
            and not (dtype == torch.bfloat16 and count > 0
                     and route != "engine"))
    line = (f"K3 {dn:8s} [{route}] B={B} F={F:3d} T={T:4d} C={C:3d} "
            f"d={d:2d}{' (edge)' if edge else f' x{count}'}: q flips "
            f"{flips} ({share:.2e}) y max_abs={ey[0]:.3e} "
            f"max_rel={ey[1]:.2e} l2_rel={ey[2]:.2e}; sums l2_rel="
            f"{esum[2]:.2e} amax rel={amax_rel:.1e} "
            f"{'ok' if good else 'FAIL'}")
    if dtype == torch.bfloat16 and not edge:
        t_k = cuda_time(lambda: kernels.launch_fused_stage_int8(
            x, a, iv, post, qwt, d))
        t_p = cuda_time(lambda: ck.dil_stage_int8_ref(x, a, iv, post, qw, d),
                        reps=2)
        wb = w.to(torch.bfloat16)
        t_l = cuda_time(library_conv(x, wb, d))
        flops = 2.0 * F * T * C * C * 15
        nbytes = 2 * F * T * C * x.element_size() + 15 * C * C + 4 * (
            2 * C + 1)
        b, by = bound_ms(flops, nbytes, torch.int8)
        line += (f" | ms={t_k:.4f} bound={b:.4f}({by}) plain={t_p:.4f} "
                 f"cudnn(bf16)={t_l:.4f}")
        account("fused_stage_int8", count, dtype, t_k, t_p, t_l, flops,
                nbytes, ey, op_dtype=torch.int8)
        if route == "engine":
            # the operand pass alone: x read, q written, about 30 fp32
            # operations per element (the gelu polynomial, the scale and
            # the rounding)
            t_o = cuda_time(lambda: kernels.launch_stage_int8_operand(
                x, a, iv))
            t_op = cuda_time(lambda: ck.stage_quant_ref(x, a, iv), reps=2)
            o_flops = 30.0 * F * T * C
            o_bytes = F * T * C * (x.element_size() + 1)
            bo, byo = bound_ms(o_flops, o_bytes, torch.float32)
            line += (f"; operand pass ms={t_o:.4f} bound={bo:.4f}({byo}) "
                     f"plain={t_op:.4f}")
            eq = float((q.int() - rq.int()).abs().max())
            account("stage_int8_operand", count, dtype, t_o, t_op, 0.0,
                    o_flops, o_bytes, (eq, 0.0, 0.0),
                    op_dtype=torch.float32)
    log(line)
    return good


def phase_probe(results: dict):
    """P1 and P2 against their plain versions at the probe's four shapes
    (int8 bit-exact, bf16 within TOL), with a cuBLAS product beside P1 as
    its yardstick; then the probe entry point with the counters zeroed just
    before and read just after.  Times are of one product: a launch's time
    over the repetitions it runs."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.tools import probe_int8 as probe

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    agg = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0 if k == "probe_gemm" else None,
               "max_abs_err": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
           for k in PROBE_PATH}
    ok, rate = True, {}

    def judge(name, out, ref, dt, t_k, t_p, t_l, ops, nbytes, shape):
        nonlocal ok
        dn = str(dt).split(".")[-1]
        if dt == torch.int8:
            e = (float((out.double() - ref.double()).abs().max()), 0.0, 0.0)
            good = bool(torch.equal(out, ref))
        else:
            e = errs(out, ref)
            good = within(e, "bfloat16")
        ok &= good
        b, by = bound_ms(ops, nbytes, dt)
        a = agg[name]
        a["ms"] += t_k
        a["plain_ms"] += t_p
        a["bound_ms"] += b
        a["ops_ms"] += bound_ms(ops, 0.0, dt)[0]
        a["bytes_ms"] += 1e3 * nbytes / HBM_BPS
        a["max_abs_err"] = max(a["max_abs_err"], e[0])
        if t_l is not None:
            a["library_ms"] += t_l
        rate[name, shape, dn] = ops / (t_k * 1e-3) / 1e12
        log(f"{name} {dn:8s} {shape}: max_abs={e[0]:.3e} "
            f"{'ok' if good else 'FAIL'} | ms={t_k:.4f} "
            f"({rate[name, shape, dn]:.1f} TOP/s) bound={b:.4f}({by}) "
            f"plain={t_p:.4f}" + ("" if t_l is None else
                                  f" cublas={t_l:.4f}"))

    for M, K, N in probe.GEMM_SHAPES:
        for dt in probe.DTYPES:
            a_, b_, bt = probe.gemm_inputs(M, K, N, dt, g, dev)
            out = kernels.launch_probe_gemm(a_, bt)
            ref = probe.probe_gemm_ref(a_, b_)
            torch.cuda.synchronize()
            t_k = cuda_time(lambda: kernels.launch_probe_gemm(
                a_, bt, probe.GEMM_REPS), 20) / probe.GEMM_REPS
            t_p = cuda_time(lambda: probe.probe_gemm_ref(a_, b_), 2)
            lib = ((lambda: torch._int_mm(a_, b_)) if dt == torch.int8
                   else (lambda: a_ @ b_))
            t_l = cuda_time(lib, 20)
            isz, osz = a_.element_size(), out.element_size()
            judge("probe_gemm", out, ref, dt, t_k, t_p, t_l,
                  probe.gemm_ops(M, K, N),
                  (M * K + K * N) * isz + M * N * osz, (M, K, N))
    for BF, BT, C, d in probe.STAGE_SHAPES:
        for dt in probe.DTYPES:
            h, w5, wt = probe.stage_inputs(BF, BT, C, d, dt, g, dev)
            out = kernels.launch_probe_stage(h, wt, BF, BT, d,
                                             probe.STAGE_REPS)
            ref = probe.probe_stage_ref(h, w5, BF, BT, d)
            torch.cuda.synchronize()
            t_k = cuda_time(lambda: kernels.launch_probe_stage(
                h, wt, BF, BT, d, probe.STAGE_REPS), 20) / probe.STAGE_REPS
            t_p = cuda_time(lambda: probe.probe_stage_ref(h, w5, BF, BT, d),
                            2)
            judge("probe_stage", out, ref, dt, t_k, t_p, None,
                  probe.stage_ops(BF, BT, C),
                  (h.numel() + wt.numel()) * h.element_size()
                  + out.numel() * 4, (BF, BT, C, d))
    for name, shape, dn in sorted(rate):
        if dn == "int8":
            ratio = rate[name, shape, "int8"] / rate[name, shape, "bfloat16"]
            log(f"{name} {shape}: int8:bf16 rate ratio {ratio:.2f}")
    kernels.reset_launch_counts()
    probe.run(reps=20, log=log)
    launches = {k: kernels.LAUNCHES[k] for k in PROBE_PATH}
    log(f"launches during the probe run: {launches}")
    for k, c in launches.items():
        if c <= 0:
            raise RuntimeError(f"kernel {k} never launched in the probe run")
    results.update(agg)
    results.setdefault("launches", {}).update(launches)
    if not ok:
        raise RuntimeError("a probe kernel disagrees with its plain version")


def _kernel_filter_fit(a: dict) -> bool:
    """The filter-fit kernel against its plain version (the eager autograd
    loop) on the card and on the CPU, at the flagship blind config (4096-point
    STFT: 2049 bins, 92 frames of random spectra), with its time and bound.
    One launch per guided evaluation of a blind request."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.sampling.blind import BlindConfig, BlindSampler
    from babe_tpu_torch.sampling.heun import SamplerConfig

    rng = np.random.default_rng(4)
    shape = (1, 2049, 92)
    X = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    Y = X * np.linspace(1.0, 0.01, 2049)[None, :, None] ** 2
    X, Y = (torch.as_tensor(v.astype(np.complex64)) for v in (X, Y))
    out = {}
    for dev in ("cpu", "cuda"):
        s = BlindSampler(None, None, SamplerConfig(), BlindConfig(),
                         device=dev)
        p0 = s.blind.initial_params(dev)
        stats = s._fit_stats(X.to(dev), Y.to(dev))
        with torch.enable_grad():
            out[dev + " plain"] = s._fit_loop(stats, p0)
        if dev == "cuda":
            st = torch.stack(stats).contiguous()
            iters = torch.zeros(1, dtype=torch.int32, device=dev)
            out["cuda kernel"] = kernels.launch_filter_fit(
                st, s.freqs, p0, s.blind, iters)
            torch.cuda.synchronize()
            n_it = int(iters.item())
            t_k = cuda_time(lambda: kernels.launch_filter_fit(
                st, s.freqs, p0, s.blind))

            def plain():
                with torch.enable_grad():
                    s._fit_loop(stats, p0)

            t_p = cuda_time(plain, reps=2)
    ref = out["cpu plain"].double()
    good = True
    for k in ("cuda plain", "cuda kernel"):
        e = float((out[k].cpu().double() - ref).abs().max())
        g = e <= 1e-2 * float(ref.abs().max())
        good &= g
        vals = out[k].cpu().numpy().round(2).tolist()
        log(f"filter fit ({k}) vs CPU plain: max abs diff {e:.3e} params "
            f"{vals} {'ok' if g else 'FAIL'}")
    F = shape[1]
    flops = 45.0 * F * n_it  # ~45 fp32 operations per bin and iteration
    nbytes = 4.0 * (4 * F + 4 * 5)
    b, by = bound_ms(flops, nbytes, torch.float32)
    log(f"filter_fit: {n_it} iterations, ms={t_k:.4f} bound={b:.6f}({by}) "
        f"plain={t_p:.4f} (per blind evaluation, fp32)")
    a.update(ms=t_k, plain_ms=t_p, bound_ms=b, library_ms=None,
             max_abs_err=float((out["cuda kernel"].cpu().double()
                                - ref).abs().max()),
             ops_ms=1e3 * flops / PEAK_FP32, bytes_ms=1e3 * nbytes / HBM_BPS,
             shapes=1)
    return good


def _random_flagship_like(net, seed: int):
    """Reseed every weight with O(1)-scale values so the dilated convs and
    gates carry signal (the EDM init keeps the gates at 1e-7)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            fan = int(np.prod(p.shape[:-1])) if p.ndim > 1 else 1
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan))


# the int8 stages' scale inputs (a, bound), card against the CPU forced
# onto the card's stages: they differ by summation order only (at most
# 5.9e-6 read on the H100 with either carrier; PERF.md, PR 2)
SCALE_TOL = 1e-4


def _int8_forced(m, edm, x, dt):
    """The int8 model on the card against the CPU, stage by stage.

    Two int8 runs drift apart as a whole: a rounding flip moves a stage's
    moments, which move the next stage's per-item scale and so re-round
    its whole input.  So the card's run is recorded at every int8 stage
    (inputs and outputs), and the CPU's run is forced onto it: its k-th
    int8 stage returns the card's k-th outputs (with the CPU's own
    straight-through gradient).  Then the card and the CPU differ only by
    summation order, and what is compared is the int8 path itself: the
    stage count, the kernels quantized on each device (equal), the scale
    inputs a and bound that each computes from the moments, the card's
    stage outputs against the plain version on the card's inputs, and the
    denoiser output and guidance gradient at the end.  Returns
    ((out, grad) relative L2 errors, per-stage maxima)."""
    import torch

    import babe_tpu_torch.models.blocks as tb
    from babe_tpu_torch import kernels

    orig = tb.fused_stage_int8
    rec = []

    def card_spy(*args):
        out = orig(*args)
        rec.append(([v.detach() if torch.is_tensor(v) else v for v in args],
                    [v.detach() for v in out]))
        return out

    def run(dev, spy):
        m.to(dev)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        tb.fused_stage_int8 = spy
        try:
            y = m.fused_denoiser(edm)(xt, torch.full((1, 1), 0.2, device=dev))
            (gx,) = torch.autograd.grad((y * y).sum(), xt)
        finally:
            tb.fused_stage_int8 = orig
        return y.detach().cpu(), gx.cpu()

    def rel(a, b):
        return float((a.float() - b.float()).norm()
                     / (b.float().norm() + 1e-30))

    m.net.compute_dtype = dt
    m.net.set_precision("int8")
    want = sum(b.num_dils for b in m.net.modules()
               if isinstance(b, tb.ResnetBlock) and b.int8)
    kernels.reset_launch_counts()
    card = run("cuda", card_spy)
    launches = kernels.LAUNCHES["fused_stage_int8"]
    st = {"stages": len(rec), "want": want, "launches": launches,
          "x": 0.0, "a": 0.0, "s": 0.0, "bound": 0.0, "y_vs_plain": 0.0,
          "mom_vs_plain": 0.0, "kernels_equal": True}
    k = 0

    def cpu_spy(*args):
        nonlocal k
        cargs, cout = rec[k]
        k += 1
        cargs = [v.cpu() if torch.is_tensor(v) else v for v in cargs]
        cout = [v.cpu() for v in cout]
        x_, a_, s_, bound_, w_, qwt_, sw_, d_ = args
        assert d_ == cargs[7] and x_.shape == cargs[0].shape, (k, d_)
        st["kernels_equal"] &= bool(torch.equal(qwt_, cargs[5])
                                    and torch.equal(sw_, cargs[6]))
        for key, mine, theirs in (("x", x_, cargs[0]), ("a", a_, cargs[1]),
                                  ("s", s_, cargs[2]),
                                  ("bound", bound_, cargs[3])):
            st[key] = max(st[key], rel(mine.detach(), theirs))
        with torch.no_grad():
            py, pmom = orig(*cargs)  # the plain version on the card's inputs
        st["y_vs_plain"] = max(st["y_vs_plain"], rel(cout[0], py))
        st["mom_vs_plain"] = max(st["mom_vs_plain"], rel(cout[1], pmom))
        y, mom = orig(*args)
        return (cout[0] + (y - y.detach()), cout[1] + (mom - mom.detach()))

    cpu = run("cpu", cpu_spy)
    st["stages_cpu"] = k
    return (rel(card[0], cpu[0]), rel(card[1], cpu[1])), st


def phase_check():
    """The model on the card (kernels) against the same weights on the CPU
    (plain path): the denoiser output and the guidance gradient
    d/dx sum(D(x)^2).  fp32 is held to summation-order tolerance.  In bf16
    and in int8 the weights here (O(1) gates) make the network chaotic
    enough that two runs differing only in summation order (or, in int8, in
    a few rounding flips) drift apart by as much as they drift from fp32, so
    the card's result is held to the CPU's fp32 reference no worse than
    1.5x the CPU's own result of the same precision is.

    int8 is also held directly to the CPU's int8 with the CPU's run forced
    onto the card's at every int8 stage (``_int8_forced``), no worse than
    1.5x the card-vs-CPU difference of the same carrier without int8 (far
    below what int8 moves the output); every stage of both runs quantizes
    the same kernels, computes the same scale inputs (``SCALE_TOL``), and
    the card's stage outputs agree with the plain version on the card's
    inputs (y and moments to 1e-3)."""
    import torch

    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus

    tiny = ["network.Ns=[8,8,16]", "network.num_dils=[1,1,2]",
            "network.emb_dim=32", "network.cqt.num_octs=3",
            "network.cqt.bins_per_oct=8", "exp.audio_len=4096"]
    for label, ov, tol in (("tiny", tiny, 2e-4),
                           ("flagship widths, short segment",
                            ["exp.audio_len=16384"], 1e-3)):
        t0 = time.perf_counter()
        # serving runs without remat (as BABE.load builds it)
        args = default_config(ov + ["exp.remat=false"])
        m = CQTDiffPlus.from_config(args).init(seed=1, device="cpu")
        _random_flagship_like(m.net, 2)
        m.net.requires_grad_(False)
        edm = EDM.from_config(args)
        L = int(args.exp.audio_len)
        x = (0.1 * np.random.default_rng(3).standard_normal((1, L))).astype(
            np.float32)
        out = {}
        variants = [(torch.float32, None)]
        if label != "tiny":
            variants += [(torch.bfloat16, None), (torch.float32, "int8"),
                         (torch.bfloat16, "int8")]
        for dt, prec in variants:
            m.net.compute_dtype = dt
            m.net.set_precision(prec)
            for dev in ("cpu", "cuda"):
                m.to(dev)
                xt = torch.tensor(x, device=dev, requires_grad=True)
                y = m.fused_denoiser(edm)(xt, torch.full((1, 1), 0.2,
                                                         device=dev))
                (gx,) = torch.autograd.grad((y * y).sum(), xt)
                out[dev, dt, prec] = (y.detach().cpu(), gx.cpu())

        def rel(a, b):
            return float((a - b).norm() / (b.norm() + 1e-30))

        for what, i in (("denoiser", 0), ("guidance grad", 1)):
            ref = out["cpu", torch.float32, None][i]
            a = out["cuda", torch.float32, None][i]
            e = rel(a, ref)
            good = bool(torch.isfinite(a).all()) and e <= tol
            log(f"check {label} fp32: {what} card vs CPU l2_rel={e:.3e} "
                f"(tol {tol:g}) {'ok' if good else 'FAIL'}")
            for dt, prec in variants[1:]:
                name = (str(dt).split(".")[-1] if prec is None
                        else f"int8 ({str(dt).split('.')[-1]} carrier)")
                card = out["cuda", dt, prec][i]
                e_card = rel(card, ref)
                e_cpu = rel(out["cpu", dt, prec][i], ref)
                ok_v = (bool(torch.isfinite(card).all())
                        and e_card <= 1.5 * e_cpu)
                log(f"check {label} {name}: {what} vs fp32 CPU: card "
                    f"l2_rel={e_card:.3e}, CPU l2_rel={e_cpu:.3e} "
                    f"(card within 1.5x) {'ok' if ok_v else 'FAIL'}")
                good &= ok_v
            if not good:
                raise RuntimeError(f"check failed: {label} {what}")
        if label == "tiny":
            continue
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[-1]
            e, st = _int8_forced(m, edm, x, dt)
            lims = tuple(1.5 * rel(out["cuda", dt, None][i],
                                   out["cpu", dt, None][i]) for i in (0, 1))
            good = (st["want"] == st["stages"] == st["stages_cpu"]
                    == st["launches"] > 0
                    and st["kernels_equal"] and st["y_vs_plain"] <= 1e-3
                    and st["mom_vs_plain"] <= 1e-3
                    and max(st["a"], st["bound"]) <= SCALE_TOL
                    and e[0] <= lims[0] and e[1] <= lims[1])
            log(f"check {label} int8 ({dn} carrier), CPU forced onto the "
                f"card's int8 stages: {st['stages']} stages of "
                f"{st['want']} on the card "
                f"({st['launches']} launches), {st['stages_cpu']} on the "
                f"CPU; kernels quantized alike on both: "
                f"{st['kernels_equal']}; stage inputs card vs CPU, max "
                f"l2_rel: x {st['x']:.2e}, gate s {st['s']:.2e}, a "
                f"{st['a']:.2e}, bound "
                f"{st['bound']:.2e} (a, bound tol {SCALE_TOL:g}); card "
                f"stage vs plain version on its inputs, max l2_rel: y "
                f"{st['y_vs_plain']:.2e}, moments {st['mom_vs_plain']:.2e} "
                f"(tol 1e-3); denoiser "
                f"l2_rel={e[0]:.3e} (tol {lims[0]:.3e}), guidance grad "
                f"l2_rel={e[1]:.3e} (tol {lims[1]:.3e}) "
                f"{'ok' if good else 'FAIL'}")
            if not good:
                raise RuntimeError(f"check failed: {label} int8 forced "
                                   f"({dn} carrier)")
        _check_train_grads(m, edm, L, tol)
        log(f"check {label}: {time.perf_counter() - t0:.1f} s")


def _check_train_grads(m, edm, L: int, tol: float):
    """The gradients of one training step (the EDM loss at fixed sigma and
    noise, remat on, every weight opened), card against the CPU: the whole
    gradient vector's relative L2 error and the worst parameter's.  fp32 to
    ``tol``; bf16 to the CPU's fp32 no worse than 1.5x the CPU's bf16 (as
    the serving check does)."""
    import torch

    rng = np.random.default_rng(21)
    x = (0.1 * rng.standard_normal((1, L))).astype(np.float32)
    sigma = np.full((1, 1), 0.2, np.float32)
    noise = (sigma * rng.standard_normal((1, L))).astype(np.float32)
    m.net.set_precision(None)
    m.net.remat = True
    m.net.requires_grad_(True)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        m.net.compute_dtype = dt
        for dev in ("cpu", "cuda"):
            m.to(dev)
            m.net.zero_grad(set_to_none=True)
            e2, _ = edm.loss_fn(None, m.apply, torch.tensor(x, device=dev),
                                sigma=torch.tensor(sigma, device=dev),
                                noise=torch.tensor(noise, device=dev))
            e2.mean().backward()
            out[dev, dt] = {k: p.grad.detach().float().cpu()
                            for k, p in m.net.named_parameters()}
    m.net.remat = False
    m.net.requires_grad_(False)
    m.net.zero_grad(set_to_none=True)

    def rel(a, b):
        va = torch.cat([v.flatten() for v in a.values()])
        vb = torch.cat([v.flatten() for v in b.values()])
        worst = max((float((a[k] - b[k]).norm() / (b[k].norm() + 1e-30)), k)
                    for k in b)
        return float((va - vb).norm() / (vb.norm() + 1e-30)), worst

    ref = out["cpu", torch.float32]
    e, worst = rel(out["cuda", torch.float32], ref)
    good = e <= tol
    log(f"check train grads fp32: all {len(ref)} parameters card vs CPU "
        f"l2_rel={e:.3e} (tol {tol:g}); worst parameter {worst[1]} "
        f"l2_rel={worst[0]:.3e} {'ok' if good else 'FAIL'}")
    e_card, _ = rel(out["cuda", torch.bfloat16], ref)
    e_cpu, _ = rel(out["cpu", torch.bfloat16], ref)
    ok_b = e_card <= 1.5 * e_cpu
    log(f"check train grads bf16 vs fp32 CPU: card l2_rel={e_card:.3e}, CPU "
        f"l2_rel={e_cpu:.3e} (card within 1.5x) {'ok' if ok_b else 'FAIL'}")
    if not (good and ok_b):
        raise RuntimeError("check failed: training gradients")


def _lowpassed_audio(L: int, fs: int, seed: int) -> np.ndarray:
    """Seeded harmonic tones plus noise, low-passed at 1 kHz by the
    parametric filter (fc 1000 Hz, -40 dB/oct)."""
    import torch

    from babe_tpu_torch.ops.filters import design_filter
    from babe_tpu_torch.ops.stft import apply_filter, rfftfreq

    rng = np.random.default_rng(seed)
    t = np.arange(L) / fs
    x = np.zeros(L)
    for f0 in rng.uniform(110, 440, 3):
        for k in range(1, 20):
            x += rng.uniform(0.2, 1.0) / k * np.sin(
                2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi))
    x += 0.05 * rng.standard_normal(L)
    x = (0.063 * x / x.std()).astype(np.float32)
    freqs = torch.as_tensor(rfftfreq(4096, fs))
    H = design_filter(torch.tensor([1000.0]), torch.tensor([-40.0]), freqs)
    return apply_filter(torch.as_tensor(x)[None], H, 4096)[0].numpy()


def phase_requests(results: dict, T: int = 35, n_blind: int = 2):
    """Two blind requests and one informed request through each of two
    loads of the same checkpoint, bf16 and int8.  Each model's run is one
    path: the counters are zeroed just before it and read just after."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.api import BABE
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.utils.weights import to_flax

    args = default_config(["tester=blind_bwe"])
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    t0 = time.perf_counter()
    model = CQTDiffPlus.from_config(args).init(seed=0, device="cpu")
    params, buffers = to_flax(model.net)
    tmpdir = tempfile.mkdtemp(prefix="babe_smoke_")
    path = os.path.join(tmpdir, "flagship-seed0.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"it": 0, "params": params, "buffers": buffers,
                     "ema": params, "args": args.to_dict()}, f)
    del model
    models = {}
    for prec in ("bf16", "int8"):
        t1 = time.perf_counter()
        models[prec] = BABE.load(path, overrides=[f"tester.T={T}"],
                                 precision=None if prec == "bf16" else prec)
        log(f"requests: flagship model (seed 0) loaded as {prec} on "
            f"{models[prec].device} in {time.perf_counter() - t1:.1f} s")
    os.remove(path)
    os.rmdir(tmpdir)
    log(f"requests: checkpoint written and loaded twice in "
        f"{time.perf_counter() - t0:.1f} s; tester.T={T} ({2 * T - 1} "
        f"guided evaluations per request)")
    reqs = [("blind", None)] * n_blind + [("informed", (1000.0, -40.0))]
    for prec, path_kernels in (("bf16", BF16_PATH), ("int8", INT8_PATH)):
        m = models.pop(prec)
        kernels.reset_launch_counts()
        for k, (kind, filt) in enumerate(reqs):
            x = _lowpassed_audio(L, fs, seed=10 + k)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, info = m.enhance(x, fs, filter=filt, seed=k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            fin = bool(np.isfinite(out).all()) and out.shape == (1, L)
            log(f"request {k} ({prec}, {kind}): {L} samples, wall "
                f"{wall:.2f} s, realtime factor {L / fs / wall:.3f}x, "
                f"fc={np.round(info['fc'], 1).tolist()} "
                f"A={np.round(info['A'], 2).tolist()}, out shape "
                f"{out.shape} finite={fin}")
            if not (fin and np.isfinite(info["fc"]).all()
                    and np.isfinite(info["A"]).all()):
                raise RuntimeError(f"request {k} ({prec}) gave a non-finite "
                                   f"result")
            results.setdefault("requests", []).append(
                {"precision": prec, "kind": kind, "wall_s": wall,
                 "rtf": L / fs / wall})
        counts = dict(kernels.LAUNCHES)
        log(f"launches during the {prec} requests: {counts}")
        for name in path_kernels:
            if counts[name] <= 0:
                raise RuntimeError(f"kernel {name} never launched on the "
                                   f"{prec} path")
        if prec == "bf16" and (counts["fused_stage_int8"]
                               or counts["stage_int8_operand"]):
            raise RuntimeError("the bf16 model launched the int8 stage")
        results[f"launches_{prec}"] = counts
        del m
        torch.cuda.empty_cache()
    launches = results.setdefault("launches", {})
    launches.update({k: results["launches_bf16"][k] for k in BF16_PATH
                     if k not in DW_KERNELS})
    for k in ("fused_stage_int8", "stage_int8_operand"):
        launches[k] = results["launches_int8"][k]


def train_launches_per_step(net) -> dict:
    """Each path kernel's launches in one training step of ``net``: K1 and
    conv_dw once per (5,3) conv outside the ResnetBlocks (the pyramid
    convs; their inputs need no gradient, so no dx), K2 once per fused
    stage and once more when remat recomputes the block, K2's backward,
    stage_dw_operands and fused_stage_dw once per stage."""
    from babe_tpu_torch.models.blocks import Conv2d, ResnetBlock

    stages = sum(b.num_dils for b in net.modules()
                 if isinstance(b, ResnetBlock) and b.fused)
    pyr = sum(1 for m in net.children()
              if isinstance(m, Conv2d) and m.kernel_size == (5, 3))
    # every flagship stage takes K2's engine, which launches its operand
    # pass once per call (the kernels phase and the CPU tests check the
    # routes)
    return {"conv5x3": pyr, "conv_dw": pyr,
            "fused_stage": stages * (2 if net.remat else 1),
            "stage_fwd_operand": stages * (2 if net.remat else 1),
            "fused_stage_bwd": stages, "stage_dw_operands": stages,
            "fused_stage_dw": stages}


def _seeded_wavs(folder: str, n: int, seconds: float, fs: int, seed: int):
    """Seeded harmonic tones plus noise, written as 16-bit wavs."""
    from babe_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    for i in range(n):
        x = 0.01 * rng.standard_normal(t.size)
        for f0 in rng.uniform(80, 600, 4):
            for k in range(1, 12):
                x += rng.uniform(0.02, 0.1) / k * np.sin(
                    2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi))
        write_wav(os.path.join(folder, f"seed{seed}_{i}.wav"),
                  (0.5 * x / np.abs(x).max()).astype(np.float32), fs)


def phase_train(results: dict, steps: int = 5, untimed: int = 2):
    """``python -m babe_tpu_torch.train``'s ``main`` at the flagship config
    (dset=musicnet on seeded 44.1 kHz wavs, exp=maestro22k_8s: batch 4,
    184184 samples, resample factor 2, remat, bf16) for ``steps`` steps,
    the first ``untimed`` untimed, then its checkpoint served by BABE.load.
    Every step is timed between synchronisations and its kernel launches
    counted; the counters are zeroed just before main and read just after.
    Fails on a non-finite loss, params or EMA that did not move after the
    untimed steps, a launch count other than the network's, a missing
    checkpoint or a non-finite blind request."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from babe_tpu_torch import kernels
    from babe_tpu_torch import train as ttrain
    from babe_tpu_torch.api import BABE
    from babe_tpu_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="babe_train_")
    try:
        wavs = os.path.join(tmp, "wavs")
        os.makedirs(wavs)
        t0 = time.perf_counter()
        _seeded_wavs(wavs, 4, 12.0, 44100, seed=30)
        log(f"train: 4 seeded 12 s wavs at 44100 Hz written in "
            f"{time.perf_counter() - t0:.1f} s")
        rec, snap = [], {}
        orig = Trainer._step

        def step_spy(self, x, sigma=None, noise=None):
            torch.cuda.synchronize()
            before = dict(kernels.LAUNCHES)
            t1 = time.perf_counter()
            m = orig(self, x, sigma, noise)
            torch.cuda.synchronize()
            rec.append({"s": time.perf_counter() - t1,
                        "loss": float(m["loss"]),
                        "nonfinite": bool(m["nonfinite"]),
                        "launches": {k: kernels.LAUNCHES[k] - before[k]
                                     for k in TRAIN_PATH}})
            snap["x"] = x
            if len(rec) == untimed:
                snap["params"] = {k: p.detach().clone()
                                  for k, p in self.params.items()}
                snap["ema"] = {k: v.clone() for k, v in self.ema.items()}
            return m

        argv = ["dset=musicnet", f"dset.path={wavs}", "exp=maestro22k_8s",
                "network=cqtdiff+", f"model_dir={os.path.join(tmp, 'exp')}",
                "exp.resume=false", f"exp.total_its={steps}",
                "logging.log_interval=1"]
        log(f"train: python -m babe_tpu_torch.train {' '.join(argv)}")
        Trainer._step = step_spy
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            tr = ttrain.main(argv)
        finally:
            Trainer._step = orig
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: kernels.LAUNCHES[k] for k in TRAIN_PATH}
        peak = torch.cuda.max_memory_allocated()
        exp = tr.args.exp
        cfg = (int(exp.batch), int(exp.audio_len),
               int(exp.resample_factor), bool(tr.net.remat),
               tr.net.compute_dtype)
        if cfg != (4, 184184, 2, True, torch.bfloat16):
            raise RuntimeError(f"train: not the flagship config: {cfg}")
        want = train_launches_per_step(tr.net)
        for i, r in enumerate(rec):
            log(f"train step {i + 1}{' (untimed)' if i < untimed else ''}: "
                f"{r['s']:.3f} s, loss {r['loss']:.5f}, launches "
                f"{r['launches']}")
        timed = [r["s"] for r in rec[untimed:]]
        s_step = float(np.median(timed))
        audio_s = int(exp.batch) * int(exp.audio_len) / int(exp.sample_rate)
        # the device's busy share over one more step of the same batch
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tr._step(snap["x"])
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t1
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CUDA]
        busy = sum(_dev_us(e) for e in kern) / 1e6
        log(f"train: {len(rec)} steps in {wall:.1f} s of main (data, "
            f"model build, steps, checkpoint); timed steps {timed} s, "
            f"median {s_step:.3f} s/step, {audio_s / s_step:.3f} audio-s "
            f"trained per s ({int(exp.batch)} x {int(exp.audio_len)} samples "
            f"at {int(exp.sample_rate)} Hz); peak memory allocated "
            f"{peak / 2**30:.2f} GiB; one profiled step: wall {pwall:.3f} s, "
            f"device kernel time {busy:.3f} s, busy share "
            f"{busy / pwall:.3f}")
        log(f"train: the profiled step's {sum(e.count for e in kern)} "
            f"kernel launches; top kernels by device time:")
        for e in sorted(kern, key=_dev_us, reverse=True)[:12]:
            log(f"  {_dev_us(e) / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")
        log(f"train: launches {counts}, per step expected {want}")
        bad = [i for i, r in enumerate(rec) if r["launches"] != want]
        if len(rec) != steps or bad or any(
                counts[k] != steps * want[k] for k in TRAIN_PATH):
            raise RuntimeError(f"train: launch counts differ from the "
                               f"network's at steps {bad}")
        if any(r["nonfinite"] or not math.isfinite(r["loss"]) for r in rec):
            raise RuntimeError("train: a non-finite step")
        moved = {what: max(float((getattr(tr, what)[k].detach()
                                  - v).abs().max())
                           for k, v in snap[what].items())
                 for what in ("params", "ema")}
        log(f"train: largest change after step {untimed}: {moved}")
        if not all(v > 0 for v in moved.values()):
            raise RuntimeError("train: params or EMA did not move")
        ckpt = tr._latest_ckpt
        if not (ckpt and os.path.exists(ckpt)):
            raise RuntimeError("train: no checkpoint written")
        log(f"train: checkpoint {os.path.basename(ckpt)} "
            f"({os.path.getsize(ckpt) / 2**20:.0f} MiB)")
        del tr, snap
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        m = BABE.load(ckpt)
        L, fs = int(m.args.exp.audio_len), m.fs
        x = _lowpassed_audio(L, fs, seed=31)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out, info = m.enhance(x, fs, seed=0)
        torch.cuda.synchronize()
        fin = (bool(np.isfinite(out).all()) and out.shape == (1, L)
               and np.isfinite(info["fc"]).all())
        log(f"train: the checkpoint loaded with BABE.load on "
            f"{m.device} in {t2 - t1:.1f} s; one blind request "
            f"{time.perf_counter() - t2:.2f} s, fc="
            f"{np.round(info['fc'], 1).tolist()} finite={fin}")
        if not fin:
            raise RuntimeError("train: the trained checkpoint's blind "
                               "request is not finite")
        results["train"] = {"s_per_step": s_step, "timed_s": timed,
                            "audio_s_per_s": audio_s / s_step,
                            "peak_gib": peak / 2**30,
                            "busy_share": busy / pwall}
        results.setdefault("launches", {}).update(
            {k: counts[k] for k in DW_KERNELS})
        del m
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_quality(results: dict, sigma_gate: float = 0.02):
    """The same-seed 35-step unconditional trajectory in bf16 and in int8:
    flagship model (seed 0) at 110250 samples, batch 4, every gate kernel
    drawn from N(0, sigma_gate^2) so each block contributes (the EDM init
    keeps them at 1e-7, which would make the two runs nearly identical).
    Reported, not gated: there are no trained weights here."""
    import torch

    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM, EDMParams
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.sampling.heun import Sampler, SamplerConfig
    from babe_tpu_torch.utils.metrics import lsd

    L, batch, T = 110250, 4, 35
    args = default_config([f"exp.audio_len={L}"])
    model = CQTDiffPlus.from_config(args).init(seed=0, device="cpu")
    g = torch.Generator().manual_seed(123)
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if name.split(".")[-2].startswith("gate") and p.ndim == 2:
                p.copy_(sigma_gate * torch.randn(p.shape, generator=g))
    model.to("cuda")
    model.net.requires_grad_(False)
    edm = EDM(EDMParams(sigma_data=0.063, sigma_min=1e-4, sigma_max=1.0,
                        ro=8, ro_train=13, Schurn=20))
    cfg = SamplerConfig(T=T, order=2, xi=0.0, audio_len=L,
                        filter_out_cqt_DC_Nyq=True)
    outs, walls = {}, {}
    for prec in ("bf16", "int8"):
        model.net.set_precision(prec)
        s = Sampler(model.fused_denoiser(edm), edm, cfg, hpf=None,
                    device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[prec] = s.predict_unconditional(gen, (batch, L)).float()
        torch.cuda.synchronize()
        walls[prec] = time.perf_counter() - t0
    a, b = outs["bf16"], outs["int8"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError("quality: a trajectory is not finite")
    rel = float((b - a).norm() / a.norm().clamp(min=1e-12))
    lsd_db = float(lsd(a, b).mean())
    log(f"quality: 35-step unconditional trajectory, {batch} x {L} samples, "
        f"gates N(0, {sigma_gate}^2), seed 0 weights, sampler seed 7: "
        f"bf16 {walls['bf16']:.2f} s, int8 {walls['int8']:.2f} s; waveform "
        f"relative divergence {rel:.6f}, LSD between the two {lsd_db:.4f} dB "
        f"(reported, not gated: no trained weights)")
    results["quality"] = {"waveform_rel_divergence": rel,
                          "lsd_between_paths_db": lsd_db,
                          "sigma_gate": sigma_gate}


def _dev_us(e) -> float:
    """An event's own device time in microseconds (the attribute's name
    differs between torch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def phase_profile():
    """Where one guided evaluation of a blind request spends its time, in
    bf16 and in int8: the parts timed with synchronisation (network forward
    with the graph kept, filter fit, guidance backward), then one whole
    stage under torch.profiler (kernel time by name and the device's busy
    share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.ops.filters import design_filter
    from babe_tpu_torch.ops.stft import apply_filter_istft, apply_stft
    from babe_tpu_torch.testers.tester import Tester

    args = default_config(["tester=blind_bwe"])
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    model = CQTDiffPlus.from_config(args).init(seed=0, device="cuda")
    model.net.requires_grad_(False)
    t = Tester(args, model, EDM.from_config(args), device="cuda")
    t.loaded = True
    b = t.blind_cfg
    y = torch.as_tensor(_lowpassed_audio(L, fs, seed=10), device="cuda")[None]
    Y = apply_stft(y, b.nfft)
    p0 = b.initial_params("cuda")
    x_hat = y + 0.2 * torch.randn(y.shape, device="cuda")
    for prec in ("bf16", "int8"):
        model.net.set_precision(prec)
        s = t.sampler()
        s._stage(x_hat, 0.2, p0, y, Y, None)  # warm-up
        parts = {}
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.enable_grad():
                xg = x_hat.detach().requires_grad_(True)
                x_den = s._denoise(xg, 0.2)
                X = apply_stft(x_den, b.nfft)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                params = s.fit_params(X, Y, p0)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                H = design_filter(params[0], params[1], s.freqs)
                val = s.cfg.norm_fn(
                    y, apply_filter_istft(X, H, b.nfft)[..., :L])
                torch.autograd.grad(val, xg)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            parts = {"network forward + STFT": t1 - t0, "filter fit": t2 - t1,
                     "guidance backward": t3 - t2}
        log(f"profile {prec}: one guided evaluation (blind), seconds: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s._stage(x_hat, 0.2, p0, y, Y, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        kern = [e for e in ka if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CUDA]
        busy = sum(_dev_us(e) for e in kern) / 1e6
        log(f"profile {prec}: one stage under the profiler: wall {wall:.4f} "
            f"s, device kernel time {busy:.4f} s, device busy share "
            f"{busy / max(wall, 1e-9):.3f}")
        log(f"profile {prec}: {sum(e.count for e in kern)} kernel launches; "
            f"top kernels by device time:")
        for e in sorted(kern, key=_dev_us, reverse=True)[:20]:
            log(f"  {_dev_us(e) / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")
        log(f"profile {prec}: top operators by device time (their kernels "
            f"included):")
        ops = [e for e in ka if e not in kern]
        for e in sorted(ops, key=_dev_us, reverse=True)[:12]:
            log(f"  {_dev_us(e) / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases",
                   default="identify,kernels,probe,check,requests,train,"
                           "quality",
                   help="comma list; 'profile' (not run by default) breaks "
                        "one guided evaluation down")
    a = p.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from babe_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    phases = a.phases.split(",")
    results: dict = {}
    if {"identify", "kernels", "probe", "train"} & set(phases):
        phase_identify(kernels)
    if "kernels" in phases:
        phase_kernels(results)
    if "probe" in phases:
        phase_probe(results)
    if "check" in phases:
        phase_check()
    if "requests" in phases:
        phase_requests(results)
    if "train" in phases:
        phase_train(results)
    if "quality" in phases:
        phase_quality(results)
    if "profile" in phases:
        phase_profile()
    launches = results.get("launches", {})
    line = []
    for name in SOURCES:
        r = results.get(name, {})
        line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches.get(name, 0),
            "max_abs_err": r.get("max_abs_err"),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"),
            "bound_by": ("operations" if r.get("ops_ms", 0.0)
                         >= r.get("bytes_ms", 0.0) else "bytes"),
            "library_ms": r.get("library_ms"),
            "check": "ok" if r else "not run",
            "launches_from": LAUNCHES_FROM.get(name, "the bf16 requests"),
            "per": PER.get(name, "one guided evaluation, bf16, main-path "
                                 "shapes")})
    log(f"card: {smi_line()}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
