#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``babe_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every default phase
    python3 chip_smoke.py --phases identify,profile   # a time breakdown

Phases (any failure exits non-zero; no phase catches and carries on):

  1. identify   the card (nvidia-smi name and power limit), torch and CUDA
                versions, and the kernel build (one nvcc per source, all
                started together) with its time and ptxas resource lines.
  2. kernels    every hand kernel against its plain PyTorch version on the
                card, in bf16 and fp32, at every shape the flagship path
                gives it: K1 (conv5x3) at each pyramid conv and its
                transpose, K2 (fused dilation stage, moments included) and
                its backward kernel at each (C, d, F, T) stage of the
                network on the full 184184-sample segment.  Each shape also
                gets its time, its bound, the plain version's time and a
                cuDNN conv of the same conv as a yardstick.
  3. check      the model on the card against the same model on the CPU
                (plain path, itself held to the JAX package by the tests):
                denoiser output and guidance gradient at the tiny config in
                fp32 and at the flagship widths on a short segment in fp32
                and bf16.
  4. requests   the flagship model from a seed, written as a JAX-format
                .ckpt, loaded with ``BABE.load`` on the card, answering two
                blind ``enhance`` requests and one informed one on 184184
                samples of seeded low-passed audio.  The launch counters are
                zeroed just before and read just after.

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
}
SOURCES = {
    "conv5x3": "babe_tpu_torch/csrc/conv5x3.cu",
    "fused_stage": "babe_tpu_torch/csrc/fused_stage.cu",
    "fused_stage_bwd": "babe_tpu_torch/csrc/fused_stage.cu",
    "filter_fit": "babe_tpu_torch/csrc/filter_fit.cu",
}


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
    import torch

    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
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
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


def phase_kernels(results: dict):
    import torch
    import torch.nn.functional as Fnn

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
    ok = True
    agg = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "max_abs_err": 0.0, "flops": 0.0,
                  "bytes": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "shapes": 0}
           for name in SOURCES}

    def library_conv(x, w, d):
        xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return lambda: Fnn.conv2d(xc, wc, padding=(2 * d, 1),
                                  dilation=(d, 1))

    def account(name, count, dtype, t_k, t_p, t_l, flops, nbytes, e):
        if dtype != torch.bfloat16:
            return
        a = agg[name]
        b, _ = bound_ms(flops, nbytes, dtype)
        a["ms"] += count * t_k
        a["plain_ms"] += count * t_p
        a["library_ms"] += count * t_l
        a["bound_ms"] += count * b
        a["flops"] += count * flops
        a["bytes"] += count * nbytes
        a["ops_ms"] += count * 1e3 * flops / PEAK_BF16
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
            if role != "pyramid fwd":  # a transposed-weight call
                w = ck._flip_io(w.transpose(2, 3).contiguous())
            y = kernels.launch_conv5x3(x, w, d)
            ref = ck.conv_ref(x, w, d)
            torch.cuda.synchronize()
            e = errs(y, ref)
            good = within(e, dn)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_conv5x3(x, w, d))
            t_p = cuda_time(lambda: ck.conv_ref(x, w, d), reps=2)
            t_l = cuda_time(library_conv(x, w, d))
            flops = 2.0 * F * T * C * N * 15
            nbytes = (F * T * (C + N) + 15 * C * N) * isz
            b, by = bound_ms(flops, nbytes, dtype)
            log(f"K1 {dn:8s} {role:11s} F={F:3d} T={T:4d} C={C:3d} N={N:3d} "
                f"d={d:2d} x{count:2d}: max_abs={e[0]:.3e} max_rel={e[1]:.2e}"
                f" l2_rel={e[2]:.2e} {'ok' if good else 'FAIL'} | "
                f"ms={t_k:.4f} bound={b:.4f}({by}) plain={t_p:.4f} "
                f"cudnn={t_l:.4f}")
            account("conv5x3", count, dtype, t_k, t_p, t_l, flops, nbytes, e)
        for (F, T, C, d), count in sorted(k2_shapes.items()):
            x = torch.randn((1, F, T, C), generator=g, device=dev).to(dtype)
            w = (torch.randn((5, 3, C, C), generator=g, device=dev)
                 / math.sqrt(15 * C)).to(dtype)
            a = 0.5 + torch.rand((1, C), generator=g, device=dev)
            s = torch.randn((1, C), generator=g, device=dev)
            y, mom, c = kernels.launch_fused_stage(x, a, s, w, d,
                                                   want_conv=True)
            ry, rmom, rc = ck._dil_stage_parts(x, a, s, w, d)
            torch.cuda.synchronize()
            ey, ec = errs(y, ry), errs(c, rc)
            em = errs(mom, rmom)
            good = within(ey, dn) and within(ec, dn) and em[2] <= (
                1e-3 if dtype == torch.bfloat16 else 1e-5)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_fused_stage(
                x, a, s, w, d, want_conv=True))
            t_p = cuda_time(lambda: ck._dil_stage_parts(x, a, s, w, d),
                            reps=2)
            t_l = cuda_time(library_conv(x, w, d))
            flops = 2.0 * F * T * C * C * 15
            nbytes = (3 * F * T * C + 15 * C * C) * isz + 4 * 4 * C
            b, by = bound_ms(flops, nbytes, dtype)
            log(f"K2 {dn:8s} F={F:3d} T={T:4d} C={C:3d} d={d:2d} x{count}: "
                f"y max_abs={ey[0]:.3e} max_rel={ey[1]:.2e} "
                f"l2_rel={ey[2]:.2e}; conv l2_rel={ec[2]:.2e}; "
                f"mom l2_rel={em[2]:.2e} {'ok' if good else 'FAIL'} | "
                f"ms={t_k:.4f} bound={b:.4f}({by}) plain={t_p:.4f} "
                f"cudnn={t_l:.4f}")
            account("fused_stage", count, dtype, t_k, t_p, t_l, flops,
                    nbytes, ey)
            # the stage's backward: cotangents of y and of the moments
            gy = torch.randn((1, F, T, C), generator=g, device=dev).to(dtype)
            gm = torch.randn((2, 1, C), generator=g, device=dev) / (F * T)
            wt = ck._flip_io(w)
            dx, ds, da = kernels.launch_fused_stage_bwd(gy, gm, y, x, c, a,
                                                        s, wt, d)
            rdx, rda, rds = ck.dil_stage_bwd_ref(x, a, s, w, y, c, gy, gm, d)
            torch.cuda.synchronize()
            edx, eda, eds = errs(dx, rdx), errs(da, rda), errs(ds, rds)
            red_tol = 2e-3 if dtype == torch.bfloat16 else 1e-5
            good = within(edx, dn) and eda[2] <= red_tol and (
                eds[2] <= red_tol)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_fused_stage_bwd(
                gy, gm, y, x, c, a, s, wt, d))
            t_p = cuda_time(lambda: ck.dil_stage_bwd_ref(
                x, a, s, w, y, c, gy, gm, d), reps=2)
            t_l = cuda_time(library_conv(x, wt, d))
            nbytes = (5 * F * T * C + 15 * C * C) * isz + 6 * 4 * C
            b, by = bound_ms(flops, nbytes, dtype)
            log(f"K2bwd {dn:8s} F={F:3d} T={T:4d} C={C:3d} d={d:2d} "
                f"x{count}: dx max_abs={edx[0]:.3e} max_rel={edx[1]:.2e} "
                f"l2_rel={edx[2]:.2e}; da l2_rel={eda[2]:.2e}; ds l2_rel="
                f"{eds[2]:.2e} {'ok' if good else 'FAIL'} | ms={t_k:.4f} "
                f"bound={b:.4f}({by}) plain={t_p:.4f} cudnn={t_l:.4f}")
            account("fused_stage_bwd", count, dtype, t_k, t_p, t_l, flops,
                    nbytes, edx)
    ok &= _kernel_filter_fit(agg["filter_fit"])
    for name, a in agg.items():
        if name == "filter_fit":
            continue  # logged by _kernel_filter_fit
        log(f"{name}: per guided evaluation (bf16, main-path shapes and "
            f"counts) ms={a['ms']:.3f} bound_ms={a['bound_ms']:.3f} "
            f"plain_ms={a['plain_ms']:.3f} cudnn_ms={a['library_ms']:.3f} "
            f"achieved={a['flops'] / max(a['ms'], 1e-9) / 1e9:.1f} TFLOP/s")
    results.update(agg)
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version "
                           f"beyond the stated tolerance {TOL}")


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


def phase_check():
    """The model on the card (kernels) against the same weights on the CPU
    (plain path): the denoiser output and the guidance gradient
    d/dx sum(D(x)^2).  fp32 is held to summation-order tolerance.  In bf16
    the weights here (O(1) gates) make the network chaotic enough that two
    bf16 runs differing only in summation order drift apart by as much as
    bf16 drifts from fp32, so the card's bf16 result is held to the fp32
    reference no worse than 1.5x the CPU's own bf16 result is."""
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
        args = default_config(ov)
        m = CQTDiffPlus.from_config(args).init(seed=1, device="cpu")
        _random_flagship_like(m.net, 2)
        m.net.requires_grad_(False)
        edm = EDM.from_config(args)
        L = int(args.exp.audio_len)
        x = (0.1 * np.random.default_rng(3).standard_normal((1, L))).astype(
            np.float32)
        out = {}
        dtypes = ((torch.float32, torch.bfloat16) if label != "tiny"
                  else (torch.float32,))
        for dt in dtypes:
            m.net.compute_dtype = dt
            for dev in ("cpu", "cuda"):
                m.to(dev)
                xt = torch.tensor(x, device=dev, requires_grad=True)
                y = m.fused_denoiser(edm)(xt, torch.full((1, 1), 0.2,
                                                         device=dev))
                (gx,) = torch.autograd.grad((y * y).sum(), xt)
                out[dev, dt] = (y.detach().cpu(), gx.cpu())

        def rel(a, b):
            return float((a - b).norm() / (b.norm() + 1e-30))

        for what, i in (("denoiser", 0), ("guidance grad", 1)):
            ref = out["cpu", torch.float32][i]
            a = out["cuda", torch.float32][i]
            e = rel(a, ref)
            good = bool(torch.isfinite(a).all()) and e <= tol
            log(f"check {label} fp32: {what} card vs CPU l2_rel={e:.3e} "
                f"(tol {tol:g}) {'ok' if good else 'FAIL'}")
            if torch.bfloat16 in dtypes:
                e_card = rel(out["cuda", torch.bfloat16][i], ref)
                e_cpu = rel(out["cpu", torch.bfloat16][i], ref)
                ok16 = (bool(torch.isfinite(out["cuda", torch.bfloat16][i])
                             .all()) and e_card <= 1.5 * e_cpu)
                log(f"check {label} bf16: {what} vs fp32 CPU: card "
                    f"l2_rel={e_card:.3e}, CPU bf16 l2_rel={e_cpu:.3e} "
                    f"(card within 1.5x) {'ok' if ok16 else 'FAIL'}")
                good &= ok16
            if not good:
                raise RuntimeError(f"check failed: {label} {what}")


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
    m = BABE.load(path, overrides=[f"tester.T={T}"])
    os.remove(path)
    os.rmdir(tmpdir)
    log(f"requests: flagship model (seed 0) written as .ckpt and loaded "
        f"on {m.device} in {time.perf_counter() - t0:.1f} s; tester.T={T} "
        f"({2 * T - 1} guided evaluations per request)")
    kernels.reset_launch_counts()
    reqs = [("blind", None)] * n_blind + [("informed", (1000.0, -40.0))]
    for k, (kind, filt) in enumerate(reqs):
        x = _lowpassed_audio(L, fs, seed=10 + k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, info = m.enhance(x, fs, filter=filt, seed=k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        fin = bool(np.isfinite(out).all()) and out.shape == (1, L)
        log(f"request {k} ({kind}): {L} samples, wall {wall:.2f} s, "
            f"realtime factor {L / fs / wall:.3f}x, fc={np.round(info['fc'], 1).tolist()} "
            f"A={np.round(info['A'], 2).tolist()}, out shape "
            f"{out.shape} finite={fin}")
        if not (fin and np.isfinite(info["fc"]).all()
                and np.isfinite(info["A"]).all()):
            raise RuntimeError(f"request {k} gave a non-finite result")
        results.setdefault("requests", []).append(
            {"kind": kind, "wall_s": wall, "rtf": L / fs / wall})
    counts = dict(kernels.LAUNCHES)
    log(f"launches during the requests: {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise RuntimeError(f"kernel {name} never launched on the path")
    results["launches"] = counts


def phase_profile():
    """Where one guided evaluation of a blind request spends its time: the
    parts timed with synchronisation (network forward with the graph kept,
    filter fit, guidance backward), then one whole stage under
    torch.profiler (kernel time by name and the device's busy share)."""
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
    s = t.sampler()
    b = s.blind
    y = torch.as_tensor(_lowpassed_audio(L, fs, seed=10), device="cuda")[None]
    Y = apply_stft(y, b.nfft)
    p0 = b.initial_params("cuda")
    x_hat = y + 0.2 * torch.randn(y.shape, device="cuda")
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
            val = s.cfg.norm_fn(y, apply_filter_istft(X, H, b.nfft)[..., :L])
            torch.autograd.grad(val, xg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts = {"network forward + STFT": t1 - t0, "filter fit": t2 - t1,
                 "guidance backward": t3 - t2}
    log("profile: one guided evaluation (blind), seconds: "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s._stage(x_hat, 0.2, p0, y, Y, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    kern = [e for e in ka
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e6
    log(f"profile: one stage under the profiler: wall {wall:.4f} s, device "
        f"kernel time {busy:.4f} s, device busy share "
        f"{busy / max(wall, 1e-9):.3f}")
    log(f"profile: {sum(e.count for e in kern)} kernel launches; top "
        f"kernels by device time:")
    for e in sorted(kern, key=dev_us, reverse=True)[:20]:
        log(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")
    log("profile: top operators by device time (their kernels included):")
    ops = [e for e in ka if e not in kern]
    for e in sorted(ops, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases", default="identify,kernels,check,requests",
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
    if "identify" in phases or "kernels" in phases:
        phase_identify(kernels)
    if "kernels" in phases:
        phase_kernels(results)
    if "check" in phases:
        phase_check()
    if "requests" in phases:
        phase_requests(results)
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
            "per": ("one guided evaluation of a blind request, fp32"
                    if name == "filter_fit" else
                    "one guided evaluation, bf16, main-path shapes")})
    log(f"card: {smi_line()}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
