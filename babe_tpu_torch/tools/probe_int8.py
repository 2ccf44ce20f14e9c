"""Probe: what int8 tensor-core products buy over bf16 on the card, at the
fused dilation stage's GEMM shapes.

Counterpart of ``tools/probe_pallas_int8.py``, with its two measurements:

  1. P1, a plain GEMM (M, K) @ (K, N): bf16 in, fp32 accumulate, bf16 out,
     against int8 in, int32 out (``csrc/probe_int8.cu``, babe_probe_gemm),
     16 dependent repetitions per launch;
  2. P2, the int8 stage's core without its prologue and epilogue: staged
     rows (BF + 4d, BT + 16, C) -> the 15 shifted patches of the implicit
     GEMM -> 5 x 3 tap products, 8 dependent repetitions per launch, in
     bf16 and in int8 (babe_probe_stage: the stage engine's main loop, so
     its ratio is that of K2's and K3's core).

Each prints the time of one product (a launch's time over its
repetitions) and its rate (Tops/s).  Launches are timed as device time:
``reps`` of them captured in one CUDA graph, a replay's time over
``reps`` (a P1 launch is about as short as its dispatch from the host,
so timing eager launches would time the host).  Usage, on a machine with
a card:

    python -m babe_tpu_torch.tools.probe_int8 [reps]

``probe_gemm_ref`` and ``probe_stage_ref`` are the kernels' plain versions
(float64 inside: exact for the int8 products at these depths).
"""

from __future__ import annotations

import sys

import torch

from babe_tpu_torch import kernels

GEMM_SHAPES = ((2048, 384, 128), (2048, 768, 256))      # (M, K, N)
STAGE_SHAPES = ((16, 128, 128, 2), (8, 128, 256, 1))    # (BF, BT, C, d)
GEMM_REPS = 16
STAGE_REPS = 8
DTYPES = (torch.bfloat16, torch.int8)


def probe_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P1's plain version: a (M,K) @ b (K,N); int8 -> int32, bf16 -> bf16."""
    out = a.double() @ b.double()
    return out.to(torch.int32 if a.dtype == torch.int8 else torch.bfloat16)


def stage_weights_tap_major(w5: torch.Tensor) -> torch.Tensor:
    """The stage probe's (5, 3C, C) kernel (rows kt*C + c) -> (15, C, C)
    tap-major, [kf*3 + kt, n, c]."""
    C = w5.shape[2]
    return w5.reshape(5, 3, C, C).permute(0, 1, 3, 2).reshape(15, C, C) \
        .contiguous()


def probe_stage_ref(h: torch.Tensor, w5: torch.Tensor, BF: int, BT: int,
                    d: int) -> torch.Tensor:
    """P2's plain version: out[f*BT + t, n] = sum over (kf, kt, c) of
    h[f + kf*d, 7 + kt + t, c] * w5[kf, kt*C + c, n]; int8 -> int32,
    bf16 -> fp32."""
    C = h.shape[2]
    hd, wd = h.double(), w5.double()
    out = h.new_zeros((BF, BT, C), dtype=torch.float64)
    for kf in range(5):
        rows = hd[kf * d:kf * d + BF]
        for kt in range(3):
            out = out + rows[:, 7 + kt:7 + kt + BT, :] @ wd[kf, kt * C:
                                                             (kt + 1) * C]
    return out.reshape(BF * BT, C).to(
        torch.int32 if h.dtype == torch.int8 else torch.float32)


def random_operand(shape, dtype, gen: torch.Generator, device):
    """int8 uniform in [-127, 127], or bf16 N(0, 1)."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def gemm_inputs(M, K, N, dtype, gen, device):
    """(a, b, bt) with bt = b transposed, the kernel's layout."""
    a = random_operand((M, K), dtype, gen, device)
    b = random_operand((K, N), dtype, gen, device)
    return a, b, b.t().contiguous()


def stage_inputs(BF, BT, C, d, dtype, gen, device):
    """(h, w5, wt) for one stage probe."""
    h = random_operand((BF + 4 * d, BT + 16, C), dtype, gen, device)
    w5 = random_operand((5, 3 * C, C), dtype, gen, device)
    return h, w5, stage_weights_tap_major(w5)


def gemm_ops(M, K, N) -> float:
    return 2.0 * M * K * N


def stage_ops(BF, BT, C) -> float:
    return 2.0 * BF * BT * 3 * C * C * 5


def device_ms(fn, reps: int, replays: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in one
    CUDA graph (after warm-up calls on a side stream), the mean of
    ``replays`` replays over ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (replays * reps)


def run(reps: int = 30, log=print) -> list[dict]:
    """Time P1 and P2 at their shapes in bf16 and int8 on the card over
    ``reps`` launches in a CUDA graph; one record per (kernel, shape,
    dtype) with the ms of one product and its Tops/s."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_int8: no CUDA device; the probe measures "
                           "the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for M, K, N in GEMM_SHAPES:
        log(f"-- GEMM ({M},{K})@({K},{N}) (x{GEMM_REPS} inner) --")
        for dt in DTYPES:
            a, _, bt = gemm_inputs(M, K, N, dt, gen, dev)
            ms = device_ms(lambda: kernels.launch_probe_gemm(
                a, bt, GEMM_REPS), reps) / GEMM_REPS
            tops = gemm_ops(M, K, N) / (ms * 1e-3) / 1e12
            name = str(dt).split(".")[-1]
            log(f"  {name}: {ms:8.4f} ms  {tops:7.1f} Tops/s per product")
            out.append({"kernel": "probe_gemm", "shape": (M, K, N),
                        "dtype": name, "ms": ms, "tops": tops})
    for BF, BT, C, d in STAGE_SHAPES:
        log(f"-- patch-build+GEMM tile: nrows={BF + 4 * d} BF={BF} BT={BT} "
            f"C={C} d={d} (x{STAGE_REPS} inner) --")
        for dt in DTYPES:
            h, _, wt = stage_inputs(BF, BT, C, d, dt, gen, dev)
            wpk = kernels.stage_tap_weights(wt)  # packed once, untimed
            ms = device_ms(lambda: kernels.launch_probe_stage(
                h, wt, BF, BT, d, STAGE_REPS, wpk=wpk), reps) / STAGE_REPS
            tops = stage_ops(BF, BT, C) / (ms * 1e-3) / 1e12
            name = str(dt).split(".")[-1]
            log(f"  {name}: {ms:8.4f} ms  {tops:7.1f} Tops/s per product "
                f"(incl. patch build)")
            out.append({"kernel": "probe_stage", "shape": (BF, BT, C, d),
                        "dtype": name, "ms": ms, "tops": tops})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 30
    if not torch.cuda.is_available():
        print("probe_int8: no CUDA device", file=sys.stderr)
        return 2
    print("device:", torch.cuda.get_device_name(0))
    run(reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
