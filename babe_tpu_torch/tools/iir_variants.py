"""Time the IIR recursion kernel's store and chunk variants on the card.

``csrc/iir.cu`` reads x a chunk of samples ahead into registers and
stores each chunk's outputs after its recursion.  This tool builds
variants of that source with another chunk length and with the stores
made between the steps instead (text edits of the shipped source, one
nvcc each, in parallel, under a temporary directory), checks that each
gives the shipped kernel's output bit for bit, and times each forward on
cheby1 (order 6) rows of 184184 samples, printing ptxas's registers and
the SM cycles a sample at the card's highest SM clock (nvidia-smi's
clocks.max.sm):

    python -m babe_tpu_torch.tools.iir_variants [--chunks 32 64 128]

It needs a card and the CUDA toolkit; it changes nothing in the repo.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import tempfile

import torch

from babe_tpu_torch import kernels as _k
from babe_tpu_torch.ops import iir

BUFFERED = """    float yb[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) yb[k] = step<NS>(cur[k], s, b, a);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) row.y[row.at(c0 + k)] = yb[k];"""
INTERLEAVED = """#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      row.y[row.at(c0 + k)] = step<NS>(cur[k], s, b, a);"""


def variants(chunks) -> dict[str, str]:
    with open(os.path.join(_k.CSRC, "iir.cu")) as f:
        src = f.read()
    if BUFFERED not in src or "constexpr int kChunk = 32;" not in src:
        raise RuntimeError("csrc/iir.cu no longer has the chunk loop this "
                           "tool edits")
    out = {}
    for c in chunks:
        base = src.replace("constexpr int kChunk = 32;",
                           f"constexpr int kChunk = {c};")
        out[f"chunk {c}, stores after the chunk"] = base
        out[f"chunk {c}, stores between the steps"] = base.replace(
            BUFFERED, INTERLEAVED)
    return out


def build(srcs: dict[str, str], tmp: str) -> dict[str, tuple]:
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        cu, so = (os.path.join(tmp, f"v{i}.{e}") for e in ("cu", "so"))
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen(
            [_k._nvcc(), *_k.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.babe_lfilter.argtypes = _k.KERNELS["lfilter"][2]
        lib.babe_lfilter.restype = ctypes.c_int
        # the instantiation for n = 7 (cheby1 of order 6)
        rep = _k.ptxas_report(log)
        regs = [v for k, v in rep.items() if "ILi6E" in k]
        out[name] = (lib, regs[0] if regs else None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    L, rows_list = 184184, (1, 4)
    b, a_ = iir.get_cheby1_ba(6, 0.05, 2 * 1000.0 / 22050)
    coef = iir._normalised(a_, b, torch.float32, "cuda")
    x = torch.randn((max(rows_list), L), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    ref = _k.launch_lfilter(x, coef)
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip()
    hz = 1e6 * float(clk.splitlines()[0]) if re.match(r"^\d", clk) else 1.98e9
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        for name, (lib, rep) in build(variants(a.chunks), tmp).items():
            for rows in rows_list:
                xr = x[:rows].contiguous()
                y = torch.empty_like(xr)

                def call():
                    rc = lib.babe_lfilter(xr.data_ptr(), y.data_ptr(),
                                          coef.data_ptr(), None, rows, L,
                                          coef.numel() // 2, 0, stream)
                    if rc:
                        raise RuntimeError(f"{name}: cudaError {rc}")

                call()
                torch.cuda.synchronize()
                same = torch.equal(y, ref[:rows])
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(a.reps):
                    call()
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1) / a.reps
                print(f"iir variant {name}, {rows}x{L}: {ms:.4f} ms forward,"
                      f" {ms * 1e-3 * hz / L:.1f} SM cycles a sample at "
                      f"{hz / 1e6:.0f} MHz; ptxas {rep}; bit-equal to the "
                      f"shipped kernel {same}", flush=True)
                if not same:
                    raise RuntimeError(f"{name} differs from the shipped "
                                       f"kernel")


if __name__ == "__main__":
    main()
