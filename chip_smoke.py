#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``babe_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every default phase
    python3 chip_smoke.py --phases identify,profile   # a time breakdown
    python3 chip_smoke.py --phases identify,iir       # IIR guidance times
    python3 chip_smoke.py --phases distill            # the PD proof

Phases (any failure exits non-zero; no phase catches and carries on):

  1. identify   the card (nvidia-smi name and power limit), torch and CUDA
                versions, and the kernel build (one nvcc per source, all
                started together, and beside them g++ for the orbax
                reader's host C++) with its time and ptxas resource lines.
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
                error); each bf16 engine shape of K2 also times K4's TMA
                route on the same conv beside K2's engine (one line a
                shape, and their sums per evaluation); K4 (the
                general dilated conv) at tests/test_pallas_conv.py's shapes
                with kernels (3,3), (5,3), (7,3), (3,5) and dilations up to
                (4,1) and (2,2), at the five level shapes of
                pallas_conv.py's table (batch 4) and at the TMA route's
                edge shapes K4_EDGE, and bf16 shapes that keep the older
                mma and CUDA-core tiles (K4_OLD_TILES), each line naming
                the route its launch took (a shape off its route fails),
                then through its
                entry point (forward and dx) at the level shapes with its
                launches counted by route (all on the TMA route, or it
                fails), and it fails if ptxas gave the TMA route a stack
                frame; the weight gradients
                conv_dw (the 7 pyramid convs and their transposed shapes)
                and fused_stage_dw with its operand pass
                stage_dw_operands (every distinct stage shape) at the
                training batch (4 x 184184 samples), then both at the edge
                shapes of their cut (rows spanning chunks, ragged T, 96
                channels, the folded narrow side, d = 64 on F = 384) and
                conv_dw at K4's kernels with dt = 2; every kernel at each
                shape the capability phase's tiny network (widths 16, 16,
                32) launches it at, recorded on the card from one fp32
                training step and one fp32 and one int8 guided evaluation
                (K1, K2 and its backward, K3, conv_dw, fused_stage_dw:
                the older tiles, checked only); the filter fit at
                every case of tools/fit_sensitivity.py's FIT_CASES (end
                point and every single step against the CPU plain loop,
                its iterations beside the plain loop's, us and SM cycles
                per iteration; it fails if ptxas gave a fit instantiation
                a stack frame or spills); the IIR recursion (csrc/iir.cu)
                against its plain loop bit for bit at 4 x 4096 samples with
                cheby1 and the biquad, forward and reversed, and at 184184
                samples within twice scipy's fp32 lfilter's error of its
                float64 one, timed per guided evaluation and beside the
                plain loop on an 8192-sample row.  Each shape also gets
                its time, its bound, the plain version's time and a cuDNN
                yardstick (a conv, or its weight gradient; bf16 for K3: no
                PyTorch call computes an int8 conv); C8 (conv_int8) and Q8
                (act_quant_dyn, act_quant) at every int8 stage shape (C >=
                96) at batch 1 and 4, as the stage's forward and as its
                int8 input gradient, bit-equal to their plain versions (q,
                the scales, the int32 accumulator, the output), each C8
                launch on its TMA route (s8 TMA + wgmma; at 96 channels on
                the stage engine's, its TMA route timed beside it), C8
                timed through its launcher and as device time in a CUDA
                graph, one
                launcher call one device kernel, its tensor maps' host
                encoding timed; Q8 also in
                fp32 at batch 4, with the per-item amax of act_quant_dyn's
                phase 1, and at its edge cases (Q8_EDGE), timed at batch 1
                through its launchers and as device time in CUDA graphs
                with the L2 flushed, each launcher call one device kernel
                (torch.profiler), its first call in a graph capture
                refused and, after kernels.q8_prepare, captured and
                replayed bit-equal; Q8's seconds logged.
  3. probe      the int8 probe's kernels (P1 GEMM, P2 stage core on the
                stage engine's loop) against their plain versions (int8
                bit-exact), P1 also at the edge shapes GEMM_EDGE and
                refusing GEMM_REFUSED before it launches, P2 also at
                P2_EDGE, with P1's tile, grid and ptxas's C7513 status,
                P2's cut, its time per ring stage at its grid and at a
                grid of one position block, ptxas's view of its loop,
                the int8:bf16 rate ratios and the yardsticks as device time
                (cuBLAS for P1, a bf16 cuDNN conv for P2, each captured in
                a CUDA graph), then the probe entry point
                (``babe_tpu_torch.tools.probe_int8``) at its four shapes
                in bf16 and int8, with its launches counted.
  4. check      the model on the card against the same model on the CPU
                (plain path, itself held to the JAX package by the tests):
                denoiser output and guidance gradient at the tiny config in
                fp32 and at the flagship widths on a short segment in fp32,
                bf16 and int8, and int8 against the CPU's int8 with the
                CPU's run forced onto the card's at every int8 stage; then
                the gradients of every parameter for one training step
                (fixed sigma and noise, remat, opened gates) in fp32 and
                bf16; then the full-width STFT denoiser on one 5 s segment
                in fp32 (its network and its audio).
  5. requests   the flagship model from a seed, written as a JAX-format
                .ckpt, loaded twice with ``BABE.load`` on the card (bf16 and
                ``precision="int8"``), each answering one blind ``enhance``
                request (bf16 also an informed one) on 184184 samples of
                seeded low-passed audio.  The launch counters are zeroed
                just before each model's requests and read just after.
     int8modes  the JAX package's own int8 configurations (the unfused
                int8 convs C8 and the quantizers Q8): the JAX API's int8
                (BABE_INT8_FUSED=0 BABE_INT8_BWD=1) and BABE_INT8_SCALE=
                amax BABE_INT8_OPS=all, each held at flagship widths on a
                short segment to the CPU's fp32 result within 1.5x of the
                CPU's own int8 error, then serving one guided blind request
                at the flagship (counters zeroed just before, read just
                after; the second also holds act_rescale at the int8 1x1
                shapes it ran and at RESCALE_EDGE (bf16 and fp32, timed
                through the launcher and as device time beside
                torch.mul), P1 the int8 1x1 product at shapes
                torch._int_mm does not take (K not a multiple of 32
                zero-padded), and int8 convs other than (5,3) at (d,1)
                through the int8 im2col product, bit for bit); then two
                quantization-aware training steps at the flagship under
                BABE_PRECISION=int8, in the fused chain and in the JAX
                API's int8 (finite loss and gradients, the int8 forward
                and weight-gradient kernels launched).
     pt         the seeded flagship weights as a reference-format .pt
                (this script's own inverse name map) and as a .ckpt, both
                through BABE.load: equal weights and configs (the oct_pow2
                frame); on the card one denoiser evaluation twice and
                PT_REPS blind requests per route, interleaved, finite, the
                .pt vs .ckpt difference within PT_K times one route's own
                run-to-run spread (the card's atomics; 0 where it is 0);
                on the CPU one blind request through each route at
                flagship widths on a short segment, equal bit for bit.
                The same weights as an orbax checkpoint directory
                (``utils/orbax_dir.py``'s writer) through BABE.load: its
                EMA bit-equal to the .ckpt route's, one blind request
                (counters zeroed just before, read just after: K1, K2,
                K2's backward and the fit launched) within PT_K times the
                .ckpt route's own spread of the .ckpt requests.  First the
                committed orbax fixture (tests/data/, written by orbax's
                OCDBT layout): every leaf's sha256 as recorded, and the
                zstd decoder's rate over its chunks.
  6. long       one whole recording: the flagship (bf16) and the
                full-width denoiser from seeds, ``BABE.load(ckpt,
                denoiser_checkpoint=...)``, one blind ``enhance(x, 44100,
                denoise=True)`` on 20 s of seeded 44.1 kHz audio (441000
                samples after resampling): the denoiser, the blind estimate
                on the first segment and 3 chunks of the autoregressive
                loop, each timed; the counters zeroed just before and read
                just after (runs alone as ``--phases identify,long``).
  7. train      ``python -m babe_tpu_torch.train``'s main at the flagship
                config (seeded 44.1 kHz wavs, exp=maestro22k_8s: batch 4,
                184184 samples, resample factor 2, remat, bf16) for 5
                steps, 2 untimed: s/step, audio-seconds trained per second,
                peak memory, the device's busy share over one profiled
                step, each step's launches held to the network's counts
                (remat recompute included), params and EMA that moved,
                the state saved with exp.ckpt_backend=orbax and a fresh
                trainer on the card resumed from the directory (params,
                buffers, EMA, Adam's moments, the counts and it bit-equal;
                the save and resume seconds and the directory's bytes),
                then the written .ckpt loaded with BABE.load on the card
                answering one blind request at tester.T = LOAD_CHECK_T;
                one more step through a world-size-1 NCCL mesh (the
                data-parallel trainer's draws, all-reduce and gathers)
                against the plain step from the same state and seed run
                twice: the loss bit for bit, the rest within NCCL_K times
                the plain steps' own spread (the weight gradients'
                atomics).
     families   the diffusion families and options beyond plain EDM at
                the flagship: first each on a 16384-sample segment at
                flagship widths, card against CPU (fp32 to 1e-3, bf16
                within 1.5x of the CPU's own bf16 error against its fp32):
                the A-weighted loss and its gradients (remat "full" and
                "save_convs"), the PD loss with a teacher and its
                gradients, the eps denoiser, the attention network's
                output (attention_layers [0,0,0,0,1,1,1,1]) and one guided
                evaluation with sigma_den_estimate = 0.01; then at 184184
                samples through the train entry point (batch 4, bf16,
                remat): the A-weighted EDM and EDMEps 2 steps each, PD 2
                steps from a teacher .ckpt that the trainer's
                save_checkpoint wrote from a seeded init (each step's
                launches held to the network's, the teacher's two forward
                evaluations included), PD_sample at stage 0, EDMEps'
                unconditional Heun and DDIM runs at T = 8, the attention
                network's step and one blind request at T = 8, one step
                without remat, with "full" and with "save_convs" (seconds,
                peak memory and K2 forward launches each: "full" twice the
                stages, "save_convs" once), and one blind request with
                sigma_den_estimate = 0.01 at T = 8; each run's seconds and
                launches logged (runs alone as --phases
                identify,families).
  8. quality    the same-seed 35-step unconditional trajectory of the
                flagship model (110250 samples, batch 4, gates opened with
                N(0, 0.02^2)) in bf16 and in int8: the waveform's relative
                divergence and the LSD between the two, reported, not gated.
  9. cli        ``python -m babe_tpu_torch.test``'s main, in-process, at
                the flagship in bf16 on a seeded .ckpt and one seeded
                test wav: blind_bwe and bwe (firwin, order 500, 1 kHz) at
                tester.T = 15, then inpainting, declipping, comp_sens,
                phase_retrieval and unconditional at tester.T = 8; per mode
                its seconds per item (and those of its trajectory dumps)
                and its launches of K1, K2, K2's backward and the fit; the
                counters zeroed just before each CLI run and read just
                after; a missing file or a non-finite result fails.
 10. capability the quality gates on trained weights, as their own
                processes: ``babe_tpu_torch.tools.capability_e2e`` (a tiny
                model trained for the tool's 1500 steps on seeded
                sawtooths, then blind BWE on two low-passed probes at the
                tool's T = 15, the length and steps the gates are
                calibrated at; gate: high-band
                LSD below the degraded probe's on both) and
                ``babe_tpu_torch.tools.quality_int8 --mode lsd`` (the same
                checkpoint in bf16 and in int8 with every tiny stack on K3;
                gate: |mean LSD delta| < 0.05 dB and K3 launched).
     iir        one guided evaluation of informed BWE at the flagship
                with the firwin, cheby1 and biquad degradations, timed;
                the counters zeroed just before each and read just after
                (each IIR evaluation launches the recursion twice).
  q8            (not by default) Q8 alone: the kernels phase's Q8 checks
                and times, then act_quant_dyn's phase 1 alone and with its
                barrier, both kernels with the L2 warm, and at batch 4
                (QAT's shape, beyond the L2), as device time.
  profile       (not by default) one guided evaluation of a blind request
                in bf16, in int8 on the fused chain and in the JAX API's
                int8 (C8 and Q8): its parts timed, then one whole stage
                under torch.profiler (device time, busy share, launches,
                the top kernels by name).
  distill       (not by default) babe_tpu_torch.tools.distill_e2e at the
                JAX tool's defaults: a teacher trained 1500 steps, a
                student distilled 1000 steps through the train CLI; both
                gates (PD loss ratio >= 2, tracking within 0.1
                sigma_data^2) must pass.
  gates         (not by default) the capability tool at 3000 steps over
                two trainings, each checkpoint through quality_int8 in the
                fused chain and in the JAX tool's configuration (the
                unfused convs); reported, not gated.

Each phase logs its seconds on a line of its own ("phase NAME: S s"),
and one line sums them up before the card's line.  The last two lines
are the kernels line and the result line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import shutil
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
    # no Pallas kernel: XLA's int8 convolution of the unfused int8 path
    # (conv_general_dilated to int32, then the rescale)
    "conv_int8": "babe_tpu/ops/conv_kernels.py:179",
    # no Pallas kernel: the XLA fusions of the per-item quantizers and of
    # the int8 1x1's rescale
    "act_quant_dyn": "babe_tpu/ops/conv_kernels.py:126",
    "act_quant": "babe_tpu/ops/conv_kernels.py:137",
    "act_rescale": "babe_tpu/ops/conv_kernels.py:305",
    # no Pallas kernel: the lax.scan of the IIR degradations (XLA on the
    # TPU)
    "lfilter": "babe_tpu/ops/iir.py:19",
}
SOURCES = {
    "conv5x3": "babe_tpu_torch/csrc/conv5x3.cu",
    "fused_stage": "babe_tpu_torch/csrc/fused_stage.cu",
    "fused_stage_bwd": "babe_tpu_torch/csrc/fused_stage.cu",
    "filter_fit": "babe_tpu_torch/csrc/filter_fit.cu",
    "fused_stage_int8": "babe_tpu_torch/csrc/fused_stage_int8.cu",
    "stage_fwd_operand": "babe_tpu_torch/csrc/fused_stage.cu",
    "stage_int8_operand": "babe_tpu_torch/csrc/fused_stage_int8.cu",
    "probe_gemm": "babe_tpu_torch/csrc/probe_gemm_sm90.cuh",
    "probe_stage": "babe_tpu_torch/csrc/probe_int8.cu",
    "dilated_conv": "babe_tpu_torch/csrc/dilated_conv.cu",
    "conv_dw": "babe_tpu_torch/csrc/conv_dw.cu",
    "stage_dw_operands": "babe_tpu_torch/csrc/conv_dw.cu",
    "fused_stage_dw": "babe_tpu_torch/csrc/conv_dw.cu",
    "conv_int8": "babe_tpu_torch/csrc/conv_int8.cu",
    "act_quant_dyn": "babe_tpu_torch/csrc/quant_int8.cu",
    "act_quant": "babe_tpu_torch/csrc/quant_int8.cu",
    "act_rescale": "babe_tpu_torch/csrc/quant_int8.cu",
    "lfilter": "babe_tpu_torch/csrc/iir.cu",
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
                  "as device time over launches of 16 repetitions in a "
                  "CUDA graph; library_ms is cuBLAS "
                  "(torch.matmul, torch._int_mm) as device time: 16 "
                  "products in one CUDA graph, a replay over 16",
    "probe_stage": "one product at each of 2 shapes x (bf16, int8), timed "
                   "as device time over launches of 8 repetitions in a "
                   "CUDA graph (the weight pack made once, outside); "
                   "library_ms is a bf16 "
                   "cuDNN conv of the staged rows (dilation (d,1), sliced "
                   "to P2's window) for each of the four, 8 in one CUDA "
                   "graph, a replay over 8 (no PyTorch call computes an "
                   "int8 conv)",
    "dilated_conv": "one forward at each of the five level shapes of "
                    "pallas_conv.py's table (batch 4, kernel (5,3), N = C), "
                    "bf16, on the TMA route (its weight pack included); "
                    "launches: its entry point's forward and dx at those "
                    "shapes; library_ms is cuDNN F.conv2d",
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
    "conv_int8": "one guided evaluation in the JAX API's int8 "
                 "(BABE_INT8_FUSED=0 BABE_INT8_BWD=1), bf16 carrier, batch "
                 "1: each int8 stage's forward and its int8 input gradient, "
                 "on the TMA route (at C = 96 the stage engine's); ms "
                 "through the launcher (CUDA events, "
                 "the host's dispatch included), device_ms as device time "
                 "(a CUDA graph of 20 launches, the L2 flushed before each); "
                 "library_ms is a bf16 cuDNN conv (no PyTorch call computes "
                 "an int8 conv)",
    "act_quant_dyn": "one guided evaluation in the JAX API's int8: the 68 "
                     "int8 input gradients' dynamic quantizations; ms is "
                     "device time (CUDA graph, L2 flushed before each), "
                     "eager_ms through the launcher; library_ms is "
                     "torch.linalg.vector_norm(ord=inf) plus "
                     "torch.quantize_per_channel (no one PyTorch call "
                     "computes it; a yardstick of time only)",
    "act_quant": "one guided evaluation in the JAX API's int8: the 68 int8 "
                 "stages' hinted quantizes; ms is device time (CUDA graph, "
                 "L2 flushed before each), eager_ms through the launcher; "
                 "library_ms is torch.quantize_per_channel (axis 0, zero "
                 "points 0, on x in fp32: it takes no bf16; it divides by s "
                 "and clamps at -128, a yardstick of time only)",
    "act_rescale": "one guided evaluation under BABE_INT8_SCALE=amax "
                   "BABE_INT8_OPS=all: the int8 1x1s' rescales; ms through "
                   "the launcher, device_ms as device time (a CUDA graph of "
                   "20 launches, the L2 flushed before each); library_ms is "
                   "torch.mul(acc, scale) to fp32 through the call, "
                   "library_device_ms the same as device time",
    "lfilter": "one row of 8192 samples with the cheby1 degradation "
               "(order 6), forward and reversed (its input gradient), the "
               "plain loop on the card beside it; eval_ms the kernel per "
               "guided evaluation of an informed request (one 184184-sample "
               "row, both directions); no one PyTorch call computes it",
}
# where each kernel's launch count comes from
LAUNCHES_FROM = {
    # a wrapper counts the launches made through it: per (shape, dtype) the
    # probe run's 2 eager warm-ups and the 20 captured into its CUDA graph;
    # the graph's 6 replays run 120 more that no wrapper sees
    "probe_gemm": "the probe run (eager and captured; not graph replays)",
    "probe_stage": "the probe run (eager and captured; not graph replays)",
    "fused_stage_int8": "the int8 requests",
    "stage_int8_operand": "the int8 requests",
    "dilated_conv": "the K4 entry-point run of the kernels phase",
    "conv_dw": "the train phase (all its steps)",
    "stage_dw_operands": "the train phase (all its steps)",
    "fused_stage_dw": "the train phase (all its steps)",
    "conv_int8": "the JAX API's int8 request (int8modes)",
    "act_quant_dyn": "the JAX API's int8 request (int8modes)",
    "act_quant": "the JAX API's int8 request (int8modes)",
    "act_rescale": "the amax, all-ops int8 request (int8modes)",
    "lfilter": "the iir phase's guided evaluations (cheby1, biquad)",
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
# the unfused int8 path's kernels: the JAX API's int8 request launches
# these three (act_quant_dyn on the int8 input gradients, act_quant on the
# hinted forwards); the amax, all-ops one has no hint, and its 1x1s add
# the rescale
C8_PATH = ("conv_int8", "act_quant_dyn", "act_quant")
INT8_MODES = (
    ("JAX API int8", {"BABE_INT8_FUSED": "0", "BABE_INT8_BWD": "1"},
     C8_PATH),
    ("amax, all ops", {"BABE_INT8_SCALE": "amax", "BABE_INT8_OPS": "all"},
     ("conv_int8", "act_quant_dyn", "act_rescale")),
)


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# the library yardsticks (``lib_time``): one warm-up and one timed call,
# then LIB_REPS more timed calls where that one took under LIB_SHORT_MS;
# cuDNN takes 50-100 ms a call at dilations of 8 and more, where repeats
# would add about a minute to the kernels phase
LIB_REPS = 3
LIB_SHORT_MS = 10.0


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


def lib_time(fn) -> float:
    """Mean milliseconds of a library yardstick ``fn()``: one timed call
    after a warm-up, or the mean of LIB_REPS more where it took under
    LIB_SHORT_MS."""
    t = cuda_time(fn, reps=1)
    return t if t >= LIB_SHORT_MS else cuda_time(fn, reps=LIB_REPS, warm=0)


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


def _flagship_level_shapes():
    """``flagship_shapes`` of the flagship (7 octaves, 64 bins, 184184
    samples at 22.05 kHz; widths and dilations of its levels)."""
    from babe_tpu_torch.ops.cqt import get_cqt

    Ns, num_dils = (64, 96, 96, 128, 128, 256, 256), (2, 3, 4, 5, 6, 7, 7)
    return flagship_shapes(get_cqt(7, 64, 22050.0, 184184), Ns, num_dils)


def phase_identify(kernels):
    import torch

    log(f"card: {smi_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    # the host C++ of the orbax reader (g++), built beside the kernels
    import threading

    from babe_tpu_torch import native

    host: dict = {}

    def build_host():
        t = time.perf_counter()
        try:
            native.lib()
        except BaseException as e:  # re-raised once the kernels are built
            host["error"] = e
        host["s"] = time.perf_counter() - t

    th = threading.Thread(target=build_host)
    t0 = time.perf_counter()
    th.start()
    kernels.build()
    th.join()
    if "error" in host:
        raise host["error"]
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        f"(one nvcc per source, in parallel; per source "
        f"{ {k: round(v, 1) for k, v in kernels.BUILD_SECONDS.items()} }); "
        f"the orbax reader's host C++ (native/zstd.cpp, g++) "
        f"{host['s']:.1f} s beside them")
    for name, text in kernels.BUILD_LOG.items():
        if name == "filter_fit":  # 32 instantiations: the kernels phase
            continue              # sums them up (_fit_ptxas_gate)
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    k2_shapes, k1_shapes = _flagship_level_shapes()
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

    side_lines, side = [], {"k4": 0.0, "k2": 0.0, "bound": 0.0,
                            "epi": 0.0}

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
            t_l = lib_time(library_conv(x, w, d))
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
            t_l = lib_time(library_conv(x, w, d))
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
                if dtype == torch.bfloat16:
                    side_lines.append(_side_by_side(x, w, d, t_k, t_o,
                                                    count, side))
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
            t_l = lib_time(library_conv(x, ck._flip_io(w), d))
            nbytes = (5 * F * T * C + 15 * C * C) * isz + 6 * 4 * C
            b, by = bound_ms(flops, nbytes, dtype)
            log(f"{line} x{count} | ms={t_k:.4f} bound={b:.4f}({by}) "
                f"plain={t_p:.4f} cudnn={t_l:.4f}")
            account("fused_stage_bwd", count, dtype, t_k, t_p, t_l, flops,
                    nbytes, edx)
        if dtype == torch.bfloat16:
            # K4's TMA route (SS operands by descriptor, a TMA ring, no
            # C7513) against K2's engine (RS, ldmatrix A, a cp.async ring)
            # on the same conv: which holds the tensor cores better
            for line in side_lines:
                log(line)
            log(f"side by side, per guided evaluation (75 stages): K4 tma "
                f"ms={side['k4']:.3f} K2 engine ms={side['k2']:.3f} "
                f"(bf16 peak bound {side['bound']:.3f}: "
                f"{100 * side['bound'] / side['k4']:.1f}% and "
                f"{100 * side['bound'] / side['k2']:.1f}%); K2's epilogue "
                f"adds bytes whose least time is {side['epi']:.3f} ms")
        ok &= _kernel_edges(dtype, g9)
        for (F, T, C, d), count in sorted(k3_shapes.items()):
            ok &= _kernel_int8_stage(1, F, T, C, d, count, dtype, g8,
                                     account, library_conv)
    # drawn after every earlier edge check, so those keep their inputs
    for dtype in (torch.bfloat16, torch.float32):
        ok &= _stage_fwd_edges(dtype, g9)
    ok &= _kernel_int8_convs({k: c for k, c in k2_shapes.items()
                              if k[2] >= 96}, account, library_conv, agg)
    ok &= _k2_fp32_evidence(k2_shapes)
    _engine_digests()
    ok &= _kernel_filter_fit(agg["filter_fit"])
    ok &= _kernel_lfilter(agg["lfilter"])
    ok &= _kernel_k4(account, results)
    ok &= _kernel_dw(account, k1_shapes, k2_shapes)
    ok &= _tiny_net_checks()
    for name in ("stage_dw_operands", "stage_fwd_operand",
                 "stage_int8_operand"):
        agg[name]["library_ms"] = None
    del agg["act_rescale"]  # measured at the 1x1 shapes in int8modes
    agg["lfilter"]["library_ms"] = None
    for name, a in agg.items():
        if name in ("filter_fit", "lfilter"):
            continue  # logged by their own checks
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


C8_REPS = 20  # launches per CUDA graph when timing C8 as device time
# the channel counts where C8 takes the stage engine's route (the TMA's
# box there is a quarter zero fill); its TMA route is timed beside it
C8_ENGINE_C = (96,)
# C8's edge shapes (B, F, T, C, N, d) and the route each must take: the
# tiny network's 16 and 32 channels (a 128-channel box over a 16- or
# 32-byte row, most of it zero fill), C != N, 96 channels on rows too
# short for the engine, F off a multiple of 2 TF (boxes cut at the F
# edge) with ragged T and two items, d at least F / 4 with N = 256 (one
# tile of 256), d past F on a ragged second channel chunk (C = 160), and
# channels off multiples of 16 (the tile)
C8_EDGE = {(1, 64, 256, 16, 16, 1): "tma", (1, 64, 256, 32, 32, 2): "tma",
           (1, 64, 64, 96, 128, 1): "tma", (1, 64, 8, 96, 96, 1): "tma",
           (2, 37, 20, 128, 128, 2): "tma", (1, 48, 64, 128, 256, 16): "tma",
           (1, 40, 24, 160, 96, 64): "tma", (1, 30, 20, 40, 24, 1): "tile"}


def _c8_edges(g) -> bool:
    """C8 at C8_EDGE on random int8 operands: the route the rule gives,
    the launch counted on it, and acc and out equal to the plain version
    bit for bit, in bf16 and fp32."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    ok = True
    by_route = kernels.ROUTE_LAUNCHES["conv_int8"]
    for (B, F, T, C, N, d), want in C8_EDGE.items():
        q = torch.randint(-127, 128, (B, F, T, C), generator=g, device="cuda",
                          dtype=torch.int8)
        qw = torch.randint(-127, 128, (5, 3, C, N), generator=g,
                           device="cuda", dtype=torch.int8)
        sx = torch.rand((B,), generator=g, device="cuda") / 100
        sw = torch.rand((N,), generator=g, device="cuda") / 100
        qwt, scale = kernels.tap_major(qw), ck.int8_scale(sx, sw)
        racc = ck.conv_int8_acc_ref(q, qw, (d, 1))
        route = kernels.C8_ROUTES[kernels.conv_int8_route(B, F, T, C, N, d)]
        line = []
        for dtype in (torch.bfloat16, torch.float32):
            before = dict(by_route)
            out, acc = kernels.launch_conv_int8(q, qwt, scale, d, dtype,
                                                want_acc=True)
            moved = {k: by_route[k] - before[k] for k in by_route}
            rout = ck.int8_rescale_ref(racc, sx, sw, dtype)
            torch.cuda.synchronize()
            eq = {"acc": torch.equal(acc, racc), "out": torch.equal(out, rout)}
            good = (all(eq.values()) and route == want
                    and moved == {k: int(k == want) for k in by_route})
            ok &= good
            line.append(f"{str(dtype).split('.')[-1]} bit-equal "
                        f"{'/'.join(k for k, v in eq.items() if v)}"
                        + ("" if eq["acc"] else
                           f" (acc differs at {int((acc != racc).sum())})")
                        + f" {'ok' if good else 'FAIL'}")
        log(f"C8 edge B={B} F={F} T={T} C={C} N={N} d={d} [{route}, want "
            f"{want}]: {'; '.join(line)}")
    return ok


def _kernel_int8_convs(shapes, account, library_conv, agg) -> bool:
    """C8 (``conv_int8``) and Q8 (``act_quant_dyn``, ``act_quant``) against
    their plain versions at every flagship int8 stage shape (C >= 96, the
    JAX API's int8 convs) at batch 1 and 4, in the two roles a guided
    evaluation gives them: the stage's forward (a bf16 activation quantized
    at its hint by ``act_quant``, the stage's kernel) and its int8 input
    gradient (a bf16 cotangent at its dynamic amax, ``act_quant_dyn``, the
    flipped, io-swapped kernel), bf16 out; fp32 out at batch 1.  q, the
    scales, the int32 accumulator and the output must equal the plain
    version's bit for bit, each C8 launch on the TMA route (its route's
    count moved by one), but at C = 96 on the engine's (``C8_ENGINE_C``),
    where the TMA route is timed beside it; then C8 at its edge shapes
    (``_c8_edges``).  At batch 1 in bf16 it times C8 through its launcher
    (CUDA events, the host's dispatch included: ``ms``), as device time in
    a CUDA graph of C8_REPS launches with the L2 flushed before each
    (``_flushed_ms``: ``device_ms``) and the launcher's host time alone
    (no synchronisation), its plain version and its yardstick (a bf16
    cuDNN conv).  One launcher call is one device kernel (torch.profiler).
    Then Q8 on its own (``_kernel_q8``)."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(88)
    flush_buf = torch.ones(2**25, dtype=torch.float32, device=dev)
    ok = True
    by_route = kernels.ROUTE_LAUNCHES["conv_int8"]
    sums = {"device": 0.0, "host": 0.0, "engine at 96": 0.0,
            "tma at 96": 0.0}
    for (F, T, C, d), count in sorted(shapes.items()):
        for B, dtype in ((1, torch.bfloat16), (4, torch.bfloat16),
                         (1, torch.float32)):
            dn = str(dtype).split(".")[-1]
            w = (torch.randn((5, 3, C, C), generator=g, device=dev)
                 / math.sqrt(15 * C)).to(dtype)
            h = torch.nn.functional.gelu(torch.randn(
                (B, F, T, C), generator=g, device=dev)).to(dtype)
            gy = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
            bound = 1.02 * h.float().abs().amax((1, 2, 3))
            line, good = [], True
            for role, x, wk in (("fwd", h, w), ("dx", gy, ck._flip_io(w))):
                if role == "dx":
                    amax = x.float().abs().amax((1, 2, 3))
                    q, sx = kernels.launch_act_quant_dyn(x)
                else:
                    amax = bound
                    q, sx = kernels.launch_act_quant(x, amax)
                rq, rs = ck.quant_act_ref(x, amax)
                qw, sw = ck.quant_weight_per_cout(wk)
                qwt = kernels.tap_major(qw)
                scale = ck.int8_scale(sx, sw)
                before = dict(by_route)
                out, acc = kernels.launch_conv_int8(q, qwt, scale, d, dtype,
                                                    want_acc=True)
                moved = {k: by_route[k] - before[k] for k in by_route}
                racc = ck.conv_int8_acc_ref(q, qw, (d, 1))
                rout = ck.int8_rescale_ref(racc, sx, sw, dtype)
                torch.cuda.synchronize()
                eq = {"q": torch.equal(q, rq), "s": torch.equal(sx, rs),
                      "acc": torch.equal(acc, racc),
                      "out": torch.equal(out, rout)}
                good &= all(eq.values())
                route = kernels.C8_ROUTES[kernels.conv_int8_route(
                    B, F, T, C, C, d)]
                # the TMA route, but the engine's at C = 96 (C8_ENGINE_C)
                want = "engine" if C in C8_ENGINE_C else "tma"
                good &= route == want and moved == {
                    k: int(k == want) for k in by_route}
                e = errs(out, rout)
                line.append(f"{role} [{route}] bit-equal "
                            f"{'/'.join(k for k, v in eq.items() if v)}"
                            + ("" if all(eq.values()) else
                               f" (acc differs at {int((acc != racc).sum())}"
                               f")"))
                if B != 1 or dtype != torch.bfloat16:
                    continue

                def c8():
                    return kernels.launch_conv_int8(q, qwt, scale, d, dtype)

                t_k = cuda_time(c8)
                t_d = _flushed_ms(c8, flush_buf, C8_REPS)
                if route == "engine":  # the TMA route it was held against
                    tma = kernels.conv_int8_plan(B, F, T, C, C, d,
                                                 route=kernels.C8_TMA)
                    t_t = _flushed_ms(lambda: kernels.launch_conv_int8(
                        q, qwt, scale, d, dtype, plan=tma), flush_buf,
                        C8_REPS)
                    sums["tma at 96"] += count * t_t
                    sums["engine at 96"] += count * t_d
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                for _ in range(C8_REPS):
                    c8()
                t_h = 1e3 * (time.perf_counter() - h0) / C8_REPS
                torch.cuda.synchronize()
                t_p = cuda_time(lambda: ck.int8_rescale_ref(
                    ck.conv_int8_acc_ref(q, qw, (d, 1)), sx, sw, dtype),
                    reps=1)
                t_l = lib_time(library_conv(x, wk, d))
                flops = 2.0 * F * T * C * C * 15
                nbytes = F * T * C * (1 + 2) + 15 * C * C + 4 * C
                b, by = bound_ms(flops, nbytes, torch.int8)
                line[-1] += (f" ms={t_k:.4f} device={t_d:.4f} host="
                             f"{t_h:.4f} bound={b:.4f}({by}) plain="
                             f"{t_p:.4f} cudnn(bf16)={t_l:.4f}"
                             + (f" tma device={t_t:.4f}" if route ==
                                "engine" else ""))
                account("conv_int8", count, dtype, t_k, t_p, t_l, flops,
                        nbytes, e, op_dtype=torch.int8)
                sums["device"] += count * t_d
                sums["host"] += count * t_h
            ok &= good
            log(f"C8/Q8 {dn:8s} B={B} F={F:3d} T={T:4d} C={C:3d} d={d:2d} "
                f"x{count}: {'; '.join(line)} {'ok' if good else 'FAIL'}")
    agg["conv_int8"]["device_ms"] = sums["device"]
    ok &= _c8_edges(g)
    x = torch.randint(-127, 128, (1, 448, 32, 256), generator=g, device=dev,
                      dtype=torch.int8)
    qwt = torch.randint(-127, 128, (15, 256, 256), generator=g, device=dev,
                        dtype=torch.int8)
    scale = torch.ones((1, 256), device=dev)
    name = _one_device_kernel(lambda: kernels.launch_conv_int8(
        x, qwt, scale, 1, torch.bfloat16), "c8_tma")
    # Q8's rescale (its checks and times are int8modes', at the shapes the
    # amax/all request runs): one launcher call, one device kernel too
    acc = torch.randint(-2**24, 2**24, (1, 320, 128, 128), generator=g,
                        device=dev, dtype=torch.int32)
    s_acc = torch.ones((1, 128), device=dev)
    name_r = _one_device_kernel(lambda: kernels.launch_act_rescale(
        acc, s_acc, torch.bfloat16), "act_rescale")
    log(f"C8: one launcher call, one device kernel: {name}; act_rescale: "
        f"one launcher call, one device kernel: {name_r}")
    log(f"C8 per guided evaluation (bf16, batch 1, 136 launches; ms): "
        f"through the launcher {agg['conv_int8']['ms']:.4f}, device (L2 "
        f"flushed) {sums['device']:.4f}, the launcher's host time "
        f"{sums['host']:.4f}, bound {agg['conv_int8']['bound_ms']:.4f}; at "
        f"C = 96 the engine {sums['engine at 96']:.4f} against the TMA "
        f"route {sums['tma at 96']:.4f} (device, L2 flushed); "
        f"{time.perf_counter() - t0:.1f} s")
    return ok & _kernel_q8(shapes, account, agg)


# Q8's edge cases (B, per_b, per-item scales): an all-zero item, per-item
# amaxes a factor of 1e6 apart on a per_b that is not a multiple of 16, a
# per_b under one step, more items than any grid (blocks walk items) and
# items too short to share; each also on a view offset by one element (not
# 16-byte aligned), in bf16 and fp32; "ties": every value k + 0.5 after
# scaling (amax 127), rounded half to even
Q8_EDGE = [(2, 77777, (1.0, 0.0)), (3, 1001, (1e-3, 1.0, 1e3)),
           (1, 5, (1.0,)), (3000, 1000, None), (300, 4096, None),
           (2, 4099, "ties")]
Q8_REPS = 20  # launches per CUDA graph when timing Q8


def _q8_amax(kernels, x):
    """act_quant_dyn's phase 1 alone on x: the per-item amax from its
    partials (each unit's max), or None where the blocks walk items (a
    block keeps only its last item's)."""
    plan = kernels.q8_cut(x)[0]
    _, partial = kernels.launch_act_quant_dyn_part(x, "partial")
    if plan.per_item == 1 and plan.B > plan.grid:
        return None
    return partial[:plan.units].view(plan.B, plan.per_item).amax(1)


def _q8_check(kernels, ck, x, bound) -> dict:
    """act_quant_dyn and act_quant (at ``bound``) on x against the plain
    version: q, s and the per-item amax bit for bit (no "amax" where the
    blocks walk items: their phase 1 keeps no per-item partial)."""
    import torch

    amax = x.float().abs().amax(dim=tuple(range(1, x.ndim)))
    q, s = kernels.launch_act_quant_dyn(x)
    rq, rs = ck.quant_act_ref(x, amax)
    pa = _q8_amax(kernels, x)
    hq, hs = kernels.launch_act_quant(x, bound)
    hrq, hrs = ck.quant_act_ref(x, bound)
    torch.cuda.synchronize()
    eq = {"dyn q": torch.equal(q, rq), "dyn s": torch.equal(s, rs)}
    if pa is not None:
        eq["amax"] = torch.equal(pa, amax)
    eq.update({"hinted q": torch.equal(hq, hrq),
               "hinted s": torch.equal(hs, hrs)})
    return eq


def _q8_eq_text(eq: dict) -> str:
    good = all(eq.values())
    return (f"bit-equal {'/'.join(k for k, v in eq.items() if v)}"
            + ("" if "amax" in eq else " (amax not read: blocks walk items)")
            + f" {'ok' if good else 'FAIL'}")


def _one_device_kernel(fn, name: str, traces: int = 3) -> str:
    """The device kernels of one ``fn()`` under torch.profiler: exactly one,
    named ``name``, or it raises.  A trace that holds no device kernel at
    all (the profiler's device trace sometimes comes back empty: PERF.md
    section 7) is taken again, up to ``traces`` times, and each empty one
    is logged; a trace with another count or name raises at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [(e.key, e.count) for e in prof.key_averages()
                if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CUDA]
        if kern:
            break
        log(f"{name}: trace {i + 1} of {traces} under torch.profiler held "
            f"no device kernel")
    if len(kern) != 1 or kern[0][1] != 1 or f"::{name}<" not in kern[0][0]:
        raise RuntimeError(f"one {name} call ran the device kernels {kern}, "
                           f"not one {name}")
    return kern[0][0].split("(")[0]


def _q8_fresh_capture(kernels, ck, x) -> bool:
    """With Q8's per-device state dropped (as in a fresh process): a first
    act_quant_dyn call inside a CUDA graph capture raises (its workspace is
    made outside any capture); after ``kernels.q8_prepare`` the kernel
    captures as a cooperative node and its replay is bit-equal to the plain
    version."""
    import torch

    kernels._Q8_STATE.clear()
    kernels._Q8_PLANS.clear()
    refused = False
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            kernels.launch_act_quant_dyn(x)
    except RuntimeError as e:
        refused = "q8_prepare" in str(e)
    kernels.q8_prepare(x.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, s = kernels.launch_act_quant_dyn(x)
    q.zero_()
    graph.replay()
    rq, rs = ck.quant_act_ref(x, x.float().abs().amax(
        dim=tuple(range(1, x.ndim))))
    torch.cuda.synchronize()
    same = torch.equal(q, rq) and torch.equal(s, rs)
    log(f"Q8 graph capture from a fresh state: first call refused "
        f"{refused}; after q8_prepare captured and replayed bit-equal "
        f"{same} {'ok' if refused and same else 'FAIL'}")
    return refused and same


def _flushed_ms(fn, flush_buf, reps: int = Q8_REPS) -> float:
    """Device ms of one ``fn()`` in a CUDA graph of ``reps`` launches, each
    after a read of ``flush_buf`` (the L2 flushed), that read's own graph
    time subtracted."""
    from babe_tpu_torch.tools.probe_int8 import device_ms

    t_f = device_ms(lambda: flush_buf.amax(), reps)
    both = device_ms(lambda: (flush_buf.amax(), fn()), reps)
    return both - t_f


def _q8_sizes(shapes) -> dict:
    """Distinct int8 stage tensors (F, T, C) with the launches per guided
    evaluation (Q8's work depends on F*T*C alone; the count sums the
    stages' dilations)."""
    sizes: dict = {}
    for (F, T, C, _), count in shapes.items():
        sizes[F, T, C] = sizes.get((F, T, C), 0) + count
    return sizes


def _kernel_q8(shapes, account, agg) -> bool:
    """Q8 on its own.  Bit-equality (q, s and act_quant_dyn's per-item
    amax; act_quant at a bound 2% over the amax) at every distinct int8
    stage tensor (F, T, C) at batch 1 and 4 in bf16 and fp32, and at
    Q8_EDGE.  One launcher call is one device kernel (torch.profiler); a
    first call inside a graph capture raises, and after q8_prepare the
    kernel captures and replays bit-equal (``_q8_fresh_capture``).  At
    batch 1 in bf16, per distinct tensor: each kernel through its launcher
    (CUDA events, eager) and as device time in a CUDA graph of Q8_REPS
    launches with the L2 flushed before each (``_flushed_ms``); the plain
    versions; the yardsticks (torch.linalg.vector_norm(ord=inf) for the
    amax, torch.quantize_per_channel for the quantize).  The breakdown
    into parts, warm times and batch 4's times are ``--phases q8``'s
    (``_q8_parts``).  Logs the seconds it takes."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(89)
    ok = True
    flush_buf = torch.ones(2**25, dtype=torch.float32, device=dev)
    sums = {k: 0.0 for k in ("dyn eager", "dyn", "hinted eager", "hinted",
                             "vector_norm", "quantize_per_channel",
                             "bound")}
    t_time = 0.0
    for (F, T, C), count in sorted(_q8_sizes(shapes).items()):
        for B in (1, 4):
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[-1]
                x = torch.randn((B, F, T, C), generator=g,
                                device=dev).to(dtype)
                bound = 1.02 * x.float().abs().amax((1, 2, 3))
                eq = _q8_check(kernels, ck, x, bound)
                ok &= all(eq.values())
                plan = kernels.q8_cut(x)[0]
                line = (f"Q8 {dn:8s} B={B} F={F:3d} T={T:4d} C={C:3d} "
                        f"x{count}: grid {plan.grid}, {plan.per_item} per "
                        f"item, chunk {plan.chunk}; {_q8_eq_text(eq)}")
                if dtype == torch.bfloat16 and B == 1:
                    t1 = time.perf_counter()
                    n = B * F * T * C
                    nbytes = n * (x.element_size() + 1) + 4 * B
                    b, by = bound_ms(3.0 * n, nbytes, torch.float32)
                    r = {"dyn eager": cuda_time(
                            lambda: kernels.launch_act_quant_dyn(x),
                            reps=Q8_REPS),
                         "dyn": _flushed_ms(
                            lambda: kernels.launch_act_quant_dyn(x),
                            flush_buf),
                         "hinted eager": cuda_time(
                            lambda: kernels.launch_act_quant(x, bound),
                            reps=Q8_REPS),
                         "hinted": _flushed_ms(
                            lambda: kernels.launch_act_quant(x, bound),
                            flush_buf)}
                    flat = x.view(B, -1)
                    r["vector_norm"] = cuda_time(
                        lambda: torch.linalg.vector_norm(
                            flat, float("inf"), dim=1), reps=Q8_REPS)
                    # it takes fp32 only: x converted beforehand
                    flat32, sc = flat.float(), bound / 127
                    zp = torch.zeros((B,), dtype=torch.int64, device=dev)
                    r["quantize_per_channel"] = cuda_time(
                        lambda: torch.quantize_per_channel(
                            flat32, sc, zp, 0, torch.qint8), reps=Q8_REPS)
                    t_pd = cuda_time(lambda: ck.quant_act_ref(
                        x, x.float().abs().amax((1, 2, 3))), reps=2)
                    t_ph = cuda_time(lambda: ck.quant_act_ref(x, bound),
                                     reps=2)
                    for k, v in r.items():
                        sums[k] += count * v
                    sums["bound"] += count * b
                    zero = (0.0, 0.0, 0.0)
                    account("act_quant_dyn", count, dtype, r["dyn"], t_pd,
                            r["vector_norm"] + r["quantize_per_channel"],
                            3.0 * n, nbytes, zero, op_dtype=torch.float32)
                    account("act_quant", count, dtype, r["hinted"], t_ph,
                            r["quantize_per_channel"], 3.0 * n, nbytes,
                            zero, op_dtype=torch.float32)
                    for name, k in (("act_quant_dyn", "dyn eager"),
                                    ("act_quant", "hinted eager")):
                        agg[name]["eager_ms"] = agg[name].get(
                            "eager_ms", 0.0) + count * r[k]
                    line += (f" | bound={b:.5f}({by}) "
                             + " ".join(f"{k}={v:.5f}" for k, v in r.items())
                             + f" plain dyn={t_pd:.4f} hinted={t_ph:.4f}")
                    t_time += time.perf_counter() - t1
                log(line)
    t_edge = time.perf_counter()
    for B, per_b, scales in Q8_EDGE:
        for dtype in (torch.bfloat16, torch.float32):
            for off in (0, 1):
                buf = torch.randn(B * per_b + off, generator=g, device=dev)
                x = buf[off:].view(B, per_b)
                if scales == "ties":
                    x.copy_(torch.randint(-253, 254, (B, per_b), generator=g,
                                          device=dev) / 2.0)
                    x[:, 0] = 127.0
                elif scales is not None:
                    x.mul_(torch.tensor(scales, device=dev)[:, None])
                buf = buf.to(dtype)
                x = buf[off:].view(B, per_b)
                bound = 1.02 * x.float().abs().amax(1)
                if scales == "ties":
                    bound = x.float().abs().amax(1)
                eq = _q8_check(kernels, ck, x, bound)
                ok &= all(eq.values())
                plan = kernels.q8_cut(x)[0]
                log(f"Q8 edge {str(dtype).split('.')[-1]:8s} ({B}, {per_b}) "
                    f"scales {scales} offset {off}: grid {plan.grid}, "
                    f"{plan.per_item} per item, chunk {plan.chunk}; "
                    f"{_q8_eq_text(eq)}")
    t_prof = time.perf_counter()
    x = torch.randn((1, 128, 1024, 96), generator=g, device=dev).bfloat16()
    bound = 1.02 * x.float().abs().amax((1, 2, 3))
    names = [_one_device_kernel(lambda: kernels.launch_act_quant_dyn(x),
                                "act_quant_dyn"),
             _one_device_kernel(lambda: kernels.launch_act_quant(x, bound),
                                "act_quant")]
    log(f"Q8: one launcher call, one device kernel: {names}")
    ok &= _q8_fresh_capture(kernels, ck, x)
    t_end = time.perf_counter()
    log("Q8 per guided evaluation (bf16, batch 1, 68 of each; ms): "
        + " ".join(f"{k}={v:.4f}" for k, v in sums.items()))
    log(f"Q8: {t_end - t0:.1f} s (checks at the stage tensors "
        f"{t_edge - t0 - t_time:.1f} s, their times {t_time:.1f} s, edge "
        f"cases {t_prof - t_edge:.1f} s, profiler and capture "
        f"{t_end - t_prof:.1f} s)")
    return ok


def _q8_parts(shapes) -> None:
    """act_quant_dyn's parts and the times the kernels phase leaves out,
    per distinct int8 stage tensor, device time in CUDA graphs of Q8_REPS
    launches: at batch 1 in bf16 phase 1 alone and phase 1 with its
    barrier (the L2 flushed), and each kernel with the L2 warm (the same x
    each launch); at batch 4 (QAT's shape, beyond the L2) each kernel with
    the L2 flushed.  Logged, with their sums per guided evaluation."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.tools.probe_int8 import device_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(90)
    flush_buf = torch.ones(2**25, dtype=torch.float32, device=dev)
    sums = {k: 0.0 for k in ("phase1", "phase1+barrier", "dyn warm",
                             "hinted warm", "dyn B4", "hinted B4",
                             "bound B4")}
    for (F, T, C), count in sorted(_q8_sizes(shapes).items()):
        x = torch.randn((1, F, T, C), generator=g, device=dev).bfloat16()
        bound = 1.02 * x.float().abs().amax((1, 2, 3))
        r = {"phase1": _flushed_ms(
                lambda: kernels.launch_act_quant_dyn_part(x, "partial"),
                flush_buf),
             "phase1+barrier": _flushed_ms(
                lambda: kernels.launch_act_quant_dyn_part(x, "scale"),
                flush_buf),
             "dyn warm": device_ms(lambda: kernels.launch_act_quant_dyn(x),
                                   Q8_REPS),
             "hinted warm": device_ms(
                lambda: kernels.launch_act_quant(x, bound), Q8_REPS)}
        x4 = torch.randn((4, F, T, C), generator=g, device=dev).bfloat16()
        bound4 = 1.02 * x4.float().abs().amax((1, 2, 3))
        r["dyn B4"] = _flushed_ms(lambda: kernels.launch_act_quant_dyn(x4),
                                  flush_buf)
        r["hinted B4"] = _flushed_ms(
            lambda: kernels.launch_act_quant(x4, bound4), flush_buf)
        r["bound B4"] = bound_ms(3.0 * x4.numel(), 3.0 * x4.numel() + 16,
                                 torch.float32)[0]
        for k, v in r.items():
            sums[k] += count * v
        log(f"Q8 parts bfloat16 F={F:3d} T={T:4d} C={C:3d} x{count} "
            f"(device ms): " + " ".join(f"{k}={v:.5f}" for k, v in r.items()))
    log("Q8 parts per guided evaluation (bf16, 68 of each; ms): "
        + " ".join(f"{k}={v:.4f}" for k, v in sums.items())
        + f"; barrier = phase1+barrier - phase1 = "
          f"{sums['phase1+barrier'] - sums['phase1']:.4f}")


def phase_q8(results: dict):
    """(not by default) Q8 alone: ``_kernel_q8`` as the kernels phase runs
    it (its checks and times), then its parts (``_q8_parts``)."""
    import torch

    t0 = time.perf_counter()
    shapes = {k: c for k, c in _flagship_level_shapes()[0].items()
              if k[2] >= 96}
    agg = {name: {"ms": 0.0, "bound_ms": 0.0}
           for name in ("act_quant_dyn", "act_quant")}

    def account(name, count, dtype, t_k, t_p, t_l, flops, nbytes, e,
                op_dtype=None):
        if dtype == torch.bfloat16:
            agg[name]["ms"] += count * t_k
            agg[name]["bound_ms"] += count * bound_ms(flops, nbytes,
                                                      op_dtype)[0]

    ok = _kernel_q8(shapes, account, agg)
    log(f"Q8 (q8 phase): {agg}")
    _q8_parts(shapes)
    log(f"q8: {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise RuntimeError("Q8 disagrees with its plain version")


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
                                 edge="edge")
    return ok


# the launchers the tiny network's training, serving and int8 serving run
TINY_LAUNCHERS = ("launch_conv5x3", "launch_fused_stage",
                  "launch_fused_stage_bwd", "launch_fused_stage_int8",
                  "launch_conv_dw", "launch_fused_stage_dw")


def _tiny_launches() -> dict:
    """The kernel launches of the capability phase's tiny network
    (``capability_e2e.TINY``: widths 16, 16 and 32), recorded on the card
    with seeded weights: one training step (fp32, batch 4, remat as the
    config sets it, the EDM loss as ``babe_tpu_torch.train`` takes it), one
    guided evaluation at batch 1 in fp32 (the blind test's) and one in
    int8 with every stack on K3 (``BABE_INT8_MINC=16``, as ``quality_int8``
    serves it).  Returns {launcher: {(dtype name, shape key): launches}};
    a shape key is (B, F, T, C, d), K1's (B, F, T, C, N, d, transposed)
    and conv_dw's (B, F, T, C, N, kernel shape, dilation)."""
    import inspect

    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.tools.capability_e2e import TINY

    seen = {name: {} for name in TINY_LAUNCHERS}

    def shape_key(name, b):
        x = b["x"]
        if name == "launch_conv5x3":
            tr = bool(b.get("transposed", False))
            N = b["w"].shape[2 if tr else 3]
            return (*x.shape, N, int(b["d"]), tr)
        if name == "launch_conv_dw":
            return (*x.shape, b["g"].shape[3], tuple(b["kshape"]),
                    tuple(b["dilation"]))
        return (*x.shape, int(b["d"]))

    undo = []
    for name in TINY_LAUNCHERS:
        orig = getattr(kernels, name)

        def rec(*a, _orig=orig, _sig=inspect.signature(orig), _name=name,
                **k):
            b = _sig.bind(*a, **k).arguments
            key = (str(b["x"].dtype).split(".")[-1], shape_key(_name, b))
            seen[_name][key] = seen[_name].get(key, 0) + 1
            return _orig(*a, **k)

        setattr(kernels, name, rec)
        undo.append((name, orig))
    prev = os.environ.get("BABE_INT8_MINC")
    try:
        args = default_config(list(TINY))
        m = CQTDiffPlus.from_config(args).init(seed=1, device="cpu")
        _random_flagship_like(m.net, 2)
        edm = EDM.from_config(args)
        m.to("cuda")
        L = int(args.exp.audio_len)
        rng = np.random.default_rng(17)

        def card(a):
            return torch.tensor(a.astype(np.float32), device="cuda")

        m.net.requires_grad_(True)
        sigma = card(np.full((4, 1), 0.2))
        e2, _ = edm.loss_fn(None, m.apply,
                            card(0.1 * rng.standard_normal((4, L))),
                            sigma=sigma,
                            noise=sigma * card(rng.standard_normal((4, L))))
        e2.mean().backward()
        m.net.requires_grad_(False)
        m.net.zero_grad(set_to_none=True)
        m.net.remat = False  # the test CLI serves without remat
        os.environ["BABE_INT8_MINC"] = "16"
        for prec in ("bf16", "int8"):
            m.net.set_precision(prec)
            xt = card(0.1 * rng.standard_normal((1, L))).requires_grad_(True)
            y = m.fused_denoiser(edm)(xt, card(np.full((1, 1), 0.2)))
            torch.autograd.grad((y * y).sum(), xt)
        torch.cuda.synchronize()
    finally:
        for name, orig in undo:
            setattr(kernels, name, orig)
        if prev is None:
            os.environ.pop("BABE_INT8_MINC", None)
        else:
            os.environ["BABE_INT8_MINC"] = prev
    return seen


def _tiny_net_checks() -> bool:
    """Every kernel at each shape the capability phase's tiny network
    launches it at (``_tiny_launches``), against its plain version on
    seeded inputs: K1, K2 and its backward and K3 within TOL (K2 in fp32
    as ``_stage_fwd_case`` holds it), ``conv_dw`` and ``fused_stage_dw``
    within DW_TOL, each line naming the route taken.  That phase's gates
    read the tiny network's restorations, and its widths run the older
    tiles, not the stage engine; a launcher the recording never saw
    fails."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    seen = _tiny_launches()
    ok = True
    for name in TINY_LAUNCHERS:
        if not seen[name]:
            log(f"tiny network: {name} was never launched FAIL")
            ok = False
    log("tiny network launches (dtype, shape): " + "; ".join(
        f"{name[7:]} {sorted(v.items())}" for name, v in seen.items()))

    def stage_inputs(B, F, T, C, dtype):
        x = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
        w = (torch.randn((5, 3, C, C), generator=g, device=dev)
             / math.sqrt(15 * C)).to(dtype)
        a = 0.5 + torch.rand((B, C), generator=g, device=dev)
        s = torch.randn((B, C), generator=g, device=dev)
        return x, a, s, w

    for (dn, (B, F, T, C, N, d, tr)), n in sorted(
            seen["launch_conv5x3"].items()):
        dtype = getattr(torch, dn)
        x = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
        w = (torch.randn((5, 3, C, N), generator=g, device=dev)
             / math.sqrt(15 * C)).to(dtype)
        wf = w.transpose(2, 3).contiguous() if tr else w
        if tr:  # an input gradient, run from the forward kernel as above
            w = ck._flip_io(wf)
        y = kernels.launch_conv5x3(x, wf, d, transposed=tr)
        ref = ck.conv_ref(x, w, d)
        torch.cuda.synchronize()
        e = errs(y, ref)
        good = within(e, dn)
        ok &= good
        log(f"K1 {dn:8s} [{K1_ROUTES[kernels.conv5x3_route(dtype, C, N)]}]"
            f" B={B} F={F:3d} T={T:4d} C={C:3d} N={N:3d} d={d:2d}"
            f"{' transposed' if tr else ''}: max_abs={e[0]:.3e} "
            f"max_rel={e[1]:.2e} l2_rel={e[2]:.2e} "
            f"{'ok' if good else 'FAIL'} (tiny x{n})")
    for (dn, (B, F, T, C, d)), n in sorted(
            seen["launch_fused_stage"].items()):
        good, line, _, _, _ = _stage_fwd_case(
            *stage_inputs(B, F, T, C, getattr(torch, dn)), d)
        ok &= good
        log(f"{line} (tiny x{n})")
    for (dn, (B, F, T, C, d)), n in sorted(
            seen["launch_fused_stage_bwd"].items()):
        x, a, s, w = stage_inputs(B, F, T, C, getattr(torch, dn))
        y, _, c = ck._dil_stage_parts(x, a, s, w, d)
        good, line, _, _ = _stage_bwd_case(x, a, s, w, y, c, d, g)
        ok &= good
        log(f"{line} (tiny x{n})")
    for (dn, (B, F, T, C, d)), n in sorted(
            seen["launch_fused_stage_int8"].items()):
        ok &= _kernel_int8_stage(B, F, T, C, d, 0, getattr(torch, dn), g,
                                 None, None, edge=f"tiny x{n}")
    for (dn, (B, F, T, C, N, ks, dil)), n in sorted(
            seen["launch_conv_dw"].items()):
        _, _, (_, good, line) = _dw_conv_case(g, B, F, T, C, N, ks, dil,
                                              getattr(torch, dn))
        ok &= good
        log(f"{line} (tiny x{n})")
    for (dn, (B, F, T, C, d)), n in sorted(
            seen["launch_fused_stage_dw"].items()):
        _, _, good, line = _dw_stage_case(g, B, F, T, C, d,
                                          getattr(torch, dn))
        ok &= good
        log(f"{line} (tiny x{n})")
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
# (F, T, C, df) at batch 4 with the (5,3) kernel, then edges of the TMA
# route's cut: T = 20 and 13 (boxes of 20 x 3 and 13 x 4 positions, their
# leftover rows never stored) on F not a multiple of the block's rows, C =
# 96 (the second 64-channel chunk half zero fill), N = 40 (a ragged weight
# box), (7,5) with dt = 2, and df = 64 on F = 64 (every kf but the centre
# reads only padding)
K4_SMALL = [(2, 16, 64, 8, 8, kf, kt, dil)
            for kf, kt in ((3, 3), (5, 3), (7, 3), (3, 5))
            for dil in ((1, 1), (2, 1), (4, 1), (2, 2))]
K4_LEVELS = [(4, F, T, C, C, 5, 3, (df, 1)) for F, T, C, df in (
    (64, 1280, 64, 2), (128, 640, 96, 4), (256, 160, 128, 16),
    (384, 40, 256, 32), (448, 20, 256, 64))]
K4_EDGE = [(2, 37, 20, 64, 64, 5, 3, (2, 1)), (1, 30, 13, 64, 64, 5, 3, (1, 1)),
           (1, 40, 40, 96, 96, 5, 3, (4, 1)), (1, 32, 48, 64, 40, 5, 3, (2, 1)),
           (1, 24, 33, 64, 64, 7, 5, (2, 2)),
           (1, 64, 32, 128, 128, 5, 3, (64, 1))]
# bf16 shapes that keep K4's older tiles, with the route each must take:
# C and N off a multiple of 8 on the mma tile, and C = 12 (too few
# channels for it) and T = 8 (rows of 8) on the CUDA cores
K4_OLD_TILES = {(1, 32, 64, 100, 100, 5, 3, (2, 1)): "mma",
                (2, 24, 48, 36, 20, 5, 3, (1, 2)): "mma",
                (1, 16, 40, 12, 12, 3, 3, (1, 1)): "simt",
                (1, 20, 8, 24, 20, 5, 3, (2, 1)): "simt"}


def _k4_ptxas_gate(kernels) -> bool:
    """Every instantiation of K4's TMA route (dconv_tma) has no stack frame
    and no spills; its registers and ptxas's C7513 status are logged."""
    rep = {k: v for k, v in kernels.ptxas_report(
        kernels.BUILD_LOG.get("dilated_conv", "")).items()
        if "dconv_tma" in k}
    bad = {k: v for k, v in rep.items()
           if v["stack"] or v["spill_stores"] or v["spill_loads"]}
    log("K4 tma ptxas: " + "; ".join(
        f"{k}: {v['registers']} registers, stack {v['stack']}, spills "
        f"{v['spill_stores']}/{v['spill_loads']}, "
        f"{'C7513 (serialized wgmma)' if v['c7513'] else 'no C7513'}"
        for k, v in sorted(rep.items())))
    return bool(rep) and not bad


# the stage engine's digest shapes (B, F, T, C, d): each engine width,
# ragged T, d up to 64, batch 4
DIGEST_SHAPES = ((1, 64, 2048, 64, 1), (1, 128, 1024, 96, 4),
                 (1, 48, 20, 96, 1), (1, 256, 256, 128, 16),
                 (1, 64, 70, 128, 4), (1, 384, 64, 256, 64),
                 (4, 448, 32, 256, 8))


def _engine_digests() -> None:
    """Logs, per DIGEST_SHAPES shape, a SHA-1 of the bytes of K2's y and
    c, K2's backward dx and K3's y on inputs seeded by the shape alone, so
    that two builds of the stage engine (two commits' runs of this script)
    can be compared bit for bit.  The moments and the backward's ds and da
    are left out: fp32 atomics sum them, and their last bits vary from run
    to run."""
    import hashlib

    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    def sha(t) -> str:
        raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
        return hashlib.sha1(raw.tobytes()).hexdigest()[:16]

    dev = torch.device("cuda")
    for B, F, T, C, d in DIGEST_SHAPES:
        g = torch.Generator(device=dev).manual_seed(B * 7 + F + T + C + d)
        x = torch.randn((B, F, T, C), generator=g, device=dev).bfloat16()
        w = (torch.randn((5, 3, C, C), generator=g, device=dev)
             / math.sqrt(15 * C)).bfloat16()
        a = 0.5 + torch.rand((B, C), generator=g, device=dev)
        s = torch.randn((B, C), generator=g, device=dev)
        gy = torch.randn((B, F, T, C), generator=g, device=dev).bfloat16()
        gm = torch.randn((2, B, C), generator=g, device=dev) / (F * T)
        y, _, c = kernels.launch_fused_stage(x, a, s, w, d, want_conv=True)
        dx, _, _ = kernels.launch_fused_stage_bwd(gy, gm, y, x, c, a, s, w, d)
        line = (f"engine digest B={B} F={F} T={T} C={C} d={d}: K2 y "
                f"{sha(y)} c {sha(c)} K2bwd dx {sha(dx)}")
        if C >= 96:
            qw, _ = ck.quant_weight_per_cout(w.float())
            iv = 0.5 + torch.rand((B,), generator=g, device=dev)
            post = torch.rand((B, C), generator=g, device=dev) * 1e-3
            y8, _, _ = kernels.launch_fused_stage_int8(
                x, a, iv, post, kernels.tap_major(qw), d)
            line += f" K3 y {sha(y8)}"
        log(line)


def _kernel_k4(account, results) -> bool:
    """K4 against its plain version (``conv_ref``) at K4_SMALL, K4_LEVELS,
    K4_EDGE and K4_OLD_TILES in bf16 and fp32, each line naming the route
    the launch took (a shape fails off its route: fp32 on the CUDA cores,
    bf16 on the TMA route but for K4_OLD_TILES), with times at the level
    shapes beside cuDNN's; then its entry point ``dilated_conv_nhwc``
    (forward and dx, the weight frozen) at the level shapes, with the
    counters zeroed just before and read just after: K4's launches, every
    one on the TMA route.  Fails if ptxas gave the TMA route a stack
    frame."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import pallas_conv as pc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    ok = _k4_ptxas_gate(kernels)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        isz = torch.tensor([], dtype=dtype).element_size()
        for shape in K4_SMALL + K4_LEVELS + K4_EDGE + list(K4_OLD_TILES):
            B, F, T, C, N, kf, kt, dil = shape
            x = torch.randn((B, F, T, C), generator=g, device=dev).to(dtype)
            w = (torch.randn((kf, kt, C, N), generator=g, device=dev)
                 / math.sqrt(kf * kt * C)).to(dtype)
            before = dict(kernels.ROUTE_LAUNCHES["dilated_conv"])
            y = kernels.launch_dilated_conv(x, w, dil)
            ref = pc.conv_ref(x, w, dil)
            torch.cuda.synchronize()
            e = errs(y, ref)
            plan = kernels.dilated_conv_plan(dtype, B, F, T, C, N, (kf, kt),
                                             dil)
            route = ",".join(
                r for r, n in kernels.ROUTE_LAUNCHES["dilated_conv"].items()
                if n != before.get(r, 0))
            want = ("simt" if dtype == torch.float32
                    else K4_OLD_TILES.get(shape, "tma"))
            level = shape in K4_LEVELS
            good = (within(e, dn) and bool(torch.isfinite(y).all())
                    and route == want)
            ok &= good
            cut = (f" box {plan.TT}x{plan.TF} BN={plan.bn} "
                   f"{plan.gx * plan.gy * plan.gz} blocks"
                   if route == "tma" else "")
            line = (f"K4 {dn:8s} [{route}{cut}] B={B} F={F:3d} T={T:4d} "
                    f"C={C:3d} N={N:3d} k=({kf},{kt}) dil={dil}: max_abs="
                    f"{e[0]:.3e} max_rel={e[1]:.2e} l2_rel={e[2]:.2e} "
                    f"{'ok' if good else f'FAIL (want the {want} route)'}")
            if level:
                t_k = cuda_time(lambda: kernels.launch_dilated_conv(
                    x, w, dil))
                t_p = cuda_time(lambda: pc.conv_ref(x, w, dil), reps=2)
                t_l = lib_time(_library_conv(x, w, dil))
                flops = 2.0 * B * F * T * kf * kt * C * N
                nbytes = (B * F * T * (C + N) + kf * kt * C * N) * isz
                b, by = bound_ms(flops, nbytes, dtype)
                line += (f" | ms={t_k:.4f} bound={b:.4f}({by}) "
                         f"plain={t_p:.4f} cudnn={t_l:.4f} "
                         f"({100 * b / t_k:.1f}% of the bound)")
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
    by_route = dict(kernels.ROUTE_LAUNCHES["dilated_conv"])
    log(f"K4 entry point (dilated_conv_nhwc, forward + dx at the "
        f"{len(K4_LEVELS)} level shapes): {n} launches, by route {by_route}")
    if n != 2 * len(K4_LEVELS) or by_route["tma"] != n:
        raise RuntimeError(f"K4's entry point launched it {n} times "
                           f"({by_route}), not {2 * len(K4_LEVELS)} on the "
                           f"TMA route")
    results.setdefault("launches", {})["dilated_conv"] = n
    return ok


def _side_by_side(x, w, d, t_k2, t_op, count, side) -> str:
    """K4's TMA route at one of K2's stage shapes (bf16, (5,3), dilation
    (d,1), C -> C) beside K2's engine there: the engine's time is K2's
    launch less its operand pass (both times include their weight pack).
    That launch also runs K2's epilogue, which moves 4 bytes an element
    more than K4 (x read for the gated residual, c written); ``side["epi"]``
    sums those bytes' least time at the memory rate.  Adds the shape's
    times, times its stages per evaluation, to ``side``."""
    from babe_tpu_torch import kernels

    B, F, T, C = x.shape
    t4 = cuda_time(lambda: kernels.launch_dilated_conv(x, w, (d, 1)))
    t2 = t_k2 - t_op
    peak = 2.0 * B * F * T * C * C * 15 / PEAK_BF16 * 1e3
    side["k4"] += count * t4
    side["k2"] += count * t2
    side["bound"] += count * peak
    side["epi"] += count * 4.0 * B * F * T * C / HBM_BPS * 1e3
    return (f"side by side F={F:3d} T={T:4d} C={C:3d} d={d:2d} x{count}: "
            f"K4 tma ms={t4:.4f} ({100 * peak / t4:.1f}% of the bf16 peak) "
            f"| K2 engine ms={t2:.4f} ({100 * peak / max(t2, 1e-9):.1f}%)")


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


def _dw_judge(what, dw, ref, dn):
    """A weight gradient against its plain version within DW_TOL."""
    e = errs(dw, ref)
    good = e[1] <= DW_TOL["max_rel"] and e[2] <= DW_TOL["l2_rel"]
    return e, good, (f"{what} {dn:8s}: max_abs={e[0]:.3e} max_rel="
                     f"{e[1]:.2e} l2_rel={e[2]:.2e} "
                     f"{'ok' if good else 'FAIL'}")


def _dw_route(dtype, C, N) -> str:
    from babe_tpu_torch import kernels

    return ("mma", "simt", "fold")[kernels.dw_route(dtype, C, N)]


def _dw_conv_case(g, Bc, F, T, C, N, ks, dil, dtype):
    """``conv_dw`` at one shape on inputs drawn from ``g``: returns (x, g_y,
    (errors, good, log line naming the route))."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    dev, dn = torch.device("cuda"), str(dtype).split(".")[-1]
    x = torch.randn((Bc, F, T, C), generator=g, device=dev).to(dtype)
    gy = torch.randn((Bc, F, T, N), generator=g, device=dev).to(dtype)
    dw = kernels.launch_conv_dw(x, gy, ks, dil)
    ref = ck.conv_dw_ref(x, gy, ks, dil)
    torch.cuda.synchronize()
    return x, gy, _dw_judge(
        f"conv_dw [{_dw_route(dtype, C, N)}] B={Bc} F={F:3d} T={T:4d} "
        f"C={C:3d} N={N:3d} k={ks} dil={dil}", dw, ref, dn)


def _dw_stage_case(g, Bs, F, T, C, d, dtype):
    """``fused_stage_dw`` and its operand pass ``stage_dw_operands`` at one
    stage shape on inputs drawn from ``g`` (the operands within TOL, the
    gradient within DW_TOL): returns (the launchers' arguments, (errors,
    the operands' errors), good, log line naming the route)."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    dev, dn = torch.device("cuda"), str(dtype).split(".")[-1]
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
    e, good, line = _dw_judge(
        f"fused_stage_dw [{_dw_route(dtype, C, C)}] B={Bs} F={F:3d} "
        f"T={T:4d} C={C:3d} d={d:2d}", dw, ref, dn)
    line += (f"; operands h, g_pre*s max_rel={eo[1]:.2e} l2_rel="
             f"{eo[2]:.2e} {'ok' if good_o else 'FAIL'}")
    return args, (e, eo), good and good_o, line


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

    g = torch.Generator(device="cuda").manual_seed(6)
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        isz = torch.tensor([], dtype=dtype).element_size()
        for (F, T, C, N, d, role), count in sorted(k1_shapes.items()):
            if role == "stage shape":
                continue
            count = 1 if role == "pyramid fwd" else 0
            x, gy, (e, good, line) = _dw_conv_case(
                g, B, F, T, C, N, (5, 3), (d, 1), dtype)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_conv_dw(
                x, gy, (5, 3), (d, 1)))
            t_p = cuda_time(lambda: ck.conv_dw_ref(x, gy, (5, 3), (d, 1)),
                            reps=2)
            t_l = lib_time(_library_wgrad(x, gy, (5, 3), (d, 1)))
            flops = 2.0 * B * F * T * 15 * C * N
            nbytes = B * F * T * (C + N) * isz + 15 * C * N * 4
            b, by = bound_ms(flops, nbytes, dtype)
            log(f"{line} {role} x{count} | ms={t_k:.4f} bound={b:.4f}({by}) "
                f"plain={t_p:.4f} cudnn={t_l:.4f}")
            account("conv_dw", count, dtype, t_k, t_p, t_l, flops, nbytes, e)
        for (F, T, C, d), count in sorted(k2_shapes.items()):
            args, (e, eo), good, line = _dw_stage_case(g, B, F, T, C, d,
                                                        dtype)
            ok &= good
            t_k = cuda_time(lambda: kernels.launch_fused_stage_dw(*args, d))
            t_p = cuda_time(lambda: ck.dil_stage_dw_ref(*args, d), reps=2)
            t_o = cuda_time(lambda: kernels.launch_stage_dw_operands(*args))
            t_op = cuda_time(lambda: ck.stage_dw_operands_ref(*args), reps=2)
            h, gc = ck.stage_dw_operands_ref(*args)
            t_l = lib_time(_library_wgrad(h, gc, (5, 3), (d, 1)))
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
            _, _, (e, good, line) = _dw_conv_case(g, Bc, F, T, C, N, ks,
                                                   dil, dtype)
            ok &= good
            log(f"{line} (edge)")
        for Bs, F, T, C, d in DW_STAGE_EDGE:
            _, _, good, line = _dw_stage_case(g, Bs, F, T, C, d, dtype)
            ok &= good
            log(f"{line} (edge)")
    return ok


def _kernel_int8_stage(B, F, T, C, d, count, dtype, g, account,
                       library_conv, edge: str = "") -> bool:
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
            f"d={d:2d}{f' ({edge})' if edge else f' x{count}'}: q flips "
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
        t_l = lib_time(library_conv(x, wb, d))
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


# P1's shapes off the probe's: ragged M and N, the smallest K and a K
# that is not a whole 128-byte ring stage, per type; and shapes the
# launcher refuses (K not a whole number of 32-byte slices)
GEMM_EDGE = {"bfloat16": [(100, 48, 70), (1, 16, 1), (2048, 400, 200)],
             "int8": [(100, 96, 70), (1, 32, 1), (2048, 416, 200)]}
GEMM_REFUSED = {"bfloat16": (64, 40, 64), "int8": (64, 48, 64)}
# P2's shapes (BF, BT, C, d) off the probe's: ragged BT (100, 20, 50) on
# the engine loop's boxes of 64 x 1, 32 x 2 and 64 x 1, C = 96 and 64
P2_EDGE = [(5, 100, 96, 2), (7, 20, 64, 3), (3, 50, 64, 1)]


def _p2_library(h, w5, BF, BT, d):
    """P2's yardstick: one bf16 cuDNN conv of the staged rows (NHWC, the
    (5,3) kernel at dilation (d,1), no padding), sliced to P2's window
    (rows f < BF, columns 7 + t), as (BF*BT, C)."""
    import torch
    import torch.nn.functional as Fn

    C = h.shape[2]
    x = h.to(torch.bfloat16).permute(2, 0, 1).unsqueeze(0)  # channels-last
    w = (w5.to(torch.bfloat16).reshape(5, 3, C, C).permute(3, 2, 0, 1)
         .contiguous(memory_format=torch.channels_last))

    def run():
        y = Fn.conv2d(x, w, dilation=(d, 1))
        return y[0, :, :BF, 7:7 + BT]

    return run, lambda y: y.permute(1, 2, 0).reshape(BF * BT, C)


def phase_probe(results: dict):
    """P1 and P2 against their plain versions at the probe's four shapes
    (int8 bit-exact, bf16 within TOL), P1 also at GEMM_EDGE and refusing
    GEMM_REFUSED before it launches; P1's tile, grid and ptxas's C7513
    status; P1's yardstick, cuBLAS, as device time (GEMM_REPS products in
    one CUDA graph) beside the old eager timing; P2's, a bf16 cuDNN conv
    of the staged rows; then the probe entry point with the counters
    zeroed just before and read just after.  Times are of one product: a
    launch's time over the repetitions it runs."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.tools import probe_int8 as probe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    agg = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0, "max_abs_err": 0.0, "ops_ms": 0.0,
               "bytes_ms": 0.0} for k in PROBE_PATH}
    ok, rate = True, {}
    gemm_entries = {k: v for k, v in kernels.ptxas_report(
        kernels.BUILD_LOG.get("probe_int8", "")).items() if "gemm_tma" in k}
    log("P1 ptxas: " + "; ".join(
        f"{k}: {v['registers']} registers, stack {v['stack']}, "
        f"{'C7513 (serialized wgmma)' if v['c7513'] else 'no C7513'}"
        for k, v in gemm_entries.items()))

    def check(out, ref, dt):
        if dt == torch.int8:
            return ((float((out.double() - ref.double()).abs().max()), 0.0,
                     0.0), bool(torch.equal(out, ref)))
        e = errs(out, ref)
        return e, within(e, "bfloat16")

    def judge(name, out, ref, dt, t_k, t_p, t_l, ops, nbytes, shape,
              extra=""):
        nonlocal ok
        dn = str(dt).split(".")[-1]
        e, good = check(out, ref, dt)
        ok &= good
        b, by = bound_ms(ops, nbytes, dt)
        a = agg[name]
        a["ms"] += t_k
        a["plain_ms"] += t_p
        a["bound_ms"] += b
        a["ops_ms"] += bound_ms(ops, 0.0, dt)[0]
        a["bytes_ms"] += 1e3 * nbytes / HBM_BPS
        a["max_abs_err"] = max(a["max_abs_err"], e[0])
        a["library_ms"] += t_l
        rate[name, shape, dn] = ops / (t_k * 1e-3) / 1e12
        log(f"{name} {dn:8s} {shape}: max_abs={e[0]:.3e} "
            f"{'ok' if good else 'FAIL'} | ms={t_k:.5f} "
            f"({rate[name, shape, dn]:.1f} TOP/s) bound={b:.5f}({by}) "
            f"plain={t_p:.4f} {extra}")

    for M, K, N in probe.GEMM_SHAPES:
        for dt in probe.DTYPES:
            a_, b_, bt = probe.gemm_inputs(M, K, N, dt, g, dev)
            out = kernels.launch_probe_gemm(a_, bt)
            ref = probe.probe_gemm_ref(a_, b_)
            torch.cuda.synchronize()
            # device time: launches captured in a CUDA graph (a launch of
            # GEMM_REPS products is about as short as its dispatch, so
            # eager launches, as timed before, time the host)
            run = lambda: kernels.launch_probe_gemm(a_, bt, probe.GEMM_REPS)
            t_k = probe.device_ms(run, 8) / probe.GEMM_REPS
            t_k_eager = cuda_time(run, 20) / probe.GEMM_REPS
            t_p = cuda_time(lambda: probe.probe_gemm_ref(a_, b_), 2)
            o = torch.empty_like(out)
            lib = ((lambda: torch._int_mm(a_, b_, out=o)) if dt == torch.int8
                   else (lambda: torch.matmul(a_, b_, out=o)))
            t_eager = cuda_time(lib, 20)
            t_l = probe.device_ms(lib, probe.GEMM_REPS)
            plan = kernels.probe_gemm_plan(M, K, N, dt)
            isz, osz = a_.element_size(), out.element_size()
            judge("probe_gemm", out, ref, dt, t_k, t_p, t_l,
                  probe.gemm_ops(M, K, N),
                  (M * K + K * N) * isz + M * N * osz, (M, K, N),
                  f"(eager launches {t_k_eager:.5f}) cublas={t_l:.5f} (graph "
                  f"of {probe.GEMM_REPS}; eager {t_eager:.5f}) | tile "
                  f"{plan.bm}x{plan.bn}, grid "
                  f"{plan.gx}x{plan.gy} = {plan.gx * plan.gy} blocks, "
                  f"{plan.nk} ring stages per product")
    for dt in probe.DTYPES:
        dn = str(dt).split(".")[-1]
        for M, K, N in GEMM_EDGE[dn]:
            a_, b_, bt = probe.gemm_inputs(M, K, N, dt, g, dev)
            out = kernels.launch_probe_gemm(a_, bt, 3)
            e, good = check(out, probe.probe_gemm_ref(a_, b_), dt)
            ok &= good
            log(f"probe_gemm {dn:8s} edge {(M, K, N)}: max_abs={e[0]:.3e} "
                f"{'ok' if good else 'FAIL'}")
        M, K, N = GEMM_REFUSED[dn]
        a_, b_, bt = probe.gemm_inputs(M, K, N, dt, g, dev)
        before = kernels.LAUNCHES["probe_gemm"]
        try:
            kernels.launch_probe_gemm(a_, bt)
            refused = False
        except ValueError as err:
            refused = kernels.LAUNCHES["probe_gemm"] == before
            log(f"probe_gemm {dn:8s} refuses {(M, K, N)} before launch: "
                f"{err}")
        ok &= refused
        if not refused:
            log(f"probe_gemm {dn:8s} {(M, K, N)}: FAIL, not refused")
    stage_entries = {k: v for k, v in kernels.ptxas_report(
        kernels.BUILD_LOG.get("probe_int8", "")).items()
        if "stage_probe" in k}
    log("P2 ptxas (the stage engine's loop): " + "; ".join(
        f"{k}: {v['registers']} registers, stack {v['stack']}, "
        f"{'C7513 (serialized wgmma)' if v['c7513'] else 'no C7513'}"
        for k, v in sorted(stage_entries.items())))
    for BF, BT, C, d in probe.STAGE_SHAPES:
        for dt in probe.DTYPES:
            h, w5, wt = probe.stage_inputs(BF, BT, C, d, dt, g, dev)
            out = kernels.launch_probe_stage(h, wt, BF, BT, d,
                                             probe.STAGE_REPS)
            ref = probe.probe_stage_ref(h, w5, BF, BT, d)
            torch.cuda.synchronize()
            # the kernel alone: the engine's weight pack made once, outside
            wpk = kernels.stage_tap_weights(wt)
            run = lambda: kernels.launch_probe_stage(
                h, wt, BF, BT, d, probe.STAGE_REPS, wpk=wpk)
            t_k = probe.device_ms(run, 4) / probe.STAGE_REPS
            t_k_eager = cuda_time(run, 20) / probe.STAGE_REPS
            t_p = cuda_time(lambda: probe.probe_stage_ref(h, w5, BF, BT, d),
                            2)
            conv, flat = _p2_library(h, w5, BF, BT, d)
            e_l = errs(flat(conv()),
                       probe.probe_stage_ref(h.to(torch.bfloat16),
                                             w5.to(torch.bfloat16), BF, BT,
                                             d))
            ok &= within(e_l, "bfloat16")
            t_l = probe.device_ms(conv, probe.STAGE_REPS)
            plan = kernels.probe_stage_plan(BF, BT, C, d, dt)
            # the loop's latency per ring stage: this grid, and a grid of
            # one position block (C / 32 blocks) at the same contraction
            hs, _, wts = probe.stage_inputs(1, plan.TT, C, d, dt, g, dev)
            wpks = kernels.stage_tap_weights(wts)
            t_s = probe.device_ms(lambda: kernels.launch_probe_stage(
                hs, wts, 1, plan.TT, d, probe.STAGE_REPS, wpk=wpks),
                4) / probe.STAGE_REPS
            judge("probe_stage", out, ref, dt, t_k, t_p, t_l,
                  probe.stage_ops(BF, BT, C),
                  (h.numel() + wt.numel()) * h.element_size()
                  + out.numel() * 4, (BF, BT, C, d),
                  f"(eager launches {t_k_eager:.5f}) "
                  f"cudnn={t_l:.5f} (bf16 conv, graph of "
                  f"{probe.STAGE_REPS}; vs the plain version max_rel "
                  f"{e_l[1]:.2e} {'ok' if within(e_l, 'bfloat16') else 'FAIL'}"
                  f") | engine loop: {plan.TT}x{plan.TF} positions x NT="
                  f"{C // plan.splits}, {plan.gx * plan.gy * plan.gz} "
                  f"blocks, {plan.n_it} ring stages per product, "
                  f"{1e3 * t_k / plan.n_it:.3f} us per stage; "
                  f"{C // 32} blocks: {1e3 * t_s / plan.n_it:.3f} us per "
                  f"stage")
    for dt in probe.DTYPES:
        dn = str(dt).split(".")[-1]
        for BF, BT, C, d in P2_EDGE:
            h, w5, wt = probe.stage_inputs(BF, BT, C, d, dt, g, dev)
            out = kernels.launch_probe_stage(h, wt, BF, BT, d, 3)
            e, good = check(out, probe.probe_stage_ref(h, w5, BF, BT, d), dt)
            ok &= good
            plan = kernels.probe_stage_plan(BF, BT, C, d, dt)
            log(f"probe_stage {dn:8s} edge {(BF, BT, C, d)} [{plan.TT}x"
                f"{plan.TF} x NT={C // plan.splits}]: max_abs={e[0]:.3e} "
                f"{'ok' if good else 'FAIL'}")
    for name, shape, dn in sorted(rate):
        if dn == "int8":
            ratio = rate[name, shape, "int8"] / rate[name, shape, "bfloat16"]
            log(f"{name} {shape}: int8:bf16 rate ratio {ratio:.2f}")
    kernels.reset_launch_counts()
    probe.run(reps=20, log=log)
    launches = {k: kernels.LAUNCHES[k] for k in PROBE_PATH}
    log(f"launches during the probe run: {launches} (through the wrappers: "
        f"eager warm-ups and CUDA-graph captures; the graphs' replays are "
        f"not counted)")
    for k, c in launches.items():
        if c <= 0:
            raise RuntimeError(f"kernel {k} never launched in the probe run")
    results.update(agg)
    results.setdefault("launches", {}).update(launches)
    # cuBLAS keeps a workspace for every stream it ran on: the yardsticks'
    # warm-up streams would carry 192 MiB into the train phase's peak
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    if not ok:
        raise RuntimeError("a probe kernel disagrees with its plain version "
                           "or takes a shape it should refuse")


# how each fit case's end point is held to the CPU plain loop's.  Two
# correct fits that round in different orders can end apart, and
# babe_tpu_torch/tools/fit_sensitivity.py measures by how much for each case
# of its FIT_CASES: the plain loop's own end point moves when its input or
# each step moves by one float32 rounding.  Each row (fc, A) is held to
# 1e-2 x that row's largest |value| where that spread stays below it; "fc
# past Nyquist" moves further (up to 31 Hz and 14 dB/oct), so it is held to
# 1e-2 x the largest |value| of both rows; "4097 bins" moves past even that
# (70 Hz against 30), so its end point is only logged.  Every step of every
# case is held sharply (_fit_steps).
FIT_END = {"fc past Nyquist": "whole", "4097 bins": "logged"}
FIT_TIMED = ("flagship", "513 bins", "4097 bins")


def _sm_clock_busy(busy) -> str:
    """nvidia-smi's SM clock read while ``busy()`` keeps the card working
    (its launches are queued first, so the card is busy while the query
    runs)."""
    import torch

    busy()
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60)
    torch.cuda.synchronize()
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def _fit_ptxas_gate(kernels) -> bool:
    """Every instantiation of the fit kernel has no stack frame and no
    spills (its per-breakpoint and per-bin arrays live in registers)."""
    rep = {k: v for k, v in kernels.ptxas_report(
        kernels.BUILD_LOG.get("filter_fit", "")).items()
        if "fit_kernel" in k}
    bad = {k: v for k, v in rep.items()
           if v["stack"] or v["spill_stores"] or v["spill_loads"]}
    regs = sorted(v["registers"] for v in rep.values())
    log(f"filter_fit ptxas: {len(rep)} instantiations, registers "
        f"{regs[0] if regs else '?'}..{regs[-1] if regs else '?'}, "
        f"{len(bad)} with a stack frame or spills"
        + "".join(f"\n  {k}: {v}" for k, v in bad.items()))
    return bool(rep) and not bad


FIT_STEP_BAR = 1e-3


def _fit_steps(kernels, cfg, freqs, stats, trace) -> tuple[bool, str]:
    """One kernel step from each iterate of the CPU plain loop, on the same
    stats, against the plain loop's own next iterate: per row (fc, A), the
    largest difference over the row's largest plain step, at most
    FIT_STEP_BAR (one rounding of fc near 2 kHz is 2.4e-4 Hz; a wrong term
    of the gradient gives far more).  Unlike the end point, one step does
    not compound rounding over the iterations."""
    import dataclasses

    import torch

    one = dataclasses.replace(cfg, max_iter=1)
    st = torch.stack(stats).cuda().contiguous()
    worst, scale, n = np.zeros(2), np.zeros(2), 0
    for (p, done), (q, _) in zip(trace, trace[1:]):
        if bool(done):
            break
        k = kernels.launch_filter_fit(st, freqs, p.to("cuda"), one).cpu()
        worst = np.maximum(worst, (k - q).abs().amax(1).double().numpy())
        scale = np.maximum(scale, (q - p).abs().amax(1).double().numpy())
        n += 1
    ok = bool((worst <= FIT_STEP_BAR * scale).all()) and n > 0
    return ok, (f"{n} single steps: max |kernel - plain| (fc, A) "
                f"{worst[0]:.3e} {worst[1]:.3e} against the largest plain "
                f"step {scale[0]:.3e} {scale[1]:.3e} (bar {FIT_STEP_BAR} of "
                f"it) {'ok' if ok else 'FAIL'}")


IIR_SHORT = (4, 4096)   # rows, samples: held to the plain loop bit for bit
IIR_TIMED = 8192        # samples of the row timed beside the plain loop
IIR_FC = 1000.0


def _iir_filters(fs: float) -> dict:
    """The degradations' IIR filters at fc = IIR_FC: cheby1 (order 6,
    ripple 0.05; the iir phase's) and the RBJ biquad (Q 0.707), as (b, a)
    float32."""
    from babe_tpu_torch.ops import iir

    c = iir.design_biquad_lpf(IIR_FC, fs, 0.707)
    return {"cheby1": iir.get_cheby1_ba(6, 0.05, 2 * IIR_FC / fs),
            "biquad": (np.float32(c[:3]), np.float32(c[3:]))}


def _kernel_lfilter(a: dict) -> bool:
    """The IIR recursion (csrc/iir.cu) against its plain version (the loop
    over time, on the card): at IIR_SHORT with cheby1 and the biquad,
    forward and reversed, bit for bit; at 184184 samples (one row, the
    informed request's) held to scipy's float64 lfilter within
    tests/test_torch_dsp.py::_iir_close's bar, with scipy's own fp32
    lfilter in the place of the JAX package's (twice its l2 error, plus
    1e-7), forward and reversed; timed there, kernel and plain loop, each
    direction once a guided evaluation."""
    import scipy.signal
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import iir

    L, fs = 184184, 22050.0
    ok = True
    g = torch.Generator(device="cuda").manual_seed(31)
    for ftype, (b, a_) in _iir_filters(fs).items():
        coef = iir._normalised(a_, b, torch.float32, "cuda")
        bn, an = coef.chunk(2)
        x = torch.randn(IIR_SHORT, generator=g, device="cuda")
        for rev in (False, True):
            out = kernels.launch_lfilter(x, coef, reverse=rev)
            ref = (iir.lfilter_ref(x.flip(-1), bn, an).flip(-1) if rev
                   else iir.lfilter_ref(x, bn, an))
            eq = torch.equal(out, ref)
            ok &= eq
            log(f"lfilter {ftype} {IIR_SHORT[0]}x{IIR_SHORT[1]} "
                f"{'reversed' if rev else 'forward'}: bit-equal to the "
                f"plain loop {eq}")
        xl = torch.randn((1, L), generator=g, device="cuda")
        xh = xl.cpu().numpy()
        b64, a64 = (np.asarray(v, np.float64) for v in (b, a_))
        bf, af = (np.asarray(v, np.float32) for v in (b, a_))
        for rev in (False, True):
            src = xh[:, ::-1] if rev else xh
            f64 = scipy.signal.lfilter(b64, a64, src.astype(np.float64))
            f32 = scipy.signal.lfilter(bf, af, src)
            out = kernels.launch_lfilter(xl, coef, reverse=rev).cpu().numpy()
            out = out[:, ::-1] if rev else out
            err = np.linalg.norm(out - f64) / np.linalg.norm(f64)
            bar = 2 * np.linalg.norm(f32 - f64) / np.linalg.norm(f64) + 1e-7
            held = bool(np.isfinite(out).all() and err <= bar)
            ok &= held
            a["max_abs_err"] = max(a["max_abs_err"],
                                   float(np.abs(out - f64).max()))
            log(f"lfilter {ftype} 1x{L} {'reversed' if rev else 'forward'}"
                f": l2 error from float64 {err:.3e} (bar {bar:.3e}, twice "
                f"scipy's fp32 lfilter's) {'ok' if held else 'FAIL'}")
        t_eval = sum(cuda_time(lambda r=rev: kernels.launch_lfilter(
            xl, coef, reverse=r)) for rev in (False, True))
        clk = _sm_clock_busy(lambda: [kernels.launch_lfilter(
            xl, coef) for _ in range(40)])
        sm_hz = 1e6 * (float(clk) if clk.replace(".", "").isdigit()
                       else 1980.0)  # else the card's most
        lat = 2 * 4 * 4 * L / sm_hz * 1e3
        log(f"lfilter {ftype}: per guided evaluation (1x{L}, forward and "
            f"reversed) {t_eval:.4f} ms, {t_eval * 1e-3 * sm_hz / (2 * L):.1f}"
            f" SM cycles a sample at {sm_hz / 1e6:.0f} MHz; the recursion's "
            f"latency (4 dependent fp32 ops of 4 cycles a sample) "
            f"{lat:.4f} ms")
        if ftype != "cheby1":
            continue
        a["eval_ms"] = t_eval
        # kernel, plain loop and bound on one row of IIR_TIMED samples: the
        # plain loop takes some 0.2 ms a sample on the card
        xt = xl[:, :IIR_TIMED]
        t_k = sum(cuda_time(lambda r=rev: kernels.launch_lfilter(
            xt, coef, reverse=r)) for rev in (False, True))
        t_p = sum(cuda_time(fn, reps=1, warm=0) for fn in (
            lambda: iir.lfilter_ref(xt, bn, an),
            lambda: iir.lfilter_ref(xt.flip(-1), bn, an).flip(-1)))
        n = bn.numel()
        ops = 2 * IIR_TIMED * (2 + 4 * (n - 1))  # both directions
        nbytes = 2 * 8 * IIR_TIMED
        b_ms, by = bound_ms(ops, nbytes, torch.float32)
        a.update(ms=t_k, plain_ms=t_p, bound_ms=b_ms, shapes=1,
                 ops_ms=bound_ms(ops, 0.0, torch.float32)[0],
                 bytes_ms=1e3 * nbytes / HBM_BPS, flops=ops,
                 bytes=nbytes)
        log(f"lfilter: per 1x{IIR_TIMED} row forward and reversed (cheby1) "
            f"ms={t_k:.4f} bound_ms={b_ms:.6f}({by}) plain_ms={t_p:.1f} "
            f"library=none (no one call)")
    return ok


def _kernel_filter_fit(a: dict) -> bool:
    """The filter-fit kernel against its plain version (the eager autograd
    loop) on the CPU, for every case of fit_sensitivity.FIT_CASES (the
    flagship blind config: a 4096-point STFT, 2049 bins, 92 frames of random
    spectra; K = 1 and 16, fc past Nyquist, ties, an exit at tol, a run to
    max_iter, positive A, 513 and 4097 bins): the end point (FIT_END) and
    every single step (_fit_steps), with its iterations beside the plain
    loop's exit iteration.  At the flagship also the plain loop on the card,
    and for FIT_TIMED the time per evaluation and per iteration (in SM
    cycles at the clock nvidia-smi reads during the timing), beside its
    bound.  One launch per guided evaluation of a blind request.  Fails if
    ptxas gave any fit instantiation a stack frame or spills."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.sampling.blind import BlindSampler
    from babe_tpu_torch.sampling.heun import SamplerConfig
    from babe_tpu_torch.tools.fit_sensitivity import (FIT_BAR, FIT_CASES,
                                                      case_config,
                                                      case_spectra)

    good = _fit_ptxas_gate(kernels)

    def case(name):
        cfg = case_config(name)
        X, Y = case_spectra(cfg)
        K = cfg.initial_params().shape[1]
        cpu = BlindSampler(None, None, SamplerConfig(), cfg, device="cpu")
        cpu_stats = cpu._fit_stats(X, Y)
        trace = []
        with torch.enable_grad():
            ref = cpu._fit_loop(cpu_stats, cfg.initial_params(), trace)
        n_plain = sum(1 for _, d in trace if not bool(d))
        s = BlindSampler(None, None, SamplerConfig(), cfg, device="cuda")
        p0 = cfg.initial_params("cuda")
        stats = s._fit_stats(X.cuda(), Y.cuda())
        st = torch.stack(stats).contiguous()
        iters = torch.zeros(1, dtype=torch.int32, device="cuda")
        out = {"cuda kernel": kernels.launch_filter_fit(st, s.freqs, p0, cfg,
                                                        iters)}
        n_it = int(iters.item())
        if name == "flagship":
            with torch.enable_grad():
                out["cuda plain"] = s._fit_loop(stats, p0)
        ref = ref.double()
        kind = FIT_END.get(name, "row")
        rows = ref.abs().amax(1).numpy()
        bar = FIT_BAR * (rows if kind == "row" else np.full(2, rows.max()))
        ok, e = True, {}
        for k, v in out.items():
            e[k] = (v.cpu().double() - ref).abs().amax(1).numpy()
            ok &= kind == "logged" or bool((e[k] <= bar).all())
        ok &= n_it == n_plain
        ok_s, steps = _fit_steps(kernels, cfg, s.freqs, cpu_stats, trace)
        log(f"filter fit [{name}] K={K} F={cfg.nfft // 2 + 1}: kernel {n_it} "
            f"iterations, plain loop {n_plain} | end point "
            + ", ".join(f"{k} vs CPU plain max abs (fc, A) {v[0]:.3e} "
                        f"{v[1]:.3e}" for k, v in e.items())
            + (" (logged only: FIT_END)" if kind == "logged" else
               f" (bar {bar[0]:.3e} {bar[1]:.3e}, {kind})")
            + f" | {steps} | {'ok' if ok and ok_s else 'FAIL'}")
        if not ok:
            log(f"  CPU plain {ref.numpy().round(3).tolist()}\n  kernel "
                f"{out['cuda kernel'].cpu().numpy().round(3).tolist()}")
        return ok and ok_s, dict(cfg=cfg, s=s, st=st, p0=p0, n_it=n_it,
                                 stats=stats, err=float(e["cuda kernel"].max()))

    runs = {}
    for name in FIT_CASES:
        ok, runs[name] = case(name)
        good &= ok
    for name in FIT_TIMED:
        r = runs[name]
        t = cuda_time(lambda: kernels.launch_filter_fit(
            r["st"], r["s"].freqs, r["p0"], r["cfg"]), reps=20)
        clock = _sm_clock_busy(lambda: [kernels.launch_filter_fit(
            r["st"], r["s"].freqs, r["p0"], r["cfg"]) for _ in range(2000)])
        us_it = 1e3 * t / max(r["n_it"], 1)
        mhz = float(clock) if clock.replace(".", "").isdigit() else float(
            "nan")
        r.update(ms=t, us_it=us_it)
        log(f"filter_fit [{name}]: {r['n_it']} iterations, ms={t:.4f} "
            f"({us_it:.3f} us, {us_it * mhz:.0f} SM cycles per iteration at "
            f"{clock} MHz)")
    r = runs["flagship"]

    def plain():
        with torch.enable_grad():
            r["s"]._fit_loop(r["stats"], r["p0"])

    t_p = cuda_time(plain, reps=2)
    F, n_it = r["s"].freqs.shape[0], r["n_it"]
    flops = 45.0 * F * n_it  # ~45 fp32 operations per bin and iteration
    nbytes = 4.0 * (4 * F + 4 * 5)
    b, by = bound_ms(flops, nbytes, torch.float32)
    log(f"filter_fit: flagship ms={r['ms']:.4f} bound={b:.6f}({by}) "
        f"plain={t_p:.4f} (per blind evaluation, fp32)")
    a.update(ms=r["ms"], plain_ms=t_p, bound_ms=b, library_ms=None,
             max_abs_err=r["err"], ops_ms=1e3 * flops / PEAK_FP32,
             bytes_ms=1e3 * nbytes / HBM_BPS, shapes=1)
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
        m.net.compute_dtype = torch.float32
        _check_ar_step(m, L, tol)
        log(f"check {label}: {time.perf_counter() - t0:.1f} s")
    _check_denoiser()


# the denoiser's bar on the card, relative to the largest value of what is
# compared: the network's output and the audio.  The sound reading on the
# H100 is about 1.4e-6 (network) and 1e-7 (audio); the same run with
# cuDNN's TF32 allowed is the control, and must fail it (PERF.md, PR 9).
# The CPU tests hold the port to the JAX package at the looser 2e-4
# absolute and 1e-3 relative (tests/test_torch_denoiser.py).
DEN_TOL = 1e-5


def _check_denoiser():
    """The full-width STFT denoiser (conf/tester/blind_bwe.yaml, seed 0) on
    one 5 s segment in fp32, card (cuDNN, TF32 off) against the CPU: the
    network on the segment's spectrum and ``apply_model``'s audio, each to
    ``DEN_TOL`` of its largest value.  The control runs the same on the
    card with TF32 allowed; it must exceed the bar, so that the bar would
    see TF32 (a lost ``_fp32_convs``)."""
    import torch

    import babe_tpu_torch.models.denoiser as dmod
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.ops.stft import stft

    t0 = time.perf_counter()
    dcfg = default_config(["tester=blind_bwe"]).tester.denoiser
    dens = {dev: dmod.MultiStageDenoiser.from_config(dcfg, device=dev)
            for dev in ("cpu", "cuda")}
    d = dens["cpu"]
    x = (0.05 * np.random.default_rng(41).standard_normal(
        (1, d.segment))).astype(np.float32)
    xt = torch.as_tensor(x)
    X = stft(torch.nn.functional.pad(xt, (0, d.win)), d.win, d.hop)
    Xr = torch.stack([X.real, X.imag], dim=1).transpose(2, 3).contiguous()

    def run(dn, dev, convs):
        with torch.no_grad():
            with convs(torch.device(dev)):
                net = dn.net(Xr.to(dev))[0].float().cpu()
            return net, dn.apply_model(xt.to(dev)).float().cpu()

    net, audio = {}, {}
    for dev, dn in dens.items():
        net[dev], audio[dev] = run(dn, dev, dmod._fp32_convs)
    fp32 = dmod._fp32_convs
    dmod._fp32_convs = lambda dev: torch.backends.cudnn.flags(  # noqa: E731
        enabled=True, allow_tf32=True)
    try:
        net["tf32"], audio["tf32"] = run(dens["cuda"], "cuda",
                                         dmod._fp32_convs)
    finally:
        dmod._fp32_convs = fp32
    ms = cuda_time(lambda: dens["cuda"].apply_model(xt.cuda()), reps=3)
    e_net = {k: errs(net[k], net["cpu"]) for k in ("cuda", "tf32")}
    e_aud = {k: errs(audio[k], audio["cpu"]) for k in ("cuda", "tf32")}
    sound = (bool(torch.isfinite(audio["cuda"]).all())
             and e_net["cuda"][1] <= DEN_TOL and e_aud["cuda"][1] <= DEN_TOL)
    seen = e_net["tf32"][1] > DEN_TOL and e_aud["tf32"][1] > DEN_TOL
    log(f"check denoiser (full width: depth {dcfg.depth}, "
        f"{dcfg.num_stages} stages, {d.net.conv2d_1_0.weight.shape[0]} "
        f"channels at {tuple(Xr.shape[2:])} frames x bins, "
        f"{sum(p.numel() for p in d.net.parameters())} parameters) fp32 "
        f"card vs CPU on one {d.segment}-sample segment, tol {DEN_TOL:g} "
        f"of the largest value: network max abs err "
        f"{e_net['cuda'][0]:.3e} (max_rel {e_net['cuda'][1]:.3e}; its "
        f"largest value {float(net['cpu'].abs().max()):.3e}), audio "
        f"max_rel {e_aud['cuda'][1]:.3e}, l2_rel {e_aud['cuda'][2]:.3e}; "
        f"control with TF32 allowed: network max_rel "
        f"{e_net['tf32'][1]:.3e}, audio max_rel {e_aud['tf32'][1]:.3e}, "
        f"l2_rel {e_aud['tf32'][2]:.3e} (must fail the bar: "
        f"{'fails' if seen else 'PASSES'}); apply_model on the card "
        f"{ms:.2f} ms per 5 s segment; {time.perf_counter() - t0:.1f} s "
        f"{'ok' if sound and seen else 'FAIL'}")
    if not (sound and seen):
        raise RuntimeError("check failed: the STFT denoiser")


def _check_ar_step(m, L: int, tol: float):
    """One step of the chunk loop at flagship widths on a short segment in
    fp32 (T = 3, no churn), card against the CPU from the same start: the
    last chunk's form, zero-padded past its data, under the overlap mask
    feathered over 50 samples (``predict_bwe_AR`` as ``_ar_loop`` runs it
    with inpaint_DC).  It covers the composite observation, the
    data-consistency replacement on the overlap and the guided scores on
    the card's kernels.  The result is held to ``tol`` relative L2, and
    the feathered overlap to the previous chunk's tail."""
    import torch

    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM
    from babe_tpu_torch.testers.tester import Tester
    from babe_tpu_torch.utils.weights import to_flax

    t0 = time.perf_counter()
    args = default_config(["tester=blind_bwe", f"exp.audio_len={L}",
                           "exp.remat=false", "tester.T=3",
                           "tester.diff_params.Schurn=0"])
    fs = int(args.exp.sample_rate)
    overlap = int(float(args.tester.complete_recording.overlap) * fs)
    n_data = 3 * L // 4
    mask = np.ones((1, L), np.float32)
    mask[:, overlap:] = 0
    y_masked = np.zeros((1, L), np.float32)
    y_masked[:, :overlap] = _lowpassed_audio(overlap, fs, seed=51)
    ylpf = np.zeros((1, L), np.float32)
    ylpf[:, :n_data] = _lowpassed_audio(n_data, fs, seed=50)
    filt = np.asarray([[1000.0], [-40.0]], np.float32)
    params, buffers = to_flax(m.net)
    out = {}
    for dev in ("cpu", "cuda"):
        t = Tester(args, m, EDM.from_config(args, cqt_hpf=m.apply_hpf_DC),
                   device=dev)
        t.set_variables(params, buffers)
        if dev == "cpu":
            y = mask * y_masked + (1 - mask) * ylpf
            t_0 = float(t.edm.create_schedule_from_initial_t(
                t.scfg.start_sigma, t.scfg.T)[0])
            x0 = (y + t_0 * np.random.default_rng(52).standard_normal(
                y.shape)).astype(np.float32)
        out[dev] = t.sampler().predict_bwe_AR(
            torch.Generator(device=dev).manual_seed(0),
            torch.as_tensor(ylpf, device=dev), y_masked, filt, "fc_A", mask,
            smooth_mask_size=50,
            x_init=torch.as_tensor(x0, device=dev)).float().cpu()
    e = errs(out["cuda"], out["cpu"])
    held = errs(out["cuda"][:, :overlap - 50],
                torch.as_tensor(y_masked[:, :overlap - 50]))
    good = (bool(torch.isfinite(out["cuda"]).all()) and e[2] <= tol
            and held[1] <= 1e-3)
    log(f"check AR step (flagship widths, {L} samples, fp32, T=3, overlap "
        f"{overlap} feathered over 50, data to {n_data}): card vs CPU "
        f"l2_rel={e[2]:.3e} max_rel={e[1]:.3e} (tol {tol:g} l2_rel); the "
        f"overlap held to the previous tail, max_rel {held[1]:.3e} (tol "
        f"1e-3); {time.perf_counter() - t0:.1f} s "
        f"{'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("check failed: the AR step")


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


def _flagship_ckpt(args, tmpdir: str) -> str:
    """The flagship network of ``args`` from seed 0, written into
    ``tmpdir`` as a JAX-format ``.ckpt`` (params, buffers, EMA, args)."""
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.utils.weights import to_flax

    model = CQTDiffPlus.from_config(args).init(seed=0, device="cpu")
    params, buffers = to_flax(model.net)
    path = os.path.join(tmpdir, "flagship-seed0.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"it": 0, "params": params, "buffers": buffers,
                     "ema": params, "args": args.to_dict()}, f)
    return path


# the precisions whose model also answers an informed request in the
# requests phase (int8's would run the blind request's kernels again)
INFORMED = ("bf16",)


def phase_requests(results: dict, T: int = 35, n_blind: int = 1):
    """``n_blind`` blind requests through each of two loads of the same
    checkpoint, bf16 and int8, and one informed request in each precision
    of INFORMED.  Each model's run is one path: the counters are zeroed
    just before it and read just after."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.api import BABE
    from babe_tpu_torch.config import default_config

    args = default_config(["tester=blind_bwe"])
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    t0 = time.perf_counter()
    tmpdir = tempfile.mkdtemp(prefix="babe_smoke_")
    path = _flagship_ckpt(args, tmpdir)
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
    for prec, path_kernels in (("bf16", BF16_PATH), ("int8", INT8_PATH)):
        m = models.pop(prec)
        reqs = [("blind", None)] * n_blind + (
            [("informed", (1000.0, -40.0))] if prec in INFORMED else [])
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


class _Int8Env:
    """The process environment with the int8 knobs ``knobs`` set (every
    other BABE_INT8_* knob unset), restored on exit."""

    KEYS = ("BABE_PRECISION", "BABE_INT8_FUSED", "BABE_INT8_BWD",
            "BABE_INT8_SCALE", "BABE_INT8_OPS", "BABE_INT8_MINC")

    def __init__(self, knobs: dict):
        self.knobs = knobs

    def __enter__(self):
        self.saved = {k: os.environ.pop(k) for k in self.KEYS
                      if k in os.environ}
        os.environ.update(self.knobs)

    def __exit__(self, *exc):
        for k in self.KEYS:
            os.environ.pop(k, None)
        os.environ.update(self.saved)


def _int8_mode_check(label: str, knobs: dict, path_kernels) -> None:
    """One int8 configuration at flagship widths on a short segment (the
    check phase's weights: O(1) gates, 16384 samples, bf16 carrier): the
    denoiser output and guidance gradient on the card and on the CPU, each
    against the CPU's fp32 result; the card must stay within 1.5x of the
    CPU's own int8 error (as phase_check holds int8), with the unfused
    path's kernels launched on the card."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus

    args = default_config(["exp.audio_len=16384", "exp.remat=false"])
    m = CQTDiffPlus.from_config(args).init(seed=1, device="cpu")
    _random_flagship_like(m.net, 2)
    m.net.requires_grad_(False)
    edm = EDM.from_config(args)
    x = (0.1 * np.random.default_rng(3).standard_normal((1, 16384))).astype(
        np.float32)
    out = {}
    for dev, dt, prec in (("cpu", torch.float32, None),
                          ("cpu", torch.bfloat16, "int8"),
                          ("cuda", torch.bfloat16, "int8")):
        m.net.compute_dtype = dt
        with _Int8Env(knobs):
            m.net.set_precision(prec)
        m.to(dev)
        kernels.reset_launch_counts()
        xt = torch.tensor(x, device=dev, requires_grad=True)
        y = m.fused_denoiser(edm)(xt, torch.full((1, 1), 0.2, device=dev))
        (gx,) = torch.autograd.grad((y * y).sum(), xt)
        out[dev, prec] = (y.detach().cpu().float(), gx.cpu().float())
    counts = {k: kernels.LAUNCHES[k] for k in path_kernels}
    good = all(v > 0 for v in counts.values())
    for what, i in (("denoiser", 0), ("guidance grad", 1)):
        ref = out["cpu", None][i]
        e_card = float((out["cuda", "int8"][i] - ref).norm() / ref.norm())
        e_cpu = float((out["cpu", "int8"][i] - ref).norm() / ref.norm())
        ok_v = (bool(torch.isfinite(out["cuda", "int8"][i]).all())
                and e_card <= 1.5 * e_cpu)
        good &= ok_v
        log(f"int8modes check ({label}, bf16 carrier, flagship widths, "
            f"16384 samples): {what} vs fp32 CPU: card l2_rel={e_card:.3e}, "
            f"CPU l2_rel={e_cpu:.3e} (card within 1.5x) "
            f"{'ok' if ok_v else 'FAIL'}")
    log(f"int8modes check ({label}): card launches {counts}")
    if not good:
        raise RuntimeError(f"int8modes: the {label} check failed")


def _qat_steps(knobs: dict, steps: int = 2) -> str:
    """``steps`` training steps at the flagship (batch 4, 184184 samples,
    remat, bf16) under BABE_PRECISION=int8 and ``knobs``, on seeded audio:
    each loss and gradient norm finite, and the int8 path's forward and
    weight-gradient kernels launched."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.setup import setup_diff_parameters, setup_network
    from babe_tpu_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="babe_qat_")
    try:
        args = default_config([
            "exp=maestro22k_8s", "network=cqtdiff+", f"model_dir={tmp}",
            "exp.resume=false", "tester.do_test=false",
            "logging.save_model=false"])
        with _Int8Env(dict(knobs, BABE_PRECISION="int8")):
            model = setup_network(args)
            tr = Trainer(args, None, model, setup_diff_parameters(
                args, cqt_hpf=model.apply_hpf_DC), device="cuda")
        B, L = int(args.exp.batch), int(args.exp.audio_len)
        x = torch.as_tensor(np.stack([_lowpassed_audio(L, 22050, 60 + i)
                                      for i in range(B)]), device="cuda")
        kernels.reset_launch_counts()
        rec = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr._step(x)
            torch.cuda.synchronize()
            rec.append((time.perf_counter() - t0, float(m["loss"]),
                        float(m["grad_norm"]), bool(m["nonfinite"])))
        counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
        fused = tr.net.int8_config.fused is not None
        need = (("fused_stage_int8", "fused_stage_dw") if fused
                else ("conv_int8", "act_quant", "conv_dw"))
        ok = (all(math.isfinite(r[1]) and math.isfinite(r[2])
                  and not r[3] for r in rec)
              and all(counts.get(k, 0) > 0 for k in need))
        steps = [tuple(round(v, 5) for v in r[:3]) for r in rec]
        line = (f"{'fused chain' if fused else 'unfused convs'}: steps "
                f"(s, loss, grad norm) {steps}, launches {counts}")
        if not ok:
            raise RuntimeError(f"int8modes: QAT failed: {line}")
        del tr, model
        torch.cuda.empty_cache()
        return line
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


# the rescale's edge cases (B, F, T, N, offset): N not a multiple of 8 (the
# scalar path), a view one element off 16-byte alignment (the scalar path
# at N = 128), several items, one row
RESCALE_EDGE = [(2, 64, 20, 36, 0), (1, 64, 32, 128, 1), (3, 32, 16, 96, 0),
                (1, 1, 1, 8, 0)]
RESCALE_REPS = 20  # launches per CUDA graph when timing the rescale


def _rescale_checks(shapes, results) -> None:
    """Q8's ``act_rescale`` against its plain version at the int8 1x1
    products one guided evaluation ran (recorded: (B, F, T, N) and the
    count), bit for bit in bf16 and fp32, and at RESCALE_EDGE; timed in
    bf16 through its launcher (CUDA events, the host's dispatch included)
    and as device time in a CUDA graph of RESCALE_REPS launches with the L2
    flushed before each (``_flushed_ms``), beside the plain version and the
    yardstick ``torch.mul(acc, scale)`` (fp32 out) timed both ways; the
    sums go to the kernels line."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    g = torch.Generator(device="cuda").manual_seed(77)
    flush_buf = torch.ones(2**25, dtype=torch.float32, device="cuda")
    a = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
         "max_abs_err": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "shapes": 0,
         "device_ms": 0.0, "library_device_ms": 0.0}

    def case(B, F, T, N, off=0):
        buf = torch.randint(-2**24, 2**24, (B * F * T * N + off,),
                            generator=g, device="cuda", dtype=torch.int32)
        acc = buf[off:].view(B, F, T, N)
        sx = torch.rand((B,), generator=g, device="cuda") / 100
        sw = torch.rand((N,), generator=g, device="cuda") / 100
        for dtype in (torch.bfloat16, torch.float32):
            out = kernels.launch_act_rescale(acc, ck.int8_scale(sx, sw),
                                             dtype)
            ref = ck.int8_rescale_ref(acc, sx, sw, dtype)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"act_rescale differs from its plain "
                                   f"version at {(B, F, T, N)}, offset "
                                   f"{off}, {dtype}")
        return acc, sx, sw

    for B, F, T, N, off in RESCALE_EDGE:
        case(B, F, T, N, off)
    log(f"act_rescale edge cases {RESCALE_EDGE} (B, F, T, N, offset): "
        f"bit-equal in bf16 and fp32")
    for (B, F, T, N), count in sorted(shapes.items()):
        acc, sx, sw = case(B, F, T, N)
        sc = ck.int8_scale(sx, sw)

        def rescale():
            return kernels.launch_act_rescale(acc, sc, torch.bfloat16)

        def mul():  # the yardstick: one PyTorch call, its output fp32
            return torch.mul(acc, sc.view(B, 1, 1, N))

        t_k = cuda_time(rescale)
        t_d = _flushed_ms(rescale, flush_buf, RESCALE_REPS)
        t_p = cuda_time(lambda: ck.int8_rescale_ref(acc, sx, sw,
                                                    torch.bfloat16), reps=2)
        t_l = cuda_time(mul)
        t_ld = _flushed_ms(mul, flush_buf, RESCALE_REPS)
        n = B * F * T * N
        b, by = bound_ms(n, 6.0 * n, torch.float32)
        a["ms"] += count * t_k
        a["device_ms"] += count * t_d
        a["plain_ms"] += count * t_p
        a["library_ms"] += count * t_l
        a["library_device_ms"] += count * t_ld
        a["bound_ms"] += count * b
        a["ops_ms"] += count * bound_ms(n, 0.0, torch.float32)[0]
        a["bytes_ms"] += count * 1e3 * 6.0 * n / HBM_BPS
        a["shapes"] += 1
        log(f"act_rescale B={B} F={F:3d} T={T:4d} N={N:3d} x{count}: "
            f"bit-equal ms={t_k:.4f} device={t_d:.4f} bound={b:.4f}({by}) "
            f"plain={t_p:.4f} torch.mul={t_l:.4f} device={t_ld:.4f}")
    log(f"act_rescale: per guided evaluation (amax, all ops; bf16) "
        f"ms={a['ms']:.3f} device_ms={a['device_ms']:.3f} "
        f"bound_ms={a['bound_ms']:.3f} plain_ms={a['plain_ms']:.3f} "
        f"library_ms={a['library_ms']:.3f} (device "
        f"{a['library_device_ms']:.3f})")
    results["act_rescale"] = a


def _int_mm_route_check() -> None:
    """The int8 1x1 product at shapes ``torch._int_mm`` does not take (M <=
    16; N not a multiple of 8; K not a multiple of 32, zero-padded), which
    go to P1's GEMM: int32 equal to the plain version (float64, exact) bit
    for bit, P1 launched once each; then int8 convs off C8's (5,3) at
    dilation (d,1) (the int8 im2col product and the rescale) against their
    plain versions, accumulator and output bit for bit."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops import conv_kernels as ck

    g = torch.Generator().manual_seed(78)
    for M, K, N in ((8, 128, 96), (4096, 96, 36), (8, 100, 36)):
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
        bt = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
        n0 = kernels.LAUNCHES["probe_gemm"]
        out = ck._int_mm(a.cuda(), bt.cuda()).cpu()
        launched = kernels.LAUNCHES["probe_gemm"] - n0
        ok = launched == 1 and torch.equal(out, ck._int_mm(a, bt))
        log(f"int8 1x1 product (M, K, N) = ({M}, {K}, {N}) through P1: "
            f"bit-equal to the plain version {ok}")
        if not ok:
            raise RuntimeError(f"the int8 1x1 product at {(M, K, N)} did "
                               f"not run P1 or differs from its plain "
                               f"version")
    for (B, F, T, C, N), ks, dil in (((2, 64, 40, 96, 96), (3, 3), (2, 2)),
                                     ((1, 32, 24, 20, 36), (1, 1), (1, 1)),
                                     ((1, 64, 20, 128, 128), (5, 3), (2, 2))):
        x = torch.randn((B, F, T, C), generator=g).to(torch.bfloat16)
        w = 0.05 * torch.randn((*ks, C, N), generator=g)
        qw = ck.QuantKernel.of(w.to(torch.bfloat16))
        qx, sx = ck.quant_act_per_item(x)
        acc = ck.conv_int8_acc(qx.cuda(), qw.q.cuda(), dil).cpu()
        ref = ck.conv_int8_acc_ref(qx, qw.q, dil)
        n0 = dict(kernels.LAUNCHES)
        out = ck.conv_int8(x.cuda(), w.cuda(), dil).cpu()
        ran = [k for k in kernels.LAUNCHES if kernels.LAUNCHES[k] != n0[k]]
        out_ref = ck.conv_int8(x, w, dil)
        ok = (torch.equal(acc, ref) and torch.equal(out, out_ref)
              and "conv_int8" not in ran and "act_rescale" in ran)
        log(f"int8 conv {ks} at dilation {dil}, (B, F, T, C, N) = "
            f"{(B, F, T, C, N)}: the im2col product ({'+'.join(ran)}), "
            f"accumulator and output bit-equal to the plain version {ok}")
        if not ok:
            raise RuntimeError(f"the int8 conv {ks} at {dil} differs from "
                               f"its plain version or ran C8")


def phase_int8modes(results: dict, T: int = 15):
    """The JAX package's int8 configurations on the card
    (``INT8_MODES``): the JAX API's int8 (``BABE_INT8_FUSED=0
    BABE_INT8_BWD=1``: one int8 conv, C8, per stage with the guidance
    gradient's input cotangent in int8) and ``BABE_INT8_SCALE=amax
    BABE_INT8_OPS=all`` (dynamic scales, the 1x1s in int8 too).  For each:
    the check at flagship widths on a short segment (``_int8_mode_check``),
    then one guided blind request at the flagship (seed-0 ``.ckpt``,
    ``BABE.load(precision="int8")`` under the knobs, 184184 samples,
    tester.T = 15) with the counters zeroed just before and read just
    after; the amax, all-ops request also records its int8 1x1 shapes,
    where ``act_rescale`` is then held to its plain version; the int8 1x1
    product at shapes ``torch._int_mm`` does not take goes through P1
    (``_int_mm_route_check``).  Then two quantization-aware training steps at the flagship under
    BABE_PRECISION=int8 in the default int8 (the fused chain) and in the
    JAX API's (``_qat_steps``)."""
    import torch

    import babe_tpu_torch.models.blocks as tb
    from babe_tpu_torch import kernels
    from babe_tpu_torch.api import BABE
    from babe_tpu_torch.config import default_config

    t00 = time.perf_counter()
    args = default_config(["tester=blind_bwe"])
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    tmpdir = tempfile.mkdtemp(prefix="babe_smoke_")
    path = _flagship_ckpt(args, tmpdir)
    x = _lowpassed_audio(L, fs, seed=50)
    launches = results.setdefault("launches", {})
    for label, knobs, path_kernels in INT8_MODES:
        t0 = time.perf_counter()
        _int8_mode_check(label, knobs, path_kernels)
        t1 = time.perf_counter()
        with _Int8Env(knobs):
            m = BABE.load(path, overrides=[f"tester.T={T}"],
                          precision="int8")
        cfg = m._tester.model.net.int8_config
        shapes: dict = {}
        hooks = []
        if "act_rescale" in path_kernels:
            def hook(mod, inp, out):
                if len(shapes_seen) < n1x1:
                    shapes_seen.append(id(mod))
                    key = (*inp[0].shape[:3], out.shape[-1])
                    shapes[key] = shapes.get(key, 0) + 1

            convs = [c for c in m._tester.model.net.modules()
                     if isinstance(c, tb.Conv2d) and c.kernel_size == (1, 1)
                     and c.int8_active()]
            n1x1, shapes_seen = len(convs), []
            hooks = [c.register_forward_hook(hook) for c in convs]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t2 = time.perf_counter()
        out, info = m.enhance(x, fs, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t2
        counts = dict(kernels.LAUNCHES)
        for h in hooks:
            h.remove()
        fin = (bool(np.isfinite(out).all()) and out.shape == (1, L)
               and np.isfinite(info["fc"]).all())
        log(f"int8modes request ({label}; {cfg}): loaded in "
            f"{t2 - t1:.1f} s; one blind request {wall:.2f} s, realtime "
            f"factor {L / fs / wall:.3f}x, fc="
            f"{np.round(info['fc'], 1).tolist()} finite={fin}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        # one act_quant_dyn per dynamic quantization: in the JAX API's
        # int8 one per int8 input gradient, as many as the hinted
        # forwards, two C8 launches per stage; no hint under amax
        q8_ok = (counts["act_quant_dyn"] == counts["act_quant"]
                 and counts["conv_int8"] == 2 * counts["act_quant"]
                 if "act_quant" in path_kernels else counts["act_quant"] == 0)
        if (not fin or not q8_ok or counts["fused_stage_int8"]
                or any(counts[k] <= 0 for k in path_kernels)):
            raise RuntimeError(f"int8modes: the {label} request failed, or "
                               f"did not run the unfused int8 kernels as "
                               f"expected")
        results.setdefault("int8modes", []).append(
            {"config": label, "wall_s": wall, "rtf": L / fs / wall})
        if "act_rescale" in path_kernels:
            launches["act_rescale"] = counts["act_rescale"]
            _rescale_checks(shapes, results)
        else:
            launches.update({k: counts[k] for k in path_kernels})
        del m
        torch.cuda.empty_cache()
        log(f"int8modes ({label}): {time.perf_counter() - t0:.1f} s")
    os.remove(path)
    os.rmdir(tmpdir)
    _int_mm_route_check()
    for label, knobs in (("default int8", {}),
                         ("JAX API int8", INT8_MODES[0][1])):
        t0 = time.perf_counter()
        line = _qat_steps(knobs)
        log(f"int8modes QAT ({label}): {line}; "
            f"{time.perf_counter() - t0:.1f} s")
    log(f"int8modes: {time.perf_counter() - t00:.1f} s")


def _reference_state_dict(net) -> dict:
    """The port's network as a reference ``.pt`` state dict: its own
    inverse of ``utils/torch_ckpt.py`` (module names with ``.<n>`` indices,
    the Conv2d wrappers' ``conv`` level dropped, kernels as torch-layout
    ``weight``, GroupNorm gains (1, C, 1, 1))."""
    import re

    import torch

    sd = {}
    for key, v in net.state_dict().items():
        parts = key.split(".")
        mods = [re.sub(r"_(\d+)", r".\1", p) if re.fullmatch(
            r"[A-Za-z]\w*?(_\d+)+", p) else p
            for p in parts[:-1] if p != "conv"]
        kind, v = parts[-1], v.detach().float().cpu()
        if kind == "kernel":
            kind = "weight"
            v = (v.permute(3, 2, 0, 1) if v.ndim == 4 else v.t())
        elif kind == "gamma":
            v = v.reshape(1, -1, 1, 1)
        sd[".".join(mods + [kind])] = v.contiguous().clone()
    return sd


# the .pt route on the card: PT_REPS blind requests per route, interleaved
# with the .ckpt route's; the largest .pt-vs-.ckpt difference may be at
# most PT_K times the largest difference between two runs of one route
# (the card's own run-to-run spread: a guided request does not repeat
# itself bit for bit there, a denoiser evaluation does), and 0 where that
# spread is 0.  An outlier run enters pairs of both kinds, so without a
# difference between the routes the ratio stays near 1 (0.93 over 28
# pairs on an H100)
PT_REPS = 3
PT_K = 4.0


def _route_spreads(runs) -> tuple[float, float]:
    """(own, cross) over ``runs`` [(route, array)]: the largest max |diff|
    between two runs of one route, and between runs of two routes."""
    own = cross = 0.0
    for i, (ra, a) in enumerate(runs):
        for rb, b in runs[i + 1:]:
            d = float(np.abs(a - b).max())
            if ra == rb:
                own = max(own, d)
            else:
                cross = max(cross, d)
    return own, cross


def phase_pt(results: dict, T: int = 8):
    """A reference-format ``.pt`` of the seeded flagship weights
    (``_reference_state_dict``; no JAX) beside a ``.ckpt`` of the same
    weights and the same config (``network=cqtdiff+_ckpt``, the
    checkpoint frame), both loaded with ``BABE.load`` (both before any
    request, so what a load leaves in the process is shared).  On the
    card: the loaded weights and the built configs must be equal; one
    denoiser evaluation per route, twice, interleaved, and ``PT_REPS``
    blind requests per route (tester.T = T), interleaved, each finite,
    with the largest .pt-vs-.ckpt difference within ``PT_K`` times the
    largest difference between two runs of one route (0 where the card
    repeats itself).  On the CPU, where a run repeats itself bit for bit,
    one blind request through each route at flagship widths on a short
    segment (16384 samples, tester.T = 2) must be equal bit for bit.
    Before the requests: the committed orbax fixture (``_orbax_fixture``);
    after them one request through an orbax directory of the same weights
    (the module doc)."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.api import BABE
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.utils.orbax_dir import write_orbax
    from babe_tpu_torch.utils.weights import to_flax

    t0 = time.perf_counter()
    _orbax_fixture(results)
    log(f"pt: the fixture's checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    args = default_config(["network=cqtdiff+_ckpt", "tester=blind_bwe"])
    tmp = tempfile.mkdtemp(prefix="babe_pt_")
    model = CQTDiffPlus.from_config(args).init(seed=0, device="cpu")
    params, buffers = to_flax(model.net)
    ckpt, pt = os.path.join(tmp, "seed0.ckpt"), os.path.join(tmp, "seed0.pt")
    payload = {"it": 5, "params": params, "buffers": buffers, "ema": params}
    with open(ckpt, "wb") as f:
        pickle.dump({**payload, "args": args.to_dict()}, f)
    torch.save({"it": 5, "ema": _reference_state_dict(model.net)}, pt)
    t1 = time.perf_counter()
    ox = write_orbax(os.path.join(tmp, "seed0.orbax"), payload,
                     args.to_dict())
    ox_write = time.perf_counter() - t1
    ox_bytes = _dir_bytes(ox)
    del model
    try:
        over = [f"tester.T={T}"]
        routes = {"ckpt": BABE.load(ckpt, overrides=over),
                  "pt": BABE.load(pt, overrides=over)}
        t1 = time.perf_counter()
        mo = BABE.load(ox, overrides=over)
        ox_load = time.perf_counter() - t1
        mc, mp = routes["ckpt"], routes["pt"]
        sc, sp = (m._tester.model.net.state_dict() for m in (mc, mp))
        same_w = set(sc) == set(sp) and all(torch.equal(sc[k], sp[k])
                                            for k in sc)
        same_cfg = (mc.args.network == mp.args.network
                    and mc.args.exp == mp.args.exp
                    and mc.args.tester == mp.args.tester
                    and mc._tester.model.cqt.mode
                    == mp._tester.model.cqt.mode == "oct_pow2"
                    and mc._tester.it == mp._tester.it == 5)
        L, fs = int(mc.args.exp.audio_len), mc.fs
        x = _lowpassed_audio(L, fs, seed=40)
        xd = torch.as_tensor(x, device="cuda").reshape(1, L)
        sig = torch.full((1, 1), 0.2, device="cuda")
        den_runs = []
        with torch.no_grad():
            for _ in range(2):
                for r, m in routes.items():
                    y = m._tester._denoiser_fn()[0](xd, sig)
                    den_runs.append((r, y.float().cpu().numpy()))
        req_runs = [(r, m.enhance(x, fs, seed=0)[0])
                    for _ in range(PT_REPS) for r, m in routes.items()]
        den_own, den_cross = _route_spreads(den_runs)
        own, cross = _route_spreads(req_runs)
        pairs = [float(np.abs(a - b).max())
                 for i, (_, a) in enumerate(req_runs)
                 for _, b in req_runs[i + 1:]]
        finite = all(np.isfinite(a).all() for _, a in den_runs + req_runs)
        so = mo._tester.model.net.state_dict()
        ox_same = (set(so) == set(sc) and all(torch.equal(so[k], sc[k])
                                              for k in sc)
                   and mo.args.network == mc.args.network
                   and mo.args.exp == mc.args.exp
                   and mo._tester.it == 5)
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        ox_out = mo.enhance(x, fs, seed=0)[0]
        ox_req = time.perf_counter() - t1
        ox_launch = {k: kernels.LAUNCHES[k] for k in ORBAX_REQUEST_PATH}
        ox_cross = max(float(np.abs(ox_out - a).max())
                       for r, a in req_runs if r == "ckpt")
        ox_ok = (ox_same and bool(np.isfinite(ox_out).all())
                 and ox_cross <= PT_K * own
                 and all(v > 0 for v in ox_launch.values()))
        log(f"pt: the same weights as an orbax directory (plain layout, "
            f"{ox_bytes} bytes, written in {ox_write:.2f} s, BABE.load "
            f"{ox_load:.2f} s): EMA and config equal to the .ckpt route's "
            f"{ox_same}; one blind request (T={T}, {ox_req:.2f} s): vs the "
            f".ckpt requests "
            f"max |diff| {ox_cross:.3e} (bar {PT_K:g} x {own:.3e}), "
            f"launches {ox_launch} {'ok' if ox_ok else 'FAIL'}")
        results["orbax_pt"] = {"bytes": ox_bytes, "write_s": ox_write,
                               "load_s": ox_load, "max_diff": ox_cross,
                               "own_diff": own, "launches": ox_launch}
        del mc, mp, mo, routes
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        short = ["tester.T=2", "exp.audio_len=16384"]
        cpu = [BABE.load(p_, overrides=short, device="cpu")
               for p_ in (ckpt, pt)]
        xs = _lowpassed_audio(16384, fs, seed=41)
        cout = [m.enhance(xs, fs, seed=0)[0] for m in cpu]
        cpu_equal = bool(np.array_equal(cout[0], cout[1]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card_ok = den_cross <= PT_K * den_own and cross <= PT_K * own
    good = (same_w and same_cfg and finite and card_ok and cpu_equal
            and bool(np.isfinite(cout[0]).all()) and ox_ok)
    log(f"pt: seeded flagship weights as .ckpt and as a reference .pt, "
        f"both through BABE.load: weights equal {same_w}, configs equal "
        f"{same_cfg} (frame oct_pow2); on the card (bar: .pt vs .ckpt <= "
        f"{PT_K:g}x one route's own spread) one denoiser evaluation x2 per "
        f"route: .pt vs .ckpt max |diff| {den_cross:.3e}, own {den_own:.3e}"
        f"; blind request (T={T}) x{PT_REPS} per route, interleaved: .pt vs "
        f".ckpt {cross:.3e}, own {own:.3e} (every pair, run order ckpt, "
        f"pt, ...: {', '.join(f'{v:.3e}' for v in pairs)}); finite {finite}"
        f"; CPU blind request (flagship widths, 16384 samples, T=2) .pt vs "
        f".ckpt bit-equal {cpu_equal} ({time.perf_counter() - t1:.1f} s) "
        f"{'ok' if good else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
    results["pt"] = {"card_denoiser_diff": den_cross,
                     "card_denoiser_own": den_own,
                     "card_max_diff": cross, "card_own_diff": own,
                     "cpu_bit_equal": cpu_equal}
    if not good:
        raise RuntimeError("pt: the .pt or the orbax route differs from the "
                           ".ckpt route")


# the kernels the orbax route's blind request must launch
ORBAX_REQUEST_PATH = ("conv5x3", "fused_stage", "fused_stage_bwd",
                      "filter_fit")
ORBAX_FIXTURE = os.path.join("tests", "data", "torch_orbax_fixture.orbax")
ORBAX_DECODE_PASSES = 40


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _leaf_digests(tree, prefix: str = "") -> dict:
    """{dotted key path: sha256, dtype, shape} of a restored tree's arrays
    and numbers, as tests/torch_orbax_fixture.py records them."""
    import hashlib

    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_leaf_digests(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if tree is None:
        return {}
    a = np.ascontiguousarray(np.asarray(tree))
    return {prefix: {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
                     "dtype": a.dtype.str, "shape": list(a.shape)}}


def _orbax_fixture(results: dict) -> None:
    """The committed orbax fixture (written by orbax, OCDBT layout) read
    with the port's reader: every leaf's sha256 as recorded; then the zstd
    decoder's rate over its stored chunks, ORBAX_DECODE_PASSES passes on
    one thread."""
    from babe_tpu_torch import native
    from babe_tpu_torch.utils.orbax_dir import read_orbax, stored_chunks

    root = os.path.dirname(os.path.abspath(__file__))
    fx = os.path.join(root, ORBAX_FIXTURE)
    with open(fx[:-len(".orbax")] + ".json") as f:
        rec = json.load(f)
    t0 = time.perf_counter()
    got = _leaf_digests(read_orbax(fx))
    t_read = time.perf_counter() - t0
    chunks = list(stored_chunks(fx).values())
    sizes = [len(native.zstd_decompress(c)) for c in chunks]
    t0 = time.perf_counter()
    for _ in range(ORBAX_DECODE_PASSES):
        for c in chunks:
            native.zstd_decompress(c)
    dt = time.perf_counter() - t0
    rate = ORBAX_DECODE_PASSES * sum(sizes) / dt / 1e6
    ok = got == rec["leaves"]
    log(f"pt: orbax fixture {ORBAX_FIXTURE} ({_dir_bytes(fx)} bytes, "
        f"OCDBT): {len(got)} leaves, sha256 as recorded {ok}, read_orbax "
        f"{t_read:.3f} s; zstd decode of its {len(chunks)} chunks "
        f"({sum(len(c) for c in chunks)} bytes to {sum(sizes)}) "
        f"{rate:.1f} MB/s over {ORBAX_DECODE_PASSES} passes, one thread, "
        f"host of {smi_line()}")
    results["orbax_fixture"] = {"leaves_equal": ok, "decode_mb_s": rate,
                                "read_s": t_read}
    if not ok:
        bad = sorted(k for k in set(got) | set(rec["leaves"])
                     if got.get(k) != rec["leaves"].get(k))
        raise RuntimeError(f"pt: the orbax fixture decodes to other leaves: "
                           f"{bad[:5]}")


LONG_FS = 44100       # the long request's input rate (resampled to 22.05k)
LONG_SECONDS = 20.0


def _spied(spies: list, runs: list):
    """Patch each (owner, method, label) of ``spies`` to append (label,
    seconds between card syncs) to ``runs``; returns the undo list."""
    import torch

    undo = []
    for owner, name, label in spies:
        orig = getattr(owner, name)

        def timed(*a, _orig=orig, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **k)
            torch.cuda.synchronize()
            runs.append((_label, time.perf_counter() - t0))
            return out

        setattr(owner, name, timed)
        undo.append((owner, name, orig))
    return undo


def phase_long(results: dict, T: int = 15):
    """One blind request with the denoiser on a whole recording (each
    sampler run at ``T`` steps: 15 since the default run gained the
    families phase; the requests phase times the full 35): 20 s of
    seeded 44.1 kHz audio (low-passed tones plus noise) through
    ``BABE.load(ckpt, denoiser_checkpoint=...).enhance(x, 44100,
    denoise=True)`` on the flagship in bf16 and the full-width denoiser
    (conf/tester/blind_bwe.yaml: depth 6, 3 dense layers, 2 stages, 513
    bins, window 1024, hop 256, 5 s segments), both from seeds.  The
    input is resampled to 441000 samples, denoised, its filter estimated
    on the first segment, and restored by the chunk loop.  The counters
    are zeroed just before the request and read just after; every bf16
    path kernel must have launched, and the sampler must have run once
    for the estimate and once per chunk."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.api import BABE
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.models.denoiser import MultiStageDenoiser
    from babe_tpu_torch.sampling.blind import BlindSampler
    from babe_tpu_torch.utils.weights import denoiser_to_flax

    args = default_config(["tester=blind_bwe"])
    fs = int(args.exp.sample_rate)
    t0 = time.perf_counter()
    tmpdir = tempfile.mkdtemp(prefix="babe_smoke_")
    path = _flagship_ckpt(args, tmpdir)
    den = MultiStageDenoiser.from_config(args.tester.denoiser, device="cpu")
    dpath = os.path.join(tmpdir, "denoiser-seed0.ckpt")
    with open(dpath, "wb") as f:
        pickle.dump({"params": denoiser_to_flax(den.net)}, f)
    del den
    m = BABE.load(path, overrides=[f"tester.T={T}"], denoiser_checkpoint=dpath)
    for p_ in (path, dpath):
        os.remove(p_)
    os.rmdir(tmpdir)
    n_den = sum(p.numel() for p in m._denoiser.net.parameters())
    dtype = str(m._tester.model.net.compute_dtype).split(".")[-1]
    log(f"long: flagship (seed 0, {dtype}) and denoiser (seed 0, {n_den} "
        f"parameters) written and loaded on {m.device} in "
        f"{time.perf_counter() - t0:.1f} s; tester.T={T}")
    n_in = int(LONG_SECONDS * LONG_FS)
    x = _lowpassed_audio(n_in, LONG_FS, seed=30)
    x = x + (0.003 * np.random.default_rng(31).standard_normal(n_in)).astype(
        np.float32)
    L = int(math.ceil(n_in * fs / LONG_FS))
    runs: list = []
    den_cls = type(m._denoiser)
    undo = _spied([(BlindSampler, "predict_blind_bwe", "blind"),
                   (BlindSampler, "predict_bwe", "chunk"),
                   (BlindSampler, "predict_bwe_AR", "chunk"),
                   (den_cls, "apply_chunked_ola", "denoiser"),
                   (den_cls, "apply_model", "denoiser segment")], runs)
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, info = m.enhance(x, LONG_FS, denoise=True, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = dict(kernels.LAUNCHES)
    finally:
        for owner, name, orig in undo:
            setattr(owner, name, orig)
    secs = {k: [t for lab, t in runs if lab == k]
            for k in ("blind", "chunk", "denoiser", "denoiser segment")}
    fin = (bool(np.isfinite(out).all()) and np.isfinite(info["fc"]).all()
           and np.isfinite(info["A"]).all())
    sampler_runs = len(secs["blind"]) + len(secs["chunk"])
    log(f"long request ({dtype}, blind + denoise): {n_in} samples at "
        f"{LONG_FS} Hz -> {out.shape[-1]} at {fs} Hz, wall {wall:.2f} s, "
        f"realtime factor {LONG_SECONDS / wall:.3f}x, "
        f"fc={np.round(info['fc'], 1).tolist()} "
        f"A={np.round(info['A'], 2).tolist()}, out shape {out.shape} "
        f"finite={fin}")
    log(f"long: denoiser {sum(secs['denoiser']):.3f} s over "
        f"{len(secs['denoiser segment'])} segments of "
        f"{m._denoiser.segment / fs:g} s (per segment "
        f"{[round(t, 4) for t in secs['denoiser segment']]} s); blind "
        f"step {sum(secs['blind']):.2f} s; chunks "
        f"{[round(t, 2) for t in secs['chunk']]} s; sampler runs "
        f"{sampler_runs} = 1 blind + {len(secs['chunk'])} chunks "
        f"(expected 1 + 3)")
    log(f"launches during the long request: {counts}")
    if not (fin and out.shape == (1, L) and L == 441000):
        raise RuntimeError(f"long request gave shape {out.shape} (want "
                           f"(1, 441000)) or a non-finite result")
    if not (len(secs["blind"]) == 1 and len(secs["denoiser"]) == 1
            and len(secs["chunk"]) == 3):
        raise RuntimeError(f"long request ran {sampler_runs} sampler runs "
                           f"and {len(secs['denoiser'])} denoiser passes "
                           f"(want 1 + 3 and 1)")
    for name in BF16_PATH:
        if counts[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the long "
                               f"path")
    if counts["fused_stage_int8"] or counts["stage_int8_operand"]:
        raise RuntimeError("the bf16 model launched the int8 stage")
    results["long"] = {"wall_s": wall, "rtf": LONG_SECONDS / wall,
                       "denoiser_s": sum(secs["denoiser"]),
                       "blind_s": sum(secs["blind"]),
                       "chunk_s": secs["chunk"]}
    results["launches_long"] = counts
    launches = results.setdefault("launches", {})
    for k in BF16_PATH:
        if k not in DW_KERNELS:
            launches.setdefault(k, counts[k])
    del m
    torch.cuda.empty_cache()


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


# the trained checkpoint's load check answers one blind request at this
# depth (the requests phase times the full 35 steps)
LOAD_CHECK_T = 8


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
        _nccl_step(tr, snap["x"])
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
        _orbax_resume(tr, results)
        del tr, snap
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        m = BABE.load(ckpt, overrides=[f"tester.T={LOAD_CHECK_T}"])
        L, fs = int(m.args.exp.audio_len), m.fs
        x = _lowpassed_audio(L, fs, seed=31)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out, info = m.enhance(x, fs, seed=0)
        torch.cuda.synchronize()
        fin = (bool(np.isfinite(out).all()) and out.shape == (1, L)
               and np.isfinite(info["fc"]).all())
        log(f"train: the checkpoint loaded with BABE.load on "
            f"{m.device} in {t2 - t1:.1f} s; one blind request (tester.T="
            f"{LOAD_CHECK_T}) "
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


def _orbax_resume(tr, results: dict) -> None:
    """The train phase's trainer saved with exp.ckpt_backend=orbax (the
    port's writer: zarr arrays of raw zstd blocks, the plain layout), then
    a fresh trainer of the same config on the card resumed from the
    directory: params, buffers, EMA, Adam's moments, the counts and it
    bit-equal to the saved state (the state, not a further step: the
    weight gradients' atomics make two steps differ)."""
    import shutil

    import torch

    from babe_tpu_torch.setup import setup_diff_parameters, setup_network
    from babe_tpu_torch.training.trainer import Trainer

    t_all = time.perf_counter()
    tr.args.exp["ckpt_backend"] = "orbax"
    tr.ckpt_backend = "orbax"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = tr.save_checkpoint()
    save_s = time.perf_counter() - t0
    nbytes = _dir_bytes(path)
    try:
        t0 = time.perf_counter()
        model = setup_network(tr.args)
        fresh = Trainer(tr.args, None, model, setup_diff_parameters(
            tr.args, cqt_hpf=model.apply_hpf_DC), device=tr.device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = fresh.resume_from_checkpoint(path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)

    def same(a, b):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)

    eq = {"params": same(fresh.params, tr.params),
          "buffers": same(dict(fresh.net.named_buffers()),
                          dict(tr.net.named_buffers())),
          "ema": same(fresh.ema, tr.ema), "mu": same(fresh.mu, tr.mu),
          "nu": same(fresh.nu, tr.nu),
          "counts": (fresh.count, fresh.sched_count, fresh.it)
          == (tr.count, tr.sched_count, tr.it)}
    ok = resumed and all(eq.values())
    log(f"train: the state saved with exp.ckpt_backend=orbax in "
        f"{save_s:.2f} s ({nbytes} bytes, {nbytes / save_s / 1e6:.0f} MB/s),"
        f" a fresh trainer built in {build_s:.2f} s and resumed from it on "
        f"the card in {resume_s:.2f} s ({nbytes / resume_s / 1e6:.0f} MB/s),"
        f" it={fresh.it}; bit-equal: {eq} {'ok' if ok else 'FAIL'}; "
        f"{time.perf_counter() - t_all:.1f} s in all; card: {smi_line()}")
    results["orbax_train"] = {"save_s": save_s, "resume_s": resume_s,
                              "bytes": nbytes, "equal": eq}
    del fresh, model
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError("train: the orbax resume is not bit-equal")


NCCL_K = 4.0  # the NCCL step's bar, in plain steps' run-to-run spreads


def _nccl_step(tr, x) -> None:
    """One flagship step (batch 4, remat, bf16) of the train phase's
    trainer through a world-size-1 NCCL mesh (``parallel/mesh.py``: the
    global batch's draws, the rank's rows, the loss scaled by its share,
    the fp32 all-reduce of the gradients and the loss, the gathered
    statistics) against the plain step from the same state and seed, run
    twice: the loss bit for bit, and the gradients' norm, Adam's moments,
    the params and the EMA within NCCL_K times the two plain steps' own
    spread (the weight gradients' atomics sum in another order each run),
    or NCCL_K float32 roundings of the largest value where that spread is
    smaller (one pair of plain steps may happen to agree).  The trainer's
    state is restored after each step."""
    import socket

    import torch
    import torch.distributed as dist

    from babe_tpu_torch.parallel import mesh as M

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        state = {k: {n: v.detach().clone() for n, v in d.items()}
                 for k, d in (("params", tr.params), ("ema", tr.ema),
                              ("mu", tr.mu), ("nu", tr.nu))}
        counts = (tr.count, tr.sched_count, tr.it)
        gen = tr.gen.get_state()
        plain, outs = tr.mesh, {}
        joined = M.make_mesh(device=tr.device)
        if not (joined.joined and joined.size == 1) or plain.joined:
            raise RuntimeError(f"train nccl: meshes {plain}, {joined}")
        for label, mesh in (("plain", plain), ("plain again", plain),
                            ("nccl", joined)):
            tr.mesh = mesh
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr._step(x)
            torch.cuda.synchronize()
            outs[label] = {
                "s": time.perf_counter() - t0,
                "loss": m["loss"].clone(), "grad_norm": m["grad_norm"].clone(),
                **{k: {n: v.detach().clone()
                       for n, v in getattr(tr, k).items()}
                   for k in state}}
            with torch.no_grad():
                for k, d in state.items():
                    for n, v in d.items():
                        getattr(tr, k)[n].copy_(v)
            tr.count, tr.sched_count, tr.it = counts
            tr.gen.set_state(gen)
        tr.mesh = plain

        def parts(u, k):
            return [u[k]] if torch.is_tensor(u[k]) else list(u[k].values())

        def diff(u, v, k):
            return max(float((p.float() - q.float()).abs().max())
                       for p, q in zip(parts(u, k), parts(v, k)))

        a, a2, b = outs["plain"], outs["plain again"], outs["nccl"]
        keys = ("grad_norm", *state)
        spread = {k: max(diff(a, a2, k), 2.0**-23 * max(
            float(p.float().abs().max()) for p in parts(a, k)))
            for k in keys}
        got = {k: diff(b, a, k) for k in keys}
        ok = torch.equal(a["loss"], b["loss"]) and all(
            got[k] <= NCCL_K * spread[k] for k in keys)
        log(f"train nccl: one flagship step through a world-size-1 NCCL "
            f"mesh ({b['s']:.3f} s) against the plain step ({a['s']:.3f}, "
            f"{a2['s']:.3f} s), loss {float(b['loss']):.6f} (bit-equal "
            f"{torch.equal(a['loss'], b['loss'])}); largest differences "
            f"from the plain step "
            + ", ".join(f"{k} {got[k]:.3e} (plain vs plain, or one "
                        f"rounding, {spread[k]:.3e})"
                        for k in keys) + f": {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("train nccl: the NCCL step differs from the "
                               "plain step beyond its own spread")
    finally:
        dist.destroy_process_group()


# the families phase: its checks run at flagship widths on this short
# segment (card against CPU, as the check phase's), its runs at the full
# 184184 samples; guided and unconditional runs at FAMILY_T steps
FAMILY_CHECK_LEN = 16384
FAMILY_T = 8
# attention on the three deepest levels and the bottleneck, where the frame
# counts are smallest (an override of the shipped config, not a published
# one)
ATTENTION_OV = "network.attention_layers=[0,0,0,0,1,1,1,1]"
# the kernels every training step of a family must launch, and those of a
# guided request
FAMILY_TRAIN = ("conv5x3", "fused_stage", "fused_stage_bwd", "conv_dw",
                "fused_stage_dw")
FAMILY_GUIDED = ("conv5x3", "fused_stage", "fused_stage_bwd", "filter_fit")


def _l2(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / (b.float().norm() + 1e-30))


def _family_compare(label: str, run, tol: float = 1e-3, extra=None) -> dict:
    """``run(dev, dtype)`` -> {name: tensor on the CPU} on the check model
    (for a loss, its per-sample squared errors: one scalar's bf16 rounding
    is a single draw, not a statistic the 1.5x bar can read).
    Each quantity on the card in fp32 against the CPU's fp32 within
    ``tol`` (summation order, as the check phase's flagship-width bar),
    and on the card in bf16 against the CPU's fp32 no worse than 1.5x the
    CPU's own bf16 result (bf16 chaos: two bf16 runs drift apart as far as
    bf16 drifts from fp32).  ``extra``: {label: (dev, dtype, run kwargs)}
    more card runs held the same way against the same references."""
    import torch

    f32, b16 = torch.float32, torch.bfloat16
    out = {(dev, dt): run(dev, dt) for dt in (f32, b16)
           for dev in ("cuda", "cpu")}
    ref = out["cpu", f32]
    cases = [("", out["cuda", f32], out["cuda", b16])]
    for name, kw in (extra or {}).items():
        cases.append((f" {name}", run("cuda", f32, **kw),
                      run("cuda", b16, **kw)))
    good = True
    for tag, c32, c16 in cases:
        for k in ref:
            e32, e_card = _l2(c32[k], ref[k]), _l2(c16[k], ref[k])
            e_cpu = _l2(out["cpu", b16][k], ref[k])
            ok = (bool(torch.isfinite(c32[k]).all())
                  and bool(torch.isfinite(c16[k]).all())
                  and e32 <= tol and e_card <= 1.5 * e_cpu)
            log(f"families check {label}{tag}: {k} card fp32 vs CPU fp32 "
                f"l2_rel={e32:.3e} (tol {tol:g}); bf16 vs CPU fp32: card "
                f"{e_card:.3e}, CPU {e_cpu:.3e} (card within 1.5x) "
                f"{'ok' if ok else 'FAIL'}")
            good &= ok
    if not good:
        raise RuntimeError(f"families check failed: {label}")
    return out


def _grads_of(net) -> "torch.Tensor":
    import torch

    return torch.cat([p.grad.detach().float().flatten().cpu()
                      for p in net.parameters()])


def _family_checks():
    """Each family's result at flagship widths on a FAMILY_CHECK_LEN
    segment, card against CPU (``_family_compare``), on O(1) weights:
    the A-weighted loss and its gradients (remat "full", and on the card
    "save_convs" too), the PD loss with a teacher and its gradients, the
    eps denoiser, the attention network's output, and one guided
    evaluation with sigma_den_estimate (each CPU run forced onto the
    card's fitted filter of its dtype: the fit's end point moves with
    rounding, ROADMAP.md section 3; the card's own fit is logged against
    the CPU's)."""
    import torch

    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM, EDMParams
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.ops.stft import apply_stft
    from babe_tpu_torch.sampling.blind import BlindConfig, BlindSampler
    from babe_tpu_torch.sampling.heun import SamplerConfig
    from babe_tpu_torch.setup import setup_diff_parameters

    Lc = FAMILY_CHECK_LEN
    rng = np.random.default_rng(40)
    x = (0.1 * rng.standard_normal((1, Lc))).astype(np.float32)
    sigma = np.full((1, 1), 0.2, np.float32)
    noise = (sigma * rng.standard_normal((1, Lc))).astype(np.float32)

    def model(ov, seed, remat=True):
        args = default_config(ov + [f"exp.audio_len={Lc}",
                                    f"exp.remat={str(remat).lower()}"])
        m = CQTDiffPlus.from_config(args).init(seed=seed, device="cpu")
        _random_flagship_like(m.net, seed + 1)
        remat_on[m] = remat
        return args, m

    def put(m, dev, dt):
        # remat changes no value, only what is kept: the CPU references
        # run without it (a third less work), the card with it
        m.to(dev)
        m.net.compute_dtype = dt
        m.net.remat = dev != "cpu" and remat_on[m]
        return torch.tensor(x, device=dev)

    remat_on = {}

    # the A-weighted loss, remat "full" and "save_convs"
    t0 = time.perf_counter()
    args, m = model(["diff_params=edm_aweighting"], 41)
    edm = setup_diff_parameters(args, cqt_hpf=m.apply_hpf_DC)

    def aw(dev, dt, policy="full"):
        xt = put(m, dev, dt)
        m.net.remat_policy = policy
        m.net.requires_grad_(True)
        m.net.zero_grad(set_to_none=True)
        e2, _ = edm.loss_fn(None, m.apply, xt, True,
                            sigma=torch.tensor(sigma, device=dev),
                            noise=torch.tensor(noise, device=dev))
        e2.mean().backward()
        return {"loss terms": e2.detach().cpu(), "grads": _grads_of(m.net)}

    _family_compare("A-weighted loss", aw,
                    extra={"save_convs": {"policy": "save_convs"}})
    log(f"families check A-weighted (+ save_convs): "
        f"{time.perf_counter() - t0:.1f} s")

    # the PD loss with a teacher (a second network), stage 0
    t0 = time.perf_counter()
    args, m = model(["diff_params=edm_PD"], 43)
    _, teacher = model(["diff_params=edm_PD"], 45)
    teacher.net.requires_grad_(False)
    pd = setup_diff_parameters(args, cqt_hpf=m.apply_hpf_DC)
    sched = pd.boundaries.flip(0)
    j = torch.tensor([[3]])
    pd_noise = (float(sched[7]) * rng.standard_normal((1, Lc))).astype(
        np.float32)

    def pdl(dev, dt):
        xt = put(m, dev, dt)
        teacher.to(dev)
        teacher.net.compute_dtype = dt
        m.net.requires_grad_(True)
        m.net.zero_grad(set_to_none=True)
        e2, _ = pd.loss_fn_PD(None, m.apply, teacher.apply, xt, 0,
                              j=j.to(dev),
                              noise=torch.tensor(pd_noise, device=dev))
        e2.mean().backward()
        return {"loss terms": e2.detach().cpu(), "grads": _grads_of(m.net)}

    _family_compare("PD loss (teacher, stage 0)", pdl)
    del teacher
    log(f"families check PD: {time.perf_counter() - t0:.1f} s")

    # the eps denoiser
    t0 = time.perf_counter()
    args, m = model(["diff_params=edm_eps"], 47, remat=False)
    m.net.requires_grad_(False)
    eps = setup_diff_parameters(args)

    def epsd(dev, dt):
        xt = put(m, dev, dt)
        with torch.no_grad():
            return {"eps denoiser": eps.denoiser(xt, m.apply, 0.2).cpu()}

    _family_compare("EDMEps", epsd)
    log(f"families check EDMEps: {time.perf_counter() - t0:.1f} s")

    # the attention network's output
    t0 = time.perf_counter()
    args, m = model([ATTENTION_OV], 49, remat=False)
    m.net.requires_grad_(False)
    cn = torch.tensor([[-0.4]])

    def att(dev, dt):
        xt = put(m, dev, dt)
        with torch.no_grad():
            return {"output": m.apply(xt, cn.to(dev)).cpu()}

    _family_compare("attention network", att)
    log(f"families check attention: {time.perf_counter() - t0:.1f} s")

    # one guided evaluation with sigma_den_estimate, the CPU's fit forced
    # onto the card's (per dtype)
    t0 = time.perf_counter()
    args, m = model(["tester.blind_bwe.sigma_den_estimate=0.01"], 51,
                    remat=False)
    m.net.requires_grad_(False)
    tedm = EDM(EDMParams.from_config(args.tester.diff_params))
    scfg, bcfg = SamplerConfig.from_args(args), BlindConfig.from_args(args)
    y = _lowpassed_audio(Lc, 22050, seed=52)[None]
    dn = rng.standard_normal((1, Lc)).astype(np.float32)
    fitted, fits = {}, {}

    def den(dev, dt):
        put(m, dev, dt)
        s = BlindSampler(m.fused_denoiser(tedm), tedm, scfg, bcfg,
                         device=dev)
        forcing = dt in fitted  # the CPU's run comes after the card's
        if forcing:
            own = s.fit_params

            def forced(X, Y, p0):
                fits[dt] = own(X, Y, p0)
                return fitted[dt].to(p0.device)

            s.fit_params = forced
        yt = torch.tensor(y, device=dev)
        sc, p, xd = s._stage(torch.tensor(x, device=dev) + yt, 0.2,
                             bcfg.initial_params(dev), yt,
                             apply_stft(yt, bcfg.nfft), None,
                             den_noise=torch.tensor(dn, device=dev))
        if not forcing:
            fitted[dt] = p.cpu()
        return {"score": sc.cpu(), "denoised": xd.cpu()}

    _family_compare("sigma_den_estimate=0.01 guided evaluation", den)
    for dt, p in fitted.items():
        log(f"families check sigma_den: {str(dt).split('.')[-1]} fit on "
            f"the card fc={np.round(p[0].numpy(), 1).tolist()} A="
            f"{np.round(p[1].numpy(), 2).tolist()}, the CPU's own fc="
            f"{np.round(fits[dt][0].numpy(), 1).tolist()} A="
            f"{np.round(fits[dt][1].numpy(), 2).tolist()}")
    log(f"families check sigma_den: {time.perf_counter() - t0:.1f} s")


def _family_train(label: str, argv: list, want: dict | None):
    """``babe_tpu_torch.train``'s main with ``argv``: each step timed
    between synchronisations with its launches; every FAMILY_TRAIN kernel
    launched in every step (exactly ``want`` a step when given), finite
    losses.  Returns the trainer and the peak memory."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch import train as ttrain
    from babe_tpu_torch.training.trainer import Trainer

    rec = []
    orig = Trainer._step

    def spy(self, x, sigma=None, noise=None, j=None):
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        t1 = time.perf_counter()
        m = orig(self, x, sigma, noise, j)
        torch.cuda.synchronize()
        rec.append({"s": time.perf_counter() - t1, "loss": float(m["loss"]),
                    "nonfinite": bool(m["nonfinite"]),
                    "launches": {k: kernels.LAUNCHES[k] - before[k]
                                 for k in TRAIN_PATH}})
        return m

    Trainer._step = spy
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        tr = ttrain.main(argv)
    finally:
        Trainer._step = orig
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    exp = tr.args.exp
    for i, r in enumerate(rec):
        log(f"families {label} step {i + 1}: {r['s']:.3f} s, loss "
            f"{r['loss']:.5f}, launches {r['launches']}")
    log(f"families {label}: {len(rec)} steps (batch {int(exp.batch)} x "
        f"{int(exp.audio_len)}, remat {tr.net.remat}, "
        f"{str(tr.net.compute_dtype).split('.')[-1]}) in {wall:.1f} s of "
        f"main, peak memory {peak / 2**30:.2f} GiB")
    if (int(exp.batch), int(exp.audio_len), tr.net.compute_dtype) != (
            4, 184184, torch.bfloat16):
        raise RuntimeError(f"families {label}: not the flagship training "
                           f"config")
    for r in rec:
        if r["nonfinite"] or not math.isfinite(r["loss"]):
            raise RuntimeError(f"families {label}: a non-finite step")
        if any(r["launches"][k] <= 0 for k in FAMILY_TRAIN):
            raise RuntimeError(f"families {label}: a path kernel did not "
                               f"launch in a step: {r['launches']}")
        if want is not None and any(r["launches"][k] != want[k]
                                    for k in want):
            raise RuntimeError(f"families {label}: launches "
                               f"{r['launches']}, expected {want} a step")
    return tr, rec, peak


def _counted(label: str, fn, need=()):
    """``fn()`` timed between synchronisations with its launches counted
    (the counters zeroed just before and read just after); every kernel of
    ``need`` must have launched."""
    import torch

    from babe_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
    log(f"families {label}: {sec:.2f} s, launches {counts}")
    missing = [k for k in need if not counts.get(k)]
    if missing:
        raise RuntimeError(f"families {label}: {missing} never launched")
    return out, sec, counts


def phase_families(results: dict):
    """The diffusion families and options beyond plain EDM at the flagship
    (conf/network/cqtdiff+.yaml, 7 octaves x 64 bins, 184184 samples):
    first each held card against CPU at flagship widths on a short segment
    (``_family_checks``), then at full size, training through
    ``babe_tpu_torch.train``'s main (batch 4, bf16, remat) and serving at
    batch 1: the A-weighted EDM (2 steps); PD with a teacher .ckpt written
    by the port's own save_checkpoint from a seeded init (2 steps, the
    teacher's two forward evaluations a step counted), then PD_sample at
    stage 0; EDMEps (2 steps, an unconditional Heun run and a DDIM run at
    FAMILY_T); the attention network (1 step, one blind guided request at
    FAMILY_T); one training step without remat, with "full" and with
    "save_convs" (seconds and peak memory each); one blind guided request
    with sigma_den_estimate = 0.01 at FAMILY_T.  Seconds per step or per
    request and each kernel's launches are logged; a failed check or a
    non-finite result fails the phase."""
    import shutil

    import torch

    from babe_tpu_torch.api import BABE
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.testers.tester import Tester
    from babe_tpu_torch.training.trainer import Trainer
    from babe_tpu_torch.utils.weights import to_flax, to_tree

    t0 = time.perf_counter()
    _family_checks()
    log(f"families checks: {time.perf_counter() - t0:.1f} s")
    out = results.setdefault("families", {})
    tmp = tempfile.mkdtemp(prefix="babe_families_")
    try:
        wavs = os.path.join(tmp, "wavs")
        os.makedirs(wavs)
        _seeded_wavs(wavs, 4, 10.0, 44100, seed=60)

        def argv(name, extra):
            return ["dset=musicnet", f"dset.path={wavs}", "exp=maestro22k_8s",
                    "network=cqtdiff+", f"model_dir={os.path.join(tmp, name)}",
                    "exp.resume=false", "logging.log_interval=1",
                    "logging.save_model=false", "tester.do_test=false",
                    f"tester.T={FAMILY_T}"] + extra

        def gen(seed):
            return torch.Generator(device="cuda").manual_seed(seed)

        def finite(label, z, shape):
            if not (tuple(z.shape) == shape and bool(torch.isfinite(z).all())):
                raise RuntimeError(f"families {label}: not finite or not "
                                   f"{shape}: {tuple(z.shape)}")

        # the A-weighted EDM
        tr, rec, peak = _family_train(
            "A-weighted", argv("aw", ["diff_params=edm_aweighting",
                                      "exp.total_its=2"]), None)
        want = train_launches_per_step(tr.net)
        if any(r["launches"] != want for r in rec):
            raise RuntimeError(f"families A-weighted: launches differ from "
                               f"the network's {want}")
        if not tr.edm.use_aweighting:
            raise RuntimeError("families A-weighted: the loss is not "
                               "A-weighted")
        out["aweighted_s_per_step"] = [r["s"] for r in rec]
        L = int(tr.args.exp.audio_len)
        del tr
        torch.cuda.empty_cache()

        # PD: a teacher from a seeded init, written by save_checkpoint
        targs = default_config(argv("teacher", ["exp.total_its=0"]))
        tm = CQTDiffPlus.from_config(targs)
        teacher_tr = Trainer(targs, None, tm, EDM.from_config(targs),
                             device="cuda")
        ckpt = teacher_tr.save_checkpoint()
        del teacher_tr, tm
        torch.cuda.empty_cache()
        log(f"families PD: teacher {os.path.basename(ckpt)} "
            f"({os.path.getsize(ckpt) / 2**20:.0f} MiB) written by "
            f"Trainer.save_checkpoint from seed 42")
        tr, rec, peak = _family_train(
            "PD", argv("pd", ["diff_params=edm_PD", "exp.total_its=2",
                              f"diff_params.PD.teacher_checkpoint={ckpt}"]),
            None)
        base = train_launches_per_step(tr.net)
        stages = base["fused_stage_bwd"]
        pyr = base["conv5x3"]
        want = dict(base, conv5x3=3 * pyr, fused_stage=base["fused_stage"]
                    + 2 * stages, stage_fwd_operand=base["stage_fwd_operand"]
                    + 2 * stages)
        if tr.teacher is None or any(r["launches"] != want for r in rec):
            raise RuntimeError(f"families PD: launches differ from the "
                               f"network's with the teacher's two forward "
                               f"evaluations {want}")
        out["pd_s_per_step"] = [r["s"] for r in rec]
        tr.net.requires_grad_(False)
        z, sec, _ = _counted(
            "PD_sample (stage 0, 8 ODE steps, batch 1)",
            lambda: tr.edm.PD_sample(gen(61), 1, L, tr.model.apply, 0),
            need=("conv5x3", "fused_stage"))
        finite("PD_sample", z, (1, L))
        out["pd_sample_s"] = sec
        del tr, z
        torch.cuda.empty_cache()

        # EDMEps: training, then Heun (the tester with its own family) and
        # DDIM
        ea = argv("eps", ["diff_params=edm_eps", "exp.total_its=2",
                          f"diff_params.T={FAMILY_T}",
                          "tester.diff_params.same_as_training=true"])
        tr, rec, peak = _family_train("EDMEps", ea, None)
        if any(r["launches"] != train_launches_per_step(tr.net) for r in rec):
            raise RuntimeError("families EDMEps: launches differ from the "
                               "network's")
        out["eps_s_per_step"] = [r["s"] for r in rec]
        tt = Tester(tr.args, tr.model, tr.edm, device="cuda")
        tt.set_variables(to_tree(tr.ema), to_flax(tr.net)[1])
        if tt.edm is not tr.edm:
            raise RuntimeError("families EDMEps: the tester serves another "
                               "family")
        z, sec, _ = _counted(
            f"EDMEps unconditional Heun (T={FAMILY_T}, batch 1)",
            lambda: tt.sampler().predict_unconditional(gen(62), (1, L)),
            need=("conv5x3", "fused_stage"))
        finite("EDMEps Heun", z, (1, L))
        out["eps_heun_s"] = sec
        z, sec, _ = _counted(
            f"EDMEps DDIM (T={tr.edm.T}, batch 1)",
            lambda: tr.edm.reverse_process_ddim(gen(63), (1, L),
                                                tr.model.apply),
            need=("conv5x3", "fused_stage"))
        finite("EDMEps DDIM", z, (1, L))
        out["eps_ddim_s"] = sec
        del tr, tt, z
        torch.cuda.empty_cache()

        # the attention network: one step, one blind guided request
        tr, rec, peak = _family_train(
            "attention", argv("att", [ATTENTION_OV, "exp.total_its=1"]),
            None)
        out["attention_s_per_step"] = [r["s"] for r in rec]
        out["attention_peak_gib"] = peak / 2**30
        tr.net.remat = False  # serving runs without it, as BABE.load builds
        tt = Tester(tr.args, tr.model, tr.edm, device="cuda")
        tt.set_variables(to_tree(tr.ema), to_flax(tr.net)[1])
        y = torch.tensor(_lowpassed_audio(L, 22050, seed=64)[None],
                         device="cuda")
        (z, p), sec, _ = _counted(
            f"attention blind request (T={FAMILY_T}, batch 1)",
            lambda: tt.sampler().predict_blind_bwe(gen(65), y),
            need=FAMILY_GUIDED)
        finite("attention request", z, (1, L))
        out["attention_request_s"] = sec
        del tr, tt, z
        torch.cuda.empty_cache()

        # save_convs beside "full" and no remat: one step each, one warm-up
        sa = default_config(argv("remat", ["exp.total_its=1"]))
        sm = CQTDiffPlus.from_config(sa)
        st = Trainer(sa, None, sm, EDM.from_config(sa, cqt_hpf=sm.apply_hpf_DC),
                     device="cuda")
        xb = np.stack([_lowpassed_audio(L, 22050, seed=66 + i)
                       for i in range(4)])
        st.train_step(xb)
        steps = {}
        for label, remat, policy in (("no remat", False, "full"),
                                     ("full", True, "full"),
                                     ("save_convs", True, "save_convs")):
            st.net.remat, st.net.remat_policy = remat, policy
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            m, sec, counts = _counted(f"train step, {label}",
                                      lambda: st.train_step(xb),
                                      need=FAMILY_TRAIN)
            peak = torch.cuda.max_memory_allocated() / 2**30
            if m["nonfinite"]:
                raise RuntimeError(f"families {label}: a non-finite step")
            steps[label] = {"s": sec, "peak_gib": peak,
                            "fused_stage": counts.get("fused_stage", 0)}
            log(f"families remat {label}: {sec:.3f} s, peak memory "
                f"{peak:.2f} GiB")
        nst = steps["no remat"]["fused_stage"]
        if not (steps["full"]["fused_stage"] == 2 * nst
                and steps["save_convs"]["fused_stage"] == nst):
            raise RuntimeError(f"families remat: K2 launches {steps}: "
                               f"\"full\" must recompute every stage, "
                               f"\"save_convs\" none")
        log("families remat, K2 forward launches a step: "
            + ", ".join(f"{k} {v['fused_stage']}" for k, v in steps.items()))
        out["remat"] = steps
        del st, sm
        torch.cuda.empty_cache()

        # a blind guided request with sigma_den_estimate = 0.01
        ba = default_config(["tester=blind_bwe"])
        path = _flagship_ckpt(ba, tmp)
        m = BABE.load(path, overrides=[
            f"tester.T={FAMILY_T}",
            "tester.blind_bwe.sigma_den_estimate=0.01"])
        if m._tester.blind_cfg.sigma_den_estimate != 0.01:
            raise RuntimeError("families sigma_den: not configured")
        x = _lowpassed_audio(L, 22050, seed=67)
        (xo, info), sec, _ = _counted(
            f"sigma_den_estimate=0.01 blind request (T={FAMILY_T})",
            lambda: m.enhance(x, 22050, seed=0), need=FAMILY_GUIDED)
        if not (np.isfinite(xo).all() and xo.shape == (1, L)
                and np.isfinite(info["fc"]).all()):
            raise RuntimeError("families sigma_den: a non-finite request")
        log(f"families sigma_den: fc={np.round(info['fc'], 1).tolist()} "
            f"A={np.round(info['A'], 2).tolist()}")
        out["sigma_den_request_s"] = sec
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


def phase_iir(results: dict, t: float = 0.5):
    """One guided evaluation of informed BWE at the flagship (seed-0
    weights, bf16, 184184 samples, the blind_bwe tester's guidance) with
    the firwin degradation (order 500) and with each IIR degradation
    (cheby1 of order 6, ripple 0.05; the biquad, Q 0.707; fc 1000 Hz), each
    timed after a warm-up evaluation.  The launch counters are zeroed just
    before the IIR evaluations and read just after: each must launch the
    recursion kernel (csrc/iir.cu) twice, forward and its input gradient,
    and its output be finite."""
    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.diffusion.edm import EDM
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
    from babe_tpu_torch.sampling import degradations as D
    from babe_tpu_torch.sampling.heun import Sampler, SamplerConfig

    base = ["exp=maestro22k_8s", "network=cqtdiff+", "tester=blind_bwe",
            f"tester.bandwidth_extension.filter.fc={IIR_FC}"]
    args = default_config(base)
    fs, L = float(args.exp.sample_rate), int(args.exp.audio_len)
    model = CQTDiffPlus.from_config(args).init(seed=0, device="cpu")
    model.to("cuda")
    model.net.requires_grad_(False)
    edm = EDM.from_config(args)
    s = Sampler(model.fused_denoiser(edm), edm, SamplerConfig.from_args(args),
                device="cuda")
    x0 = torch.tensor(_lowpassed_audio(L, int(fs), seed=50)[None],
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(51)
    x = x0 + t * torch.randn(x0.shape, generator=gen, device="cuda")
    secs, counts = {}, {}
    for ftype, extra in (("firwin", ["tester.bandwidth_extension.filter."
                                     "order=500"]),
                         ("cheby1", ["tester.bandwidth_extension.filter."
                                     "order=6"]),
                         ("biquad", [])):
        a = default_config(base + [
            f"tester.bandwidth_extension.filter.type={ftype}", *extra])
        filt, _ = D.prepare_filter(a, fs)
        deg = D.degradation_from_filter(filt, ftype)
        with torch.no_grad():
            y = deg(x0)
        s._score(x, t, y, deg, gen)  # a warm-up evaluation
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = s._score(x, t, y, deg, gen)
        torch.cuda.synchronize()
        secs[ftype] = time.perf_counter() - t0
        counts[ftype] = kernels.LAUNCHES["lfilter"]
        if not torch.isfinite(out).all():
            raise RuntimeError(f"iir: the {ftype} evaluation is not finite")
        want = 0 if ftype == "firwin" else 2
        if counts[ftype] != want:
            raise RuntimeError(f"iir: the {ftype} evaluation launched the "
                               f"recursion {counts[ftype]} times, not "
                               f"{want}")
    log(f"iir: {L} samples, bf16 flagship, seed-0 weights, t = {t}, one "
        f"guided evaluation: "
        + ", ".join(f"{k} {v:.3f} s ({counts[k]} lfilter launches)"
                    for k, v in secs.items()))
    results.setdefault("launches", {})["lfilter"] = (counts["cheby1"]
                                                     + counts["biquad"])
    results["iir"] = secs


# the cli phase: its modes, in two runs of the CLI at two depths; the
# files each mode writes per test item (the unconditional run's one wav)
# test items per CLI run (a second item repeats each mode's timing)
CLI_ITEMS = 1
CLI_RUNS = ((15, ("blind_bwe", "bwe")),
            (8, ("inpainting", "declipping", "comp_sens", "phase_retrieval",
                 "unconditional")))
CLI_FILES = {
    "blind_bwe": ["blind_bwe_original/{n}.wav", "blind_bwe_degraded/{n}.wav",
                  "blind_bwe_reconstructed/{n}.wav",
                  "blind_bwe_estimate/{n}.wav", "blind_bwe/{n}_rid.npz"],
    "bwe": ["bwe_original/{n}.wav", "bwe_degraded/{n}.wav",
            "bwe_reconstructed/{n}.wav"],
    "inpainting": ["inpainting/{n}.wav"],
    "declipping": ["bwe_declipped/{n}.wav"],
    "comp_sens": ["bwe_cs/{n}.wav"],
    "phase_retrieval": ["bwe_pr/{n}.wav"],
    "unconditional": ["unconditional/unconditional.wav"],
}
CLI_KERNELS = ("conv5x3", "fused_stage", "fused_stage_bwd", "filter_fit")


def _results_finite(res) -> bool:
    """Every array in a mode's result (arrays, or (pred, filter) pairs)
    is finite, and there is at least one."""
    arrs = [np.asarray(a) for item in (res if isinstance(res, list)
                                       else [res])
            for a in (item if isinstance(item, tuple) else (item,))]
    return bool(arrs) and all(np.isfinite(a).all() for a in arrs)


def phase_cli(results: dict):
    """``python -m babe_tpu_torch.test``'s ``main``, in-process, at the
    flagship (exp=maestro22k_8s, network=cqtdiff+, bf16) on seeded weights
    written as a .ckpt and CLI_ITEMS seeded test wav (dset=musicnet, 9 s
    at 22.05 kHz, cropped to 184184 samples by the test set): blind_bwe and
    bwe (firwin, order 500, fc 1000 Hz) at tester.T = 15, then
    inpainting, declipping, comp_sens, phase_retrieval and unconditional
    (2 clips) at tester.T = 8.  The counters are zeroed just before each
    CLI run and read just after; each mode's seconds per item and its
    launches of K1, K2, K2's backward and the fit come from a spy on its
    Tester method.  blind_bwe's seconds are split between card syncs into
    its request (``predict_blind_bwe``) and the host work around it (the
    low-pass, the metrics, the wav writes, the trajectory dump, the
    animation and the filter plot, the host copies).  Fails
    on a missing file, a non-finite result, or a guided mode that did not
    launch K1, K2 and K2's backward (and the fit, for blind_bwe)."""
    import shutil

    import torch

    from babe_tpu_torch import kernels
    from babe_tpu_torch import test as tcli
    from babe_tpu_torch.config import default_config
    from babe_tpu_torch.sampling.blind import BlindSampler
    from babe_tpu_torch.testers import tester as tmod
    from babe_tpu_torch.testers.tester import Tester
    from babe_tpu_torch.utils.logging import MetricsLogger

    methods = {"blind_bwe": "test_blind_bwe", "bwe": "test_bwe",
               "inpainting": "test_inpainting",
               "declipping": "test_declipping",
               "comp_sens": "test_comp_sens",
               "phase_retrieval": "test_phase_retrieval",
               "unconditional": "sample_unconditional"}
    from babe_tpu_torch.utils import logging as ulog

    tmp = tempfile.mkdtemp(prefix="babe_cli_")
    prev = os.environ.pop("BABE_PRECISION", None)
    per_mode: dict = {}
    dumps: list = []  # seconds in the trajectory dumps (compressed .npz)
    save_trajectory = ulog.save_trajectory
    undo = []

    def timed_dump(*a, **k):
        t0 = time.perf_counter()
        out = save_trajectory(*a, **k)
        dumps.append(time.perf_counter() - t0)
        return out

    parts: list = []  # (piece, seconds between card syncs) of a mode
    ulog.save_trajectory = timed_dump
    undo_parts = _spied([
        (BlindSampler, "predict_blind_bwe", "request"),
        (Tester, "apply_lowpass_fcA", "low-pass"),
        (tmod, "lsd", "metrics"), (tmod, "lsd_high_band", "metrics"),
        (tmod, "filter_db_mse", "metrics"), (MetricsLogger, "log", "metrics"),
        (tmod, "write_audio_file", "wav writes"),
        (ulog, "save_trajectory", "trajectory dump"),
        (ulog, "diffusion_spec_animation", "animation"),
        (ulog, "plot_filter_response", "filter plot"),
        (Tester, "_host", "host copies")], parts)
    try:
        base = ["exp=maestro22k_8s", "network=cqtdiff+", "tester=blind_bwe"]
        ckpt = _flagship_ckpt(default_config(base), tmp)
        test_dir = os.path.join(tmp, "test")
        os.makedirs(test_dir)
        _seeded_wavs(test_dir, CLI_ITEMS, 9.0, 22050, seed=40)
        names = sorted(os.path.splitext(f)[0] for f in os.listdir(test_dir))
        out_dir = os.path.join(tmp, "out")
        for mode, meth in methods.items():
            orig = getattr(Tester, meth)

            def spy(self, *a, _orig=orig, _mode=mode, **k):
                torch.cuda.synchronize()
                before = dict(kernels.LAUNCHES)
                dumps.clear()
                parts.clear()
                t0 = time.perf_counter()
                out = _orig(self, *a, **k)
                torch.cuda.synchronize()
                split: dict = {}
                for piece, sec in parts:
                    split[piece] = split.get(piece, 0.0) + sec
                per_mode[_mode] = {
                    "s": time.perf_counter() - t0, "dump_s": sum(dumps),
                    "split": split,
                    "launches": {n: kernels.LAUNCHES[n] - before[n]
                                 for n in CLI_KERNELS}}
                return out

            setattr(Tester, meth, spy)
            undo.append((meth, orig))
        counts = {}
        for T, modes in CLI_RUNS:
            argv = base + [
                f"model_dir={out_dir}", f"tester.checkpoint={ckpt}",
                "dset=musicnet", f"dset.test.path={test_dir}",
                f"dset.test.num_samples={CLI_ITEMS}", f"tester.T={T}",
                "tester.bandwidth_extension.filter.type=firwin",
                "tester.bandwidth_extension.filter.order=500",
                "tester.bandwidth_extension.filter.fc=1000",
                "tester.unconditional.num_samples=2",
                "tester.modes=[" + ",".join(modes) + "]"]
            log(f"cli: python -m babe_tpu_torch.test {' '.join(argv)}")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = tcli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_counts = dict(kernels.LAUNCHES)
            log(f"cli: tester.T={T} run of {list(modes)}: {wall:.1f} s "
                f"(model build and load included); launches {run_counts}")
            for k, v in run_counts.items():
                counts[k] = counts.get(k, 0) + v
            for mode in modes:
                if mode not in res or not _results_finite(res[mode]):
                    raise RuntimeError(f"cli: mode {mode} gave no result or "
                                       f"a non-finite one")
                missing = [f for n in names for f in CLI_FILES[mode]
                           if not os.path.exists(os.path.join(
                               out_dir, "outputs", f.format(n=n)))]
                if missing:
                    raise RuntimeError(f"cli: mode {mode} did not write "
                                       f"{missing}")
                m = per_mode[mode]
                uncond = mode == "unconditional"
                items = 1 if uncond else len(names)
                log(f"cli: {mode} (T={T}): {m['s'] / items:.2f} s per "
                    f"{'run of 2 clips' if uncond else 'item'} (of it "
                    f"{m['dump_s'] / items:.2f} s in trajectory dumps), "
                    f"launches {m['launches']}")
                need = (("conv5x3", "fused_stage") if uncond
                        else ("conv5x3", "fused_stage", "fused_stage_bwd")
                        + (("filter_fit",) if mode == "blind_bwe" else ()))
                for n in need:
                    if m["launches"][n] <= 0:
                        raise RuntimeError(f"cli: mode {mode} never launched "
                                           f"{n}")
        with open(os.path.join(out_dir, "outputs", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            log(f"cli: metrics.jsonl {r['mode']} {r['item']}: lsd "
                f"{r['lsd']:.3f} (degraded {r['lsd_degraded']:.3f}), high "
                f"band {r['lsd_high_band']:.3f} (degraded "
                f"{r['lsd_high_band_degraded']:.3f}), fc "
                f"{np.round(r['fc_est'], 1).tolist()}")
        if len(recs) != len(names) or not all(
                np.isfinite([r["lsd"], r["lsd_high_band"]]).all()
                for r in recs):
            raise RuntimeError("cli: blind_bwe's records are missing or not "
                               "finite")
        results["cli"] = per_mode
        results["launches_cli"] = counts
        # blind_bwe's seconds per item by piece, the rest untimed host work
        b, items = per_mode["blind_bwe"], len(names)
        rest = b["s"] - sum(b["split"].values())
        log("cli: blind_bwe per item: " + ", ".join(
            f"{piece} {sec / items:.3f} s" for piece, sec in
            b["split"].items()) + f", rest {rest / items:.3f} s (of "
            f"{b['s'] / items:.3f} s)")
    finally:
        for owner, name, orig in reversed(undo_parts):
            setattr(owner, name, orig)
        ulog.save_trajectory = save_trajectory
        for meth, orig in undo:
            setattr(Tester, meth, orig)
        if prev is not None:
            os.environ["BABE_PRECISION"] = prev
        shutil.rmtree(tmp, ignore_errors=True)


def _tool_json(module: str, argv: list[str], timeout: float) -> dict:
    """Run ``python -m <module> <argv>`` from the repository root; log its
    output's tail and return the JSON object of its last line.  A non-zero
    exit fails unless the JSON line says why (the caller checks it)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *argv], cwd=repo,
                       capture_output=True, text=True, timeout=timeout)
    lines = r.stdout.strip().splitlines()
    for line in lines[-12:]:
        log(f"  {module.split('.')[-1]}: {line[:300]}")
    if r.returncode not in (0, 1) or not lines:
        raise RuntimeError(f"{module} failed (exit {r.returncode}):\n"
                           f"{r.stderr[-3000:]}")
    out = json.loads(lines[-1])
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_capability(results: dict):
    """The quality gates on trained weights, on the card:
    ``babe_tpu_torch.tools.capability_e2e`` trains the tiny network for its
    own 1500 iterations (the length the gates are calibrated at) on seeded
    sawtooths and serves blind BWE on two low-passed probes at its own
    tester.T = 15 (gate: high-band LSD below the
    degraded input's on every probe), then
    ``babe_tpu_torch.tools.quality_int8 --mode lsd`` serves that checkpoint
    in bf16 and in int8 with every tiny stack on K3 (gate: |mean LSD
    delta| < 0.05 dB, K3 launched).  Both run as their own processes; each
    prints one JSON line, logged here."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="babe_cap_")
    try:
        cap = _tool_json("babe_tpu_torch.tools.capability_e2e",
                         ["--workdir", tmp, "--device", "cuda"], timeout=900)
        log(f"capability: {json.dumps(cap)}")
        its = cap["its"]
        log(f"capability: training {its} its took {cap['train_s']:.1f} s "
            f"({cap['train_s'] / its * 1e3:.1f} ms per iteration, process "
            f"start and data included); blind test {cap['test_s']:.1f} s")
        q = _tool_json("babe_tpu_torch.tools.quality_int8",
                       ["--mode", "lsd", "--workdir", tmp, "--device",
                        "cuda"], timeout=600)
        log(f"quality_int8 --mode lsd: {json.dumps(q)}")
        results["capability"] = {"capability_e2e": cap, "quality_int8": q}
        if not cap["improved_all"]:
            raise RuntimeError("capability: high-band LSD did not improve "
                               "on every probe")
        if not (q["gate_pass"] and q["k3_launches_int8"] > 0):
            raise RuntimeError("capability: the int8 LSD gate failed or K3 "
                               "did not launch")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_distill(results: dict):
    """(Not by default.) The end-to-end distillation proof on the card,
    as its own process: ``babe_tpu_torch.tools.distill_e2e`` at the JAX
    tool's defaults (a tiny teacher trained 1500 iterations on seeded
    sawtooths, a student distilled from it 1000 iterations through
    ``python -m babe_tpu_torch.train diff_params=edm_PD``, boundaries T =
    8), with both of its gates: the PD loss falls at least 2x, and the
    student at T/2 steps tracks the teacher at T within 0.1 sigma_data^2.
    A gate that fails fails the phase."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="babe_pd_")
    try:
        out = _tool_json("babe_tpu_torch.tools.distill_e2e",
                         ["--workdir", tmp, "--device", "cuda"],
                         timeout=1800)
        log(f"distill: {json.dumps(out)}")
        results["distill"] = out
        if not (out["loss_gate"] and out["tracking_gate"]):
            raise RuntimeError(f"distill: a gate failed (loss ratio "
                               f"{out['pd_loss_ratio']}, tracking "
                               f"{out['mse_student_halfsteps_vs_full']} "
                               f"against {out['tracking_budget']})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_gates(results: dict, its: int = 3000, trainings: int = 2):
    """(Not by default.) The int8 gate beyond the tools' own 1500 steps:
    ``trainings`` runs of ``babe_tpu_torch.tools.capability_e2e --its
    {its}`` (each a training of its own: the card's atomics make two runs
    differ), each checkpoint then served by ``quality_int8 --mode lsd`` in
    the port's default int8 (the fused chain, K3) and in the JAX tool's
    configuration (``BABE_INT8_FUSED=0``: the unfused convs, C8, with the
    exact input gradient).  Reported per training, not gated: the gates
    are calibrated at 1500 steps."""
    import shutil

    rows = []
    for k in range(trainings):
        tmp = tempfile.mkdtemp(prefix="babe_gates_")
        try:
            cap = _tool_json("babe_tpu_torch.tools.capability_e2e",
                             ["--workdir", tmp, "--device", "cuda", "--its",
                              str(its)], timeout=1500)
            log(f"gates training {k} ({its} its): {json.dumps(cap)}")
            row = {"capability": cap}
            for name, knobs in (("fused", {}),
                                 ("unfused", {"BABE_INT8_FUSED": "0"})):
                with _Int8Env(knobs):
                    q = _tool_json("babe_tpu_torch.tools.quality_int8",
                                   ["--mode", "lsd", "--workdir", tmp,
                                    "--device", "cuda"], timeout=600)
                log(f"gates training {k}, quality_int8 ({name}): "
                    f"{json.dumps(q)}")
                row[name] = q
            rows.append(row)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    for k, r in enumerate(rows):
        log(f"gates training {k}: high-band LSD "
            f"{r['capability']['lsd_high_band_reconstructed']} (degraded "
            f"{r['capability']['lsd_high_band_degraded']}); int8 mean LSD "
            f"delta fused {r['fused']['lsd_delta_mean']:+.4f} dB, unfused "
            f"{r['unfused']['lsd_delta_mean']:+.4f} dB (bar 0.05)")
    results["gates"] = rows


def _dev_us(e) -> float:
    """An event's own device time in microseconds (the attribute's name
    differs between torch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


PROFILE_PRECISIONS = (("bf16", "bf16", {}), ("int8", "int8", {}),
                      ("int8, JAX API", "int8", INT8_MODES[0][1]))


def phase_profile():
    """Where one guided evaluation of a blind request spends its time, in
    bf16, in int8 on the fused chain and in the JAX API's int8 (the
    unfused convs C8 and Q8; ``PROFILE_PRECISIONS``): the parts timed with
    synchronisation (network forward with the graph kept, filter fit,
    guidance backward), then one whole stage under torch.profiler (kernel
    time by name, launches and the device's busy share)."""
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
    for prec, precision, knobs in PROFILE_PRECISIONS:
        with _Int8Env(knobs):
            model.net.set_precision(precision)
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
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases",
                   default="identify,kernels,probe,check,requests,"
                           "int8modes,pt,long,train,families,iir,quality,"
                           "cli,capability",
                   help="comma list; 'profile' (not run by default) breaks "
                        "one guided evaluation down, 'q8' (nor this) checks "
                        "and times Q8 alone with its parts, 'gates' (nor "
                        "this) runs the int8 gate at 3000 training steps, "
                        "'distill' (nor this) the end-to-end distillation "
                        "proof")
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
    seconds: dict = {}

    def timed(name, fn):
        """Run one phase and log its seconds on a line of its own."""
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")

    if {"identify", "kernels", "probe", "train", "cli", "capability",
            "q8"} & set(phases):
        timed("identify", lambda: phase_identify(kernels))
    for name, fn in (("kernels", phase_kernels), ("probe", phase_probe),
                     ("check", lambda _: phase_check()),
                     ("requests", phase_requests),
                     ("int8modes", phase_int8modes), ("pt", phase_pt),
                     ("long", phase_long), ("train", phase_train),
                     ("families", phase_families), ("iir", phase_iir),
                     ("quality", phase_quality), ("cli", phase_cli),
                     ("capability", phase_capability),
                     ("gates", phase_gates), ("distill", phase_distill),
                     ("profile", lambda _: phase_profile()),
                     ("q8", phase_q8)):
        if name in phases:
            timed(name, lambda: fn(results))
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
            **{k: r[k] for k in ("eager_ms", "device_ms",
                                 "library_device_ms", "eval_ms") if k in r},
            "check": "ok" if r else "not run",
            "launches_from": LAUNCHES_FROM.get(name, (
                "the bf16 requests" if "requests" in phases
                else "the long request")),
            "per": PER.get(name, "one guided evaluation, bf16, main-path "
                                 "shapes")})
    total = time.perf_counter() - t_start
    log("phases, seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in seconds.items())
        + f"; outside them {total - sum(seconds.values()):.1f}")
    log(f"chip_smoke: {total:.1f} s in all, the kernels' build included")
    log(f"card: {smi_line()}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
