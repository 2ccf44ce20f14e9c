"""Per-launch operations and bytes of the port's stage kernels, from shapes.

A launch works on B items of (F, T) positions and C channels at the stage's
(5,3) kernel (15 taps, C in and C out).  Each input byte is counted once and
each output byte once, whatever the kernel reads again; the per-item
vectors (the stage's scale a and gate s, the moments) are fp32.  ``act`` is
the activations' dtype (bf16 on the served path).

  fused_stage        K2: y = (x + conv(gelu(x a)) s) / sqrt 2 and the moments
                     of y; with ``writes_conv`` also the conv output c (kept
                     for the backward when a gradient is wanted)
  fused_stage_bwd    K2's backward to the input: reads x, y, c and g_y,
                     writes dx; its operand pass included
  fused_stage_int8   K3: K2's forward with the conv in int8 (int8 kernel),
                     the moments and the per-channel amax of y
  fused_stage_dw     the stage's weight gradient: reads x, y and g_y,
                     writes dW (fp32); its operand pass included
"""

from __future__ import annotations

from perfbench.counts import DTYPE_BYTES

TAPS = 15


def conv_ops(B: int, F: int, T: int, C: int) -> float:
    return 2.0 * B * F * T * C * C * TAPS


def fused_stage(B, F, T, C, act="bf16", writes_conv=True):
    e = DTYPE_BYTES[act]
    act_tensors = 3 if writes_conv else 2  # x in; y (and c) out
    nbytes = (act_tensors * B * F * T * C * e + TAPS * C * C * e
              + 4 * 4 * B * C)             # a, s in; two moments out
    return conv_ops(B, F, T, C), nbytes, act


def fused_stage_bwd(B, F, T, C, act="bf16"):
    e = DTYPE_BYTES[act]
    nbytes = (5 * B * F * T * C * e + TAPS * C * C * e
              + 6 * 4 * B * C)             # a, s, g_mom in; da, ds out
    return conv_ops(B, F, T, C), nbytes, act


def fused_stage_int8(B, F, T, C, act="bf16"):
    e = DTYPE_BYTES[act]
    nbytes = (2 * B * F * T * C * e + TAPS * C * C    # int8 kernel
              + 4 * (2 * C + 1) * B + 4 * 3 * B * C)  # scales in; moments out
    return conv_ops(B, F, T, C), nbytes, "int8"


def fused_stage_dw(B, F, T, C, act="bf16"):
    e = DTYPE_BYTES[act]
    nbytes = (3 * B * F * T * C * e + 4 * 4 * B * C
              + TAPS * C * C * 4)          # dW out in fp32
    return conv_ops(B, F, T, C), nbytes, act


KERNELS = {"fused_stage": fused_stage, "fused_stage_bwd": fused_stage_bwd,
           "fused_stage_int8": fused_stage_int8,
           "fused_stage_dw": fused_stage_dw}
