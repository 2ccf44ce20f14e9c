"""The general frequency-dilated conv (K4), with its plain version.

Counterpart of ``babe_tpu/ops/pallas_conv.py``: ``dilated_conv_nhwc(x, w,
dilation)`` is a 'SAME' channels-last conv with any odd kernel (kf, kt) and
dilation (df, dt), fp32 accumulation, output in x's dtype.  On a CUDA tensor
it launches ``csrc/dilated_conv.cu`` (odd kernels up to 7, bf16 or fp32, any
F, T and C: the TPU kernel's tiling limits do not apply); on a CPU tensor it
runs the plain ``conv_ref`` (``conv_kernels.conv_taps``, of which K1's plain
version is the (5,3) case).  Its gradient is an autograd Function: dx is K4
again on the cotangent with the kernel flipped and its in/out channels
swapped, dw the ``conv_dw`` kernel (plain version
``conv_kernels.conv_dw_ref``).  There is no fallback: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from babe_tpu_torch import kernels as _k
from babe_tpu_torch.ops.conv_kernels import _conv_dw_any, _flip_io
from babe_tpu_torch.ops.conv_kernels import conv_taps as conv_ref


def _conv_any(x, w, dilation):
    if x.is_cuda:
        return _k.launch_dilated_conv(x.contiguous(), w.contiguous(),
                                      dilation)
    return conv_ref(x, w, dilation)


class _DilatedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        ctx.dilation = dilation
        return _conv_any(x, w, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv_any(g, _flip_io(w), ctx.dilation)
        if ctx.needs_input_grad[1]:
            dw = _conv_dw_any(x, g, w.shape[:2], ctx.dilation).to(w.dtype)
        return dx, dw, None


def dilated_conv_nhwc(x: torch.Tensor, w: torch.Tensor,
                      dilation=(1, 1)) -> torch.Tensor:
    """'SAME' NHWC conv, odd kernel (kf, kt) HWIO, dilation (df, dt); fp32
    accumulation, output in x.dtype (w is cast to it, and its gradient
    comes back in it)."""
    if w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"dilated_conv_nhwc: w {tuple(w.shape)} does not "
                         f"fit x {tuple(x.shape)}")
    if w.shape[0] % 2 == 0 or w.shape[1] % 2 == 0:
        raise ValueError(f"dilated_conv_nhwc: kernel {tuple(w.shape[:2])} "
                         f"must have odd sizes")
    dil = tuple(int(v) for v in dilation)
    if len(dil) != 2 or min(dil) < 1:
        raise ValueError(f"dilated_conv_nhwc: dilation {dilation}")
    return _DilatedConv.apply(x, w.to(x.dtype), dil)
