"""The network's convolutions: the hand kernels and their plain versions.

Counterpart of ``babe_tpu/ops/conv_kernels.py``.  Layout is channels-last
(B, F, T, C) with HWIO kernels, as in the JAX package.

  * ``conv5x3_dilated`` (K1): 'SAME' (5,3) conv with dilation (d,1).  On a
    CUDA tensor it launches ``csrc/conv5x3.cu``; on a CPU tensor it runs the
    plain ``conv_ref``.  Its backward is K1 again on the cotangent with the
    kernel flipped and its in/out channels swapped.
  * ``fused_stage`` (K2): one ResnetBlock dilation stage
    h = gelu(x*a); y = (x + conv5x3_d(h, w)*s)/sqrt2; moments [sum y,
    sum y^2] per (B, C).  CUDA tensors launch ``csrc/fused_stage.cu``; CPU
    tensors run ``dil_stage_ref``.  The backward returns dx, da and ds (the
    moments feed the next stage's group norm, so their cotangent is folded
    into y's and a, s carry gradient back to x through earlier moments):
    on CUDA one launch of the same tile in its backward mode (the conv
    transpose with the vjp's elementwise chain fused around it), on the
    CPU ``dil_stage_bwd_ref``.

There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from babe_tpu_torch import kernels as _k

SQRT2 = math.sqrt(2.0)


# --------------------------------------------------------------- plain convs


def conv_ref(x: torch.Tensor, w: torch.Tensor, d: int = 1) -> torch.Tensor:
    """Plain 'SAME' (5,3) conv with dilation (d,1): the 15 taps as shifted
    matmuls, fp32 accumulation, output in x.dtype (K1's plain version)."""
    B, F, T, C = x.shape
    kf_n, kt_n, Ci, N = w.shape
    assert (kf_n, kt_n) == (5, 3) and Ci == C, (tuple(w.shape), C)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 2 * d, 2 * d))
    wf = w.to(x.dtype).float()
    acc = x.new_zeros((B, F, T, N), dtype=torch.float32)
    for kf in range(5):
        for kt in range(3):
            acc = acc + torch.matmul(
                xp[:, kf * d:kf * d + F, kt:kt + T, :], wf[kf, kt])
    return acc.to(x.dtype)


def conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv as a matmul (w: [1,1,Cin,Cout]); output in x.dtype.  The
    matmul accumulates in fp32 on both the CPU and the card."""
    return torch.matmul(x, w[0, 0].to(x.dtype))


# ------------------------------------------------------------------ gelu

# erf(z) ~ z * P(z^2): the JAX package's degree-10 fit on |z| <= 3.2
_ERF_C = (1.1283750399e+00, -3.7607088364e-01, 1.1265245796e-01,
          -2.6595735634e-02, 5.0087573199e-03, -7.4968982878e-04,
          8.6683659408e-05, -7.3661495009e-06, 4.2725490474e-07,
          -1.4950546990e-08, 2.3633496703e-10)
_INV_SQRT2PI = 0.3989422804014327


def _erf_poly(z):
    v = z * z
    p = torch.full_like(z, _ERF_C[-1])
    for c in _ERF_C[-2::-1]:
        p = p * v + c
    return z * p


def _gelu_impl(x: torch.Tensor) -> torch.Tensor:
    """gelu with the polynomial erf, fp32 inside, output in x.dtype."""
    xf = x.float()
    z = torch.clamp(xf * 0.7071067811865475, -3.2, 3.2)
    return (0.5 * xf * (1.0 + _erf_poly(z))).to(x.dtype)


def _gelu_deriv(x: torch.Tensor) -> torch.Tensor:
    """gelu'(x) = 0.5*(1+erf(x/sqrt2)) + x*phi(x), same erf polynomial; fp32."""
    xf = x.float()
    z = torch.clamp(xf * 0.7071067811865475, -3.2, 3.2)
    return 0.5 * (1.0 + _erf_poly(z)) + xf * (
        _INV_SQRT2PI * torch.exp(-0.5 * xf * xf))


class _GeluPoly(torch.autograd.Function):
    """Polynomial-erf gelu with the analytic derivative as its backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_impl(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * _gelu_deriv(x)).to(g.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu; bf16 compute uses the polynomial erf (|err| ~1e-5,
    below bf16 resolution), fp32 the library erf."""
    if x.dtype == torch.bfloat16:
        return _GeluPoly.apply(x)
    return torch.nn.functional.gelu(x, approximate="none")


# ------------------------------------------------------------------- K1


def _flip_io(w: torch.Tensor) -> torch.Tensor:
    """Kernel of the input gradient: flipped taps, in/out channels swapped."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _conv_any(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    if x.is_cuda:
        return _k.launch_conv5x3(x.contiguous(), w.to(x.dtype).contiguous(), d)
    return conv_ref(x, w, d)


class _Conv5x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, d):
        ctx.save_for_backward(w)
        ctx.d = d
        return _conv_any(x, w, d)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return _conv_any(g.to(w.dtype), _flip_io(w), ctx.d), None, None


def conv5x3_dilated(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """'SAME' NHWC conv, kernel (5,3), dilation (d,1); fp32 accumulation,
    output in x.dtype.  Input gradient only: the weight gradient is not
    implemented yet, so a weight that requires grad raises."""
    B, F, T, C = x.shape
    assert tuple(w.shape[:3]) == (5, 3, C), (tuple(w.shape), C)
    if w.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "conv5x3_dilated: the weight gradient is not implemented "
            "(freeze the parameters with requires_grad_(False))")
    return _Conv5x3.apply(x, w.to(x.dtype), int(d))


# ------------------------------------------------------------------- K2


def _bcast(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype)[:, None, None, :]


def _sqrt2(x: torch.Tensor) -> torch.Tensor:
    """sqrt(2) rounded to x's dtype, as the reference divides by it."""
    return torch.tensor(SQRT2, dtype=x.dtype, device=x.device)


def _dil_stage_parts(x, a, s, w, d):
    dt = x.dtype
    h = _gelu_impl(x * _bcast(a, dt))
    c = conv_ref(h, w.to(dt), d)
    y = (x + c * _bcast(s, dt)) / _sqrt2(x)
    y32 = y.float()
    mom = torch.stack([y32.sum((1, 2)), (y32 * y32).sum((1, 2))])
    return y, mom, c


def dil_stage_ref(x, a, s, w, d: int):
    """Plain version of K2 (the math of the JAX ``_dil_stage_ref`` on
    unpadded tensors).  x (B,F,T,C); a, s (B,C) fp32; w (5,3,C,C).
    Returns (y in x.dtype, mom (2,B,C) fp32)."""
    y, mom, _ = _dil_stage_parts(x, a, s, w, d)
    return y, mom


def dil_stage_bwd_ref(x, a, s, w, y, c, g_y, g_mom, d: int):
    """Plain version of K2's backward (the vjp of the JAX ``_dil_stage_ref``
    with respect to x, a and s).  y and c are the stage's output and conv
    output; g_y, g_mom the cotangents of y and of the moments.  Returns
    (dx in x.dtype, da, ds fp32)."""
    dt = x.dtype
    # moments -> output cotangent: d(sum y)/dy = 1, d(sum y^2)/dy = 2y
    g = g_y + (g_mom[0][:, None, None, :]
               + 2.0 * y.float() * g_mom[1][:, None, None, :]).to(dt)
    g_pre = g / _sqrt2(x)
    ds = (g_pre.float() * c.float()).sum((1, 2))
    dh = conv_ref(g_pre * _bcast(s, dt), _flip_io(w.to(dt)), d)
    a_b = _bcast(a, dt)
    du = (dh.float() * _gelu_deriv(x * a_b)).to(dt)
    dx = g_pre + du * a_b
    da = (du.float() * x.float()).sum((1, 2))
    return dx, da, ds


class _FusedStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, s, w, d):
        need_conv = any(ctx.needs_input_grad[:3])
        a, s, w = a.float(), s.float(), w.to(x.dtype)
        if x.is_cuda:
            y, mom, c = _k.launch_fused_stage(
                x.contiguous(), a.contiguous(), s.contiguous(),
                w.contiguous(), d, want_conv=need_conv)
        else:
            y, mom, c = _dil_stage_parts(x, a, s, w, d)
        ctx.save_for_backward(x, a, s, w, y, c if need_conv else None)
        ctx.d = d
        return y, mom

    @staticmethod
    def backward(ctx, g_y, g_mom):
        x, a, s, w, y, c = ctx.saved_tensors
        if x.is_cuda:
            dx, ds, da = _k.launch_fused_stage_bwd(
                g_y.to(x.dtype).contiguous(), g_mom.float().contiguous(),
                y, x.contiguous(), c, a.contiguous(), s.contiguous(),
                _flip_io(w), ctx.d)
        else:
            dx, da, ds = dil_stage_bwd_ref(x, a, s, w, y, c, g_y, g_mom,
                                           ctx.d)
        return dx, da, ds, None, None


def fused_stage(x, a, s, w, d: int):
    """One fused ResnetBlock dilation stage: (y, mom).  See module doc."""
    B, F, T, C = x.shape
    assert tuple(w.shape) == (5, 3, C, C), (tuple(w.shape), C)
    assert tuple(a.shape) == (B, C) and tuple(s.shape) == (B, C)
    if w.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "fused_stage: the weight gradient is not implemented "
            "(freeze the parameters with requires_grad_(False))")
    return _FusedStage.apply(x, a, s, w, int(d))
