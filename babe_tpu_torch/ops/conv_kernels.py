"""The network's convolutions: the hand kernels and their plain versions.

Counterpart of ``babe_tpu/ops/conv_kernels.py``.  Layout is channels-last
(B, F, T, C) with HWIO kernels, as in the JAX package.

  * ``conv5x3_dilated`` (K1): 'SAME' (5,3) conv with dilation (d,1).  On a
    CUDA tensor it launches ``csrc/conv5x3.cu``; on a CPU tensor it runs the
    plain ``conv_ref``.  Its backward is K1 again on the cotangent with the
    kernel flipped and its in/out channels swapped (dx), and ``conv_dw``
    (``csrc/conv_dw.cu``; plain version ``conv_dw_ref``) for the weight.
  * ``fused_stage`` (K2): one ResnetBlock dilation stage
    h = gelu(x*a); y = (x + conv5x3_d(h, w)*s)/sqrt2; moments [sum y,
    sum y^2] per (B, C).  CUDA tensors launch ``csrc/fused_stage.cu`` (in
    bf16 an operand pass forming h, ``stage_gelu_ref``'s kernel, then the
    sm_90a stage engine; else the tile); CPU tensors run
    ``dil_stage_ref``.  The backward returns dx, da and ds (the
    moments feed the next stage's group norm, so their cotangent is folded
    into y's and a, s carry gradient back to x through earlier moments):
    on CUDA one launch of the conv transpose with the vjp's elementwise
    chain fused around it (in bf16 the sm_90a engine, else the tile's
    backward mode; the launcher forms the layout its route reads from w),
    on the CPU ``dil_stage_bwd_ref``.  The weight's gradient is
    ``fused_stage_dw`` (``csrc/conv_dw.cu``; plain version
    ``dil_stage_dw_ref``): an operand pass forms gelu(x*a) and the conv
    output's cotangent into scratch (``stage_dw_operands_ref``), then
    ``conv_dw``'s GEMM reduces them; on CUDA that pass also forms the
    engine's input, once for both.
  * ``fused_stage_int8`` (K3): the same stage with the conv in int8:
    q = int8(gelu6(x*a) * 127/bound), acc = conv5x3_d(q, qw) in int32,
    y = x/sqrt2 + acc*post in fp32, moments [sum y, sum y^2, max |y|] of
    the fp32 y.  CUDA tensors launch ``csrc/fused_stage_int8.cu`` (for
    bf16 x an operand pass forming q, ``stage_quant_ref``'s kernel, then
    the stage engine in int8; else the tile); CPU tensors run
    ``dil_stage_int8_ref``.  The backward is straight-through:
    the vjp of the exact stage (K2 recomputed, then K2's backward) at the
    int8 forward's inputs; the bound gets no gradient.  Its weight gradient
    is the exact stage's (``fused_stage_dw``), as the JAX ``_fused_i8_bwd``
    gives it: quantization-aware training keeps the int8 forward.
  * ``conv_int8``, ``conv_int8_hinted`` and ``dot1x1_int8``: the JAX
    package's unfused int8 convs.  The activation is quantized per item
    (``quant_act_per_item``: a dynamic amax; ``quant_act_with_scale``: an
    analytic bound known before the activation), the kernel per output
    channel; the int8 products accumulate in int32 and are rescaled by
    s_x[b] * s_w[n] into the input's dtype.  On CUDA the quantizers are
    Q8 (``csrc/quant_int8.cu``: ``act_quant_dyn``, the dynamic amax and
    quantize in one launch, and ``act_quant`` at a bound), the (5,3)
    conv C8 (``csrc/conv_int8.cu``, ``conv_int8``: the stage engine's int8
    loop or a tile, with the rescale in its epilogue) and the 1x1 product
    ``torch._int_mm`` (P1's GEMM at the shapes it does not take, K
    zero-padded to a multiple of 32) rescaled by Q8's ``act_rescale``;
    ``conv_int8`` with any other odd kernel or dilation forms the int8
    im2col and runs it through that product and the rescale (the JAX
    package computes these in XLA); on the CPU their
    plain versions (``conv_int8_acc_ref``: the conv in float64 on the int
    values, exact).  The backward is straight-through from the saved
    int8 activation (never x, except the 1x1's plain vjp): dw = g (x)
    dequant(qx) (``conv_dw``), dx the exact transpose, or with the int8
    backward on (``BABE_INT8_BWD=1``) the int8 conv of g with the flipped,
    io-swapped kernel on per-item scales; ``exact_backward()`` wins over
    that knob.

The knobs are the JAX package's environment variables, read into an
``Int8Config`` when a network's precision is set (``Int8Config.from_env``):
``BABE_INT8_SCALE`` (bound/amax), ``BABE_INT8_MINC`` (96 under bound, 128
under amax), ``BABE_INT8_OPS`` (conv/all), ``BABE_INT8_FUSED`` (the fused
K3 chain, the port's default "1"; "0" the unfused convs) and
``BABE_INT8_BWD``.  ``BABE_INT8_FUSED=0 BABE_INT8_BWD=1`` is the JAX API's
``precision="int8"``.

There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import torch

from babe_tpu_torch import kernels as _k

SQRT2 = math.sqrt(2.0)


# --------------------------------------------------------------- plain convs


def conv_taps(x: torch.Tensor, w: torch.Tensor,
              dilation=(1, 1)) -> torch.Tensor:
    """Plain 'SAME' conv with odd kernel (kf, kt) and dilation (df, dt): the
    taps as shifted matmuls, fp32 accumulation, output in x.dtype (K4's
    plain version, ``pallas_conv.conv_ref``)."""
    B, F, T, C = x.shape
    kf, kt, Ci, N = w.shape
    assert kf % 2 == 1 and kt % 2 == 1 and Ci == C, (tuple(w.shape), C)
    df, dt = (int(v) for v in dilation)
    pf, pt = (kf - 1) // 2 * df, (kt - 1) // 2 * dt
    xp = torch.nn.functional.pad(x.float(), (0, 0, pt, pt, pf, pf))
    wf = w.to(x.dtype).float()
    acc = x.new_zeros((B, F, T, N), dtype=torch.float32)
    for i in range(kf):
        for j in range(kt):
            acc = acc + torch.matmul(
                xp[:, i * df:i * df + F, j * dt:j * dt + T, :], wf[i, j])
    return acc.to(x.dtype)


def conv_ref(x: torch.Tensor, w: torch.Tensor, d: int = 1) -> torch.Tensor:
    """Plain 'SAME' (5,3) conv with dilation (d,1) (K1's plain version)."""
    assert tuple(w.shape[:3]) == (5, 3, x.shape[3]), (tuple(w.shape),
                                                       x.shape[3])
    return conv_taps(x, w, (d, 1))


def conv_dw_ref(x: torch.Tensor, g: torch.Tensor, kshape,
                dilation=(1, 1)) -> torch.Tensor:
    """Plain weight gradient of a 'SAME' conv with odd kernel ``kshape`` and
    dilation (df, dt) (``conv_dw``'s plain version): per tap (i, j) the fp32
    sum over every position of the shifted input times the output
    cotangent, dW[i,j,c,n] = sum_{b,f,t} x[b, f+(i-PF)df, t+(j-PT)dt, c] *
    g[b,f,t,n].  Returns (KF, KT, C, N) fp32."""
    kf, kt = (int(v) for v in kshape)
    df, dt = (int(v) for v in dilation)
    B, F, T, C = x.shape
    N = g.shape[-1]
    pf, pt = (kf - 1) // 2 * df, (kt - 1) // 2 * dt
    xp = torch.nn.functional.pad(x.float(), (0, 0, pt, pt, pf, pf))
    g2 = g.float().reshape(-1, N)
    dw = x.new_empty((kf, kt, C, N), dtype=torch.float32)
    for i in range(kf):
        for j in range(kt):
            xs = xp[:, i * df:i * df + F, j * dt:j * dt + T, :]
            dw[i, j] = xs.reshape(-1, C).t() @ g2
    return dw


def _conv_dw_any(x, g, kshape, dilation) -> torch.Tensor:
    """The weight gradient in fp32: ``conv_dw`` on CUDA, else the plain
    version."""
    if x.is_cuda:
        return _k.launch_conv_dw(x.contiguous(), g.to(x.dtype).contiguous(),
                                 kshape, dilation)
    return conv_dw_ref(x, g, kshape, dilation)


# ------------------------------------------------------- save_convs remat


class ConvTape:
    """The conv outputs of one rematerialized block under
    ``remat_policy="save_convs"`` (the JAX ``nn.remat`` policy
    ``save_only_these_names("conv_out")``, which saves what ``Conv2d``
    tags): the block runs under ``active()``.  On its first pass every conv
    of a ``Conv2d`` keeps its output, and so does every fused dilation
    stage (K2) its conv output c: the JAX default path runs each stage's
    (5,3) conv as a ``Conv2d`` (``H_{i}``), whose output carries the tag.
    When the backward recomputes the block, each conv returns its kept
    output instead of running again, and each stage forms y and its
    moments from its kept c with the stage's residual tail
    (``_stage_tail``), without K2's forward.  A conv's backward needs its
    input and weight, not its output, so it is unchanged; the elementwise
    work around the convs is recomputed."""

    def __init__(self):
        self.outs: list[torch.Tensor] = []
        self.pos: int | None = None  # None while recording

    @contextlib.contextmanager
    def active(self):
        global _TAPE
        prev, _TAPE = _TAPE, self
        try:
            yield
        finally:
            _TAPE = prev
            self.pos = 0

    @property
    def replaying(self) -> bool:
        return self.pos is not None

    def keep(self, t: torch.Tensor) -> None:
        self.outs.append(t.detach())

    def kept(self) -> torch.Tensor:
        y = self.outs[self.pos]
        self.pos += 1
        return y.detach()

    def take(self, compute):
        if self.replaying:
            return self.kept()
        y = compute()
        self.keep(y)
        return y


_TAPE: ConvTape | None = None


def _taped(compute):
    """``compute()``, or inside an active ``ConvTape`` its kept output."""
    return compute() if _TAPE is None else _TAPE.take(compute)


class _Conv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w2):
        ctx.save_for_backward(x, w2)
        return _taped(lambda: torch.matmul(x, w2))

    @staticmethod
    def backward(ctx, g):
        x, w2 = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w2.t())
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw


def conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv as a matmul (w: [1,1,Cin,Cout]); output in x.dtype.  The
    matmul accumulates in fp32 on both the CPU and the card; its backward
    is the matmul's own (dx = g w^T, dw = x^T g)."""
    return _Conv1x1.apply(x, w[0, 0].to(x.dtype))


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


def _conv_any(x: torch.Tensor, w: torch.Tensor, d: int,
              transposed: bool = False) -> torch.Tensor:
    """K1, or with ``transposed`` K1 with w flipped and io-swapped (the
    input gradient of a conv with kernel w)."""
    if x.is_cuda:
        return _k.launch_conv5x3(x.contiguous(), w.to(x.dtype).contiguous(), d,
                                 transposed)
    return conv_ref(x, _flip_io(w) if transposed else w, d)


class _Conv5x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, d):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        ctx.d = d
        return _taped(lambda: _conv_any(x, w, d))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv_any(g, w, ctx.d, transposed=True)
        if ctx.needs_input_grad[1]:
            dw = _conv_dw_any(x, g, (5, 3), (ctx.d, 1)).to(w.dtype)
        return dx, dw, None


def conv5x3_dilated(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """'SAME' NHWC conv, kernel (5,3), dilation (d,1); fp32 accumulation,
    output in x.dtype.  The weight gradient comes back in x's dtype (the
    cast to it carries it to the parameter's)."""
    B, F, T, C = x.shape
    assert tuple(w.shape[:3]) == (5, 3, C), (tuple(w.shape), C)
    return _Conv5x3.apply(x, w.to(x.dtype), int(d))


# ------------------------------------------------------------------- K2


def _bcast(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype)[:, None, None, :]


def _sqrt2(x: torch.Tensor) -> torch.Tensor:
    """sqrt(2) rounded to x's dtype, as the reference divides by it."""
    return torch.tensor(SQRT2, dtype=x.dtype, device=x.device)


def stage_gelu_ref(x, a):
    """The conv input of a K2 stage, h = gelu(x*a) in x's dtype (x*a
    rounded first): the plain version of ``stage_fwd_operand``."""
    return _gelu_impl(x * _bcast(a, x.dtype))


def _stage_tail(x, s, c):
    """A stage's residual tail from its conv output c: y = (x + c*s) /
    sqrt2 in x's dtype, and the moments [sum y, sum y^2] per (B, C)."""
    y = (x + c * _bcast(s, x.dtype)) / _sqrt2(x)
    y32 = y.float()
    mom = torch.stack([y32.sum((1, 2)), (y32 * y32).sum((1, 2))])
    return y, mom


def _dil_stage_parts(x, a, s, w, d):
    h = stage_gelu_ref(x, a)
    c = conv_ref(h, w.to(x.dtype), d)
    y, mom = _stage_tail(x, s, c)
    return y, mom, c


def dil_stage_ref(x, a, s, w, d: int):
    """Plain version of K2 (the math of the JAX ``_dil_stage_ref`` on
    unpadded tensors).  x (B,F,T,C); a, s (B,C) fp32; w (5,3,C,C).
    Returns (y in x.dtype, mom (2,B,C) fp32)."""
    y, mom, _ = _dil_stage_parts(x, a, s, w, d)
    return y, mom


def _stage_gpre(x, y, g_y, g_mom):
    """The cotangent of a stage's pre-scale sum x + c*s, rounded to x's
    dtype step by step: the moments' cotangent folded into y's
    (d sum y / dy = 1, d sum y^2 / dy = 2y), then divided by sqrt2."""
    g = g_y + (g_mom[0][:, None, None, :]
               + 2.0 * y.float() * g_mom[1][:, None, None, :]).to(x.dtype)
    return g / _sqrt2(x)


def dil_stage_bwd_ref(x, a, s, w, y, c, g_y, g_mom, d: int):
    """Plain version of K2's backward (the vjp of the JAX ``_dil_stage_ref``
    with respect to x, a and s).  y and c are the stage's output and conv
    output; g_y, g_mom the cotangents of y and of the moments.  Returns
    (dx in x.dtype, da, ds fp32)."""
    dt = x.dtype
    g_pre = _stage_gpre(x, y, g_y, g_mom)
    ds = (g_pre.float() * c.float()).sum((1, 2))
    dh = conv_ref(g_pre * _bcast(s, dt), _flip_io(w.to(dt)), d)
    a_b = _bcast(a, dt)
    du = (dh.float() * _gelu_deriv(x * a_b)).to(dt)
    dx = g_pre + du * a_b
    da = (du.float() * x.float()).sum((1, 2))
    return dx, da, ds


def stage_dw_operands_ref(x, a, s, y, g_y, g_mom):
    """Plain version of ``stage_dw_operands``: the operands of one K2
    stage's weight gradient, h = gelu(x*a) and the conv output's cotangent
    g_pre*s, each formed in x's dtype in the reference's order."""
    gc = _stage_gpre(x, y, g_y, g_mom) * _bcast(s, x.dtype)
    return stage_gelu_ref(x, a), gc


def dil_stage_dw_ref(x, a, s, y, g_y, g_mom, d: int):
    """Plain version of ``fused_stage_dw``: the weight gradient of one K2
    stage (the vjp of the JAX ``_dil_stage_ref`` with respect to w), the
    per-tap fp32 sums of h = gelu(x*a) against the conv output's cotangent
    g_pre*s (``stage_dw_operands_ref``).  Returns (5, 3, C, C) fp32."""
    h, gc = stage_dw_operands_ref(x, a, s, y, g_y, g_mom)
    return conv_dw_ref(h, gc, (5, 3), (d, 1))


class _FusedStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, s, w, d):
        need_conv = any(ctx.needs_input_grad[:3])
        a, s, w = a.float(), s.float(), w.to(x.dtype)
        if _TAPE is not None and _TAPE.replaying:
            # save_convs' recompute: the kept conv output, not K2 again
            c = _TAPE.kept()
            y, mom = _stage_tail(x, s, c)
        else:
            if x.is_cuda:
                y, mom, c = _k.launch_fused_stage(
                    x.contiguous(), a.contiguous(), s.contiguous(),
                    w.contiguous(), d,
                    want_conv=need_conv or _TAPE is not None)
            else:
                y, mom, c = _dil_stage_parts(x, a, s, w, d)
            if _TAPE is not None:
                _TAPE.keep(c)
        ctx.save_for_backward(x, a, s, w, y, c if need_conv else None)
        ctx.d = d
        return y, mom

    @staticmethod
    def backward(ctx, g_y, g_mom):
        x, a, s, w, y, c = ctx.saved_tensors
        need_dw = ctx.needs_input_grad[3]
        if x.is_cuda:
            args = (x.contiguous(), a.contiguous(), s.contiguous(), y,
                    g_y.to(x.dtype).contiguous(), g_mom.float().contiguous())
            # one operand pass serves dw (h, gc) and the engine (gc)
            ops = _k.launch_stage_dw_operands(*args) if need_dw else None
            dx, ds, da = _k.launch_fused_stage_bwd(
                args[4], args[5], y, args[0], c, args[1], args[2],
                w.contiguous(), ctx.d, gc=None if ops is None else ops[1])
            dw = (_k.launch_fused_stage_dw(*args, ctx.d, operands=ops)
                  if need_dw else None)
        else:
            dx, da, ds = dil_stage_bwd_ref(x, a, s, w, y, c, g_y, g_mom,
                                           ctx.d)
            dw = (dil_stage_dw_ref(x, a, s, y, g_y, g_mom, ctx.d)
                  if need_dw else None)
        if dw is not None:
            dw = dw.to(w.dtype)
        return dx, da, ds, dw, None


def fused_stage(x, a, s, w, d: int):
    """One fused ResnetBlock dilation stage: (y, mom).  See module doc.
    The weight gradient comes back in x's dtype."""
    B, F, T, C = x.shape
    assert tuple(w.shape) == (5, 3, C, C), (tuple(w.shape), C)
    assert tuple(a.shape) == (B, C) and tuple(s.shape) == (B, C)
    return _FusedStage.apply(x, a, s, w, int(d))


# ------------------------------------------------------------------- K3

# the narrowest conv that runs int8 under precision="int8" by default (the
# JAX package's default BABE_INT8_MINC under its analytic-bound scales; 128
# under dynamic amax scales)
INT8_MINC = 96
SQRT2_INV = 0.7071067811865475

# degree-6 fit of the same erf form as _ERF_C (|erf err| <= 1.4e-3): the
# int8 stage's gelu, whose error sits well under the quantization half-step
_ERF_C6 = (1.1264247159e+00, -3.6561742760e-01, 9.7881790600e-02,
           -1.7389500700e-02, 1.8964682000e-03, -1.1349870000e-04,
           2.8324000000e-06)


def _erf_poly6(z):
    v = z * z
    p = v * _ERF_C6[-1] + _ERF_C6[-2]
    for c in _ERF_C6[-3::-1]:
        p = p * v + c
    return z * p


def _gelu_cheap_impl(x: torch.Tensor) -> torch.Tensor:
    """gelu with the degree-6 erf, fp32 inside, output in x.dtype.  Every
    step is one rounded fp32 operation in this order; K3's prologue repeats
    them one for one."""
    xf = x.float()
    z = torch.clamp(xf * 0.7071067811865475, -3.2, 3.2)
    return (0.5 * xf * (1.0 + _erf_poly6(z))).to(x.dtype)


class _GeluInt8(torch.autograd.Function):
    """The degree-6 gelu with the exact analytic derivative (the
    degree-10 erf's) as its backward (JAX ``_gelu_for_int8``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_cheap_impl(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * _gelu_deriv(x)).to(g.dtype)


def gelu_for_int8(x: torch.Tensor) -> torch.Tensor:
    """gelu whose output is about to be quantized to int8: the degree-6 erf
    forward (its error under the quantization half-step), the exact
    derivative backward."""
    return _GeluInt8.apply(x)


def _full127(t: torch.Tensor) -> torch.Tensor:
    """127 as a tensor like ``t``.  Dividing by it (or it by ``t``) is a
    true division on every device and matches the JAX package: PyTorch
    multiplies by the reciprocal of a Python-number divisor on CUDA and
    takes 127/t as reciprocal(t)*127, an ulp off at times."""
    return torch.full_like(t, 127.0)


def quant_weight_per_cout(w: torch.Tensor):
    """(..., ci, co) -> (int8 q, fp32 scale (co,)): s = max(amax_co,
    1e-20)/127, q = clip(round(w/s), +-127), round half to even."""
    w32 = w.float()
    amax = w32.abs().amax(dim=tuple(range(w.ndim - 1)))
    s = amax.clamp(min=1e-20) / _full127(amax)
    q = torch.clamp(torch.round(w32 / s), -127.0, 127.0).to(torch.int8)
    return q, s


def quant_i8(hf: torch.Tensor, iv) -> torch.Tensor:
    """fp32 -> int8 at the per-item reciprocal scale iv = 127/bound
    (broadcast), round half to even, clipped to +-127."""
    return torch.clamp(torch.round(hf * iv), -127.0, 127.0).to(torch.int8)


def _hwio(wt: torch.Tensor) -> torch.Tensor:
    """(15, N, C) tap-major -> (5, 3, C, N) HWIO: the inverse of
    ``kernels.tap_major``."""
    return wt.reshape(5, 3, wt.shape[1], wt.shape[2]).permute(0, 1, 3, 2)


def stage_quant_ref(x, a, iv):
    """The int8 conv input of a K3 stage, q = int8(gelu6(float(x)*a) * iv):
    the plain version of ``stage_int8_operand``."""
    return quant_i8(_gelu_cheap_impl(x.float() * a[:, None, None, :]),
                    iv[:, None, None, None])


def _int8_stage_parts(x, a, iv, post, qw, d):
    """(y, mom, q): the plain int8 stage and its quantized conv input."""
    B, F, T, C = x.shape
    xf = x.float()
    q = stage_quant_ref(x, a, iv)
    # int8 x int8 products summed in float64: exact at these magnitudes
    # (|acc| <= 15 * C * 127^2 < 2^53)
    qp = torch.nn.functional.pad(q.double(), (0, 0, 1, 1, 2 * d, 2 * d))
    wd = qw.double()
    acc = x.new_zeros((B, F, T, qw.shape[3]), dtype=torch.float64)
    for kf in range(5):
        for kt in range(3):
            acc = acc + torch.matmul(
                qp[:, kf * d:kf * d + F, kt:kt + T, :], wd[kf, kt])
    y3 = xf * SQRT2_INV + acc.float() * post[:, None, None, :]
    mom = torch.stack([y3.sum((1, 2)), (y3 * y3).sum((1, 2)),
                       y3.abs().amax((1, 2))])
    return y3.to(x.dtype), mom, q


def dil_stage_int8_ref(x, a, iv, post, qw, d: int):
    """Plain version of K3 (the math of the JAX ``_dil_stage_int8_ref`` on
    unpadded tensors).  x (B,F,T,C); a (B,C) fp32; iv (B,) fp32 = 127/bound;
    post (B,N) fp32 = bound/127 * sw * s / sqrt2; qw (5,3,C,N) int8.
    Returns (y in x.dtype, mom (3,B,N) fp32)."""
    y, mom, _ = _int8_stage_parts(x, a, iv, post, qw, d)
    return y, mom


def int8_scales(bound, s, sw):
    """(iv, post) of one int8 stage from the per-item bound (B,), the gate
    s (B,N) and the weight scales sw (N,), in the reference's order."""
    bnd = bound.float().clamp(min=1e-20)
    c = _full127(bnd)
    post = (bnd / c)[:, None] * sw[None, :] * s.float() * SQRT2_INV
    return c / bnd, post


class _FusedStageInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, s, bound, w, qwt, sw, d):
        a = a.float()
        iv, post = int8_scales(bound, s, sw)
        if x.is_cuda:
            y, mom, _ = _k.launch_fused_stage_int8(
                x.contiguous(), a.contiguous(), iv.contiguous(),
                post.contiguous(), qwt, d)
        else:
            y, mom = dil_stage_int8_ref(x, a, iv, post, _hwio(qwt), d)
        ctx.save_for_backward(x, a, s.float(), w.to(x.dtype))
        ctx.d = d
        return y, mom

    @staticmethod
    def backward(ctx, g_y, g_mom):
        # straight-through: the vjp of the exact stage at the same inputs,
        # its forward recomputed for the exact y and conv output; the
        # weight's gradient is the exact stage's too (JAX _fused_i8_bwd)
        x, a, s, w = ctx.saved_tensors
        d = ctx.d
        need_dw = ctx.needs_input_grad[4]
        g_mom = g_mom[:2].float()
        if x.is_cuda:
            x, a, s = x.contiguous(), a.contiguous(), s.contiguous()
            y, _, c = _k.launch_fused_stage(x, a, s, w.contiguous(), d,
                                            want_conv=True)
            args = (x, a, s, y, g_y.to(x.dtype).contiguous(),
                    g_mom.contiguous())
            ops = _k.launch_stage_dw_operands(*args) if need_dw else None
            dx, ds, da = _k.launch_fused_stage_bwd(
                args[4], args[5], y, x, c, a, s, w.contiguous(), d,
                gc=None if ops is None else ops[1])
            dw = (_k.launch_fused_stage_dw(*args, d, operands=ops)
                  if need_dw else None)
        else:
            y, _, c = _dil_stage_parts(x, a, s, w, d)
            dx, da, ds = dil_stage_bwd_ref(x, a, s, w, y, c, g_y, g_mom, d)
            dw = (dil_stage_dw_ref(x, a, s, y, g_y, g_mom, d)
                  if need_dw else None)
        if dw is not None:
            dw = dw.to(w.dtype)
        return dx, da, ds, None, dw, None, None, None


def fused_stage_int8(x, a, s, bound, w, qwt, sw, d: int):
    """One int8 ResnetBlock dilation stage: (y, mom (3,B,C)).

    x (B,F,T,C); a, s (B,C) fp32 (GroupNorm-affine factor and gate); bound
    (B,) fp32, an upper bound on max|gelu(x*a)| per item; w (5,3,C,C) the
    exact kernel (the backward's); qwt (15,C,C) int8 and sw (C,) fp32 its
    per-output-channel quantization, tap-major.  See the module doc."""
    B, F, T, C = x.shape
    assert tuple(w.shape) == (5, 3, C, C), (tuple(w.shape), C)
    assert tuple(qwt.shape) == (15, C, C) and qwt.dtype == torch.int8
    assert tuple(a.shape) == (B, C) and tuple(s.shape) == (B, C)
    return _FusedStageInt8.apply(x, a, s, bound, w, qwt, sw, int(d))


# ------------------------------------- the unfused int8 convs (C8, Q8)

INT8_SCALES = ("bound", "amax")
INT8_OPS = ("conv", "all")


@dataclasses.dataclass(frozen=True)
class Int8Config:
    """The JAX package's int8 knobs, as one network holds them.

    scale: "bound" (an analytic per-item bound on the dilation stages'
        conv inputs, from the GroupNorm statistics; dynamic amax where no
        bound is given) or "amax" (dynamic per-item amax everywhere);
    minc: the narrowest conv (min of its in and out channels) that runs
        in int8;
    ops: "conv" (the non-1x1 convs) or "all" (the 1x1s too);
    fused: the narrowest dilation stack that runs as the fused int8 chain
        (K3), or None for none; only under the bound scales;
    bwd: the guidance gradient's input cotangent through the int8 conv
        (inside ``exact_backward()`` the exact transpose wins)."""
    scale: str = "bound"
    minc: int = INT8_MINC
    ops: str = "conv"
    fused: int | None = INT8_MINC
    bwd: bool = False

    @classmethod
    def from_env(cls, env=None) -> "Int8Config":
        """The knobs from ``env`` (the process environment by default),
        with the JAX package's defaults but one: ``BABE_INT8_FUSED``
        defaults to "1" (the fused chain) where the JAX package's default
        is "0"."""
        env = os.environ if env is None else env
        scale = env.get("BABE_INT8_SCALE", "bound")
        ops = env.get("BABE_INT8_OPS", "conv")
        if scale not in INT8_SCALES or ops not in INT8_OPS:
            raise ValueError(f"BABE_INT8_SCALE={scale!r} (one of "
                             f"{INT8_SCALES}), BABE_INT8_OPS={ops!r} (one "
                             f"of {INT8_OPS})")
        minc = int(env.get("BABE_INT8_MINC",
                           INT8_MINC if scale == "bound" else 128))
        spec = env.get("BABE_INT8_FUSED", "1")
        if spec in ("0", "", "off") or scale != "bound":
            fused = None
        else:
            fused = minc if spec in ("1", "on") else int(spec)
        return cls(scale, minc, ops, fused,
                   env.get("BABE_INT8_BWD", "0") == "1")

    def active(self, cin: int, cout: int, is_1x1: bool = False) -> bool:
        """Whether a conv of these widths runs in int8 (JAX
        ``_int8_active``)."""
        if min(cin, cout) < self.minc:
            return False
        return (not is_1x1) or self.ops == "all"


_EXACT_BWD = False


@contextlib.contextmanager
def exact_backward():
    """The exact conv transpose for every int8 conv's input gradient
    computed inside this context, whatever the networks' ``bwd`` knob (the
    trainer's steps run in it)."""
    global _EXACT_BWD
    prev, _EXACT_BWD = _EXACT_BWD, True
    try:
        yield
    finally:
        _EXACT_BWD = prev


def quant_act_ref(x: torch.Tensor, amax: torch.Tensor):
    """Q8's quantizer, plain version (any device): (B, ...) -> (int8 q,
    fp32 scale (B,)) at the per-item amax (B,): a = max(amax, 1e-20), s =
    a/127, q = clip(round(float(x) * (127/a)), +-127), round half to
    even (JAX ``_quant_act_with_scale``)."""
    a = amax.float().clamp(min=1e-20)
    c = _full127(a)
    iv = (c / a).view((-1,) + (1,) * (x.ndim - 1))
    return quant_i8(x.float(), iv), a / c


def quant_act_with_scale(x: torch.Tensor, amax: torch.Tensor):
    """``quant_act_ref`` at a per-item amax known before x (a bound): on
    CUDA Q8's ``act_quant``."""
    if x.is_cuda:
        return _k.launch_act_quant(x.contiguous(),
                                   amax.float().contiguous())
    return quant_act_ref(x, amax)


def quant_act_per_item(x: torch.Tensor):
    """(B, ...) -> (int8 q, fp32 scale (B,)) at the per-item dynamic amax
    over every other axis (JAX ``_quant_act_per_item``).  On CUDA Q8's
    ``act_quant_dyn``, one launch."""
    if x.is_cuda:
        return _k.launch_act_quant_dyn(x.contiguous())
    amax = x.float().abs().amax(dim=tuple(range(1, x.ndim)))
    return quant_act_with_scale(x, amax)


def conv_int8_acc_ref(q: torch.Tensor, qw: torch.Tensor,
                      dilation=(1, 1)) -> torch.Tensor:
    """C8's plain accumulator: the 'SAME' conv of int8 q (B,F,T,C) with
    the int8 HWIO kernel qw (KF,KT,C,N) at ``dilation``, in float64 on the
    int values (exact: |acc| <= KF*KT*C*127^2 < 2^53), as int32."""
    kf, kt = int(qw.shape[0]), int(qw.shape[1])
    df, dt = (int(v) for v in dilation)
    out = torch.nn.functional.conv2d(
        q.permute(0, 3, 1, 2).double(), qw.permute(3, 2, 0, 1).double(),
        padding=((kf - 1) // 2 * df, (kt - 1) // 2 * dt), dilation=(df, dt))
    return out.permute(0, 2, 3, 1).round().to(torch.int32)


def int8_rescale_ref(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                     dtype) -> torch.Tensor:
    """out = float(acc) * (s_x[b] * s_w[n]) in ``dtype`` (the scale product
    first, in fp32, as the JAX package forms it)."""
    scale = sx.float().view((-1,) + (1,) * (acc.ndim - 1)) * sw.float()
    return (acc.float() * scale).to(dtype)


def int8_scale(sx: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """The (B, N) fp32 rescale s_x[b] * s_w[n] of C8's epilogue."""
    return (sx.float()[:, None] * sw.float()[None, :]).contiguous()


def _dil2(dilation) -> tuple[int, int]:
    """A dilation as (df, dt): an int d is the stages' (d, 1)."""
    if isinstance(dilation, int):
        return int(dilation), 1
    return tuple(int(v) for v in dilation)


def im2col_int8(q: torch.Tensor, kshape, dilation) -> torch.Tensor:
    """The 'SAME' taps of int8 q (B,F,T,C) for an odd kernel ``kshape`` at
    ``dilation``, zero-padded: (B*F*T, KF*KT*C) int8, tap (i, j) major."""
    kf, kt = (int(v) for v in kshape)
    df, dt = _dil2(dilation)
    B, F, T, C = q.shape
    pf, pt = (kf - 1) // 2 * df, (kt - 1) // 2 * dt
    qp = q.new_zeros((B, F + 2 * pf, T + 2 * pt, C))
    qp[:, pf:pf + F, pt:pt + T] = q
    return torch.cat([qp[:, i * df:i * df + F, j * dt:j * dt + T]
                      for i in range(kf) for j in range(kt)],
                     dim=-1).reshape(B * F * T, kf * kt * C)


def conv_int8_acc(q: torch.Tensor, qw: torch.Tensor,
                  dilation) -> torch.Tensor:
    """The int32 accumulator of the 'SAME' conv of int8 q (B,F,T,C) with
    the int8 HWIO kernel qw (KF,KT,C,N) at any odd kernel and dilation:
    the im2col product through ``_int_mm`` (on CUDA the library's int8
    product or P1, zero-padded where they need it; on the CPU float64)."""
    B, F, T, _ = q.shape
    N = qw.shape[3]
    cols = im2col_int8(q, qw.shape[:2], dilation)
    acc = _int_mm(cols, qw.permute(3, 0, 1, 2).reshape(N, -1).contiguous())
    return acc.view(B, F, T, N)


def _conv_int8_q(qx, sx, qw, qwt, sw, dilation, dtype) -> torch.Tensor:
    """The int8 'SAME' conv of quantized qx with its rescale, in
    ``dtype``.  On CUDA a (5,3) kernel at dilation (d,1) runs C8
    (tap-major kernel qwt); any other odd kernel and dilation the int8
    im2col product (``conv_int8_acc``) and Q8's rescale, as the JAX
    package computes it in XLA.  On the CPU the plain accumulator and
    rescale (HWIO kernel qw)."""
    df, dt = _dil2(dilation)
    if qx.is_cuda:
        if tuple(qw.shape[:2]) == (5, 3) and dt == 1:
            return _k.launch_conv_int8(qx, qwt, int8_scale(sx, sw), df,
                                       dtype)
        return _k.launch_act_rescale(conv_int8_acc(qx, qw, (df, dt)),
                                     int8_scale(sx, sw), dtype)
    return int8_rescale_ref(conv_int8_acc_ref(qx, qw, (df, dt)), sx, sw,
                            dtype)


@dataclasses.dataclass(frozen=True)
class QuantKernel:
    """A conv kernel quantized per output channel: HWIO ``q`` (the plain
    version's), tap-major ``qt`` (C8's; (N, K) for a 1x1) and the scales
    ``s``."""
    q: torch.Tensor
    qt: torch.Tensor | None
    s: torch.Tensor

    @classmethod
    def of(cls, w: torch.Tensor) -> "QuantKernel":
        with torch.no_grad():
            q, s = quant_weight_per_cout(w)
        qt = (_k.tap_major(q) if tuple(w.shape[:2]) != (1, 1)
              else q[0, 0].t().contiguous())
        return cls(q, qt, s)


def _conv_transpose_any(g, w, dilation) -> torch.Tensor:
    """The exact input gradient of a 'SAME' conv with kernel w: K1 for a
    (5,3) kernel at dilation (d,1), else K4 (``dilated_conv``) with the
    kernel flipped and io-swapped; the plain version on the CPU."""
    df, dt = _dil2(dilation)
    if tuple(w.shape[:2]) == (5, 3) and dt == 1:
        return _conv_any(g, w, df, transposed=True)
    if g.is_cuda:
        return _k.launch_dilated_conv(g.contiguous(), _flip_io(w),
                                      (df, dt))
    return conv_taps(g, _flip_io(w), (df, dt))


def _int8_dx(g, w, dilation, qwT: QuantKernel | None) -> torch.Tensor:
    """The input gradient of a conv with kernel w at ``dilation``: with
    ``qwT`` (the quantized flipped, io-swapped kernel) the int8 conv of g
    on per-item dynamic scales, else the exact transpose."""
    if qwT is None:
        return _conv_transpose_any(g, w, dilation)
    qg, sg = quant_act_per_item(g)
    return _conv_int8_q(qg, sg, qwT.q, qwT.qt, qwT.s, dilation, g.dtype)


class _ConvInt8(torch.autograd.Function):
    """conv_int8 / conv_int8_hinted: residuals (qx, sx, w[, bound]), never
    x; straight-through backward (JAX ``_int8_bwd_from_q``)."""

    @staticmethod
    def forward(ctx, x, w, bound, qw: QuantKernel, d, qwT):
        if bound is None:
            qx, sx = quant_act_per_item(x)
        else:
            qx, sx = quant_act_with_scale(x, bound)
        out = _taped(lambda: _conv_int8_q(qx, sx, qw.q, qw.qt, qw.s, d,
                                          x.dtype))
        ctx.save_for_backward(qx, sx, w)
        ctx.d, ctx.qwT = d, qwT
        return out

    @staticmethod
    def backward(ctx, g):
        qx, sx, w = ctx.saved_tensors
        d = ctx.d
        g = g.to(w.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            qwT = None if _EXACT_BWD else ctx.qwT
            dx = _int8_dx(g, w, d, qwT() if callable(qwT) else qwT)
        if ctx.needs_input_grad[1]:
            # dequant(qx): the true input of the quantized forward
            xhat = (qx.float() * sx.view(-1, 1, 1, 1)).to(g.dtype)
            dw = _conv_dw_any(xhat, g, tuple(w.shape[:2]), d).to(w.dtype)
        return dx, dw, None, None, None, None


def conv_int8(x, w, d, bound=None, bwd: bool = False,
              qw: QuantKernel | None = None, qwT=None):
    """'SAME' NHWC conv with any odd kernel in int8 at dilation ``d`` (an
    int d is the stages' (d, 1); else (df, dt)) (JAX ``conv_int8``; with
    ``bound`` (B,) fp32, an upper bound on max|x| per item, JAX
    ``conv_int8_hinted``).  Output in x's dtype; the bound gets no
    gradient.  ``bwd``: the input gradient is the int8 conv of g with the
    flipped, io-swapped kernel (``exact_backward()`` wins), else the exact
    transpose.  ``qw`` and ``qwT``: the quantized kernel and the quantized
    flipped, io-swapped kernel (or a callable returning it), made here
    from w when not given."""
    B, F, T, C = x.shape
    kf, kt = int(w.shape[0]), int(w.shape[1])
    assert kf % 2 == 1 and kt % 2 == 1 and w.shape[2] == C, (
        tuple(w.shape), C)
    w = w.to(x.dtype)
    if qw is None:
        qw = QuantKernel.of(w)
    if bwd and qwT is None:
        qwT = lambda: QuantKernel.of(_flip_io(w.detach()))  # noqa: E731
    if bound is not None:
        bound = bound.detach()
    return _ConvInt8.apply(x, w, bound, qw, _dil2(d), qwT if bwd else None)


def int_mm_takes(M: int, K: int, N: int) -> bool:
    """Whether ``torch._int_mm`` takes an (M, K) @ (K, N) int8 product
    (M > 16, K and N multiples of 8)."""
    return M > 16 and K % 8 == 0 and N % 8 == 0


INT_MM_K = 32  # P1's K step for int8 (one 32-byte slice)


def pad_int_mm(a: torch.Tensor, bt: torch.Tensor):
    """a (M, K) and bt (N, K) int8 with K zero-padded to a multiple of 32:
    the product's int32 sums are unchanged (the added terms are 0 * 0)."""
    K = a.shape[1]
    pad = -K % INT_MM_K
    if pad == 0:
        return a, bt
    return (torch.nn.functional.pad(a, (0, pad)),
            torch.nn.functional.pad(bt, (0, pad)))


def _int_mm(qx2: torch.Tensor, qwt: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ (K, N) -> int32 (qwt is the (N, K) kernel).  Where
    ``torch._int_mm`` takes the shape it runs on CUDA (read
    column-major); every other shape has K zero-padded to a multiple of 32
    (``pad_int_mm``) and runs P1's GEMM (``launch_probe_gemm``), which
    takes any M and N.  On the CPU the same (padded) operands multiply in
    float64 (exact)."""
    M, K = qx2.shape
    N = qwt.shape[0]
    if not int_mm_takes(M, K, N):
        qx2, qwt = pad_int_mm(qx2, qwt)
        if qx2.is_cuda:
            return _k.launch_probe_gemm(qx2.contiguous(), qwt.contiguous(),
                                        reps=1)
    elif qx2.is_cuda:
        return torch._int_mm(qx2, qwt.t())
    return (qx2.double() @ qwt.t().double()).round().to(torch.int32)


def _dot1x1_int8_fwd(x, w, qw: QuantKernel) -> torch.Tensor:
    B, F, T, C = x.shape
    N = w.shape[3]
    qx, sx = quant_act_per_item(x)
    acc = _int_mm(qx.reshape(-1, C), qw.qt).view(B, F, T, N)
    if acc.is_cuda:
        return _k.launch_act_rescale(acc, int8_scale(sx, qw.s), x.dtype)
    return int8_rescale_ref(acc, sx, qw.s, x.dtype)


class _Dot1x1Int8(torch.autograd.Function):
    """dot1x1_int8: an int8 1x1 forward; the backward is the plain 1x1
    vjp at the saved x and w (JAX ``_dot1x1_int8_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, qw: QuantKernel):
        ctx.save_for_backward(x, w)
        return _taped(lambda: _dot1x1_int8_fwd(x, w, qw))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        w2 = w[0, 0].to(g.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w2.t())
        if ctx.needs_input_grad[1]:
            C, N = w2.shape
            dw = (x.reshape(-1, C).t() @ g.reshape(-1, N))[None, None]
            dw = dw.to(w.dtype)
        return dx, dw, None


def dot1x1_int8(x, w, qw: QuantKernel | None = None):
    """1x1 'SAME' conv (w [1,1,Cin,Cout]) as an int8 product on per-item
    and per-output-channel scales (JAX ``dot1x1_int8``); output in x's
    dtype."""
    if qw is None:
        qw = QuantKernel.of(w.to(x.dtype))
    return _Dot1x1Int8.apply(x, w.to(x.dtype), qw)
