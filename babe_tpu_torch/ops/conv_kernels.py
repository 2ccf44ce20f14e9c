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
    is not ported (int8 training waits for the unfused int8 convs), so a
    weight that requires grad raises.

There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

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
        return _conv_any(x, w, d)

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


def _dil_stage_parts(x, a, s, w, d):
    dt = x.dtype
    h = stage_gelu_ref(x, a)
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

# the ResnetBlock dilation stacks with at least this many channels run the
# int8 stage under precision="int8"; narrower ones stay on K2 (the JAX
# package's default BABE_INT8_MINC under its analytic-bound scales)
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
        # its forward recomputed for the exact y and conv output
        x, a, s, w = ctx.saved_tensors
        d = ctx.d
        g_mom = g_mom[:2].float()
        if x.is_cuda:
            x, a, s = x.contiguous(), a.contiguous(), s.contiguous()
            y, _, c = _k.launch_fused_stage(x, a, s, w.contiguous(), d,
                                            want_conv=True)
            dx, ds, da = _k.launch_fused_stage_bwd(
                g_y.to(x.dtype).contiguous(), g_mom.contiguous(), y, x, c,
                a, s, w.contiguous(), d)
        else:
            y, _, c = _dil_stage_parts(x, a, s, w, d)
            dx, da, ds = dil_stage_bwd_ref(x, a, s, w, y, c, g_y, g_mom, d)
        return dx, da, ds, None, None, None, None, None


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
    if w.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "fused_stage_int8: the weight gradient is not implemented "
            "(freeze the parameters with requires_grad_(False))")
    return _FusedStageInt8.apply(x, a, s, bound, w, qwt, sw, int(d))
