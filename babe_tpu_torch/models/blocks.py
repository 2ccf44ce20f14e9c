"""Building blocks of the CQTDiff+ backbone, as ``torch.nn`` modules.

Counterpart of ``babe_tpu/models/blocks.py``.  Activations are channels-last
(B, F, T, C) as in the JAX package, and the module and parameter names follow
the JAX tree (``downs_0_2.H_0.conv.kernel``, ``norm_1.gamma``, ...), so the
weight bridge (``utils/weights.py``) is a mechanical rename.  Parameters are
fp32; compute follows the input dtype (bf16 at the flagship config).

A ``ResnetBlock`` given an ``attention_dict`` runs the gated time attention
first (``TimeAttentionBlock`` with its T5 ``RelativePositionBias``, in the
JAX order; its products are plain matmuls and einsums, as the JAX package
leaves them to XLA).  Its fp32 position bias promotes bf16 activations to
fp32 from there on, as jnp's type promotion does in the JAX network.

The (5,3) dilation stack of a ``ResnetBlock`` runs the fused-chain form of
the JAX ``_fused_dil_chain``: each stage's GroupNorm denominators come from
the moments the previous stage emitted, and the stage itself is one
``fused_stage`` call (kernel K2 on CUDA, ``dil_stage_ref`` on the CPU).  A
block put in int8 (``int8=True``, or an ``Int8Config`` whose ``fused``
width it reaches) runs the JAX ``_fused_dil_chain_int8``
instead: one ``fused_stage_int8`` per stage (kernel K3), each quantizing its
conv input at a per-item scale bounded analytically from the previous
stage's per-channel amax.

The unfused int8 path (an ``Int8Config`` given to ``set_int8``, as the
network's ``set_precision`` gives it): ``Conv2d`` dispatches as the JAX
``conv2d_same`` does, its (5,3) convs of at least ``minc`` channels
through ``conv_int8`` (C8) and, under ``ops="all"``, its 1x1s through
``dot1x1_int8``; a dilation stack in int8 that is not a fused chain runs
the JAX unfused loop: GroupNorm, * (gamma + 1), the degree-6 gelu, then
``conv_int8`` with the hint BOUND_SAFETY * max_c(amax_c(x) * |a_c|) under
the bound scales (none under amax), then the gated residual.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from babe_tpu_torch.kernels import tap_major
from babe_tpu_torch.ops.pallas_conv import dilated_conv_nhwc
from babe_tpu_torch.ops.conv_kernels import (
    INT8_MINC,
    Int8Config,
    QuantKernel,
    _flip_io,
    conv1x1,
    conv5x3_dilated,
    conv_int8,
    dot1x1_int8,
    fused_stage,
    fused_stage_int8,
    gelu_exact,
    gelu_for_int8,
    quant_weight_per_cout,
)

SQRT2 = math.sqrt(2.0)
INV_SQRT2 = 1.0 / SQRT2
INIT_W = math.sqrt(1.0 / 3.0)  # 'init' of the reference network
INIT_ZERO = 1e-7  # 'init_zero'
GN_GROUPS = 8
GN_EPS = 1e-7
# inflation of the analytic int8 bound: with bf16 activations and the
# degree-6 gelu's overshoot the realized max can exceed the fp32 bound by
# up to ~1%; 1.02 keeps it a true upper bound (the JAX package's value)
BOUND_SAFETY = 1.02


def _kaiming_uniform_(p: torch.Tensor, scale: float,
                      gen: torch.Generator | None) -> None:
    """EDM kaiming_uniform * scale; fan_in = prod(shape[:-1])."""
    fan_in = int(np.prod(p.shape[:-1]))
    bound = math.sqrt(3.0 / fan_in) * scale
    with torch.no_grad():
        p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * bound)


class Linear(nn.Module):
    """Linear layer with the JAX layout: ``kernel`` (in, out), ``bias``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 init_weight: float = INIT_W):
        super().__init__()
        self.init_weight = init_weight
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, gen=None) -> None:
        _kaiming_uniform_(self.kernel, self.init_weight, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def _stamped(cache: dict, key, ws, build):
    """``build()`` memoised in ``cache[key]`` for the weights ``ws`` as they
    are now: rebuilt when one of them was replaced or changed through its
    parameter (``load_state_dict``, an in-place edit under
    ``torch.no_grad()``, a move to another device), which changes its
    storage, version counter or device.  An edit through ``.data`` changes
    none of these: the owner's ``set_int8`` (or the network's
    ``set_precision``) empties the cache after one."""
    stamp = tuple((w.data_ptr(), w._version, w.device) for w in ws)
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            cache[key] = hit = (stamp, build())
    return hit[1]


class _ConvParams(nn.Module):
    """Holds the HWIO ``kernel`` (and optional ``bias``) of a Conv2d; the
    JAX tree nests them one level down, under ``conv``."""

    def __init__(self, kshape, features: int, use_bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*kshape))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)


class Conv2d(nn.Module):
    """'SAME' 2-D conv on (B, F, T, C), odd kernel (kf, kt), dilation
    (df, dt), dispatched as the JAX ``conv2d_same`` does: under an int8
    config that makes it active (``set_int8``), its kernel runs
    ``conv_int8`` (C8 for (5,3) at dilation (d,1), the int8 im2col product
    otherwise; with the caller's ``scale_hint`` its hinted form) and, under
    ``ops="all"``, (1,1) kernels ``dot1x1_int8``;
    else (1,1) kernels are matmuls (``conv1x1``); (5,3) kernels with
    dilation (d,1) go through ``conv5x3_dilated`` (kernel K1 on CUDA);
    every other kernel through ``dilated_conv_nhwc`` (kernel K4 on
    CUDA)."""

    def __init__(self, in_features: int, features: int, kernel=(1, 1),
                 dilation=(1, 1), use_bias: bool = False,
                 init_weight: float = INIT_W):
        super().__init__()
        kernel = tuple(int(k) for k in kernel)
        dilation = tuple(int(d) for d in dilation)
        if kernel[0] % 2 == 0 or kernel[1] % 2 == 0:
            raise NotImplementedError(
                f"Conv2d: kernel {kernel}: only odd kernels are ported "
                "('SAME' padding is symmetric)")
        self.kernel_size, self.dilation = kernel, dilation
        self.init_weight = init_weight
        self.conv = _ConvParams((*kernel, in_features, features), features,
                                use_bias)
        self.set_int8(None)

    def reset_parameters(self, gen=None) -> None:
        _kaiming_uniform_(self.conv.kernel, self.init_weight, gen)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)

    @property
    def weight(self) -> torch.Tensor:
        return self.conv.kernel

    def set_int8(self, cfg: Int8Config | None) -> None:
        """Run in int8 where ``cfg`` makes this conv active (None: never).
        Drops the quantized kernels, so the next int8 evaluation quantizes
        the weights as they are now."""
        self.i8 = cfg
        self._qcache = {}

    def int8_active(self) -> bool:
        cin, cout = self.conv.kernel.shape[2:]
        return self.i8 is not None and self.i8.active(
            cin, cout, self.kernel_size == (1, 1))

    def _quantized(self, k: torch.Tensor, flipped: bool = False):
        """The kernel k (the weight in the activations' dtype) quantized
        per output channel, or its flipped, io-swapped form (the int8
        input gradient's); cached per dtype (``_stamped``)."""
        return _stamped(self._qcache, (k.dtype, flipped), [self.conv.kernel],
                        lambda: QuantKernel.of(_flip_io(k.detach()) if flipped
                                               else k.detach()))

    def forward(self, x: torch.Tensor, scale_hint=None) -> torch.Tensor:
        k = self.conv.kernel.to(x.dtype)
        if self.int8_active():
            y = self._forward_int8(x, k, scale_hint)
        elif self.kernel_size == (1, 1):
            y = conv1x1(x, k)
        elif self.kernel_size == (5, 3) and self.dilation[1] == 1:
            y = conv5x3_dilated(x, k, self.dilation[0])
        else:
            y = dilated_conv_nhwc(x, k, self.dilation)
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(y.dtype)
        return y

    def _forward_int8(self, x, k, scale_hint):
        if self.kernel_size == (1, 1):
            return dot1x1_int8(x, k, self._quantized(k))
        return conv_int8(x, k, self.dilation, bound=scale_hint,
                         bwd=self.i8.bwd, qw=self._quantized(k),
                         qwT=lambda: self._quantized(k, flipped=True))


def _gn_moments(x: torch.Tensor, g: int):
    """Group (mean, unbiased std) of BiasFreeGroupNorm, each (B, g) fp32."""
    B, F, T, C = x.shape
    cg = C // g
    n = F * T * cg
    x32 = x.float()
    s1 = x32.mean((1, 2))
    s2 = (x32 * x32).mean((1, 2))
    m = s1.reshape(B, g, cg).mean(-1)
    sq = s2.reshape(B, g, cg).mean(-1)
    var = (sq - m * m) * (n / (n - 1.0))
    return m, torch.sqrt(torch.clamp(var, min=0.0))


class BiasFreeGroupNorm(nn.Module):
    """x / (std + eps) * gamma with no mean subtraction of x but a centered,
    unbiased std per group of channels (torch ``x.std()`` semantics)."""

    def __init__(self, num_features: int, num_groups: int = GN_GROUPS,
                 eps: float = GN_EPS):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.gamma = nn.Parameter(torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cg = x.shape[-1] // self.num_groups
        _, std = _gn_moments(x, self.num_groups)
        scale = (self.gamma[None, :].float()
                 / torch.repeat_interleave(std + self.eps, cg, dim=-1))
        return x * scale.to(x.dtype)[:, None, None, :]

    def bound_factor(self, x: torch.Tensor, gamma: torch.Tensor):
        """max_c amax_c(x) / denom_c * |gain_c * (gamma_c + 1)| per item
        (B,) fp32: with |gelu(v)| <= |v|, a bound on max |gelu(norm(x) *
        (gamma + 1))| (the JAX unfused int8 loop's hint before its
        inflation)."""
        cg = x.shape[-1] // self.num_groups
        _, std = _gn_moments(x, self.num_groups)
        denom = torch.repeat_interleave(std + self.eps, cg, dim=-1)
        amax_c = x.float().abs().amax((1, 2))
        a_abs = (self.gamma[None, :].float()
                 * (gamma.float() + 1.0)).abs() / denom
        return (amax_c * a_abs).amax(-1)


class RFF_MLP_Block(nn.Module):
    """Noise-level embedding: fixed random Fourier features (buffer
    ``RFF_freq``) and a 3-layer relu MLP."""

    def __init__(self, emb_dim: int = 256, rff_dim: int = 32):
        super().__init__()
        self.register_buffer("RFF_freq", torch.zeros(1, rff_dim))
        self.MLP_0 = Linear(2 * rff_dim, 128)
        self.MLP_1 = Linear(128, 256)
        self.MLP_2 = Linear(256, emb_dim)

    def reset_buffers(self, gen=None) -> None:
        self.RFF_freq.copy_(16.0 * torch.randn(self.RFF_freq.shape,
                                               generator=gen))

    def forward(self, sigma: torch.Tensor) -> torch.Tensor:
        table = 2.0 * math.pi * sigma * self.RFF_freq
        x = torch.cat([torch.sin(table), torch.cos(table)], dim=1)
        x = torch.relu(self.MLP_0(x))
        x = torch.relu(self.MLP_1(x))
        return torch.relu(self.MLP_2(x))


class AddFreqEncodingRFF(nn.Module):
    """Fixed RFF positional channels over frequency (buffer ``embeddings``
    [2N, F]), concatenated: (B, F, T, C) -> (B, F, T, C + 2N)."""

    def __init__(self, f_dim: int, N: int = 32):
        super().__init__()
        self.N = N
        self.register_buffer("embeddings", torch.zeros(2 * N, f_dim))

    def reset_buffers(self, gen=None) -> None:
        freqs = 16.0 * torch.randn((1, self.N, 1), generator=gen)
        n = torch.arange(self.embeddings.shape[1])[None, None, :]
        table = 2.0 * math.pi * n * freqs
        self.embeddings.copy_(
            torch.cat([torch.sin(table), torch.cos(table)], dim=1)[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F, T, C = x.shape
        enc = self.embeddings.t()[None, :, None, :].expand(B, F, T, 2 * self.N)
        return torch.cat([x, enc.to(x.dtype)], dim=-1)


class Conv1d(nn.Module):
    """1-D conv of kernel 1 on (B, T, C), the JAX ``Conv1d`` (a flax
    ``nn.Conv``) as the attention's qk projection uses it: ``conv.kernel``
    (1, in, out), optional ``conv.bias``; computed in the input's dtype."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = False, init_weight: float = INIT_W):
        super().__init__()
        self.init_weight = init_weight
        self.conv = _ConvParams((1, in_features, features), features,
                                use_bias)

    def reset_parameters(self, gen=None) -> None:
        _kaiming_uniform_(self.conv.kernel, self.init_weight, gen)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.conv.kernel[0].to(x.dtype)
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(x.dtype)
        return y


def _relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5 bucketing of integer relative positions: half the buckets for
    each sign, exact below a quarter of them, logarithmic up to
    ``max_distance`` and clamped past it; the float32 log's integer cast
    truncates toward zero, as ``astype(int32)`` does."""
    num_buckets //= 2
    ret = (rel_pos >= 0).to(torch.int32) * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(torch.clamp(n, min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class RelativePositionBias(nn.Module):
    """A learned bias per head and T5 bucket of the key-query offset:
    ``relative_attention_bias`` (num_buckets, num_heads), N(0, 1) init."""

    def __init__(self, num_buckets: int, max_distance: int, num_heads: int):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Parameter(
            torch.empty(num_buckets, num_heads))

    def reset_parameters(self, gen=None) -> None:
        with torch.no_grad():
            self.relative_attention_bias.copy_(torch.randn(
                self.relative_attention_bias.shape, generator=gen))

    def forward(self, num_queries: int, num_keys: int) -> torch.Tensor:
        """The bias [1, heads, num_queries, num_keys] (fp32)."""
        i, j = num_queries, num_keys
        dev = self.relative_attention_bias.device
        q_pos = torch.arange(j - i, j, device=dev)
        k_pos = torch.arange(j, device=dev)
        bucket = _relative_position_bucket(k_pos[None, :] - q_pos[:, None],
                                           self.num_buckets,
                                           self.max_distance)
        bias = self.relative_attention_bias[bucket.long()]  # [i, j, heads]
        return bias.permute(2, 0, 1)[None]


class TimeAttentionBlock(nn.Module):
    """Per-head attention over time with the frequency axis flattened into
    the features, on (B, F, T, C) with F = Fdim: a 1x1 projection to
    ``num_heads`` channels, the qk projection, q k^T plus the relative
    position bias, scaled by Fdim^-0.5, softmax, times v (the projected
    input itself), and a 1x1 projection back to C channels; in the JAX
    order.  The fp32 bias promotes a bf16 input's scores, and so the
    block's output, to fp32, as jnp's type promotion does."""

    def __init__(self, attention_dict, Fdim: int, dim: int):
        super().__init__()
        ad = attention_dict
        heads = int(ad["num_heads"])
        self.heads, self.Fdim = heads, Fdim
        N = heads * Fdim
        self.proj_in = Conv2d(dim, heads, (1, 1))
        self.qk = Conv1d(N, 2 * N, use_bias=bool(ad.get("bias_qkv", False)))
        if ad.get("use_rel_pos", True):
            self.rel_pos = RelativePositionBias(
                int(ad["rel_pos_num_buckets"]),
                int(ad["rel_pos_max_distance"]), heads)
        else:
            self.rel_pos = None
        self.proj_out = Conv2d(heads, dim, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F, T, C = x.shape
        heads, Fd = self.heads, self.Fdim
        h = self.proj_in(x)  # [B, F, T, heads]
        hf = h.permute(0, 2, 3, 1).reshape(B, T, heads * F)
        v = hf.reshape(B, T, heads, F).transpose(1, 2)  # [B, h, T, F]
        qk = self.qk(hf).reshape(B, T, heads, 2 * Fd).transpose(1, 2)
        q, k = qk.split(Fd, dim=-1)
        sim = torch.einsum("bhnd,bhmd->bhnm", q, k)
        if self.rel_pos is not None:
            sim = sim + self.rel_pos(T, T)
        sim = sim * (Fd**-0.5)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v.to(attn.dtype))
        return self.proj_out(out.permute(0, 3, 2, 1))  # [B, F, T, heads]


class ResnetBlock(nn.Module):
    """Sigma-conditioned dilated-conv residual block.

    With an ``attention_dict`` the block first runs the gated time
    attention: GroupNorm (``norm2``) -> sigma affine (``affine2``) ->
    ``TimeAttentionBlock`` (``attn_block``) -> gated residual (``gate2``)
    x 1/sqrt2.  (5,3) blocks with norm run the fused dilation chain (one ``fused_stage``
    per dilation, or one ``fused_stage_int8`` when the block is in int8);
    every other block runs the plain loop GroupNorm -> sigma affine ->
    gelu -> conv -> gated residual (a 1x1 matmul, or K4 for other
    kernels)."""

    def __init__(self, dim: int, dim_out: int, use_norm: bool = True,
                 num_dils: int = 6, kernel_size=(5, 3), emb_dim: int = 256,
                 proj_place: str = "before", attention_dict=None,
                 Fdim: int = 128, int8: bool = False):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.use_norm, self.num_dils = use_norm, num_dils
        self.kernel_size = tuple(kernel_size)
        self.proj_place = proj_place
        N = dim_out if proj_place == "before" else dim
        self.N = N
        if dim != N:
            self.proj_in = Conv2d(dim, N, (1, 1))
        self.attention = attention_dict is not None
        if self.attention:
            self.affine2 = Linear(emb_dim, N)
            self.gate2 = Linear(emb_dim, N, init_weight=INIT_ZERO)
            self.norm2 = BiasFreeGroupNorm(N)
            self.attn_block = TimeAttentionBlock(attention_dict, Fdim, N)
        for i in range(num_dils):
            setattr(self, f"affine_{i}", Linear(emb_dim, N))
            setattr(self, f"gate_{i}",
                    Linear(emb_dim, N, init_weight=INIT_ZERO))
            if use_norm:
                setattr(self, f"norm_{i}", BiasFreeGroupNorm(N))
            setattr(self, f"H_{i}",
                    Conv2d(N, N, self.kernel_size, dilation=(2**i, 1)))
        if proj_place == "after" and N != dim_out:
            self.proj_out = Conv2d(N, dim_out, (1, 1))
        if dim != dim_out:
            self.res_conv = Conv2d(dim, dim_out, (1, 1))
        self.set_int8(Int8Config() if int8 else None)
        if int8 and not self.int8:
            raise ValueError("only (5,3) blocks with norm of at least "
                             f"{INT8_MINC} channels have an int8 chain")

    @property
    def fused(self) -> bool:
        """Whether the dilation stack runs as a fused chain."""
        return (self.kernel_size == (5, 3) and self.use_norm
                and self.num_dils > 0)

    def set_int8(self, cfg: Int8Config | None) -> None:
        """Run in int8 as ``cfg`` says (None: never): the dilation stack as
        the fused int8 chain (K3) where the block is a fused chain at least
        ``cfg.fused`` wide, and ``cfg`` handed to the block's convs.  Drops
        the quantized kernels, so the next int8 evaluation quantizes the
        weights as they are now."""
        self.i8 = cfg
        self.int8 = (cfg is not None and cfg.fused is not None
                     and self.fused and self.N >= cfg.fused)
        self._qcache = {}
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.set_int8(cfg)

    @property
    def unfused_int8(self) -> bool:
        """Whether the dilation stack runs the JAX unfused loop with int8
        convs (an int8 config active at this width, and no fused chain)."""
        return (self.i8 is not None and not self.int8
                and self.kernel_size != (1, 1)
                and self.i8.active(self.N, self.N))

    def _sub(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"{name}_{i}")

    def forward(self, x_in: torch.Tensor, sigma_emb: torch.Tensor):
        x = x_in
        if self.dim != self.N:
            x = self.proj_in(x)
        if self.attention:
            gamma = self.affine2(sigma_emb)
            scale = self.gate2(sigma_emb)
            h = self.norm2(x) * (gamma[:, None, None, :] + 1.0)
            h = self.attn_block(h)
            x = (x + h * scale[:, None, None, :]) * INV_SQRT2
        if self.unfused_int8:
            x = self._unfused_dil_int8(x, sigma_emb)
        elif self.fused:
            x = self._fused_dil_chain(x, sigma_emb)
        else:
            for i in range(self.num_dils):
                x0 = x
                h = x
                gamma = self._sub("affine", i)(sigma_emb)
                scale = self._sub("gate", i)(sigma_emb)
                if self.use_norm:
                    h = self._sub("norm", i)(h)
                h = gelu_exact(h * (gamma[:, None, None, :] + 1.0))
                h = self._sub("H", i)(h)
                x = (x0 + h * scale[:, None, None, :]) * INV_SQRT2
        if self.proj_place == "after" and self.N != self.dim_out:
            x = self.proj_out(x)
        res = x_in if self.dim == self.dim_out else self.res_conv(x_in)
        return (x + res) * INV_SQRT2

    def _unfused_dil_int8(self, x: torch.Tensor, sigma_emb: torch.Tensor):
        """The dilation stack as the JAX unfused loop in int8 (its default,
        non-``BABE_STAGE_REMAT`` branch): per stage GroupNorm, * (gamma +
        1), the degree-6 gelu, the int8 conv (hinted under the bound
        scales), the gated residual."""
        hinted = self.use_norm and self.i8.scale == "bound"
        for i in range(self.num_dils):
            x0 = h = x
            gamma = self._sub("affine", i)(sigma_emb)
            scale = self._sub("gate", i)(sigma_emb)
            hint = None
            if self.use_norm:
                gn = self._sub("norm", i)
                h = gn(h)
            if hinted:
                hint = BOUND_SAFETY * gn.bound_factor(x, gamma)
            h = gelu_for_int8(h * (gamma[:, None, None, :] + 1.0))
            h = self._sub("H", i)(h, scale_hint=hint)
            x = (x0 + h * scale[:, None, None, :]) * INV_SQRT2
        return x

    def _quantized(self):
        """The stages' kernels in int8, per output channel: (qw (nd,15,N,N)
        tap-major, sw (nd,N)), quantized once per set of weights
        (``_stamped``)."""
        ws = [self._sub("H", i).weight for i in range(self.num_dils)]

        def build():
            q, s = zip(*(quant_weight_per_cout(w) for w in ws))
            return torch.stack([tap_major(v) for v in q]), torch.stack(s)
        return _stamped(self._qcache, "stages", ws, build)

    def _fused_dil_chain(self, x: torch.Tensor, sigma_emb: torch.Tensor):
        """The dilation stack as fused stages.  Stage i's GroupNorm
        denominators come from the moments [sum y, sum y^2] that stage i-1
        emitted (the first from x), so the normalisation needs no pass of
        its own over the activations.  In int8 each stage also gets a
        per-item bound on its conv input, max_c(amax_c * |a_c|) * 1.02
        (|gelu(v)| <= |v|), from the per-channel amax that stage i-1
        emitted as its third moment."""
        B, F, T, N = x.shape
        g = GN_GROUPS
        cg = N // g
        n = F * T * cg

        def denom_from(s1, s2):
            m = (s1 / (F * T)).reshape(B, g, cg).mean(-1)
            sq = (s2 / (F * T)).reshape(B, g, cg).mean(-1)
            var = (sq - m * m) * (n / (n - 1.0))
            std = torch.sqrt(torch.clamp(var, min=0.0))
            return torch.repeat_interleave(std + GN_EPS, cg, dim=-1)

        # every stage's sigma affine and gate as one matmul (in the
        # embedding's dtype, as the Linear modules compute them), and the
        # stages' GroupNorm gains and kernels stacked once per block: the
        # same arithmetic as the per-stage modules in a fraction of the
        # launches
        nd, dt, et = self.num_dils, x.dtype, sigma_emb.dtype
        lins = [self._sub(k, i) for k in ("affine", "gate") for i in range(nd)]
        kern = torch.cat([m.kernel for m in lins], dim=1).to(et)
        bias = torch.cat([m.bias for m in lins]).to(et)
        ag = (sigma_emb @ kern + bias).float().view(B, 2, nd, N)
        gains = torch.stack([self._sub("norm", i).gamma for i in range(nd)])
        num = gains.float()[None] * (ag[:, 0] + 1.0)  # (B, nd, N)
        ws = torch.stack([self._sub("H", i).weight for i in range(nd)]).to(dt)
        x32 = x.float()
        s1, s2 = x32.sum((1, 2)), (x32 * x32).sum((1, 2))
        if self.int8:
            qw, sw = self._quantized()
            amax = x32.abs().amax((1, 2))
        for i in range(nd):
            a = num[:, i] / denom_from(s1, s2)
            if self.int8:
                bound = BOUND_SAFETY * (amax * a.abs()).amax(-1)
                x, mom = fused_stage_int8(x, a, ag[:, 1, i], bound, ws[i],
                                          qw[i], sw[i], 2**i)
                amax = mom[2]
            else:
                x, mom = fused_stage(x, a, ag[:, 1, i], ws[i], 2**i)
            s1, s2 = mom[0], mom[1]
        return x


_RESAMPLE_KERNELS = {
    "linear": np.array([1 / 8, 3 / 8, 3 / 8, 1 / 8], np.float32),
    "cubic": np.array(
        [-0.01171875, -0.03515625, 0.11328125, 0.43359375,
         0.43359375, 0.11328125, -0.03515625, -0.01171875], np.float32),
    "lanczos3": np.array(
        [0.003689131001010537, 0.015056144446134567, -0.03399861603975296,
         -0.066637322306633, 0.13550527393817902, 0.44638532400131226,
         0.44638532400131226, 0.13550527393817902, -0.066637322306633,
         -0.03399861603975296, 0.015056144446134567, 0.003689131001010537],
        np.float32),
}


def _reflect_pad_t(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad axis 2 (T) of (B, F, T, C) by p on both sides (numpy
    'reflect': the edge sample is not repeated)."""
    T = x.shape[2]
    idx = np.abs(np.arange(-p, T + p))
    idx = np.where(idx >= T, 2 * (T - 1) - idx, idx)
    return x.index_select(2, torch.as_tensor(idx, device=x.device))


def resample_time(x: torch.Tensor, up: bool,
                  kernel: str = "cubic") -> torch.Tensor:
    """Anti-aliased x2 resampling along T of (B, F, T, C) with reflect
    padding.  Down: pad 3, correlate with the kernel at stride 2 -> T/2.
    Up: pad 2, zero-stuff, convolve -> 2T.  Taps are summed in fp32 and the
    result rounded to x.dtype."""
    w = [float(v) for v in _RESAMPLE_KERNELS[kernel]]
    K = len(w)
    x32 = x.float()
    if not up:
        xp = _reflect_pad_t(x32, 3)
        To = (xp.shape[2] - K) // 2 + 1
        acc = sum(w[k] * xp[:, :, k:k + 2 * To - 1:2, :] for k in range(K))
        return acc.to(x.dtype)
    wr = w[::-1]
    xp = _reflect_pad_t(x32, 2)
    T = x.shape[2]
    even = sum(wr[2 * j] * xp[:, :, j:j + T, :] for j in range(K // 2))
    odd = sum(wr[2 * j + 1] * xp[:, :, j + 1:j + 1 + T, :]
              for j in range(K // 2))
    out = torch.stack([even, odd], dim=3).reshape(
        x.shape[0], x.shape[1], 2 * T, x.shape[3])
    return out.to(x.dtype)
