"""Building blocks of the CQTDiff+ backbone, as ``torch.nn`` modules.

Counterpart of ``babe_tpu/models/blocks.py``.  Activations are channels-last
(B, F, T, C) as in the JAX package, and the module and parameter names follow
the JAX tree (``downs_0_2.H_0.conv.kernel``, ``norm_1.gamma``, ...), so the
weight bridge (``utils/weights.py``) is a mechanical rename.  Parameters are
fp32; compute follows the input dtype (bf16 at the flagship config).

The (5,3) dilation stack of a ``ResnetBlock`` runs the fused-chain form of
the JAX ``_fused_dil_chain``: each stage's GroupNorm denominators come from
the moments the previous stage emitted, and the stage itself is one
``fused_stage`` call (kernel K2 on CUDA, ``dil_stage_ref`` on the CPU).  A
block put in int8 (``int8=True``) runs the JAX ``_fused_dil_chain_int8``
instead: one ``fused_stage_int8`` per stage (kernel K3), each quantizing its
conv input at a per-item scale bounded analytically from the previous
stage's per-channel amax.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from babe_tpu_torch.kernels import tap_major
from babe_tpu_torch.ops.pallas_conv import dilated_conv_nhwc
from babe_tpu_torch.ops.conv_kernels import (
    conv1x1,
    conv5x3_dilated,
    fused_stage,
    fused_stage_int8,
    gelu_exact,
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
    (df, dt), dispatched as the JAX ``conv2d_same`` does: (1,1) kernels are
    matmuls (``conv1x1``); (5,3) kernels with dilation (d,1) go through
    ``conv5x3_dilated`` (kernel K1 on CUDA); every other kernel through
    ``dilated_conv_nhwc`` (kernel K4 on CUDA)."""

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

    def reset_parameters(self, gen=None) -> None:
        _kaiming_uniform_(self.conv.kernel, self.init_weight, gen)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)

    @property
    def weight(self) -> torch.Tensor:
        return self.conv.kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.conv.kernel.to(x.dtype)
        if self.kernel_size == (1, 1):
            y = conv1x1(x, k)
        elif self.kernel_size == (5, 3) and self.dilation[1] == 1:
            y = conv5x3_dilated(x, k, self.dilation[0])
        else:
            y = dilated_conv_nhwc(x, k, self.dilation)
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(y.dtype)
        return y


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


class TimeAttentionBlock(nn.Module):
    """Not ported yet: the flagship config runs without attention."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TimeAttentionBlock is not ported yet (configs with "
            "attention_layers set wait for a later slice of the port)")


class ResnetBlock(nn.Module):
    """Sigma-conditioned dilated-conv residual block.

    (5,3) blocks with norm run the fused dilation chain (one ``fused_stage``
    per dilation, or one ``fused_stage_int8`` when the block is in int8);
    every other block runs the plain loop GroupNorm -> sigma affine ->
    gelu -> conv -> gated residual (a 1x1 matmul, or K4 for other
    kernels)."""

    def __init__(self, dim: int, dim_out: int, use_norm: bool = True,
                 num_dils: int = 6, kernel_size=(5, 3), emb_dim: int = 256,
                 proj_place: str = "before", attention_dict=None,
                 Fdim: int = 128, int8: bool = False):
        super().__init__()
        if attention_dict is not None:
            TimeAttentionBlock(attention_dict, Fdim)
        self.dim, self.dim_out = dim, dim_out
        self.use_norm, self.num_dils = use_norm, num_dils
        self.kernel_size = tuple(kernel_size)
        self.proj_place = proj_place
        N = dim_out if proj_place == "before" else dim
        self.N = N
        if dim != N:
            self.proj_in = Conv2d(dim, N, (1, 1))
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
        self.set_int8(int8)

    @property
    def fused(self) -> bool:
        """Whether the dilation stack runs as a fused chain."""
        return (self.kernel_size == (5, 3) and self.use_norm
                and self.num_dils > 0)

    def set_int8(self, on: bool) -> None:
        """Run the dilation stack in int8 (K3) or not (K2).  Only a fused
        chain has an int8 form.  Drops the quantized kernels, so the next
        int8 evaluation quantizes the weights as they are now."""
        if on and not self.fused:
            raise ValueError("only (5,3) blocks with norm have an int8 chain")
        self.int8 = bool(on)
        self._qcache = None

    def _sub(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"{name}_{i}")

    def forward(self, x_in: torch.Tensor, sigma_emb: torch.Tensor):
        x = x_in
        if self.dim != self.N:
            x = self.proj_in(x)
        if self.fused:
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

    def _quantized(self):
        """The stages' kernels in int8, per output channel: (qw (nd,15,N,N)
        tap-major, sw (nd,N)).  Quantized once per set of weights: the
        cache is rebuilt when a kernel was replaced or changed through its
        parameter (``load_state_dict``, an in-place edit under
        ``torch.no_grad()``, a move to another device), which changes its
        storage or bumps its version counter, and after ``set_int8``.  An
        edit through ``.data`` bumps neither: call ``set_int8`` (or the
        network's ``set_precision``) after one."""
        ws = [self._sub("H", i).weight for i in range(self.num_dils)]
        stamp = tuple((w.data_ptr(), w._version) for w in ws)
        if self._qcache is None or self._qcache[0] != stamp:
            with torch.no_grad():
                q, s = zip(*(quant_weight_per_cout(w) for w in ws))
                self._qcache = (stamp, torch.stack([tap_major(v) for v in q]),
                                torch.stack(s))
        return self._qcache[1:]

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

        # every stage's sigma affine and gate as one matmul, and the stages'
        # GroupNorm gains and kernels stacked once per block: the same
        # arithmetic as the per-stage modules in a fraction of the launches
        nd, dt = self.num_dils, x.dtype
        lins = [self._sub(k, i) for k in ("affine", "gate") for i in range(nd)]
        kern = torch.cat([m.kernel for m in lins], dim=1).to(dt)
        bias = torch.cat([m.bias for m in lins]).to(dt)
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
