"""CQTDiff+ (the octave-banded CQT U-Net of BABE), plain PyTorch in float32.

Written from the architecture: per octave a 1x1 init block, a ResnetBlock
of frequency-dilated (5,3) convs, x2 time down-sampling and the auxiliary
pyramid conv of the raw CQT; a bottleneck; a decoder with per-octave
output heads.  Each dilation stage is GroupNorm (a centered, unbiased std
per group, no mean subtraction of x) * (1 + affine(emb)), exact-erf gelu,
the conv at dilation (2^i, 1), and the gated residual (x + h * gate(emb)) /
sqrt 2.  Parameters are a flat dict keyed by the names of the port's
modules, so one seeded set of tensors serves both; nothing here reads a
prepared or packed weight.

``quant_bits`` runs the (5,3) stages of the stacks at least
``quant_min_channels`` wide with their convs in integers of that many bits
(``quantized_stage``: the int8 configuration's semantics at 8 bits, its
control at 4).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as Fn

from perfbench.reference.cqt import frame

INV_SQRT2 = 1.0 / math.sqrt(2.0)
GN_GROUPS = 8
GN_EPS = 1e-7
# the int8 stage's inflation of its analytic bound (the configuration's)
BOUND_SAFETY = 1.02
_CUBIC = (-0.01171875, -0.03515625, 0.11328125, 0.43359375,
          0.43359375, 0.11328125, -0.03515625, -0.01171875)


@dataclass(frozen=True)
class NetConfig:
    num_octs: int = 7
    bins_per_oct: int = 64
    emb_dim: int = 256
    Ns: tuple = (64, 96, 96, 128, 128, 256, 256)
    num_dils: tuple = (2, 3, 4, 5, 6, 7, 7)
    fs: float = 22050.0
    audio_len: int = 184184
    beta: float = 1.0
    quant_bits: int | None = None
    quant_min_channels: int = 96

    @property
    def frame(self):
        return frame(self.num_octs, self.bins_per_oct, self.fs,
                     self.audio_len, self.beta)


def _taps(kf: int, kt: int, dil):
    return [(i, j, i * dil[0], j * dil[1]) for i in range(kf)
            for j in range(kt)]


class _TapConv(torch.autograd.Function):
    """A 'SAME' conv as one float32 product per tap, summed: the input
    shifted by the tap's offset times the tap's C x N kernel.  Its backward
    is the same sums transposed; it keeps only x and w."""

    @staticmethod
    def forward(ctx, x, w, dil):
        kf, kt = w.shape[:2]
        pf, pt = dil[0] * (kf // 2), dil[1] * (kt // 2)
        B, F, T, _ = x.shape
        xp = Fn.pad(x, (0, 0, pt, pt, pf, pf))
        y = None
        for i, j, oi, oj in _taps(kf, kt, dil):
            v = xp[:, oi:oi + F, oj:oj + T] @ w[i, j]
            y = v if y is None else y + v
        ctx.save_for_backward(x, w)
        ctx.dil = dil
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dil = ctx.dil
        kf, kt = w.shape[:2]
        pf, pt = dil[0] * (kf // 2), dil[1] * (kt // 2)
        B, F, T, C = x.shape
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp = x.new_zeros((B, F + 2 * pf, T + 2 * pt, C))
            for i, j, oi, oj in _taps(kf, kt, dil):
                dxp[:, oi:oi + F, oj:oj + T] += g @ w[i, j].t()
            dx = dxp[:, pf:pf + F, pt:pt + T]
        if ctx.needs_input_grad[1]:
            xp = Fn.pad(x, (0, 0, pt, pt, pf, pf))
            dw = torch.stack([
                (xp[:, oi:oi + F, oj:oj + T].reshape(-1, C).t()
                 @ g.reshape(-1, g.shape[-1]))
                for _, _, oi, oj in _taps(kf, kt, dil)]).view(w.shape)
        return dx, dw, None


def conv(x: torch.Tensor, w: torch.Tensor, dil=(1, 1)):
    """'SAME' conv of x (B, F, T, C) with an odd HWIO kernel (kf, kt, C, N)
    at dilation ``dil`` (along F, along T)."""
    if tuple(w.shape[:2]) == (1, 1):
        return x @ w[0, 0]
    return _TapConv.apply(x, w, tuple(dil))


def group_scale(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """gamma / (std + eps) per item and channel, (B, 1, 1, C): the std
    centered and unbiased over each group of channels."""
    B, F, T, C = x.shape
    g = x.reshape(B, F * T, GN_GROUPS, C // GN_GROUPS)
    std = g.std(dim=(1, 3), correction=1)  # (B, groups)
    std = std.repeat_interleave(C // GN_GROUPS, dim=-1)
    return (gamma / (std + GN_EPS))[:, None, None, :]


def group_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    return x * group_scale(x, gamma)


def linear(P, name, x):
    return x @ P[name + ".kernel"] + P[name + ".bias"]


def embedding(P, sigma_c):
    table = 2.0 * math.pi * sigma_c * P["embedding.RFF_freq"]
    x = torch.cat([torch.sin(table), torch.cos(table)], dim=1)
    for i in range(3):
        x = torch.relu(linear(P, f"embedding.MLP_{i}", x))
    return x


# erf(z) ~ z P(z^2) on |z| <= 3.2, degree 6 (|error| <= 1.4e-3): the gelu
# whose output the int8 configuration quantizes (the JAX package's fit;
# its error lies under the quantization's half step)
_ERF6 = (1.1264247159e+00, -3.6561742760e-01, 9.7881790600e-02,
         -1.7389500700e-02, 1.8964682000e-03, -1.1349870000e-04,
         2.8324000000e-06)


def gelu6(v: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(v * INV_SQRT2, -3.2, 3.2)
    z2, p = z * z, torch.zeros_like(z)
    for c in reversed(_ERF6):
        p = p * z2 + c
    return 0.5 * v * (1.0 + z * p)


def quantized_stage(x, a, gate, w, d: int, bits: int):
    """A (5,3) stage with its conv in ``bits``-bit integers, the value of
    the quantized stage with the gradient of the exact one (straight
    through).  The conv input gelu6(x a) is quantized per item at the bound
    BOUND_SAFETY * max_c(amax_c(x) |a_c|) (|gelu(v)| <= |v|), the kernel
    per output channel at its absolute max, both symmetric with
    round-half-to-even; the products are taken of the dequantized values in
    float32."""
    exact = (x + conv(Fn.gelu(x * a, approximate="none"), w, (d, 1))
             * gate) * INV_SQRT2
    q = 2.0 ** (bits - 1) - 1.0
    with torch.no_grad():
        bound = BOUND_SAFETY * (x.abs().amax((1, 2)) * a.abs()[:, 0, 0]
                                ).amax(-1)
        step = (bound.clamp(min=1e-20) / q)[:, None, None, None]
        h = torch.clamp(torch.round(gelu6(x * a) / step), -q, q) * step
        sw = w.abs().amax((0, 1, 2)).clamp(min=1e-20) / q
        wq = torch.clamp(torch.round(w / sw), -q, q) * sw
        y = (x + conv(h, wq, (d, 1)) * gate) * INV_SQRT2
    return exact + (y - exact).detach()


def resnet_block(P, cfg: NetConfig, pre: str, x_in, emb, dim: int,
                 dim_out: int, num_dils: int, kernel=(5, 3),
                 proj_after: bool = False):
    N = dim if proj_after else dim_out
    x = x_in if dim == N else conv(x_in, P[pre + "proj_in.conv.kernel"])
    bits = (cfg.quant_bits if kernel == (5, 3)
            and N >= cfg.quant_min_channels else None)
    for i in range(num_dils):
        gamma = linear(P, f"{pre}affine_{i}", emb)[:, None, None, :]
        gate = linear(P, f"{pre}gate_{i}", emb)[:, None, None, :]
        w = P[f"{pre}H_{i}.conv.kernel"]
        if bits is not None:
            a = group_scale(x, P[f"{pre}norm_{i}.gamma"]) * (gamma + 1.0)
            x = quantized_stage(x, a, gate, w, 2**i, bits)
            continue
        h = group_norm(x, P[f"{pre}norm_{i}.gamma"])
        h = Fn.gelu(h * (gamma + 1.0), approximate="none")
        x = (x + conv(h, w, (2**i, 1)) * gate) * INV_SQRT2
    if proj_after and N != dim_out:
        x = conv(x, P[pre + "proj_out.conv.kernel"])
    res = x_in if dim == dim_out else conv(x_in, P[pre + "res_conv.conv.kernel"])
    return (x + res) * INV_SQRT2


def _reflect(x, p):
    """x (B, F, T, C) reflect-padded by p along T (the edge not repeated)."""
    T = x.shape[2]
    idx = torch.arange(-p, T + p, device=x.device).abs()
    return x[:, :, torch.where(idx >= T, 2 * (T - 1) - idx, idx)]


def resample_time(x: torch.Tensor, up: bool) -> torch.Tensor:
    """x2 cubic resampling along T of (B, F, T, C), reflect-padded."""
    K = len(_CUBIC)
    if not up:
        xp = _reflect(x, 3)
        To = (xp.shape[2] - K) // 2 + 1
        return sum(_CUBIC[k] * xp[:, :, k:k + 2 * To - 1:2] for k in range(K))
    wr = _CUBIC[::-1]
    xp = _reflect(x, 2)
    T = x.shape[2]
    even = sum(wr[2 * j] * xp[:, :, j:j + T] for j in range(K // 2))
    odd = sum(wr[2 * j + 1] * xp[:, :, j + 1:j + 1 + T] for j in range(K // 2))
    B, F, _, C = x.shape
    return torch.stack([even, odd], dim=3).reshape(B, F, 2 * T, C)


def unet(P, cfg: NetConfig, coeffs, sigma_c):
    """The U-Net on octave coefficients (lowest octave first)."""
    n, bpo, Ns, nd = cfg.num_octs, cfg.bins_per_oct, cfg.Ns, cfg.num_dils
    emb = embedding(P, sigma_c)
    hs, X, pyr = [], None, None
    for i in range(n):
        c = coeffs[n - 1 - i]
        C = torch.stack([c.real, c.imag], dim=-1)
        d_in = Ns[i - 1] if i > 0 else Ns[0]
        C2 = resnet_block(P, cfg, f"downs_{i}_0.", C, emb, 2, d_in, 1, (1, 1))
        if i == 0:
            X, pyr = C2, resample_time(C, up=False)
        elif i < n - 1:
            pyr = torch.cat([resample_time(C, up=False),
                             resample_time(pyr, up=False)], dim=1)
            X = torch.cat([C2, X], dim=1)
        else:
            pyr = torch.cat([C, pyr], dim=1)
            X = torch.cat([C2, X], dim=1)
        X = resnet_block(P, cfg, f"downs_{i}_2.", X, emb, d_in, Ns[i], nd[i])
        hs.append(X)
        if i < n - 1:
            X = resample_time(X, up=False)
        X = (X + conv(pyr, P[f"downs_{i}_1.conv.kernel"])) * INV_SQRT2
    X = resnet_block(P, cfg, "middle_0_1.", X, emb, Ns[-1], Ns[-1], nd[-1])
    Xout = resnet_block(P, cfg, "middle_0_0.", X, emb, Ns[-1], 2, 1, (1, 1),
                        proj_after=True)
    outs = [None] * n
    for p in range(n):
        j = n - 1 - p
        d_out = Ns[j - 1] if j > 0 else Ns[0]
        X = torch.cat([X, hs.pop()], dim=-1)
        X = resnet_block(P, cfg, f"ups_{p}_1.", X, emb, 2 * Ns[j], d_out,
                         nd[j])
        head = resnet_block(P, cfg, f"ups_{p}_0.", X, emb, d_out, 2, 1,
                            (1, 1), proj_after=True)
        Xout = (Xout + head) * INV_SQRT2
        X = X[:, bpo:]
        Out, Xout = Xout[:, :bpo], Xout[:, bpo:]
        outs[p] = torch.complex(Out[..., 0], Out[..., 1])
        if j > 0:
            X, Xout = resample_time(X, up=True), resample_time(Xout, up=True)
    return outs


def model(P, cfg: NetConfig, x: torch.Tensor, sigma_c: torch.Tensor):
    """The raw-audio model: CQT, U-Net, inverse CQT; x [B, L]."""
    fr = cfg.frame
    L = x.shape[-1]
    Y = fr.synthesis(unet(P, cfg, fr.analysis(fr.spectrum(x)), sigma_c))
    return torch.fft.irfft(Y, n=fr.Ls, dim=-1)[..., :L]
