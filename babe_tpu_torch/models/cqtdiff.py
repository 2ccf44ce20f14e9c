"""CQTDiff+ — the octave-banded CQT diffusion U-Net, in PyTorch.

Counterpart of ``babe_tpu/models/cqtdiff.py``:

  raw audio (B,T) --CQT--> per-octave complex coeffs --[encoder: per-octave
  init blocks, freq-dilated ResNet blocks, x2 time downsampling, auxiliary
  "pyramid" path of raw-CQT downsamples]--> bottleneck --[decoder with
  per-octave output heads]--> CQT^-1 --> raw audio (B,T).

Layout is channels-last (B, F, T, C); the octave list is ordered lowest
octave first and consumed highest first, as in the JAX package.

``remat`` rematerializes every ``ResnetBlock`` in the backward pass (the
JAX ``nn.remat`` of the block): under autograd each block runs through
``torch.utils.checkpoint`` (non-reentrant), so only block boundaries are
kept and each block's forward runs again in the backward.  With
``remat_policy="full"`` everything in the block is recomputed; with
``"save_convs"`` the outputs of its ``Conv2d`` convs and the conv
outputs of its fused dilation stages are kept from the first pass and the
recompute runs only the rest (``ConvTape``: the JAX policy
``save_only_these_names("conv_out")``, whose default path runs each
stage's conv as a tagged ``Conv2d``).  Any other policy is "full", as in
JAX.  Training at the flagship config uses remat; serving does not.

``precision`` is an attribute of the network: ``"int8"`` reads the JAX
package's int8 knobs from the environment when it is set
(``ops.conv_kernels.Int8Config.from_env``: ``BABE_INT8_SCALE``,
``BABE_INT8_MINC``, ``BABE_INT8_OPS``, ``BABE_INT8_FUSED``,
``BABE_INT8_BWD``) and holds them on the network's modules.  By default
every (5,3) dilation stack with at least 96 channels runs the fused int8
chain (kernel K3) with analytic-bound scales: the JAX package's
``BABE_PRECISION=int8 BABE_INT8_FUSED=1`` on its TPU.  ``BABE_INT8_FUSED=0``
runs the JAX unfused loop instead, one int8 conv (C8) per stage, and with
``BABE_INT8_BWD=1`` the guidance gradient's input cotangent in int8 too:
``BABE_INT8_FUSED=0 BABE_INT8_BWD=1`` is the JAX API's
``precision="int8"``.  ``BABE_INT8_SCALE=amax`` quantizes every int8 conv
input at its dynamic per-item amax (no fused chain), and
``BABE_INT8_OPS=all`` puts the 1x1s of at least ``minc`` channels in int8
too.  Everything else (the narrower stacks, the pyramid convs, the CQT)
keeps the compute dtype.  ``None`` and ``"bf16"`` run every conv in the
compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from babe_tpu_torch.models.blocks import (
    INV_SQRT2,
    AddFreqEncodingRFF,
    Conv1d,
    Conv2d,
    Linear,
    RelativePositionBias,
    ResnetBlock,
    RFF_MLP_Block,
    resample_time,
)
from babe_tpu_torch.ops.conv_kernels import ConvTape, Int8Config
from babe_tpu_torch.ops.cqt import CQT, get_cqt

PRECISIONS = (None, "bf16", "int8")


class CQTDiffPlusNet(nn.Module):
    """The network on CQT coefficient lists.

    ``forward(coeffs, sigma)``: coeffs is the list from ``CQT.fwd`` (lowest
    octave first, each [B, bins_per_oct, M_o] complex), sigma is cnoise
    [B, 1].  Returns the output coefficient list (same shapes)."""

    def __init__(self, num_octs: int = 7, bins_per_oct: int = 64,
                 emb_dim: int = 256,
                 Ns: Sequence[int] = (64, 96, 96, 128, 128, 256, 256),
                 num_dils: Sequence[int] = (2, 3, 4, 5, 6, 7, 7),
                 use_norm: bool = True, use_fencoding: bool = False,
                 attention_layers: Sequence[int] = (0,) * 8,
                 attention_dict=None, num_bottleneck_layers: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 precision: str | None = None, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        self.remat = bool(remat)
        self.remat_policy = str(remat_policy)
        n, bpo = num_octs, bins_per_oct
        self.num_octs, self.bins_per_oct = n, bpo
        self.Ns, self.num_dils = tuple(Ns), tuple(num_dils)
        self.use_fencoding = use_fencoding
        self.num_bottleneck_layers = num_bottleneck_layers
        self.compute_dtype = compute_dtype
        attention_layers = tuple(attention_layers)

        def attn(i):
            if i < len(attention_layers) and attention_layers[i]:
                return dict(attention_dict)
            return None

        self.embedding = RFF_MLP_Block(emb_dim=emb_dim)
        for i in range(n):
            cin = 2
            if use_fencoding:
                setattr(self, f"freq_encodings_{i}",
                        AddFreqEncodingRFF(bpo, 32))
                cin = 2 + 64
            dim_in = Ns[i - 1] if i > 0 else Ns[i]
            dim_out = Ns[i]
            setattr(self, f"downs_{i}_0", ResnetBlock(
                cin, dim_in, use_norm, num_dils=1, kernel_size=(1, 1),
                emb_dim=emb_dim))
            setattr(self, f"downs_{i}_2", ResnetBlock(
                dim_in, dim_out, use_norm, num_dils=num_dils[i],
                emb_dim=emb_dim, attention_dict=attn(i), Fdim=(i + 1) * bpo))
            setattr(self, f"downs_{i}_1", Conv2d(2, dim_out, (5, 3)))
        for b in range(num_bottleneck_layers):
            setattr(self, f"middle_{b}_1", ResnetBlock(
                Ns[-1], Ns[-1], use_norm, num_dils=num_dils[-1],
                emb_dim=emb_dim, attention_dict=attn(n), Fdim=n * bpo))
            setattr(self, f"middle_{b}_0", ResnetBlock(
                Ns[-1], 2, use_norm, num_dils=1, kernel_size=(1, 1),
                proj_place="after", emb_dim=emb_dim))
        for pidx in range(n):
            j = n - 1 - pidx
            if j == 0:
                dim_in, dim_out = Ns[0] * 2, Ns[0]
            else:
                dim_in, dim_out = Ns[j] * 2, Ns[j - 1]
            setattr(self, f"ups_{pidx}_1", ResnetBlock(
                dim_in, dim_out, use_norm, num_dils=num_dils[j],
                emb_dim=emb_dim, attention_dict=attn(j), Fdim=(j + 1) * bpo))
            setattr(self, f"ups_{pidx}_0", ResnetBlock(
                dim_out, 2, use_norm, num_dils=1, kernel_size=(1, 1),
                proj_place="after", emb_dim=emb_dim))
        self.set_precision(precision)

    def set_precision(self, precision: str | None) -> None:
        """Put the network in ``precision`` (see the module doc).  The
        int8 kernels are quantized anew on the next int8 evaluation, so
        this also picks up weights edited through ``.data``."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be 'bf16', 'int8' or None, "
                             f"got {precision!r}")
        self.precision = precision
        cfg = Int8Config.from_env() if precision == "int8" else None
        self.int8_config = cfg
        for m in self.modules():
            if isinstance(m, (ResnetBlock, Conv2d)):
                m.set_int8(cfg)

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        """Seeded EDM init of every weight and RFF buffer (on the CPU
        generator ``gen``; GroupNorm gains 1, biases 0)."""
        for m in self.modules():
            if isinstance(m, (Linear, Conv2d, Conv1d, RelativePositionBias)):
                m.reset_parameters(gen)
            elif isinstance(m, (RFF_MLP_Block, AddFreqEncodingRFF)):
                m.reset_buffers(gen)

    def _block(self, name: str, x, sigma_emb):
        """Run the ResnetBlock ``name``, rematerialized under ``remat``."""
        blk = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()):
            return blk(x, sigma_emb)
        if self.remat_policy != "save_convs":
            return checkpoint(blk, x, sigma_emb, use_reentrant=False)
        tape = ConvTape()

        def run(x_, s_):
            with tape.active():
                return blk(x_, s_)

        return checkpoint(run, x, sigma_emb, use_reentrant=False)

    def forward(self, coeffs, sigma):
        n, bpo = self.num_octs, self.bins_per_oct
        assert len(coeffs) == n
        cdt = self.compute_dtype
        sigma_emb = self.embedding(sigma).to(cdt)
        blk = self._block

        def as_real(c):
            return torch.stack([c.real, c.imag], dim=-1).to(cdt)

        hs = []
        X = pyr = None
        for i in range(n):
            C = as_real(coeffs[n - 1 - i])  # highest octave first
            C2 = (getattr(self, f"freq_encodings_{i}")(C) if self.use_fencoding
                  else C)
            C2 = blk(f"downs_{i}_0", C2, sigma_emb)
            if i == 0:
                X = C2
                pyr = resample_time(C, up=False)
            elif i < n - 1:
                pyr = torch.cat([resample_time(C, up=False),
                                 resample_time(pyr, up=False)], dim=1)
                X = torch.cat([C2, X], dim=1)
            else:
                pyr = torch.cat([C, pyr], dim=1)
                X = torch.cat([C2, X], dim=1)
            X = blk(f"downs_{i}_2", X, sigma_emb)
            hs.append(X)
            if i < n - 1:
                X = resample_time(X, up=False)
            pyr_proj = getattr(self, f"downs_{i}_1")(pyr)
            X = (X + pyr_proj) * INV_SQRT2

        Xout = None
        for b in range(self.num_bottleneck_layers):
            X = blk(f"middle_{b}_1", X, sigma_emb)
            Xout = blk(f"middle_{b}_0", X, sigma_emb)

        outs = [None] * n
        for pidx in range(n):
            j = n - 1 - pidx
            X = torch.cat([X, hs.pop()], dim=-1)
            X = blk(f"ups_{pidx}_1", X, sigma_emb)
            out_head = blk(f"ups_{pidx}_0", X, sigma_emb)
            Xout = (Xout + out_head) * INV_SQRT2
            X = X[:, bpo:]
            Out, Xout = Xout[:, :bpo], Xout[:, bpo:]
            Outf = Out.float()
            outs[pidx] = torch.complex(Outf[..., 0], Outf[..., 1])
            if j > 0:
                X = resample_time(X, up=True)
                Xout = resample_time(Xout, up=True)
        return outs


class CQTDiffPlus(nn.Module):
    """Raw-audio model: CQT -> ``CQTDiffPlusNet`` -> CQT^-1.

        model = CQTDiffPlus.from_config(cfg).init(seed=0, device="cuda")
        x_hat = model.apply(x, cnoise)     # x [B,T], cnoise [B,1]
    """

    def __init__(self, num_octs=7, bins_per_oct=64, fs=22050.0,
                 audio_len=184184, window="kaiser", beta=1.0, emb_dim=256,
                 Ns=(64, 96, 96, 128, 128, 256, 256),
                 num_dils=(2, 3, 4, 5, 6, 7, 7), use_norm=True,
                 use_fencoding=False, attention_layers=(0,) * 8,
                 attention_dict=None, num_bottleneck_layers=1,
                 compute_dtype=torch.float32, cqt_mode="native",
                 precision=None, remat=False, remat_policy="full",
                 net: CQTDiffPlusNet | None = None):
        super().__init__()
        self.cqt: CQT = get_cqt(num_octs, bins_per_oct, float(fs),
                                int(audio_len), window=window,
                                beta=float(beta), mode=cqt_mode)
        self.audio_len = int(audio_len)
        self.net = net if net is not None else CQTDiffPlusNet(
            num_octs=num_octs, bins_per_oct=bins_per_oct, emb_dim=emb_dim,
            Ns=tuple(Ns), num_dils=tuple(num_dils), use_norm=use_norm,
            use_fencoding=use_fencoding,
            attention_layers=tuple(attention_layers),
            attention_dict=attention_dict,
            num_bottleneck_layers=num_bottleneck_layers,
            compute_dtype=compute_dtype, precision=precision, remat=remat,
            remat_policy=remat_policy)

    @classmethod
    def from_config(cls, args, compute_dtype=None,
                    precision=None) -> "CQTDiffPlus":
        net = args.network
        if compute_dtype is None:
            compute_dtype = (torch.bfloat16 if args.exp.get("use_bf16", False)
                             else torch.float32)
        return cls(
            num_octs=int(net.cqt.num_octs),
            bins_per_oct=int(net.cqt.bins_per_oct),
            fs=float(args.exp.sample_rate), audio_len=int(args.exp.audio_len),
            window=net.cqt.get("window", "kaiser"),
            beta=float(net.cqt.get("beta", 1.0)),
            emb_dim=int(net.emb_dim), Ns=tuple(net.Ns),
            num_dils=tuple(net.num_dils), use_norm=bool(net.use_norm),
            use_fencoding=bool(net.use_fencoding),
            attention_layers=tuple(net.attention_layers),
            attention_dict=net.get("attention_dict"),
            num_bottleneck_layers=int(net.get("num_bottleneck_layers", 1)),
            compute_dtype=compute_dtype,
            cqt_mode=net.cqt.get("mode", "native"),
            precision=precision, remat=bool(args.exp.get("remat", False)),
            remat_policy=str(args.exp.get("remat_policy", "full")))

    def with_audio_len(self, audio_len: int) -> "CQTDiffPlus":
        """The same network (shared weights) behind a CQT frame built for
        ``audio_len`` samples: the weights are length-agnostic, the frame
        is not."""
        c = self.cqt
        return CQTDiffPlus(
            num_octs=c.num_octs, bins_per_oct=c.bins_per_oct, fs=c.fs,
            audio_len=audio_len, window=c.window, beta=c.beta,
            cqt_mode=c.mode, net=self.net)

    def init(self, seed: int = 0, device="cuda") -> "CQTDiffPlus":
        """Seeded random weights (EDM init, drawn on the CPU so a seed gives
        the same weights everywhere), then move to ``device``."""
        gen = torch.Generator().manual_seed(int(seed))
        self.net.reset_parameters(gen)
        return self.to(device)

    def apply(self, x: torch.Tensor, cnoise: torch.Tensor) -> torch.Tensor:
        """Full forward: CQT -> U-Net -> CQT^-1 -> crop."""
        T = x.shape[-1]
        outs = self.net(self.cqt.fwd(x), cnoise)
        return self.cqt.bwd(outs, length=T)

    def apply_hpf_DC(self, x: torch.Tensor) -> torch.Tensor:
        return self.cqt.apply_hpf_DC(x)

    def fused_denoiser(self, edm):
        """EDM denoiser with CQT/hpf FFT sharing:
        hpf_DC(cskip*x + cout*net(cin*x, cnoise)) with one rfft/irfft pair
        (the analysis spectrum serves the skip term and the hpf mask
        multiplies the synthesis spectrum before the one inverse FFT)."""
        cqt = self.cqt

        def denoiser(x, sigma):
            sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                    device=x.device)
            if sigma.ndim == 0:
                sigma = sigma[None, None]
            elif sigma.ndim == 1:
                sigma = sigma[:, None]
            T = x.shape[-1]
            cskip, cout = edm.cskip(sigma), edm.cout(sigma)
            cin, cnoise = edm.cin(sigma), edm.cnoise(sigma)
            X = cqt.spectrum(x)
            coeffs = [c * cin[..., None] for c in cqt.fwd_spectrum(X)]
            Y = cqt.bwd_spectrum(self.net(coeffs, cnoise))
            D = cskip * X + cout * Y
            D = D * cqt.mask(x.device)
            return torch.fft.irfft(D, n=cqt.Ls, dim=-1)[..., :T]

        return denoiser
