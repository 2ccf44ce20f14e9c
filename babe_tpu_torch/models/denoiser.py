"""MultiStage STFT denoiser for pre-cleaning historical recordings, in
PyTorch.

Counterpart of ``babe_tpu/models/denoiser.py``: the reference's two-stage
DenseNet U-Net over complex STFTs, used by the denoise -> blind-BWE chain.
The modules carry the JAX package's names; the layout is PyTorch's NCHW,
(B, C, frames, bins), where the JAX package is channels-last, and the
weight bridge (``utils/weights.py``: ``load_denoiser_flax`` /
``denoiser_to_flax``) transposes the kernels.

Every conv pads by reflection (the 'same' split of ``_reflect_conv``, and
(2, 2, 2, 2) before each strided down-conv); the up-convs are unpadded
transposed convs.  No hand kernel: the JAX package runs these convs as
plain XLA convs, and here they are cuDNN's, in fp32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from babe_tpu_torch.ops.stft import hamming_window, istft, stft
from babe_tpu_torch.utils.device import check_device

NS = (64, 64, 64, 128, 128, 256, 512)
SS = ((2, 2),) * 6
OLA_OVERLAP = 1024


class _ReflectConv(nn.Conv2d):
    """A conv whose input is reflect-padded by ``pad`` = (top, bottom,
    left, right); the default is 'same' with the extra row and column at
    the end."""

    def __init__(self, cin, cout, ksize, stride=(1, 1), pad=None):
        super().__init__(cin, cout, ksize, stride=stride)
        kh, kw = self.kernel_size
        self.pad = pad if pad is not None else (
            (kh - 1) // 2, kh - 1 - (kh - 1) // 2,
            (kw - 1) // 2, kw - 1 - (kw - 1) // 2)

    def forward(self, x):
        ph0, ph1, pw0, pw1 = self.pad
        if any(self.pad):
            x = F.pad(x, (pw0, pw1, ph0, ph1), mode="reflect")
        return super().forward(x)


class DenseBlock(nn.Module):
    """Layer i sees the concatenation [x_{i-1}, ..., x_0, input]."""

    def __init__(self, num_layers, N0, N, ksize=(3, 3)):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"H_{i}_0", _ReflectConv(N0 + i * N, N, ksize))

    def forward(self, x):
        x_ = F.elu(self.H_0_0(x))
        for i in range(1, self.num_layers):
            x = torch.cat([x_, x], dim=1)
            x_ = F.elu(getattr(self, f"H_{i}_0")(x))
        return x_


class IBlock(nn.Module):
    """DenseBlock plus a residual 1x1 projection."""

    def __init__(self, N0, N, num_tfc):
        super().__init__()
        self.tfc = DenseBlock(num_tfc, N0, N)
        self.conv2d_res = _ReflectConv(N0, N, (1, 1))

    def forward(self, x):
        return self.tfc(x) + self.conv2d_res(x)


class EBlock(nn.Module):
    def __init__(self, N0, N01, N, S, num_tfc):
        super().__init__()
        self.i_block = IBlock(N0, N01, num_tfc)
        ks = (S[0] + 2, S[1] + 2)
        self.conv2d_2_0 = _ReflectConv(N01, N, ks, stride=S, pad=(2, 2, 2, 2))

    def forward(self, x):
        x = self.i_block(x)
        return F.elu(self.conv2d_2_0(x)), x


def _crop_center(big, shape):
    """Crop (B, C, H, W) ``big`` to ``shape``'s H and W, the offsets
    floor-divided."""
    dh = (big.shape[2] - shape[2]) // 2
    dw = (big.shape[3] - shape[3]) // 2
    return big[:, :, dh:dh + shape[2], dw:dw + shape[3]]


class DBlock(nn.Module):
    def __init__(self, N0, N, S, num_tfc):
        super().__init__()
        self.S = tuple(S)
        ks = (S[0] + 2, S[1] + 2)
        self.tconv_1_0 = nn.ConvTranspose2d(N0, N, ks, stride=S, padding=0)
        self.projection = _ReflectConv(N0, N, (1, 1))
        self.i_block = IBlock(2 * N, N, num_tfc)

    def forward(self, x, bridge):
        up = F.elu(self.tconv_1_0(x))
        x2 = x.repeat_interleave(self.S[0], dim=2).repeat_interleave(
            self.S[1], dim=3)
        x2 = self.projection(x2)
        h = _crop_center(up, x2.shape) + x2
        hb = torch.cat([_crop_center(h, bridge.shape), bridge], dim=1)
        return self.i_block(hb)


class Encoder(nn.Module):
    def __init__(self, N0, Ns, Ss, depth, num_tfc):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            Nin = N0 if i == 0 else Ns[i]
            self.add_module(f"eblocks_{i}", EBlock(Nin, Ns[i], Ns[i + 1],
                                                   Ss[i], num_tfc))
        self.i_block = IBlock(Ns[depth], Ns[depth], num_tfc)

    def forward(self, x):
        skips = []
        for i in range(self.depth):
            x, skip = getattr(self, f"eblocks_{i}")(x)
            skips.append(skip)
        return self.i_block(x), skips


class Decoder(nn.Module):
    def __init__(self, Ns, Ss, depth, num_tfc):
        super().__init__()
        self.depth = depth
        for i in range(depth, 0, -1):
            self.add_module(f"dblocks_{i - 1}", DBlock(Ns[i], Ns[i - 1],
                                                       Ss[i - 1], num_tfc))

    def forward(self, x, skips):
        for i in range(self.depth, 0, -1):
            x = getattr(self, f"dblocks_{i - 1}")(x, skips[i - 1])
        return x


class SAM(nn.Module):
    """Supervised attention module."""

    def __init__(self, n_feat):
        super().__init__()
        self.conv1 = _ReflectConv(n_feat, n_feat, (3, 3))
        self.conv2 = _ReflectConv(n_feat, 2, (3, 3))
        self.conv3 = _ReflectConv(2, n_feat, (3, 3))

    def forward(self, feats, input_spec):
        x1 = self.conv1(feats)
        pred = self.conv2(feats) + input_spec
        M = torch.sigmoid(self.conv3(pred))
        return x1 * M + feats, pred


def _freq_table(f_dim: int) -> np.ndarray:
    """10 cosine positional channels over frequency, [F, 10]."""
    n = np.arange(f_dim) / (f_dim - 1)
    return np.stack([np.cos((2**k) * np.pi * n) for k in range(10)],
                    axis=-1).astype(np.float32)


class MultiStageDenoiseNet(nn.Module):
    """Input (B, 2, frames, bins): real and imaginary parts as channels.
    With two stages it returns (pred2, pred1), with one the prediction."""

    def __init__(self, depth=6, num_tfc=3, num_stages=2, use_fencoding=True,
                 use_SAM=True, f_dim=513):
        super().__init__()
        self.num_stages = num_stages
        self.use_fencoding = use_fencoding
        self.use_SAM = use_SAM
        cin = 2
        if use_fencoding:
            # a learned parameter initialised to the table (not a buffer)
            self.freq_encoding_fembeddings = nn.Parameter(
                torch.from_numpy(_freq_table(f_dim)))
            cin += 10
        self.conv2d_1_0 = _ReflectConv(cin, NS[0], (7, 7))
        self.encoder_s1 = Encoder(NS[0], NS, SS, depth, num_tfc)
        self.decoder_s1 = Decoder(NS, SS, depth, num_tfc)
        if num_stages > 1:
            self.sam_1 = SAM(NS[0])
            self.conv2d_2_0 = _ReflectConv(cin, NS[0], (7, 7))
            self.encoder_s2 = Encoder(2 * NS[0], NS, SS, depth, num_tfc)
            self.decoder_s2 = Decoder(NS, SS, depth, num_tfc)
        self.finalblock_conv2 = _ReflectConv(NS[0], 2, (3, 3))

    def forward(self, x):
        if self.use_fencoding:
            B, _, T, Fd = x.shape
            enc = self.freq_encoding_fembeddings.t()[None, :, None, :]
            xw = torch.cat([x, enc.expand(B, 10, T, Fd).to(x.dtype)], dim=1)
        else:
            xw = x
        h = F.elu(self.conv2d_1_0(xw))
        h, skips = self.encoder_s1(h)
        feats1 = self.decoder_s1(h, skips)
        if self.num_stages > 1:
            Fout, pred1 = self.sam_1(feats1, x)
            h2 = F.elu(self.conv2d_2_0(xw))
            h2 = torch.cat([h2, Fout if self.use_SAM else feats1], dim=1)
            h2, skips2 = self.encoder_s2(h2)
            feats2 = self.decoder_s2(h2, skips2)
            return self.finalblock_conv2(feats2), pred1
        return self.finalblock_conv2(feats1)


def _fp32_convs(device: torch.device):
    """cuDNN in strict fp32 on the card (TF32 would drift from the fp32
    reference); nothing to set on the CPU."""
    if device.type == "cuda":
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    return contextlib.nullcontext()


class MultiStageDenoiser:
    """The network with its STFT framing and the chunked overlap-add over
    a whole recording.  ``net`` holds the weights; the denoiser runs on
    ``device`` (the card unless the CPU is asked for)."""

    def __init__(self, depth=6, num_tfc=3, num_stages=2, use_fencoding=True,
                 use_SAM=True, f_dim=513, fs=22050, stft_win_size=1024,
                 stft_hop_size=256, segment_seconds=5.0, seed: int = 0,
                 device="cuda"):
        self.device = check_device(device, "MultiStageDenoiser")
        # a seeded init that leaves the global generator as it was
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = MultiStageDenoiseNet(
                depth=depth, num_tfc=num_tfc, num_stages=num_stages,
                use_fencoding=use_fencoding, use_SAM=use_SAM, f_dim=f_dim)
        self.net.requires_grad_(False).eval().to(self.device)
        self.num_stages = num_stages
        self.fs = int(fs)
        self.win = int(stft_win_size)
        self.hop = int(stft_hop_size)
        self.segment = int(self.fs * segment_seconds)

    @classmethod
    def from_config(cls, dcfg, device="cuda") -> "MultiStageDenoiser":
        return cls(
            depth=int(dcfg.get("depth", 6)),
            num_tfc=int(dcfg.get("num_tfc", 3)),
            num_stages=int(dcfg.get("num_stages", 2)),
            use_fencoding=bool(dcfg.get("use_fencoding", True)),
            use_SAM=bool(dcfg.get("use_SAM", True)),
            f_dim=int(dcfg.get("f_dim", 513)),
            fs=int(dcfg.get("sample_rate_denoiser", 22050)),
            stft_win_size=int(dcfg.get("stft_win_size", 1024)),
            stft_hop_size=int(dcfg.get("stft_hop_size", 256)),
            segment_seconds=float(dcfg.get("segment_size", 5.0)),
            device=device,
        )

    @torch.no_grad()
    def apply_model(self, x: torch.Tensor) -> torch.Tensor:
        """Denoise one time segment [B, L]: STFT (padded by one window on
        the right, hamming, center=False) -> net -> iSTFT, cropped to L."""
        x = x.to(self.device, torch.float32)
        X = stft(F.pad(x, (0, self.win)), self.win, self.hop)  # [B, F, Tf]
        Xr = torch.stack([X.real, X.imag], dim=1).transpose(2, 3)
        with _fp32_convs(self.device):
            out = self.net(Xr)
        if self.num_stages > 1:
            out = out[0]
        out = out.transpose(2, 3)  # [B, 2, F, Tf]
        y = istft(torch.complex(out[:, 0], out[:, 1]), self.win, self.hop)
        return y[..., :x.shape[-1]]

    @torch.no_grad()
    def apply_chunked_ola(self, x: torch.Tensor) -> torch.Tensor:
        """Denoise a recording [B, L] segment by segment, cross-fading
        consecutive segments with a hamming window over 1024 samples; the
        last segment is zero-padded to full length."""
        x = x.to(self.device, torch.float32)
        seg, ov = self.segment, OLA_OVERLAP
        w = torch.as_tensor(hamming_window(2 * ov), device=self.device)
        wl, wr = w[:ov], w[ov:]
        L = x.shape[-1]
        out = torch.zeros_like(x)
        pointer, first = 0, True
        while True:
            if pointer + seg < L:
                chunk = self.apply_model(x[:, pointer:pointer + seg])
                if first:
                    chunk = torch.cat([chunk[:, :seg - ov],
                                       chunk[:, seg - ov:] * wr], dim=-1)
                else:
                    chunk = torch.cat([chunk[:, :ov] * wl,
                                       chunk[:, ov:seg - ov],
                                       chunk[:, seg - ov:] * wr], dim=-1)
                out[:, pointer:pointer + seg] += chunk
                pointer += seg - ov
                first = False
            else:
                tail = x[:, pointer:]
                n = tail.shape[-1]
                chunk = self.apply_model(F.pad(tail, (0, seg - n)))
                if not first:
                    chunk = torch.cat([chunk[:, :ov] * wl, chunk[:, ov:]],
                                      dim=-1)
                out[:, pointer:] += chunk[:, :n]
                return out


def setup_denoiser(args, device="cuda") -> MultiStageDenoiser:
    """Build the denoiser of ``args.tester.denoiser`` and load its
    checkpoint: a ``.ckpt`` pickle holding ``{"params": tree}`` in the JAX
    package's layout, or a reference ``.pt`` torch checkpoint (its
    ``network`` weights first, converted to that layout and filled
    non-strictly: an entry the checkpoint lacks keeps the seeded init, as
    in the JAX package).  A path that does not exist prints a warning and
    keeps the seeded init (seed 0), as the JAX package keeps its own
    seeded init."""
    from babe_tpu_torch.testers.tester import read_checkpoint
    from babe_tpu_torch.utils.torch_ckpt import (fill_variables,
                                                 load_torch_checkpoint)
    from babe_tpu_torch.utils.weights import (denoiser_to_flax,
                                              load_denoiser_flax)

    dcfg = args.tester.denoiser
    model = MultiStageDenoiser.from_config(dcfg, device=device)
    path = str(dcfg.get("checkpoint_path", dcfg.get("checkpoint", "")))
    if path and os.path.exists(path):
        if path.endswith(".pt"):
            params = fill_variables(
                {"params": denoiser_to_flax(model.net)},
                load_torch_checkpoint(path, prefer="network"),
                strict=False)["params"]
        else:
            payload = read_checkpoint(path)
            if "params" not in payload:
                raise ValueError(f"denoiser checkpoint {path!r} holds no "
                                 f"'params' entry")
            params = payload["params"]
        load_denoiser_flax(model.net, params)
        model.net.to(model.device)
    else:
        print(f"warning: denoiser checkpoint {path!r} not found; using "
              f"random init")
    return model
