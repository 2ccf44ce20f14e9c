"""The octave-banded invertible CQT (NSGT, "native" frame), plain PyTorch.

A frozen copy of the port's native-mode frame: 5-smooth time sizes per
octave, kaiser windows, the painless dual, the DC and Nyquist bands kept
in the frame operator but given no coefficients.  Analysis is an rfft, a
gather of each band's bins, the window and a batched ifft; synthesis the
batched fft, the dual window and a gather-based overlap-add.  Every sum in
float32 (complex64); the frame is host numpy in float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def next_fast_len(n: int, even: bool = True) -> int:
    """Smallest 5-smooth integer >= n (even if asked)."""
    n = max(int(n), 2)
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1 and (not even or n % 2 == 0):
            return n
        n += 1


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


class Frame:
    """The frame of ``num_octs`` octaves of ``bins_per_oct`` bins for
    ``audio_len`` samples at ``fs``: ``M`` (frames per octave, lowest
    first), ``Ls`` (the FFT length) and the gather plans."""

    def __init__(self, num_octs: int, bins_per_oct: int, fs: float,
                 audio_len: int, beta: float = 1.0):
        self.num_octs, self.bins_per_oct = int(num_octs), int(bins_per_oct)
        self.fs, self.audio_len = float(fs), int(audio_len)
        Ls = self.Ls = next_fast_len(self.audio_len, even=True)
        bpo, n = self.bins_per_oct, self.num_octs
        K = n * bpo
        fmin = self.fs / 2.0 / 2.0**n
        freqs = fmin * 2.0 ** (np.arange(K) / bpo)
        bins_per_hz = Ls / self.fs
        ratio = 2.0 ** (1.0 / bpo) - 2.0 ** (-1.0 / bpo)
        half = np.maximum(2, np.round(freqs * ratio * bins_per_hz / 2.0)
                          ).astype(int)
        centers = np.round(freqs * bins_per_hz).astype(int)
        support = [int(2 * half[(o + 1) * bpo - 1] + 1) for o in range(n)]
        k = n - 1
        need = max(support[o] << (k - o) for o in range(n))
        m_top = next_fast_len(-(-need >> k), even=False) << k
        self.M = tuple(m_top >> (n - 1 - o) for o in range(n))

        def band(kk):
            h = half[kk]
            d = np.arange(-h, h + 1)
            w = np.kaiser(2 * h + 1, beta)
            l = centers[kk] + d
            keep = (l >= 1) & (l <= Ls // 2 - 1)
            return l[keep], w[keep]

        bands = [band(kk) for kk in range(K)]
        S = np.zeros(Ls)
        S_oct = np.zeros(Ls)
        for o in range(n):
            for kk in range(o * bpo, (o + 1) * bpo):
                l, w = bands[kk]
                for tgt in (S, S_oct):
                    tgt[l] += self.M[o] * w**2
                    tgt[(Ls - l) % Ls] += self.M[o] * w**2
        h_dc = max(2, int(np.ceil(fmin * bins_per_hz)) + half[0])
        np.add.at(S, np.arange(-h_dc, h_dc + 1) % Ls,
                  _next_pow2(2 * h_dc + 1) * np.kaiser(2 * h_dc + 1, beta)**2)
        h_ny = max(2, int(np.ceil((self.fs / 2 - freqs[-1]) * bins_per_hz))
                   + half[-1])
        np.add.at(S, (Ls // 2 + np.arange(-h_ny, h_ny + 1)) % Ls,
                  _next_pow2(2 * h_ny + 1) * np.kaiser(2 * h_ny + 1, beta)**2)
        n_rbins = Ls // 2 + 1
        self.mask_np = (S_oct / S)[:n_rbins].astype(np.float32)
        self.plans = []
        for o in range(n):
            Mo = self.M[o]
            scale = 2.0 * Mo / Ls
            idx = np.zeros((bpo, Mo), np.int64)
            w_ana = np.zeros((bpo, Mo), np.float32)
            w_syn = np.zeros((bpo, Mo), np.float32)
            for j, kk in enumerate(range(o * bpo, (o + 1) * bpo)):
                l, w = bands[kk]
                pos = (l - centers[kk]) % Mo
                idx[j, pos] = l
                w_ana[j, pos] = w * scale
                w_syn[j, pos] = w * Mo / (S[l] * scale)
            # synthesis as a gather: per rfft bin the slots that land on it
            flat, used = idx.reshape(-1), w_syn.reshape(-1) != 0
            buckets: dict[int, list[int]] = {}
            for s_, (l, u) in enumerate(zip(flat, used)):
                if u:
                    buckets.setdefault(int(l), []).append(s_)
            occ = max(len(v) for v in buckets.values())
            gm = np.full((occ, n_rbins), flat.shape[0], np.int64)
            for l, slots in buckets.items():
                gm[:len(slots), l] = slots
            self.plans.append((idx, w_ana, w_syn, gm))
        self._dev: dict = {}

    def _on(self, device):
        key = str(device)
        if key not in self._dev:
            t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            self._dev[key] = ([tuple(t(a) for a in p) for p in self.plans],
                              t(self.mask_np))
        return self._dev[key]

    def mask(self, device) -> torch.Tensor:
        return self._on(device)[1]

    def spectrum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if x.shape[-1] < self.Ls:
            x = torch.nn.functional.pad(x, (0, self.Ls - x.shape[-1]))
        return torch.fft.rfft(x, dim=-1)

    def analysis(self, X: torch.Tensor) -> list[torch.Tensor]:
        """Octave coefficients, lowest first, each [B, bins, M_o]."""
        out = []
        for idx, w_ana, _, _ in self._on(X.device)[0]:
            out.append(torch.fft.ifft(X[..., idx] * w_ana, dim=-1))
        return out

    def synthesis(self, coeffs) -> torch.Tensor:
        """The rfft spectrum the coefficients reconstruct."""
        Y = None
        for c, (_, _, w_syn, gm) in zip(coeffs, self._on(coeffs[0].device)[0]):
            flat = (torch.fft.fft(c, dim=-1) * w_syn).flatten(-2)
            flat = torch.cat([flat, flat.new_zeros((*flat.shape[:-1], 1))],
                             dim=-1)
            v = flat[..., gm].sum(-2)
            Y = v if Y is None else Y + v
        return Y


@functools.lru_cache(maxsize=4)
def frame(num_octs: int, bins_per_oct: int, fs: float, audio_len: int,
          beta: float = 1.0) -> Frame:
    return Frame(num_octs, bins_per_oct, fs, audio_len, beta)
