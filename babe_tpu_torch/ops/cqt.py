"""Invertible octave-banded Constant-Q transform (NSGT), in PyTorch.

Counterpart of ``babe_tpu/ops/cqt.py``.  The frame construction is the same
host-side numpy (both modes: ``native`` 5-smooth time sizes, and the
``oct_pow2`` / ``compat`` frame of the published checkpoints); the compute
path runs on ``torch.fft``:

  analysis   rfft -> per octave: gather the band's bins, window, batched ifft
  synthesis  per octave: batched fft, dual window, gather-based overlap-add
             through per-frequency contributor maps -> irfft

Gradients come from plain autograd through ``torch.fft`` and the index
gathers (the JAX package installs custom scatter-free vjps for the TPU);
the gathers are ``index_select``s, whose backward is an atomic index_add.
As in the JAX transform, the DC and Nyquist bands are part of the frame but
produce no coefficients, so ``bwd(fwd(x))`` equals ``apply_hpf_DC(x)``, a
multiplication by the precomputed spectral mask.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


def next_fast_len(n: int, even: bool = True) -> int:
    """Smallest 5-smooth integer >= n (even if requested)."""
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


def _kaiser(length: int, beta: float) -> np.ndarray:
    return np.kaiser(length, beta)


def _hann(length: int, beta: float = 0.0) -> np.ndarray:
    return np.hanning(length)


_WINDOWS = {"kaiser": _kaiser, "hann": _hann, "hanning": _hann}


def _take_last(z: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``z[..., idx]`` for a complex z, as an index_select on its real view:
    the backward is then an index_add (atomic adds on the card) instead of
    the sorting accumulate that advanced indexing differentiates into."""
    out = torch.view_as_real(z).index_select(-2, idx.reshape(-1))
    return torch.view_as_complex(out.reshape(*z.shape[:-1], *idx.shape, 2))


@dataclass(frozen=True)
class _OctavePlan:
    """Static gather plan for one octave (host numpy arrays)."""

    M: int  # time frames
    idx: np.ndarray  # [bins_per_oct, M] int32 rfft bin feeding each slot
    w_ana: np.ndarray  # [bins_per_oct, M] float32 analysis window (scaled)
    w_syn: np.ndarray  # [bins_per_oct, M] float32 dual synthesis window
    conj: np.ndarray | None = None  # [bins_per_oct, M] bool: slot reads conj


class CQT:
    """Octave-banded invertible CQT (NSGT, painless case).

    ``fwd(x)``  : [B, T<=audio_len] real -> list (lowest octave first) of
                  [B, bins_per_oct, M_o] complex64, M_o doubling per octave.
    ``bwd(cs)`` : inverse; returns [B, audio_len] real.
    ``apply_hpf_DC(x)`` : projection removing content outside the octave bands.
    """

    def __init__(self, num_octs: int, bins_per_oct: int, fs: float,
                 audio_len: int, window: str = "kaiser", beta: float = 1.0,
                 mode: str = "native"):
        self.num_octs = int(num_octs)
        self.bins_per_oct = int(bins_per_oct)
        self.fs = float(fs)
        self.audio_len = int(audio_len)
        self.mode = mode
        self.window, self.beta = window, float(beta)
        if mode == "native":
            self.Ls = next_fast_len(self.audio_len, even=True)
            self._build_native(window, beta)
        elif mode in ("oct_pow2", "compat"):
            self.Ls = self.audio_len + (self.audio_len % 2)
            self._build_compat(window, beta)
        else:
            raise ValueError(f"unknown CQT mode {mode!r}")
        self._finalize_plans()
        self._dev: dict = {}

    def _build_native(self, window: str, beta: float):
        win_fn = _WINDOWS[window]
        K = self.num_octs * self.bins_per_oct
        nyq = self.fs / 2.0
        fmin = nyq / (2.0**self.num_octs)
        # geometric bin centers; highest bin sits one bin-step below Nyquist
        freqs = fmin * 2.0 ** (np.arange(K) / self.bins_per_oct)
        self.freqs = freqs
        Ls = self.Ls
        bins_per_hz = Ls / self.fs

        # window half-widths: support spans geometric neighbours f_{k-1}..f_{k+1}
        ratio = 2.0 ** (1.0 / self.bins_per_oct) - 2.0 ** (-1.0 / self.bins_per_oct)
        half = np.maximum(2, np.round(freqs * ratio * bins_per_hz / 2.0)).astype(int)
        centers = np.round(freqs * bins_per_hz).astype(int)

        # per-octave time resolution: 5-smooth multiples of 2^(num_octs-1)
        # (exact halving across octaves, FFT-friendly sizes, and markedly less
        # oversampling than pow2 rounding: e.g. 5 s @ 22.05 kHz gets M_top 1280
        # instead of 2048 — a 1.6x reduction of all downstream U-Net compute)
        max_support = [
            int(2 * half[(o + 1) * self.bins_per_oct - 1] + 1)
            for o in range(self.num_octs)
        ]
        k = self.num_octs - 1
        need = max(max_support[o] << (k - o) for o in range(self.num_octs))
        m_top = next_fast_len(-(-need >> k), even=False) << k
        self.M = tuple(m_top >> (self.num_octs - 1 - o) for o in range(self.num_octs))
        for o in range(self.num_octs):
            assert self.M[o] >= max_support[o], "painless condition violated"

        # ---- frame operator S(f) over positive frequencies, with all bands ----
        n_rbins = Ls // 2 + 1
        S = np.zeros(Ls, dtype=np.float64)  # full grid; mirrors added explicitly
        S_oct = np.zeros(Ls, dtype=np.float64)

        def band_window(k: int) -> tuple[np.ndarray, np.ndarray]:
            """absolute rfft bins + window values for octave bin k (clipped)."""
            h = half[k]
            d = np.arange(-h, h + 1)
            w = win_fn(2 * h + 1, beta)
            l = centers[k] + d
            keep = (l >= 1) & (l <= Ls // 2 - 1)
            return l[keep], w[keep]

        band_cache = [band_window(k) for k in range(K)]
        for o in range(self.num_octs):
            Mo = self.M[o]
            for k in range(o * self.bins_per_oct, (o + 1) * self.bins_per_oct):
                l, w = band_cache[k]
                S[l] += Mo * w**2
                S[(Ls - l) % Ls] += Mo * w**2  # mirror band
                S_oct[l] += Mo * w**2
                S_oct[(Ls - l) % Ls] += Mo * w**2

        # DC band: symmetric around bin 0, covers |f| <= fmin-ish
        h_dc = max(2, int(np.ceil(fmin * bins_per_hz)) + half[0])
        w_dc = win_fn(2 * h_dc + 1, beta)
        m_dc = _next_pow2(2 * h_dc + 1)
        l_dc = (np.arange(-h_dc, h_dc + 1)) % Ls
        np.add.at(S, l_dc, m_dc * w_dc**2)
        # Nyquist band: symmetric around Ls//2
        h_ny = max(2, int(np.ceil((nyq - freqs[-1]) * bins_per_hz)) + half[-1])
        w_ny = win_fn(2 * h_ny + 1, beta)
        m_ny = _next_pow2(2 * h_ny + 1)
        l_ny = (Ls // 2 + np.arange(-h_ny, h_ny + 1)) % Ls
        np.add.at(S, l_ny, m_ny * w_ny**2)

        assert S.min() > 0, "frame operator not invertible (coverage gap)"
        self._mask = (S_oct / S)[:n_rbins].astype(np.float32)  # hpf_DC mask

        # ---- per-octave gather plans ----
        plans = []
        for o in range(self.num_octs):
            Mo = self.M[o]
            scale = 2.0 * Mo / Ls
            idx = np.zeros((self.bins_per_oct, Mo), dtype=np.int32)
            w_ana = np.zeros((self.bins_per_oct, Mo), dtype=np.float32)
            w_syn = np.zeros((self.bins_per_oct, Mo), dtype=np.float32)
            for j, k in enumerate(range(o * self.bins_per_oct, (o + 1) * self.bins_per_oct)):
                l, w = band_cache[k]
                pos = (l - centers[k]) % Mo  # window peak at slot 0 (baseband)
                idx[j, pos] = l
                w_ana[j, pos] = w * scale
                w_syn[j, pos] = w * Mo / (S[l] * scale)
            plans.append(_OctavePlan(M=Mo, idx=idx, w_ana=w_ana, w_syn=w_syn))
        self._plans: tuple[_OctavePlan, ...] = tuple(plans)

    def _build_compat(self, window: str, beta: float):
        """`cqt_nsgt_pytorch` "oct"-mode frame, re-derived (no code reuse) from
        the painless CQ-NSGT construction the package adapts (Velasco,
        Holighaus, Doerfler, Grill, DAFx-11; reference call site:
        networks/cqtdiff+.py:620).  Differences from our native mode:

          * frequency grid: LogScale(fmin, fmax, K) INCLUSIVE of fmax = fs/2
            (top bin sits at Nyquist), odiv = num_octs/(K-1) — not 1/bins_per_oct,
          * bandwidths from the constant Q factor
            q = sqrt(2^odiv)/(2^odiv - 1)/2, window length M_k =
            round((f_k/q) * Ls/fs) clipped to min_win=4,
          * per-octave time size = next power of two of the octave's max
            window length (the "powers of 2 for the time sizes" noted at
            reference networks/cqtdiff+.py:18), exact halving enforced,
          * FFT length = audio_len itself (package pads nothing),
          * windows are full-length periodic (peak at the bin center,
            support M_k, asymmetric split for even M_k) — NOT clipped at the
            spectrum edges: slots beyond Nyquist read the conjugate mirror
            of the rfft half-spectrum exactly as the package's complex FFT
            sees X[Ls-l] = conj(X[l]) for real input,
          * analysis scale 1 (plain ifft convention), duals absorb M_o/S.

        The absolute coefficient-scale convention and the kaiser periodic
        sampling are pinned here by derivation, not by running the package
        (no egress); tests/test_cqt_compat.py carries a parity harness that
        activates automatically when `cqt_nsgt_pytorch` is importable.
        """
        win_fn = _WINDOWS[window]
        K = self.num_octs * self.bins_per_oct
        Ls = self.Ls
        nyq = self.fs / 2.0
        fmax = nyq - 1e-6  # package: fmax just below Nyquist so the bin survives
        fmin = fmax / (2.0**self.num_octs)
        odiv = (np.log2(fmax) - np.log2(fmin)) / (K - 1)
        pow2n = 2.0**odiv
        q = np.sqrt(pow2n) / (pow2n - 1.0) / 2.0
        freqs = fmin * pow2n ** np.arange(K)
        self.freqs = freqs
        bins_per_hz = Ls / self.fs

        centers = np.round(freqs * bins_per_hz).astype(int)
        Lg = np.maximum(4, np.round((freqs / q) * bins_per_hz)).astype(int)

        # per-octave pow2 time sizes with exact halving (top octave governs)
        k_top = self.num_octs - 1
        m_top = _next_pow2(int(Lg[(k_top + 1) * self.bins_per_oct - 1]))
        while any(
            (m_top >> (k_top - o)) < Lg[(o + 1) * self.bins_per_oct - 1]
            for o in range(self.num_octs)
        ):
            m_top *= 2
        self.M = tuple(m_top >> (self.num_octs - 1 - o) for o in range(self.num_octs))

        def periodic_win(m: int) -> np.ndarray:
            """window of length m, peak at index m//2 (offset 0)."""
            w = win_fn(m + 1, beta)
            # win_fn returns a symmetric (m+1)-point window, peak at index m/2;
            # dropping the last sample yields the periodic form; roll so that
            # element j corresponds to offset d = j - m//2
            return w[:-1] if m % 2 == 0 else win_fn(m, beta)

        # ---- frame operator over the full grid ----
        S = np.zeros(Ls, dtype=np.float64)
        S_oct = np.zeros(Ls, dtype=np.float64)

        def band_slots(k: int):
            m = int(Lg[k])
            d = np.arange(m) - m // 2
            w = periodic_win(m)
            l_full = (centers[k] + d) % Ls
            return l_full, w

        band_cache = [band_slots(k) for k in range(K)]
        for o in range(self.num_octs):
            Mo = self.M[o]
            for k in range(o * self.bins_per_oct, (o + 1) * self.bins_per_oct):
                l_full, w = band_cache[k]
                np.add.at(S, l_full, Mo * w**2)
                np.add.at(S, (Ls - l_full) % Ls, Mo * w**2)  # mirror band
                np.add.at(S_oct, l_full, Mo * w**2)
                np.add.at(S_oct, (Ls - l_full) % Ls, Mo * w**2)

        # DC band (length 2*center_of_first_bin+1-ish; nsgt: M[0]=2*fbas[1])
        m_dc = max(4, int(round(2 * freqs[0] * bins_per_hz)))
        w_dc = periodic_win(m_dc)
        l_dc = (np.arange(m_dc) - m_dc // 2) % Ls
        np.add.at(S, l_dc, _next_pow2(m_dc) * w_dc**2)
        # Nyquist band (bandwidth: neighbour difference across the mirror)
        m_ny = max(4, int(round(2 * (nyq - freqs[-2]) * bins_per_hz)))
        w_ny = periodic_win(m_ny)
        l_ny = (Ls // 2 + np.arange(m_ny) - m_ny // 2) % Ls
        np.add.at(S, l_ny, _next_pow2(m_ny) * w_ny**2)

        assert S.min() > 0, "frame operator not invertible (coverage gap)"
        n_rbins = Ls // 2 + 1
        self._mask = (S_oct / S)[:n_rbins].astype(np.float32)

        # ---- per-octave gather plans (with conjugate-mirror folding) ----
        plans = []
        for o in range(self.num_octs):
            Mo = self.M[o]
            idx = np.zeros((self.bins_per_oct, Mo), dtype=np.int32)
            conj = np.zeros((self.bins_per_oct, Mo), dtype=bool)
            w_ana = np.zeros((self.bins_per_oct, Mo), dtype=np.float32)
            w_syn = np.zeros((self.bins_per_oct, Mo), dtype=np.float32)
            for j, k in enumerate(
                range(o * self.bins_per_oct, (o + 1) * self.bins_per_oct)
            ):
                l_full, w = band_cache[k]
                m = l_full.shape[0]
                d = np.arange(m) - m // 2
                pos = d % Mo  # window peak at slot 0 (baseband demodulation)
                folded = np.where(l_full <= Ls // 2, l_full, Ls - l_full)
                idx[j, pos] = folded
                conj[j, pos] = l_full > Ls // 2
                w_ana[j, pos] = w  # plain ifft convention, scale 1
                # painless duals are pointwise g(l)*M/S(l) at the frequency
                # where the (possibly mirror-) band element lives — i.e. the
                # synthesis TARGET bin (S is asymmetric around Nyquist because
                # the even-length periodic windows have support
                # d in [-m/2, m/2-1], so S[l_full] would be wrong for folded
                # slots)
                w_syn[j, pos] = w * Mo / S[folded]
            plans.append(
                _OctavePlan(M=Mo, idx=idx, w_ana=w_ana, w_syn=w_syn, conj=conj)
            )
        self._plans = tuple(plans)

    def _finalize_plans(self):
        """Invert the (bin, slot) -> frequency maps into per-frequency
        contributor lists, so synthesis is a gather:
        Y[l] = sum_r flat[gmap[r, l]], with a trailing zero slot for "none".
        A slot whose full-grid bin lies beyond Nyquist contributes its
        conjugate; a slot exactly at 0 or Ls/2 contributes value + conj."""
        Ls = self.Ls
        n_rbins = Ls // 2 + 1
        gmaps, gconjs = [], []
        for p in self._plans:
            flat_idx = p.idx.reshape(-1)
            flat_conj = (p.conj.reshape(-1) if p.conj is not None
                         else np.zeros_like(flat_idx, dtype=bool))
            used = (p.w_syn.reshape(-1) != 0) | (p.w_ana.reshape(-1) != 0)
            buckets: dict[int, list[tuple[int, bool]]] = {}
            for j, (l, cj, u) in enumerate(zip(flat_idx, flat_conj, used)):
                if not u:
                    continue
                buckets.setdefault(int(l), []).append((j, bool(cj)))
                if p.conj is not None and (l == 0 or l == Ls // 2):
                    buckets[int(l)].append((j, not bool(cj)))
            max_occ = max((len(v) for v in buckets.values()), default=1)
            pad_slot = flat_idx.shape[0]
            gm = np.full((max_occ, n_rbins), pad_slot, dtype=np.int64)
            gc = np.zeros((max_occ, n_rbins), dtype=bool)
            for l, entries in buckets.items():
                for r, (j, cj) in enumerate(entries):
                    gm[r, l] = j
                    gc[r, l] = cj
            gmaps.append(gm)
            gconjs.append(gc if gc.any() else None)
        self._gather_syn = tuple(gmaps)
        self._gather_syn_conj = tuple(gconjs)

    def _on(self, device) -> dict:
        """The plans as tensors on ``device`` (built once per device)."""
        key = str(torch.device(device))
        if key not in self._dev:
            def t(a, dtype):
                return None if a is None else torch.as_tensor(
                    np.asarray(a), dtype=dtype, device=device)

            self._dev[key] = {
                "plans": [
                    (t(p.idx, torch.long), t(p.conj, torch.bool),
                     t(p.w_ana, torch.float32), t(p.w_syn, torch.float32))
                    for p in self._plans
                ],
                "gather": [(t(gm, torch.long), t(gc, torch.bool))
                           for gm, gc in zip(self._gather_syn,
                                             self._gather_syn_conj)],
                "mask": t(self._mask, torch.float32),
            }
        return self._dev[key]

    def mask(self, device) -> torch.Tensor:
        """hpf_DC spectral mask [Ls//2+1] on ``device``."""
        return self._on(device)["mask"]

    # ------------------------------------------------------------ compute

    def spectrum(self, x: torch.Tensor) -> torch.Tensor:
        """rfft of the zero-padded signal, the shared analysis front end."""
        T = x.shape[-1]
        x = x.float()
        if T < self.Ls:
            x = torch.nn.functional.pad(x, (0, self.Ls - T))
        return torch.fft.rfft(x, dim=-1)

    def fwd_spectrum(self, X: torch.Tensor) -> list[torch.Tensor]:
        """Analysis from an rfft spectrum; octaves lowest first."""
        outs = []
        for idx, conj, w_ana, _ in self._on(X.device)["plans"]:
            sl = _take_last(X, idx)
            if conj is not None:
                sl = torch.where(conj, sl.conj(), sl)
            outs.append(torch.fft.ifft(sl * w_ana, dim=-1))
        return outs

    def fwd(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Analysis. x: [..., T] real, T <= audio_len."""
        return self.fwd_spectrum(self.spectrum(x))

    def bwd_spectrum(self, coeffs) -> torch.Tensor:
        """Synthesis up to the final irfft: the reconstructed spectrum."""
        assert len(coeffs) == self.num_octs
        dev = self._on(coeffs[0].device)
        batch = coeffs[0].shape[:-2]
        Y = None
        for c, (_, _, _, w_syn), (gm, gc) in zip(coeffs, dev["plans"],
                                                 dev["gather"]):
            flat = (torch.fft.fft(c, dim=-1) * w_syn).reshape(*batch, -1)
            flat = torch.cat([flat, flat.new_zeros((*batch, 1))], dim=-1)
            v = _take_last(flat, gm)  # [..., max_occ, n_rbins]
            if gc is not None:
                v = torch.where(gc, v.conj(), v)
            v = v.sum(dim=-2)
            Y = v if Y is None else Y + v
        return Y

    def bwd(self, coeffs, length: int | None = None) -> torch.Tensor:
        """Synthesis from octave coefficients (lowest octave first)."""
        length = self.audio_len if length is None else length
        x = torch.fft.irfft(self.bwd_spectrum(coeffs), n=self.Ls, dim=-1)
        return x[..., :length]

    def apply_hpf_DC(self, x: torch.Tensor) -> torch.Tensor:
        """Project onto the octave-band subspace (removes DC & Nyquist bands)."""
        T = x.shape[-1]
        X = self.spectrum(x) * self.mask(x.device)
        return torch.fft.irfft(X, n=self.Ls, dim=-1)[..., :T]


@functools.lru_cache(maxsize=8)
def get_cqt(num_octs: int, bins_per_oct: int, fs: float, audio_len: int,
            window: str = "kaiser", beta: float = 1.0,
            mode: str = "native") -> CQT:
    """Cached constructor: frame building is host work worth reusing."""
    return CQT(num_octs, bins_per_oct, fs, audio_len, window=window,
               beta=beta, mode=mode)
