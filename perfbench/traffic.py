"""The one traffic generator: every mix is a JSON file under
``perfbench/traffic/`` whose parameters this module reads.

Restoration requests are band-limited recordings: notes of harmonic tones
(a fundamental drawn log-uniformly, harmonics rolling off as 1/h^r below
Nyquist, random phases, an exponential decay), plus white noise, low-passed
at a cutoff drawn from the mix's list by a piecewise log-log slope, scaled
to the tester's level, and cut into the mix's number of segments at seeded
offsets.  Every request of every seed has the same sizes; the seed changes
only the content and which cutoff each request gets.  Everything is drawn
on the run's device from generators seeded by ``weights.derive``.
"""

from __future__ import annotations

import json
import math
import os

import torch

from perfbench.weights import derive

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def recording(rec: dict, n: int, fs: float, g, device) -> torch.Tensor:
    """``n`` samples of notes of harmonic tones plus noise (unfiltered)."""
    note = max(int(rec["note_s"] * fs), 1)
    notes = -(-n // note)
    lo, hi = (math.log(f) for f in rec["f0_hz"])
    f0 = torch.exp(_uniform(g, notes, lo, hi, device))
    H = int(rec["harmonics"])
    phase = _uniform(g, (notes, H), 0.0, 2 * math.pi, device)
    t = torch.arange(n, device=device, dtype=torch.float64) / fs
    k = torch.arange(n, device=device) // note
    t_in = (t - k.double() * note / fs).float()
    h = torch.arange(1, H + 1, device=device, dtype=torch.float64)
    freq = f0.double()[k][None, :] * h[:, None]              # (H, n)
    amp = (h ** -float(rec["rolloff"])).float()[:, None] * (
        freq < fs / 2).float()
    arg = torch.remainder(2 * math.pi * freq * t[None, :], 2 * math.pi)
    tones = (amp * torch.sin(arg.float() + phase[k].t())).sum(0)
    tones = tones * torch.exp(-t_in / float(rec["decay_s"]))
    noise = torch.randn(n, generator=g, device=device)
    return tones / tones.std() + 10 ** (rec["noise_db"] / 20) * noise


def lowpass(x: torch.Tensor, fs: float, fc: float, slope_db_oct: float):
    """x with 1 below fc and slope_db_oct dB per octave above it."""
    f = torch.fft.rfftfreq(x.shape[-1], 1.0 / fs).to(x.device)
    H = torch.where(f >= fc, 10 ** (slope_db_oct * torch.log2(
        torch.clamp(f, min=fc) / fc) / 20), torch.ones_like(f))
    return torch.fft.irfft(torch.fft.rfft(x) * H, n=x.shape[-1])


def restore_request(mix: dict, seed: int, k: int, length: int, fs: float,
                    device) -> tuple[torch.Tensor, float]:
    """Request ``k`` of a restoration mix: ([segments, length] float32 on
    ``device``, the cutoff in Hz)."""
    g = torch.Generator(device=device).manual_seed(derive(seed, f"req{k}"))
    rec = mix["recording"]
    n = int(rec["length_segments"] * length)
    lp = mix["lowpass"]
    cuts = lp["cutoffs_hz"]
    fc = float(cuts[int(torch.randint(len(cuts), (1,), generator=g,
                                      device=device))])
    x = lowpass(recording(rec, n, fs, g, device), fs, fc,
                float(lp["slope_db_per_oct"]))
    x = x * (float(rec["std"]) / x.std())
    S = int(mix["segments"])
    offs = torch.randint(n - length + 1, (S,), generator=g, device=device)
    idx = offs[:, None] + torch.arange(length, device=device)[None, :]
    return x[idx].float().contiguous(), fc
