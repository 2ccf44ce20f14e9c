"""EDM preconditioning, the Heun update, the blind BWE guided step with its
filter fit, and the training loss, plain PyTorch in float32.

Written from the EDM paper (Karras et al. 2022) and BABE (Moliner et al.
2023): D(x; s) = c_skip x + c_out F(c_in x, c_noise) with the DC and
Nyquist bands of the CQT frame projected out of D; the blind step's
filter is a piecewise log-log lowpass fitted to the STFT magnitudes by
projected gradient descent with a tolerance exit; the guidance is the
gradient of the L2 reconstruction error through the network, scaled by
xi / (||grad|| / sqrt(L) + 1e-6) / t.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from perfbench.reference.network import NetConfig, model, unet


@dataclass(frozen=True)
class EDMConfig:
    sigma_data: float = 0.063


def precond(e: EDMConfig, sigma):
    sd2 = e.sigma_data**2
    return (sd2 / (sigma**2 + sd2),                      # c_skip
            sigma * e.sigma_data * (sd2 + sigma**2) ** -0.5,  # c_out
            (sd2 + sigma**2) ** -0.5,                    # c_in
            0.25 * torch.log(sigma))                     # c_noise


def denoise(P, cfg: NetConfig, e: EDMConfig, x: torch.Tensor, t: float,
            parts: bool = False):
    """D(x; t) with the frame's band projection, x [B, L]; with ``parts``
    also its network term, c_out F projected (D less the skip term)."""
    sigma = torch.full((x.shape[0], 1), float(t), dtype=torch.float32,
                       device=x.device)
    cskip, cout, cin, cnoise = precond(e, sigma)
    fr = cfg.frame
    X = fr.spectrum(x)
    coeffs = [c * cin[..., None] for c in fr.analysis(X)]
    net = cout * fr.synthesis(unet(P, cfg, coeffs, cnoise))
    mask, L = fr.mask(x.device), x.shape[-1]
    D = torch.fft.irfft((cskip * X + net) * mask, n=fr.Ls, dim=-1)[..., :L]
    if not parts:
        return D
    return D, torch.fft.irfft(net * mask, n=fr.Ls, dim=-1)[..., :L]


def schedule(sigma_max: float, sigma_min: float, rho: float, T: int):
    """The rho schedule t_0 .. t_T (t_T = 0) of T steps, in float32."""
    i = torch.arange(0, T + 1, dtype=torch.float32)
    a = sigma_max ** (1 / rho)
    t = (a + i / (T - 1) * (sigma_min ** (1 / rho) - a)) ** rho
    t[-1] = 0.0
    return t.tolist()


def heun_step(P, cfg, e, x_hat, t_hat: float, t_next: float):
    """One second-order Heun step from (x_hat, t_hat) to t_next (Euler to
    0 when t_next is 0): (x_next, the first denoised estimate, its network
    term)."""
    with torch.no_grad():
        den1, net1 = denoise(P, cfg, e, x_hat, t_hat, parts=True)
        d1 = (x_hat - den1) / t_hat
        h = t_next - t_hat
        if t_next == 0.0:
            return x_hat + h * d1, den1, net1
        x_mid = x_hat + h * d1
        d2 = (x_mid - denoise(P, cfg, e, x_mid, t_next)) / t_next
        return x_hat + h * 0.5 * (d1 + d2), den1, net1


# ---------------------------------------------------------------- blind BWE

@dataclass(frozen=True)
class BlindConfig:
    nfft: int = 4096
    sample_rate: float = 22050.0
    mu: tuple = (1000.0, 10.0)
    tol: tuple = (5e-3, 5e-3)
    max_iter: int = 100
    fcmin: float = 20.0
    fcmax: float = 11025.0
    Amin: float = -50.0
    xi: float = 0.2
    audio_len: int = 184184


def _hamming(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.54 - 0.46 * torch.cos(2.0 * math.pi * k / n)).float()


def stft(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Zero-padded by nfft at the end, periodic hamming, hop nfft/2, no
    centering: complex [..., nfft/2 + 1, frames]."""
    x = torch.nn.functional.pad(x, (0, nfft))
    frames = x.unfold(-1, nfft, nfft // 2) * _hamming(nfft, x.device)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def istft(X: torch.Tensor, nfft: int) -> torch.Tensor:
    """Overlap-add inverse of ``stft`` (window-envelope normalised)."""
    hop, dev = nfft // 2, X.device
    w = _hamming(nfft, dev)
    frames = torch.fft.irfft(X.transpose(-1, -2), n=nfft, dim=-1) * w
    n = frames.shape[-2]
    T = (n - 1) * hop + nfft
    idx = (torch.arange(n, device=dev)[:, None] * hop
           + torch.arange(nfft, device=dev)[None, :]).reshape(-1)
    lead = frames.shape[:-2]
    y = frames.new_zeros((*lead, T)).index_add(-1, idx,
                                                frames.reshape(*lead, -1))
    env = torch.zeros(T, device=dev).index_add(0, idx, (w * w).repeat(n))
    return y / env.clamp(min=1e-11)


def design_filter(fc, A, f):
    """H = 1 below fc[0]; past each breakpoint 10^(A_k log2(f/fc_k)/20),
    chained at the first bin at or above fc_k."""
    H = torch.ones_like(f)
    for k in range(fc.shape[0]):
        mask = f >= fc[k]
        fck = torch.clamp(fc[k], min=1e-9)
        seg = 10.0 ** (A[k] * torch.log2(torch.maximum(f, fck) / fck) / 20.0)
        if k == 0:
            H = torch.where(mask, seg, H)
        else:
            first = torch.argmax(mask.to(torch.int32)).reshape(1)
            cont = torch.where(mask.any(), H.index_select(0, first)[0],
                               torch.ones_like(H[0]))
            H = torch.where(mask, seg * cont, H)
    return H


def _clamp(b: BlindConfig, p):
    fc, A = p[0], p[1]
    fcs = [fc[0].clamp(b.fcmin, b.fcmax)]
    As = [A[0].clamp(b.Amin, -1.0)]
    for k in range(1, fc.shape[0]):
        fcs.append(torch.minimum(torch.maximum(fc[k], fcs[-1] + 1.0),
                                 torch.tensor(b.fcmax, device=fc.device)))
        As.append(torch.minimum(torch.maximum(
            A[k], torch.tensor(b.Amin, device=A.device)), As[-1]))
    return torch.stack([torch.stack(fcs), torch.stack(As)])


def fit_stats(X, Y):
    """Per-bin sums over items and frames of |X|^2, |X||Y| and |Y|^2, each
    times the sqrt frequency weighting squared."""
    Xm, Ym = X.abs(), Y.abs()
    w2 = torch.linspace(0.0, 1.0, Xm.shape[-2], device=X.device)
    return ((Xm * Xm).sum((0, -1)) * w2, (Xm * Ym).sum((0, -1)) * w2,
            (Ym * Ym).sum((0, -1)) * w2)


def objective(stats, p, freqs):
    """|| (|X| H - |Y|) w || of the filter p [2, K], from ``fit_stats``."""
    a, b, c = stats
    H = design_filter(p[0], p[1], freqs)
    return torch.sqrt(torch.clamp((H * H * a - 2.0 * H * b + c).sum(),
                                  min=1e-12))


def fit(b: BlindConfig, freqs, X, Y, p0):
    """Projected gradient descent on (fc, A) of the objective, with
    per-parameter steps mu and the monotonicity clamps; stops moving once
    both mean steps fall under the tolerances."""
    stats = fit_stats(X, Y)
    mu = torch.tensor(b.mu, device=X.device)[:, None]
    p = p0.detach().float()
    done = False
    for _ in range(b.max_iter):
        if done:
            break
        with torch.enable_grad():
            q = p.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(stats, q, freqs), q)
        newp = _clamp(b, p - mu * g)
        done = bool(((newp[0] - p[0]).abs().mean() < b.tol[0])
                    & ((newp[1] - p[1]).abs().mean() < b.tol[1]))
        p = newp
    return p


def freqs_of(b: BlindConfig, device) -> torch.Tensor:
    return (torch.arange(b.nfft // 2 + 1, dtype=torch.float64, device=device)
            * b.sample_rate / b.nfft).float()


def guidance(P, cfg, e, b: BlindConfig, x_hat, t: float, params, y):
    """The guidance term of one evaluation, xi / (||g|| / sqrt(L) + 1e-6)
    * g / t, g the gradient with respect to x_hat of the L2 error between
    y and the denoised estimate filtered by ``params``.  The gradient is
    taken one item at a time (each item's term of the error depends on
    that item alone), so that one item's graph is held at a time."""
    H = design_filter(params[0], params[1], freqs_of(b, y.device))
    L = x_hat.shape[-1]
    rec = []
    for i in range(x_hat.shape[0]):
        with torch.enable_grad():
            xg = x_hat[i:i + 1].detach().requires_grad_(True)
            xf = istft(stft(denoise(P, cfg, e, xg, t), b.nfft) * H[:, None],
                       b.nfft)[..., :L]
            val = torch.linalg.vector_norm(y[i:i + 1] - xf, dim=-1).sum()
            rec.append(torch.autograd.grad(val, xg)[0])
    rec = torch.cat(rec)
    return b.xi / (rec.norm() / b.audio_len**0.5 + 1e-6) * rec / t


def guided_stage(P, cfg, e, b: BlindConfig, x_hat, t: float, params, y):
    """One guided evaluation of the blind sampler: (score, fitted params,
    denoised estimate, its network term)."""
    with torch.no_grad():
        x_den, net = denoise(P, cfg, e, x_hat, t, parts=True)
        params = fit(b, freqs_of(b, y.device), stft(x_den, b.nfft),
                     stft(y, b.nfft), params)
    score = (x_den - x_hat) / t**2 - guidance(P, cfg, e, b, x_hat, t,
                                              params, y)
    return score, params, x_den, net


# ---------------------------------------------------------------- training

def train_loss(P, cfg, e, x, sigma, noise):
    """EDM's training loss on x [B, L] at sigma [B, 1] with the prior draw
    noise [B, L] (already scaled by sigma): the mean squared error of the
    preconditioned network output against its target."""
    cskip, cout, cin, cnoise = precond(e, sigma)
    target = (x - cskip * (x + noise)) / cout
    return ((model(P, cfg, cin * (x + noise), cnoise) - target) ** 2).mean()
