"""The plain reference held to the port's plain path (float32, on the CPU)
at tiny sizes, on the same seeded weights.  The reference imports nothing
of the port; these tests import both."""

import ast
import os

import pytest
import torch

from perfbench import harness
from perfbench.loops import net_config
from perfbench.loops.restore import blind_config
from perfbench.reference import cqt as rcqt
from perfbench.reference import diffusion as rd
from perfbench.reference import network as rn
from perfbench.tests.tiny import tiny_run
from perfbench.weights import load_into, seeded_tensors

CELL = "maestro22k_bf16.restore_4seg"


@pytest.fixture(scope="module")
def setup():
    from babe_tpu_torch.diffusion.edm import EDM, EDMParams
    from babe_tpu_torch.setup import setup_network
    from babe_tpu_torch.testers.tester import Tester

    run = tiny_run(CELL)
    args = harness.port_args(run.config)
    model = setup_network(args, compute_dtype=torch.float32)
    shapes = {n: tuple(t.shape) for n, t in model.net.state_dict().items()}
    P = seeded_tensors(shapes, 5, "cpu")
    load_into(model.net, P)
    model.net.requires_grad_(False)
    edm = EDM(EDMParams.from_config(args.tester.diff_params))
    tester = Tester(args, model, edm, device="cpu")
    tester.loaded = True
    e = rd.EDMConfig(float(args.tester.diff_params.sigma_data))
    return run, model, tester, P, net_config(run), e


def _x(L, seed=0, scale=0.1):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn((2, L), generator=g)


def _close(a, b, tol):
    err = float((a - b).detach().norm() / b.detach().norm())
    assert err < tol, err


def test_reference_imports_nothing_of_the_port():
    here = os.path.dirname(rn.__file__)
    for fn in os.listdir(here):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(here, fn)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("babe_tpu_torch", "babe_tpu",
                                               "jax"), (fn, n)


def test_cqt_frame_and_transforms(setup):
    _, model, _, _, cfg, _ = setup
    port = model.cqt
    fr = rcqt.frame(cfg.num_octs, cfg.bins_per_oct, cfg.fs, cfg.audio_len)
    assert fr.M == tuple(port.M) and fr.Ls == port.Ls
    x = _x(cfg.audio_len)
    a, b = fr.analysis(fr.spectrum(x)), port.fwd(x)
    for u, v in zip(a, b):
        _close(u, v, 1e-6)
    _close(fr.synthesis(a), port.bwd_spectrum(b), 1e-6)
    _close(fr.mask("cpu"), port.mask("cpu"), 1e-7)


def test_network(setup):
    _, model, _, P, cfg, _ = setup
    x = _x(cfg.audio_len, 1)
    c = torch.tensor([[0.1], [-0.7]])
    _close(rn.model(P, cfg, x, c), model.apply(x, c), 1e-5)


def test_denoiser(setup):
    _, model, tester, P, cfg, e = setup
    x = _x(cfg.audio_len, 2, 0.3)
    den = model.fused_denoiser(tester.edm)
    for t in (0.2, 0.01):
        ref = rd.denoise(P, cfg, e, x, t)
        _close(ref, den(x, torch.full((2, 1), t)), 1e-5)


def test_guided_stage(setup):
    from babe_tpu_torch.ops.stft import apply_stft

    run, _, tester, P, cfg, e = setup
    s = tester.sampler()
    b = blind_config(run)
    y = _x(cfg.audio_len, 3)
    x_hat = y + 0.15 * _x(cfg.audio_len, 4, 1.0)
    p0 = s.blind.initial_params("cpu")
    score, params, x_den = s._stage(x_hat, 0.15, p0, y,
                                    apply_stft(y, b.nfft), None)
    r_score, r_params, r_den, _ = rd.guided_stage(P, cfg, e, b, x_hat, 0.15,
                                                  p0, y)
    _close(r_den, x_den, 1e-5)
    _close(r_score, score, 1e-4)
    _close(r_params, params, 1e-5)


def test_fit_matches_the_plain_loop(setup):
    from babe_tpu_torch.ops.stft import apply_stft, rfftfreq

    run, _, tester, _, cfg, _ = setup
    s = tester.sampler()
    b = blind_config(run)
    X, Y = apply_stft(_x(cfg.audio_len, 5), b.nfft), apply_stft(
        _x(cfg.audio_len, 6) * 0.5, b.nfft)
    p0 = s.blind.initial_params("cpu")
    port = s._fit_loop(s._fit_stats(X, Y), p0)
    ref = rd.fit(b, torch.as_tensor(rfftfreq(b.nfft, b.sample_rate)), X, Y,
                 p0)
    _close(ref, port, 1e-6)


def test_heun_step(setup):
    run, _, tester, P, cfg, e = setup
    s = tester.sampler()
    dp = run.config["tester"]["diff_params"]
    t = rd.schedule(float(dp["sigma_max"]), float(dp["sigma_min"]),
                    float(dp["ro"]), int(run.config["tester"]["T"]))
    assert t == pytest.approx(s._schedule(False)[0], rel=1e-6)
    x_hat = _x(cfg.audio_len, 7, t[1])
    for i in (1, len(t) - 2):
        s1 = s._score(x_hat, t[i])
        h = t[i + 1] - t[i]
        d1 = -t[i] * s1
        x_next = x_hat + h * d1
        if t[i + 1] != 0.0:
            x_next = x_hat + h * 0.5 * (d1 - t[i + 1] * s._score(x_next,
                                                                 t[i + 1]))
        r_next, r_den, _ = rd.heun_step(P, cfg, e, x_hat, t[i], t[i + 1])
        _close(r_den, s1 * t[i] ** 2 + x_hat, 1e-5)
        _close(r_next, x_next, 1e-5)


@pytest.fixture(scope="module")
def int8_setup():
    """The port's int8 network (its fused chain on every stack of the tiny
    network) beside the reference at 8 bits, in float32."""
    import os

    from babe_tpu_torch.setup import setup_network

    run = tiny_run("maestro22k_int8.restore_4seg")
    args = harness.port_args(run.config)
    saved = os.environ.get("BABE_INT8_MINC")
    os.environ["BABE_INT8_MINC"] = "8"
    try:
        model = setup_network(args, compute_dtype=torch.float32,
                              precision="int8")
    finally:
        os.environ.pop("BABE_INT8_MINC")
        if saved is not None:
            os.environ["BABE_INT8_MINC"] = saved
    shapes = {n: tuple(t.shape) for n, t in model.net.state_dict().items()}
    P = seeded_tensors(shapes, 6, "cpu")
    load_into(model.net, P)
    model.net.requires_grad_(False)
    return model, P, net_config(run)


def test_int8_stages(int8_setup):
    """The reference at 8 bits against the port's int8 chain: its values
    up to the conv inputs whose rounding the order of float32 sums flips,
    and its input gradient the exact stage's (straight through); ten times
    closer than the float32 network is."""
    model, P, cfg = int8_setup
    assert cfg.quant_bits == 8 and cfg.quant_min_channels == 8
    x = _x(cfg.audio_len, 8).requires_grad_(True)
    c = torch.tensor([[0.1], [-0.7]])
    y = model.apply(x, c)
    (gx,) = torch.autograd.grad(y.square().sum(), x)
    xr = x.detach().clone().requires_grad_(True)
    yr = rn.model(P, cfg, xr, c)
    (gr,) = torch.autograd.grad(yr.square().sum(), xr)
    _close(yr.detach(), y.detach(), 5e-3)
    _close(gr, gx, 1e-2)
    fp32 = rn.model(P, rn.NetConfig(**{**cfg.__dict__, "quant_bits": None}),
                    x.detach(), c)
    y = y.detach()
    assert float((fp32 - y).norm() / y.norm()) > 10 * float(
        (yr.detach() - y).norm() / y.norm())
