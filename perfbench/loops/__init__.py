"""One loop per kind of traffic (a mix file's ``kind``): each builds the
cell's program from its configuration, warms it up, runs the window, and
compares what the window produced with the plain reference."""

from __future__ import annotations

import gc
import time

import torch

from perfbench import harness
from perfbench.reference.network import NetConfig
from perfbench.weights import load_into, seeded_tensors


class WindowClosed(Exception):
    """Raised at the first unit boundary past the window's end."""


class Clock:
    """The window: ``tick()`` after each unit (an evaluation or a step)
    raises ``WindowClosed`` past the deadline or past ``stop_after`` units,
    and runs the tracer's hooks."""

    def __init__(self):
        self.units = 0
        self.deadline = float("inf")
        self.stop_after = None
        self.tracer = None

    def before(self) -> None:
        if self.tracer is not None:
            self.tracer.before(self.units)

    def tick(self) -> None:
        if self.tracer is not None:
            self.tracer.after(self.units)
        self.units += 1
        if self.stop_after is not None and self.units >= self.stop_after:
            raise WindowClosed
        if time.perf_counter() >= self.deadline:
            raise WindowClosed


def build_program(run, remat: bool | None = None):
    """(args, model) of the port at the cell's configuration, on the run's
    device, with the seeded weights loaded; and the weights."""
    from babe_tpu_torch import kernels
    from babe_tpu_torch.ops.conv_kernels import Int8Config
    from babe_tpu_torch.setup import setup_network

    cfg = run.config
    args = harness.port_args(cfg)
    if remat is not None:
        args.exp["remat"] = remat
    if run.device.type == "cuda":
        kernels.build()
    model = setup_network(args, precision=cfg["precision"])
    shapes = {n: tuple(t.shape) for n, t in model.net.state_dict().items()}
    weights = seeded_tensors(shapes, run.seed, run.device)
    model.to(run.device)
    load_into(model.net, weights)
    if cfg["precision"] == "int8":
        want = Int8Config(**cfg["int8"])
        if model.net.int8_config != want:
            raise RuntimeError(f"the network's int8 knobs "
                               f"{model.net.int8_config} are not the "
                               f"configuration's {want}")
    return args, model, weights


def net_config(run, quant_bits=None) -> NetConfig:
    """The reference's network at the configuration's sizes and precision:
    where the configuration runs int8 stages, those in 8-bit integers (or
    ``quant_bits``, the control's)."""
    net, exp = run.config["network"], run.config["exp"]
    i8 = run.config.get("int8") or {}
    if quant_bits is None and run.config["precision"] == "int8":
        quant_bits = 8
    return NetConfig(quant_min_channels=int(i8.get("fused") or 96),num_octs=int(net["cqt"]["num_octs"]),
                     bins_per_oct=int(net["cqt"]["bins_per_oct"]),
                     emb_dim=int(net["emb_dim"]), Ns=tuple(net["Ns"]),
                     num_dils=tuple(net["num_dils"]),
                     fs=float(exp["sample_rate"]),
                     audio_len=int(exp["audio_len"]),
                     beta=float(net["cqt"]["beta"]), quant_bits=quant_bits)


def close_window(run, clock: Clock, t0: float) -> None:
    """Wait for the device; take the window's length, its units, the memory
    peak and the trace."""
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    run.window_s = time.perf_counter() - t0
    run.units = clock.units
    if clock.tracer is not None:
        clock.tracer.close()
        run.trace_data = clock.tracer.trace


def model_counts(run, L: int, fs: float, batch: int, passes: dict) -> dict:
    """What the readers weigh a unit's work by: its convs and products,
    the batch, the passes over them, the int8 stacks' width."""
    from perfbench.counts.network import network_convs

    cfg = run.config
    return {"convs": network_convs(cfg["network"], L, fs), "batch": batch,
            "passes": passes,
            "int8_min_channels": (cfg["int8"]["fused"]
                                  if cfg["precision"] == "int8" else None),
            # K2 keeps its conv output for a backward
            "writes_conv": "input_grad" in passes}


def start_window(run, clock: Clock) -> float:
    """End set-up (everything warmed up), start the window."""
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    clock.units = 0
    clock.stop_after = None
    clock.deadline = t0 + run.seconds
    if run.trace:
        from perfbench.trace import Tracer

        tr = run.mix["trace"]
        clock.tracer = Tracer(tr["start"], tr["count"])
    return t0


def free() -> None:
    """Return the memory of the program's state, which the caller has
    dropped, before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_precision():
    """float32 everywhere: TF32 off for cuDNN convs and for matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rel(a: torch.Tensor, b: torch.Tensor, base=None) -> float:
    """||a - b|| / ||base|| (base: b)."""
    base = b if base is None else base
    return float((a.double() - b.double()).norm()
                 / base.double().norm().clamp(min=1e-300))
