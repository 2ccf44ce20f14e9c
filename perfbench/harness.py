"""What every cell's run shares: the manifest and the files a cell names,
the run's record, the port's configuration built from a configuration
file, the metric readers, the checks and the result line.

A cell is found by name: ``BENCHMARK.json`` gives its configuration and
traffic; ``perfbench/configs/<config>.json`` holds the configuration as it
is run, ``perfbench/traffic/<traffic>.json`` the mix (its ``kind`` names
the loop, ``perfbench/loops/<kind>.py``), ``perfbench/limits/<cell>.json``
the limits of the cell's comparison with the reference, and
``perfbench/metrics/<metric>.py`` the reader of each metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules a run may not hold once its window has closed (the JAX
# package and its stack; the port, babe_tpu_torch, is a name of its own)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "babe_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(man: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those that list the cell, or list no cells and move (per-layer) or are
    (end-to-end) a metric the cell reports."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def loaded_modules() -> list[str]:
    """The forbidden top-level module names this process holds, compared
    whole (the part of each name before its first dot)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def clear_program_environment() -> None:
    """Drop the port's behaviour knobs from the environment, so that what
    runs is what the configuration file states."""
    for k in list(os.environ):
        if k.startswith("BABE_"):
            del os.environ[k]


def cache_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its kernels under ``build/kernels`` there by itself)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


@dataclass
class Run:
    """The record of one run, filled by its loop and read by the metric
    readers."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    mix: dict
    limits: dict
    device: object = None
    t_start: float = 0.0
    setup_s: float | None = None
    window_s: float | None = None
    units: float = 0.0             # evaluations or steps done in the window
    attempted: int = 0
    failed: int = 0
    audio_s: float = 0.0           # seconds of audio the window's work is worth
    spans: dict = field(default_factory=dict)     # name -> [seconds, ...]
    counts: dict = field(default_factory=dict)    # shapes and model work
    trace_data: object = None       # trace.Trace of the traced units
    checks: dict = field(default_factory=dict)    # name -> (value, limit)
    readings: dict = field(default_factory=dict)  # read, not compared
    memory_peak_bytes: int = 0

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def check(self, name: str, value: float) -> None:
        """Record a compared number beside its limit from the cell's
        limits file; a number the file gives no limit is a reading only."""
        if name in self.limits:
            self.checks[name] = (float(value), float(self.limits[name]))
        else:
            self.readings[name] = float(value)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def read_metric(name: str, run: Run):
    """The metric's reader, ``perfbench/metrics/<name>.py``: its value, or
    None where it found nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def port_args(config: dict):
    """The port's configuration: its shipped defaults with every group the
    configuration file holds put in whole."""
    from babe_tpu_torch.config import default_config, make_config

    args = default_config([])
    for group in ("network", "exp", "diff_params", "tester"):
        args[group] = make_config(config[group])
    return args


def loop(kind: str):
    return importlib.import_module(f"perfbench.loops.{kind}")
