"""The benchmark of the PyTorch and CUDA port (babe_tpu_torch) on one card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It builds the cell named in BENCHMARK.json
from its configuration and traffic files, loads and warms up (``setup_s``),
measures for ``--seconds`` seconds, checks what the window produced
against the plain reference in ``perfbench/reference/``, and prints one
JSON line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end ones, or with ``--trace 1`` the per-layer
ones, read from a profiler trace of a few evaluations or steps), ``device``
and, with ``--trace 1``, ``breakdown``; the compared numbers beside their
limits under ``checks``, last, and as the last lines on standard error.
It exits non-zero, and prints no result, without a CUDA card, or when the
process holds a module of the JAX package or its stack once the window
has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(run, man, trace: bool) -> dict:
    import torch

    metrics = {}
    for m in harness.metrics_of(man, run.workload, trace):
        v = harness.read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.trace_data is not None:
        device["busy_s"] = run.trace_data.busy_s()
        device["window_s"] = run.trace_data.window_s
        out["breakdown"] = {"device_ops": run.trace_data.top_ops(),
                            "idle_gaps": run.trace_data.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    a = parse(argv)
    harness.clear_program_environment()
    harness.cache_environment()
    man = harness.manifest()
    w = harness.cell(man, a.workload)
    import babe_tpu_torch  # noqa: F401  (the system under test)

    config = harness.load_json(harness.HERE, "configs", f"{w['config']}.json")
    from perfbench import traffic

    mix = traffic.load(w["traffic"])
    limits = harness.load_json(harness.HERE, "limits", f"{a.workload}.json")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(
            w["chips"]):
        print(f"perfbench: the cell {a.workload} needs {w['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.Run(workload=a.workload, seed=a.seed, seconds=a.seconds,
                      trace=bool(a.trace), config=config, mix=mix,
                      limits=limits, device=torch.device("cuda", 0),
                      t_start=T_START)
    harness.loop(mix["kind"]).run(run)
    found = harness.loaded_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    line = result_line(run, man, bool(a.trace))
    for k, v in run.readings.items():
        print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
