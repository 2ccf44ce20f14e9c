"""What the metric readers under ``perfbench/metrics/`` share.  Each reader
returns None where its run has nothing for it to read (no trace, no
completed request, a trace whose kernels do not add up to the expected
launches), and the harness then leaves the metric out of the line."""

from __future__ import annotations

from perfbench.counts import least_seconds
from perfbench.counts.kernels import KERNELS
from perfbench.counts.network import int8_stage, model_least_seconds

# device kernel names (demangled, as the profiler gives them) of each stage
# kernel's launch: every pattern matches exactly one kernel per launch
STAGE_KERNELS = {
    "fused_stage": (r"stage_h\(", r"stage_sm90<\d+, ?0>"),
    "fused_stage_bwd": (r"stage_operands<", r"stage_sm90<\d+, ?1>"),
    "fused_stage_int8": (r"stage_q\(", r"stage_sm90<\d+, ?2>"),
    "fused_stage_dw": (r"stage_operands<", r"dw_mma\("),
}


def rate(run):
    """Seconds of audio per wall second over the whole window."""
    if not run.window_s or not run.audio_s:
        return None
    return run.audio_s / run.window_s


def mean_span(run, name: str, scale: float = 1.0):
    v = run.spans.get(name)
    return scale * sum(v) / len(v) if v else None


def idle_share(run):
    tr = run.trace_data
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def launches_per_unit(run):
    tr = run.trace_data
    return None if tr is None or not tr.units else len(tr.kernels) / tr.units


def device_ms_per_unit(run):
    tr = run.trace_data
    if tr is None or not tr.units:
        return None
    return 1e3 * sum(e - s for _, s, e in tr.kernels) / 1e6 / tr.units


def mfu(run):
    """The window's model operations at the peaks over its wall time, %."""
    c = run.counts
    if not c or not run.window_s or not run.units:
        return None
    least = model_least_seconds(c["convs"], c["batch"], c["passes"],
                                c["int8_min_channels"])
    return 100.0 * least * run.units / run.window_s


def _stages(run, kernel: str) -> list:
    """The stage convs of one unit that launch ``kernel``.  An int8 stage
    runs K3 forward; where the input gradient is taken through it, its
    backward runs the exact stage's forward (K2) again, for the conv
    output the backward reads."""
    c = run.counts
    i8 = c["int8_min_channels"]
    grad = c["passes"].get("input_grad", 0) > 0
    out = []
    for conv in c["convs"]:
        if conv.role != "stage":
            continue
        if kernel == "fused_stage_int8" and not int8_stage(conv, i8):
            continue
        if kernel == "fused_stage" and int8_stage(conv, i8) and not grad:
            continue
        out.append(conv)
    return out


def roofline(run, kernel: str):
    """The least time of the traced launches of a stage kernel over their
    summed device time, %; None unless every pattern of the kernel matched
    exactly one device kernel per expected launch."""
    tr = run.trace_data
    if tr is None or not run.counts or not tr.units:
        return None
    stages = _stages(run, kernel)
    launches = sum(c.count for c in stages) * tr.units
    if not launches:
        return None
    B = run.counts["batch"]
    work = KERNELS[kernel]
    least = 0.0
    for c in stages:
        if kernel == "fused_stage":
            ops, nbytes, dt = work(B, c.F, c.T, c.C,
                                   writes_conv=run.counts["writes_conv"])
        else:
            ops, nbytes, dt = work(B, c.F, c.T, c.C)
        least += c.count * least_seconds(ops, nbytes, dt)
    device = 0.0
    for pattern in STAGE_KERNELS[kernel]:
        ev = tr.matching([pattern])
        if len(ev) != launches:
            return None
        device += sum(e - s for _, s, e in ev) / 1e6
    return 100.0 * least * tr.units / device
