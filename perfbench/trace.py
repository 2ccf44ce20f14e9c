"""The traced part of a ``--trace 1`` run and what is read from it.

``Tracer`` runs ``torch.profiler`` (host and device activities) over a few
evaluations or steps in the steady part of the window, between two
synchronizations, inside a span named ``perfbench.traced``.  The events are
kept in memory and reduced once the window has closed: the device operations (kernels, copies,
sets) with their names and intervals, the busy time as the union of those
intervals, the idle gaps between them named by what the host was doing
(the innermost host span open at the gap's middle), and sums by name.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    window_s: float = 0.0
    units: int = 0                      # evaluations or steps traced
    ops: list = field(default_factory=list)   # (name, start_us, end_us)
    host: list = field(default_factory=list)  # (name, start_us, end_us)

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if not o[0].startswith(("Memcpy",
                                                             "Memset"))]

    def busy_s(self) -> float:
        total, end = 0.0, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s >= end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def seconds_by_name(self) -> dict:
        out: dict[str, float] = {}
        for name, s, e in self.ops:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def matching(self, patterns) -> list:
        rxs = [re.compile(p) for p in patterns]
        return [o for o in self.kernels if any(r.search(o[0]) for r in rxs)]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps with no device operation, each named by the
        innermost host span open at its middle: [[name, seconds], ...]."""
        ops = sorted(self.ops, key=lambda o: o[1])
        gaps, end = [], None
        for _, s, e in ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for dur, a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            inner = [h for h in self.host if h[1] <= mid <= h[2]]
            name = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                    else "no host span")
            out.append([name, dur / 1e6])
        return out

    def top_ops(self, top: int = 10) -> list:
        by = self.seconds_by_name()
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]


class Tracer:
    """Traces units ``start`` .. ``start + count - 1`` of the window: call
    ``before(i)`` before unit i and ``after(i)`` after it."""

    SPAN = "perfbench.traced"

    def __init__(self, start: int, count: int):
        self.start, self.count = int(start), int(count)
        self.prof = None
        self.done = None      # the finished profile, reduced by close()
        self.span = None
        self.trace: Trace | None = None

    def before(self, i: int) -> None:
        if i != self.start:
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        _sync()
        self.span = record_function(self.SPAN)
        self.span.__enter__()

    def after(self, i: int) -> None:
        if self.prof is None or i != self.start + self.count - 1:
            return
        _sync()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.done, self.prof = self.prof, None

    def close(self) -> None:
        """Once the window has closed: reduce the trace, or drop one the
        window's end cut short."""
        if self.prof is not None:
            self.span.__exit__(None, None, None)
            self.prof.stop()
            self.prof = None
        if self.done is not None:
            self.trace = reduce(self.done, self.count)
            self.done = None


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reduce(prof, units: int) -> Trace:
    """The device operations and host spans inside the traced span."""
    cuda = torch.autograd.DeviceType.CUDA
    win = None
    host, ops = [], []
    for e in prof.events():
        r = e.time_range
        if e.device_type == cuda:
            # a host span shows on the device's timeline too: not an op
            if not getattr(e, "is_user_annotation", False) and (
                    e.name != Tracer.SPAN):
                ops.append((e.name, r.start, r.end))
        else:
            if e.name == Tracer.SPAN:
                win = (r.start, r.end)
            host.append((e.name, r.start, r.end))
    if win is None:
        raise RuntimeError("the traced span is missing from the trace")
    a, b = win
    ops = [(n, max(s, a), min(e, b)) for n, s, e in ops if e > a and s < b]
    host = [h for h in host if h[0] != Tracer.SPAN and h[2] > a and h[1] < b]
    return Trace(window_s=(b - a) / 1e6, units=units, ops=ops, host=host)
