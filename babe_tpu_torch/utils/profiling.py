"""Scheduled ``torch.profiler`` traces of the training loop.

Counterpart of ``babe_tpu/utils/profiling.py``: ``step()`` once per
iteration; after ``wait`` + ``warmup`` steps the next ``active`` steps are
traced, ``repeat`` + 1 times, each window written as a Chrome trace
``<model_dir>/profile/trace_<n>.json`` (CPU activity, and the card's
kernels when there is one)."""

from __future__ import annotations

import os


class ScheduledProfiler:
    def __init__(self, logdir: str, wait: int = 10, warmup: int = 5,
                 active: int = 5, repeat: int = 1, enabled: bool = True):
        self.logdir = logdir
        self.wait, self.warmup, self.active = int(wait), int(warmup), int(active)
        self.cycle = self.wait + self.warmup + self.active
        self.total = self.cycle * (int(repeat) + 1)
        self.enabled = enabled
        self._step = 0
        self._prof = None
        self._n = 0
        if enabled:
            os.makedirs(logdir, exist_ok=True)

    @classmethod
    def from_config(cls, args) -> "ScheduledProfiler":
        p = args.get_path("logging.profiling", {}) or {}
        return cls(logdir=os.path.join(str(args.model_dir), "profile"),
                   wait=int(p.get("wait", 10)), warmup=int(p.get("warmup", 5)),
                   active=int(p.get("active", 5)),
                   repeat=int(p.get("repeat", 1)),
                   enabled=bool(p.get("enabled", False)))

    def step(self):
        if not self.enabled or self._step >= self.total:
            if self._prof is not None:
                self._stop()
            return
        pos = self._step % self.cycle
        if pos == self.wait + self.warmup and self._prof is None:
            self._start()
        elif pos == 0 and self._prof is not None:
            self._stop()
        self._step += 1

    def _start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def _stop(self):
        self._prof.stop()
        self._prof.export_chrome_trace(
            os.path.join(self.logdir, f"trace_{self._n}.json"))
        self._n += 1
        self._prof = None

    def close(self):
        if self._prof is not None:
            self._stop()
