"""Training observability: a JSONL metrics stream and the loss-by-sigma plot
(matplotlib, when installed).  Counterpart of the training half of
``babe_tpu/utils/logging.py``; its wandb mirror is not ported (a wandb run
would contact a server: see ROADMAP.md)."""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_loss_by_sigma(means, stds, bins, out_path: str) -> str | None:
    """Loss against noise level, with error bars; None without
    matplotlib."""
    plt = _mpl()
    if plt is None:
        return None
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.errorbar(np.asarray(bins, dtype=float), np.asarray(means, dtype=float),
                yerr=np.asarray(stds, dtype=float), marker="o")
    ax.set_xscale("log")
    ax.set_xlabel("sigma")
    ax.set_ylabel("loss")
    fig.savefig(out_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return out_path


class MetricsLogger:
    """``<path>/metrics.jsonl``, one record appended per ``log`` call."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = os.path.join(path, "metrics.jsonl")

    def log(self, data: dict, step: int | None = None):
        rec = dict(data)
        rec["_ts"] = time.time()
        if step is not None:
            rec["_step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
