"""launches_per_eval.generate: device kernels in the traced evaluations,
per evaluation (every kernel, the port's and PyTorch's)."""

from perfbench.readers import launches_per_unit


def read(run):
    return launches_per_unit(run)
