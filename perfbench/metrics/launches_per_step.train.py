"""launches_per_step.train: device kernels in the traced steps, per step
(every kernel, the port's and PyTorch's)."""

from perfbench.readers import launches_per_unit


def read(run):
    return launches_per_unit(run)
