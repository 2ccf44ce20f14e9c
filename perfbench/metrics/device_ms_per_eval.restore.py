"""device_ms_per_eval.restore: summed kernel time in the traced
evaluations, per evaluation."""

from perfbench.readers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run)
