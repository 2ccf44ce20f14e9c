"""mfu.restore: the window's model operations (each conv and product from
shapes, at its dtype's peak) over the window's wall time, %."""

from perfbench.readers import mfu


def read(run):
    return mfu(run)
