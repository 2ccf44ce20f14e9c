"""mfu.train: the window's model operations (forward, input and weight
gradients of each conv and product, remat not counted) at the peaks over
the window's wall time, %."""

from perfbench.readers import mfu


def read(run):
    return mfu(run)
