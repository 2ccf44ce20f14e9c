"""idle_share.generate: share of the traced window with no operation on the
device, %."""

from perfbench.readers import idle_share


def read(run):
    return idle_share(run)
