"""request_s.restore: mean seconds of the requests the window
completed, host clock from the call to a synchronize after it."""

from perfbench.readers import mean_span


def read(run):
    return mean_span(run, "request_s")
