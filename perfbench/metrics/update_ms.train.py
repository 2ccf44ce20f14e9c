"""update_ms.train: mean milliseconds of Trainer._apply_update (the clip,
Adam, the EMA) in the traced run, host clock to a synchronize after it."""

from perfbench.readers import mean_span


def read(run):
    return mean_span(run, "update_s", 1e3)
