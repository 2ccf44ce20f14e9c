"""data_ms.train: mean milliseconds of Trainer.get_batch (the loader's
batch, its copy to the card and the resampling) in the traced run, host
clock to a synchronize after it."""

from perfbench.readers import mean_span


def read(run):
    return mean_span(run, "data_s", 1e3)
