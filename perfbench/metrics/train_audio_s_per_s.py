"""train_audio_s_per_s: seconds of training audio the window's steps
consumed per wall second of the window, host clock."""

from perfbench.readers import rate


def read(run):
    return rate(run)
