"""generate_audio_s_per_s: seconds of audio the window's work is worth
per wall second of the window, host clock."""

from perfbench.readers import rate


def read(run):
    return rate(run)
