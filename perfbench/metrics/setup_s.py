"""setup_s: process start to the first timed unit (import, the kernels
loaded or built, weights, the CQT frame, the warm-up), host clock."""


def read(run):
    return run.setup_s
