"""setup_s (s, host clock): process start to the first timed batch."""


def read(run):
    return run.setup_s
