"""Seconds from the process's start to the end of the warm-up: imports,
the program's kernel library (built on a checkout's first run), the
pool made from the seed, and the warm-up calls."""


def read(run):
    return run.setup_s
