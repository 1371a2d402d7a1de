"""Share of the traced window in which nothing ran on the device: 1 less
the union of its kernels, copies and sets over the window."""
from milbench.stats import idle_pct


def read(run):
    return idle_pct(run)
