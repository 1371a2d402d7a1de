"""Fused timepoints completed in the window, per minute of the window."""
from milbench.stats import rate


def read(run):
    return rate(run, "timepoints", 60.0)
