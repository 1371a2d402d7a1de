"""Pairs registered in the window, per second of the window."""
from milbench.stats import rate


def read(run):
    return rate(run, "pairs")
