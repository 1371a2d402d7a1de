"""Voxels x RL iterations of the calls completed in the window, over the
window, in 10^9 per second."""
from milbench.stats import rate


def read(run):
    return rate(run, "voxel_iters", 1e-9)
