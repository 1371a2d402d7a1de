"""Share of the RL iterations' roofline in a decon_singleview call: the
least time of the calls' iterations (bytes each must touch, over the
HBM rate) over the device kernel time inside the calls' spans."""
import numpy as np

from milbench.stats import rl_least_s, roofline_pct


def read(run):
    tv = run.trace
    if tv is None:
        return None
    voxels = int(np.prod(run.config["shape_zyx"]))
    least = rl_least_s(voxels, run.config["n_iters"], "single", run.completed())
    return roofline_pct(least, tv.kernel_s_within("bench.call"))
