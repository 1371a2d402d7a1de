"""Share of the joint RL iterations' roofline in a fused timepoint: the
least time of the iterations (bytes each must touch, over the HBM rate)
over the device kernel time inside fusion_dualview's decon_dualview
spans."""
import numpy as np

from milbench.data import iso_shape
from milbench.stats import rl_least_s, roofline_pct

SPANS = [("microimagelib_tpu_torch.models.fusion", "decon_dualview",
          "fusion.decon_dualview")]


def read(run):
    tv = run.trace
    if tv is None:
        return None
    n = len(tv.spans("fusion.decon_dualview"))
    least = rl_least_s(int(np.prod(iso_shape(run.config))), run.config["n_iters"],
                       "dual", n)
    return roofline_pct(least, tv.kernel_s_within("fusion.decon_dualview"))
