"""Mean host ms of fusion_dualview's call into decon_dualview per
timepoint (it returns host numpy, so its span ends after the device)."""
from milbench.stats import mean_ms

SPANS = [("microimagelib_tpu_torch.models.fusion", "decon_dualview",
          "fusion.decon_dualview")]


def read(run):
    return mean_ms(run.spans.host_s("fusion.decon_dualview"))
