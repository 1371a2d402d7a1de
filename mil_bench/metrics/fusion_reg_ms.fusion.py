"""Mean host ms of fusion_dualview's call into reg3d per timepoint (the
registration ends with its matrix on the host)."""
from milbench.stats import mean_ms

SPANS = [("microimagelib_tpu_torch.models.fusion", "reg3d", "fusion.reg3d")]


def read(run):
    return mean_ms(run.spans.host_s("fusion.reg3d"))
