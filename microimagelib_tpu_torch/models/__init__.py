from microimagelib_tpu_torch.models.backprojector import gen_backprojector
from microimagelib_tpu_torch.models.deconvolution import (
    decon_dualview,
    decon_dualview_prepared,
    decon_dualview_prepared_batch,
    decon_singleview,
    gen_otf,
    rl_decon_dual,
    rl_decon_single,
)
from microimagelib_tpu_torch.models.registration import (
    atrans3dgpu,
    atrans3dgpu_16bit,
    checkmatrix,
    reg3d,
    reg3d_affine,
    reg3d_affine_pyramid,
    zncc,
)

__all__ = [
    "decon_singleview",
    "decon_dualview",
    "decon_dualview_prepared",
    "decon_dualview_prepared_batch",
    "gen_otf",
    "rl_decon_single",
    "rl_decon_dual",
    "gen_backprojector",
    "reg3d",
    "reg3d_affine",
    "reg3d_affine_pyramid",
    "atrans3dgpu",
    "atrans3dgpu_16bit",
    "checkmatrix",
    "zncc",
]
