from microimagelib_tpu_torch.models.backprojector import gen_backprojector
from microimagelib_tpu_torch.models.batch import BatchConfig, spim_fusion_batch
from microimagelib_tpu_torch.models.deconvolution import (
    decon_dualview,
    decon_dualview_prepared,
    decon_dualview_prepared_batch,
    decon_singleview,
    gen_otf,
    rl_decon_dual,
    rl_decon_single,
)
from microimagelib_tpu_torch.models.fusion import (
    fusion_dualview,
    imoperation3d,
    imresize3d,
)
from microimagelib_tpu_torch.models.projections import (
    mip3d,
    mip3d_frames,
    mp2d,
    mp2d_packed,
    mp3d,
)
from microimagelib_tpu_torch.models.registration import (
    atrans3dgpu,
    atrans3dgpu_16bit,
    checkmatrix,
    reg2d,
    reg2d_phasor,
    reg3d,
    reg3d_affine,
    reg3d_affine_pyramid,
    reg3d_phasor,
    reg_3dgpu,
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
    "fusion_dualview",
    "imoperation3d",
    "imresize3d",
    "reg2d",
    "reg2d_phasor",
    "reg3d_phasor",
    "reg_3dgpu",
    "mp2d",
    "mp2d_packed",
    "mip3d",
    "mip3d_frames",
    "mp3d",
    "BatchConfig",
    "spim_fusion_batch",
]
