from microimagelib_tpu_torch.ops.affine import (
    affine_transform_3d,
    corr3d_grad_torch,
    corr3d_partials,
)
from microimagelib_tpu_torch.ops.basics import (
    align_size_3d,
    crop_center,
    flip3,
    pad_psf_to_origin,
    pad_stack_edge,
    snap_fft_size,
    snap_transform_size,
)
from microimagelib_tpu_torch.ops.corr import (
    NCCPartials,
    corr3d_auto,
    corr3d_grad_pallas,
    corr3d_partials_pallas,
    resolve_ncc_impl,
)
from microimagelib_tpu_torch.ops.lbfgs import lbfgs_minimize
from microimagelib_tpu_torch.ops.matrix import (
    compose_affine,
    dof_to_matrix,
    identity_tmx,
    matrix_to_params,
    params_to_matrix,
    rot_to_matrix,
    scale_tmx,
)
from microimagelib_tpu_torch.ops.powell import EvalCounter, powell
from microimagelib_tpu_torch.ops.powell_device import powell_device

__all__ = [
    "affine_transform_3d",
    "corr3d_partials",
    "corr3d_grad_torch",
    "corr3d_partials_pallas",
    "corr3d_grad_pallas",
    "corr3d_auto",
    "resolve_ncc_impl",
    "NCCPartials",
    "align_size_3d",
    "crop_center",
    "flip3",
    "pad_psf_to_origin",
    "pad_stack_edge",
    "snap_transform_size",
    "snap_fft_size",
    "identity_tmx",
    "scale_tmx",
    "compose_affine",
    "params_to_matrix",
    "matrix_to_params",
    "dof_to_matrix",
    "rot_to_matrix",
    "powell",
    "EvalCounter",
    "powell_device",
    "lbfgs_minimize",
]
