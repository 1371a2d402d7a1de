from microimagelib_tpu_torch.ops.basics import (
    align_size_3d,
    crop_center,
    flip3,
    pad_psf_to_origin,
    pad_stack_edge,
    snap_fft_size,
    snap_transform_size,
)

__all__ = [
    "align_size_3d",
    "crop_center",
    "flip3",
    "pad_psf_to_origin",
    "pad_stack_edge",
    "snap_transform_size",
    "snap_fft_size",
]
