"""Core volume ops the RL slice needs: FFT-size policy, flips, PSF
placement, edge padding, cropping. Tensors are C-order ``(z, y, x)``; the
results stay on the input tensor's device.
"""

from __future__ import annotations

import torch


def snap_transform_size(n: int) -> int:
    """The reference's FFT-size policy (reference:src/api_subfunc.cu:57-87):
    align up to 16; if the result is a power of two return it; else return
    the next power of two when <= 128, otherwise align up to 64."""
    n = int(n)
    n = -(-n // 16) * 16
    hi_bit = n.bit_length() - 1
    low_pot = 1 << hi_bit
    if low_pot == n:
        return n
    hi_pot = 1 << (hi_bit + 1)
    if hi_pot <= 128:
        return hi_pot
    return -(-n // 64) * 64


def snap_fft_size(n: int, tpu_friendly: bool = True) -> int:
    """FFT-size policy: the reference policy, plus (``tpu_friendly``, the
    default) a snap to the next power of two when it is within 25%. The
    JAX package chose that default; the port keeps it because the padded
    grid changes the result, so both packages must pad alike."""
    base = snap_transform_size(n)
    if not tpu_friendly:
        return base
    pot = 1 << (base - 1).bit_length()
    if pot != base and pot <= base * 1.25:
        return pot
    return base


def flip3(a):
    """Flip along all three axes (matched back-projector PSF flip,
    reference:include/cukernel.cuh:667-677)."""
    return torch.flip(a, dims=(0, 1, 2))


def pad_psf_to_origin(psf, fft_shape):
    """Circularly split the PSF around its center voxel (size//2) so the
    center lands at index (0,0,0) of the FFT grid, zero elsewhere —
    ``padPSFgpu`` (reference:include/cukernel.cuh:679-697). ``fft_shape``
    (z, y, x) must be >= the psf shape per axis."""
    pz, py, px = psf.shape
    tmp = torch.zeros(tuple(fft_shape), dtype=psf.dtype, device=psf.device)
    tmp[:pz, :py, :px] = psf
    return torch.roll(tmp, shifts=(-(pz // 2), -(py // 2), -(px // 2)),
                      dims=(0, 1, 2))


def pad_stack_edge(img, out_shape):
    """Pad to ``out_shape`` (z, y, x) with replicate-edge values, the image
    centered with offsets (out-in)//2 per axis — ``padstackgpu``
    (reference:include/cukernel.cuh:699-737). Requires out >= in."""
    out = img
    for ax, (i, o) in enumerate(zip(img.shape, out_shape)):
        if o != i:
            idx = (torch.arange(o, device=img.device) - (o - i) // 2
                   ).clamp_(0, i - 1)
            out = out.index_select(ax, idx)
    return out


def crop_center(img, out_shape):
    """Centered crop of the last three axes with offsets (in-out)//2 —
    ``cropgpu`` (reference:src/api_subfunc.cu:1736-1744); leading axes
    (a batch of timepoints) are kept."""
    iz, iy, ix = img.shape[-3:]
    oz, oy, ox = out_shape
    so = ((iz - oz) // 2, (iy - oy) // 2, (ix - ox) // 2)
    return img[..., so[0]:so[0] + oz, so[1]:so[1] + oy, so[2]:so[2] + ox]


def rot_by_y_axis(a, direction: int):
    """+-90-degree rotation about the Y axis by index permutation
    (reference:include/cukernel.cuh:437-453): x and z swap extents.

    direction  1: out[z', y, x'] = in[x', y, sx-1-z']
    direction -1: out[z', y, x'] = in[sz-1-x', y, z']

    Returns a contiguous tensor: the resample and NCC kernels read C
    order."""
    t = a.permute(2, 1, 0)
    if direction == 1:
        return torch.flip(t, dims=(0,)).contiguous()
    if direction == -1:
        return torch.flip(t, dims=(2,)).contiguous()
    raise ValueError(f"Invalid rotation direction {direction}")


def align_size_3d(img, out_shape):
    """Centered re-size with zero padding (or centered crop where an
    output axis is smaller) — ``alignsize3Dgpu``
    (reference:include/cukernel.cuh:754-770).
    out[d] = in[d - (out-in)//2] where in range, else 0."""
    out = torch.zeros(tuple(out_shape), dtype=img.dtype, device=img.device)
    sl_out, sl_in = [], []
    for i_sz, o_sz in zip(img.shape, out_shape):
        so = (o_sz - i_sz) // 2
        o_lo = max(so, 0)
        i_lo = o_lo - so
        n = min(i_sz - i_lo, o_sz - o_lo)
        sl_out.append(slice(o_lo, o_lo + n))
        sl_in.append(slice(i_lo, i_lo + n))
    out[tuple(sl_out)] = img[tuple(sl_in)]
    return out
