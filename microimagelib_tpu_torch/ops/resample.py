"""Separable resampling for diagonal affine transforms (pure per-axis
scale + translation — what ``imresize3d``'s isotropization uses,
reference:src/apifunc.cpp:429-446): trilinear interpolation factorizes
into three 1-D linear-interpolation matrices, so the resample is three
dense products instead of an 8-neighbour gather per voxel (the JAX
package's ``ops/resample.py``).

Semantics are the gather path's (``ops/affine.py``): source coordinate
c = scale * out_index + offset, texel footprint clamped at the borders,
zero where c is outside [-0.5, size - 0.5) per axis (the
``affinetransformkernel`` mask, reference:include/cukernel.cuh:515).

The products run in full float32 whatever the global TF32 setting: the
interpolation weights carry 24-bit fractions, and TF32's 10 bits would
move the result by ~1e-3 of its range.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resize3d_separable", "is_diagonal_tmx"]


def _interp_matrix(n_out, n_in, scale, offset):
    """(n_out, n_in) linear-interpolation matrix for c = scale*i + offset."""
    c = scale * np.arange(n_out, dtype=np.float64) + offset
    valid = (c >= -0.5) & (c < n_in - 0.5)
    i0 = np.floor(c).astype(np.int64)
    f = c - i0
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    w = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    np.add.at(w, (rows, i0c), ((1.0 - f) * valid).astype(np.float32))
    np.add.at(w, (rows, i1c), (f * valid).astype(np.float32))
    return w


def _apply_separable(vol, wz, wy, wx):
    """out[zo, yo, xo] = sum wz[zo, zi] wy[yo, yi] wx[xo, xi] vol[zi, yi, xi],
    z then y then x, as the JAX package contracts it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = torch.einsum("ab,byx->ayx", wz, vol)
        t = torch.einsum("cb,abx->acx", wy, t)
        return torch.einsum("dx,acx->acd", wx, t).contiguous()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resize3d_separable(vol, out_shape_zyx, tmx_diag=None):
    """Resample the (z, y, x) float32 tensor ``vol`` through a diagonal
    affine onto ``out_shape_zyx``, on ``vol``'s device.

    ``tmx_diag``: optional 12-vector whose off-diagonal rotation terms are
    all zero — (scale_x, scale_y, scale_z) on the diagonal and a
    translation column. Defaults to ``imresize3d`` scaling
    (in_size/out_size per axis, zero offset)."""
    vol = vol.to(torch.float32)
    iz, iy, ix = vol.shape
    oz, oy, ox = (int(s) for s in out_shape_zyx)
    if tmx_diag is None:
        sx, sy, sz = ix / ox, iy / oy, iz / oz
        tx = ty = tz = 0.0
    else:
        if not is_diagonal_tmx(tmx_diag):
            raise ValueError("resize3d_separable requires a diagonal transform")
        m = np.asarray(tmx_diag, np.float64).reshape(3, 4)
        sx, sy, sz = m[0, 0], m[1, 1], m[2, 2]
        tx, ty, tz = m[0, 3], m[1, 3], m[2, 3]

    def put(w):
        return torch.from_numpy(w).to(vol.device)

    return _apply_separable(vol, put(_interp_matrix(oz, iz, sz, tz)),
                            put(_interp_matrix(oy, iy, sy, ty)),
                            put(_interp_matrix(ox, ix, sx, tx)))


def is_diagonal_tmx(tmx, tol=0.0):
    m = np.asarray(tmx, np.float64).reshape(3, 4)
    off = [m[0, 1], m[0, 2], m[1, 0], m[1, 2], m[2, 0], m[2, 1]]
    return all(abs(v) <= tol for v in off)
