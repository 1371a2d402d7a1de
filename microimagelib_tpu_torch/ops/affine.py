"""Affine transform with trilinear interpolation, and the fused
resample-and-correlate sums that registration minimizes (the JAX
package's ``ops/affine.py``).

The reference samples through CUDA 3D textures: output voxel (x, y, z)
maps through a 3x4 matrix and ``tex3D(tx+0.5, ...)`` interpolates texels
floor(c) and floor(c)+1 with fraction frac(c), each texel clamped to the
volume on its own (reference:include/cukernel.cuh:500-556). Texture
filtering rounds its weights to 8 bits; here, as in the JAX package, the
same footprint is gathered and the lerp taken in fp32.

Boundary masks (the reference's asymmetry, kept on purpose):
  * transform: valid iff c >= -0.5 and c < size - 0.5
    (``tx >= 0`` after the +0.5 shift, reference:include/cukernel.cuh:515)
  * correlate: strict c > -0.5 (``tx > 0``,
    reference:include/cukernel.cuh:545)
Outside the mask the sample is 0.

Everything here is plain PyTorch and runs on the input's device, chunked
over output z so a (256, 512, 512) volume peaks at a few volumes of
temporaries. :func:`corr3d_partials` is the plain version of the kernel
K5 and :func:`corr3d_grad_torch` (autograd through it) the plain version
of K4 (``kernels/corr.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["affine_transform_3d", "corr3d_partials", "corr3d_grad_torch"]

# output voxels per chunk: ~30 temporaries of 4-8 bytes each, so a chunk
# holds well under 1 GB of scratch
CHUNK_VOXELS = 1 << 22


def _matrix_floats(tmx):
    """The 12 entries as Python floats, each rounded to float32 first."""
    if isinstance(tmx, torch.Tensor):
        tmx = tmx.detach().cpu().numpy()
    return [float(v) for v in np.asarray(tmx, np.float32).reshape(12)]


def _z_chunks(oz, oy, ox):
    step = max(1, CHUNK_VOXELS // max(1, oy * ox))
    return [(z0, min(oz, z0 + step)) for z0 in range(0, oz, step)]


def _coords(m, z0, z1, oy, ox, device, row_first=False):
    """Source coordinates (cx, cy, cz) of output rows z0..z1-1 in fp32.
    By default each is ``m[a,0]*x + m[a,1]*y + m[a,2]*z + m[a,3]``
    evaluated left to right, as the JAX gather path does; ``row_first``
    evaluates ``m[a,0]*x + ((m[a,1]*y + m[a,2]*z) + m[a,3])``, the order of
    the Pallas kernels and of K4/K5 (csrc/corr.cu). The two orders round
    differently: where that moves a coordinate across a lattice point, its
    floor flips, and with it the one-sided derivative the gradient sums
    take.
    ``m`` is a 12-vector of floats or a float32 tensor (for autograd)."""
    f32 = torch.float32
    xs = torch.arange(ox, dtype=f32, device=device)[None, None, :]
    ys = torch.arange(oy, dtype=f32, device=device)[None, :, None]
    zs = torch.arange(z0, z1, dtype=f32, device=device)[:, None, None]
    if row_first:
        return tuple(m[4 * a] * xs + ((m[4 * a + 1] * ys + m[4 * a + 2] * zs)
                                      + m[4 * a + 3]) for a in range(3))
    return tuple(m[4 * a] * xs + m[4 * a + 1] * ys + m[4 * a + 2] * zs
                 + m[4 * a + 3] for a in range(3))


def _trilerp(flat, shape, cx, cy, cz, strict_lo):
    """Trilinear sample of the flattened (sz, sy, sx) volume ``flat`` at
    (cx, cy, cz), zero outside the validity box: the JAX package's
    ``_trilerp_window`` over the whole volume, in the same fp32 order."""
    sz, sy, sx = shape
    if strict_lo:
        valid = (cx > -0.5) & (cy > -0.5) & (cz > -0.5)
    else:
        valid = (cx >= -0.5) & (cy >= -0.5) & (cz >= -0.5)
    valid &= (cx < sx - 0.5) & (cy < sy - 0.5) & (cz < sz - 0.5)

    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    z0 = torch.floor(cz)
    fx = cx - x0
    fy = cy - y0
    fz = cz - z0

    # clamp each footprint texel on its own (CUDA clamp addressing): at c
    # in [-1, 0) both neighbours resolve to texel 0. Clamping the floor to
    # [-1, n] first keeps far-out coordinates inside int64 and changes no
    # clamped index.
    def corners(c0, n):
        r = c0.clamp(-1, n).to(torch.int64)
        return r.clamp(0, n - 1), (r + 1).clamp(0, n - 1)

    x0i, x1i = corners(x0, sx)
    y0i, y1i = corners(y0, sy)
    z0i, z1i = corners(z0, sz)
    syx = sy * sx
    b00 = z0i * syx + y0i * sx
    b01 = z0i * syx + y1i * sx
    b10 = z1i * syx + y0i * sx
    b11 = z1i * syx + y1i * sx

    v000 = flat[b00 + x0i]
    v001 = flat[b00 + x1i]
    v010 = flat[b01 + x0i]
    v011 = flat[b01 + x1i]
    v100 = flat[b10 + x0i]
    v101 = flat[b10 + x1i]
    v110 = flat[b11 + x0i]
    v111 = flat[b11 + x1i]

    c00 = v000 + (v001 - v000) * fx
    c01 = v010 + (v011 - v010) * fx
    c10 = v100 + (v101 - v100) * fx
    c11 = v110 + (v111 - v110) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    val = c0 + (c1 - c0) * fz
    return torch.where(valid, val, torch.zeros((), dtype=val.dtype,
                                               device=val.device))


def affine_transform_3d(src, tmx, out_shape):
    """Resample ``src`` (z, y, x) float32 tensor through the 3x4 matrix
    ``tmx`` onto ``out_shape`` (z, y, x), on src's device — the
    ``affinetransformkernel`` + texture fetch
    (reference:include/cukernel.cuh:500-524); non-strict lower mask."""
    m = _matrix_floats(tmx)
    oz, oy, ox = (int(s) for s in out_shape)
    flat = src.contiguous().reshape(-1)
    out = torch.empty((oz, oy, ox), dtype=torch.float32, device=src.device)
    for z0, z1 in _z_chunks(oz, oy, ox):
        cx, cy, cz = _coords(m, z0, z1, oy, ox, src.device)
        out[z0:z1] = _trilerp(flat, tuple(src.shape), cx, cy, cz, False)
    return out


def _partials_chunk(flat, shape, tgt, m, z0, z1):
    sz, sy, sx = shape
    cx, cy, cz = _coords(m, z0, z1, sy, sx, tgt.device, row_first=True)
    s = _trilerp(flat, shape, cx, cy, cz, True)
    t = tgt[z0:z1]
    return (torch.sum(s * s, dtype=torch.float64),
            torch.sum(s * t, dtype=torch.float64))


def corr3d_partials(src, tgt, tmx):
    """(sum s^2, sum s*t) as float64 0-d tensors, where s is ``src``
    resampled through ``tmx`` onto ``tgt``'s grid (zero outside, strict
    lower bound) and t the target — the ``corrkernel``
    (reference:include/cukernel.cuh:526-556). Coordinates in the kernels'
    order (``_coords(row_first=True)``), so a voxel's sample here and in
    K4/K5 is the same fp32 number; products in fp32, sums in float64 as the
    reference accumulates them. The plain version of K5."""
    shape = tuple(src.shape)
    m = _matrix_floats(tmx)
    flat = src.contiguous().reshape(-1)
    ss = st = None
    for z0, z1 in _z_chunks(*shape):
        a, b = _partials_chunk(flat, shape, tgt, m, z0, z1)
        ss = a if ss is None else ss + a
        st = b if st is None else st + b
    return ss, st


def corr3d_grad_torch(src, tgt, tmx):
    """(ss, st, gs, gt): the sums of :func:`corr3d_partials` and their
    gradients in the 12 matrix entries, gs = d(ss/2)/dm and gt = d(st)/dm,
    by autograd through the gather formulation (the JAX package's
    ``grad_fallback_xla``). The plain version of K4. Each z chunk runs its
    own backward pass, so the graph never holds more than one chunk; the
    per-chunk gradients add up in float64. Returns float64 tensors on the
    volumes' device."""
    shape = tuple(src.shape)
    flat = src.contiguous().reshape(-1)
    m = torch.tensor(_matrix_floats(tmx), dtype=torch.float32,
                     device=src.device, requires_grad=True)
    f64 = dict(dtype=torch.float64, device=src.device)
    ss, st = torch.zeros((), **f64), torch.zeros((), **f64)
    gs, gt = torch.zeros(12, **f64), torch.zeros(12, **f64)
    with torch.enable_grad():
        for z0, z1 in _z_chunks(*shape):
            a, b = _partials_chunk(flat, shape, tgt, m, z0, z1)
            ga, = torch.autograd.grad(a, m, retain_graph=True)
            gb, = torch.autograd.grad(b, m)
            ss += a.detach()
            st += b.detach()
            gs += 0.5 * ga.double()
            gt += gb.double()
    return ss, st, gs, gt
