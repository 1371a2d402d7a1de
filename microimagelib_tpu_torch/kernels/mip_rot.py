"""K8: the rotating MIP's factored route — wrapper, launch counter and
plain PyTorch version.

A rotation about x (``r_axis=1``) or y (``r_axis=2``) leaves that axis
invariant, so each frame of the rotating MIP is one 2-D bilinear resample
of the (a, b) = (z, x) or (z, y) plane, the same for every invariant row,
followed by a max over the rotated grid's z' and a clip at 0. The JAX
package computes it as per-frame 2-tap tables ``wa`` (zo, na, po) and
``wb`` (zo, nb, po) contracted against the volume by two einsums per z'
chunk (``microimagelib_tpu/models/projections.py:152-297``).
:func:`tap_tables` and :func:`mip_rot_torch` are that computation in
float32 (the plain version); :func:`mip_rot` runs it on a CPU tensor and
the hand-written kernel ``csrc/mip_rot.cu`` on a CUDA tensor, which takes
the 2 x 2 taps of each sample straight from the matrices instead of
contracting the tables' zeros, or the call raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import build

__all__ = ["mip_rot", "mip_rot_torch", "tap_tables", "coefficients", "coordinate",
           "extents", "rows_first", "fp32_matmul", "kernel_attrs", "LAUNCHES"]

# kernel launches made by mip_rot (one per call on a CUDA tensor)
LAUNCHES = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mil_mip_rot.argtypes = [p] * 3 + [i] * 7 + [p]
        lib.mil_mip_rot.restype = i
        lib.mil_mip_rot_attrs.argtypes = [p]
        lib.mil_mip_rot_attrs.restype = i
        _lib = lib
    return _lib


def kernel_attrs(device=None):
    """What K8 compiled to on the current (or the given) CUDA device: a
    dict of registers and spilled bytes a thread, static shared bytes,
    resident blocks per SM and threads a block."""
    lib = _library()
    vals = (ctypes.c_int * 5)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.mil_mip_rot_attrs(vals)
    build.check(lib, err, "mip_rot kernel attributes")
    return dict(zip(("registers", "spill_bytes", "static_smem", "blocks_per_sm",
                     "threads"), vals))


@contextlib.contextmanager
def fp32_matmul():
    """Matrix products in full float32 inside the block: TF32's 10-bit
    mantissa would break the routes' 1e-5 x max agreement on the card."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def extents(shape_zyx, out_shape, r_axis):
    """(rows, na, nb, zo, po): the invariant rows, the source plane's (a, b)
    extents, and the rotated grid's z' and output column counts."""
    sz, sy, sx = shape_zyx
    if r_axis == 2:        # about y: (z, x) planes resample, y invariant
        return sy, sz, sx, out_shape[0], out_shape[2]
    if r_axis == 1:        # about x: (z, y) planes resample, x invariant
        return sx, sz, sy, out_shape[0], out_shape[1]
    raise ValueError("r_axis must be 1 (X) or 2 (Y)")


def rows_first(img, r_axis):
    """The volume as (rows, a, b), C-contiguous: the JAX route's ``src3``."""
    return (img.permute(1, 0, 2) if r_axis == 2 else img.permute(2, 0, 1)).contiguous()


def coefficients(mats, r_axis):
    """Per frame the (b, a) coordinates' factors, (n, 6) float32: cb = kb * q
    + kbz * z' + kb0 and ca = ka * q + kaz * z' + ka0 (the matrix's x or y
    row, then its z row)."""
    m = np.asarray(mats, np.float32).reshape(-1, 3, 4)
    b = 0 if r_axis == 2 else 1
    return np.ascontiguousarray(np.stack(
        [m[:, b, b], m[:, b, 2], m[:, b, 3], m[:, 2, b], m[:, 2, 2], m[:, 2, 3]], axis=1))


def coordinate(k, kz, k0, bs, zs):
    """One axis's source coordinate over the rotated grid's (z', q):
    ``(k * q + kz * z') + k0`` in float32, rounded after each operation:
    the gather route's order (``ops/affine.py`` ``_coords``, whose other
    terms are the rotation's exact zeros), so the routes and K8 sample at
    the same points. XLA contracts the JAX package's tables' ``k * q + kz
    * z'`` into one FMA in some compiles: a difference of a few ulps."""
    return (k * bs + kz * zs) + k0


def _tap_table(c, n, zpad):
    """(zpad, n, po) 2-tap weights for coordinates c (zo, po), with the
    per-axis half of the validity mask; rows past zo are zero."""
    valid = (c >= -0.5) & (c < n - 0.5)
    i0 = torch.floor(c)
    f = c - i0
    i0r = i0.to(torch.int32)
    i0c = torch.clamp(i0r, 0, n - 1)[:, None, :]
    i1c = torch.clamp(i0r + 1, 0, n - 1)[:, None, :]
    wv = valid.to(torch.float32)
    w0 = ((1.0 - f) * wv)[:, None, :]
    w1 = (f * wv)[:, None, :]
    ids = torch.arange(n, dtype=torch.int32, device=c.device)[None, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    w = torch.where(ids == i0c, w0, zero) + torch.where(ids == i1c, w1, zero)
    return torch.nn.functional.pad(w, (0, 0, 0, 0, 0, zpad - c.shape[0]))


def tap_tables(mats, zo, na, nb, po, chunk, r_axis, device="cpu"):
    """The factored route's per-frame 2-tap tables (``_factored_tables`` of
    the JAX package): (was, wbs), each (n, zpad / chunk, chunk, n_axis, po)
    float32 on ``device``, zpad = zo rounded up to a multiple of ``chunk``.
    They depend on the grid and the matrices only, not on the image."""
    zpad = -(-zo // chunk) * chunk
    coef = torch.from_numpy(coefficients(mats, r_axis)).to(device)
    zs = torch.arange(zo, dtype=torch.float32, device=device)[:, None]
    bs = torch.arange(po, dtype=torch.float32, device=device)[None, :]
    n = coef.shape[0]
    was = torch.empty((n, zpad // chunk, chunk, na, po), dtype=torch.float32, device=device)
    wbs = torch.empty((n, zpad // chunk, chunk, nb, po), dtype=torch.float32, device=device)
    for k in range(n):
        kb, kbz, kb0, ka, kaz, ka0 = coef[k]
        cb = coordinate(kb, kbz, kb0, bs, zs)
        ca = coordinate(ka, kaz, ka0, bs, zs)
        was[k] = _tap_table(ca, na, zpad).reshape(zpad // chunk, chunk, na, po)
        wbs[k] = _tap_table(cb, nb, zpad).reshape(zpad // chunk, chunk, nb, po)
    return was, wbs


def mip_rot_torch(img, was, wbs, r_axis, fgroup=1):
    """Plain version of :func:`mip_rot` (``_factored_contract`` of the JAX
    package): per group of ``fgroup`` frames and per z' chunk, the two
    einsums ``rab,fcbq->fracq`` and ``fracq,fcaq->frcq`` in float32, the
    max folded across chunks, clipped at 0; transposed to (n, po, rows) for
    ``r_axis=1``. The last group holds the frames left over (the JAX
    package pads it with zero tables and drops their frames: the same
    result)."""
    src3 = rows_first(img, r_axis)
    n, rows, po = was.shape[0], src3.shape[0], was.shape[-1]
    frames = torch.empty((n, rows, po), dtype=torch.float32, device=img.device)
    with fp32_matmul():
        for g0 in range(0, n, fgroup):
            wa, wb = was[g0:g0 + fgroup], wbs[g0:g0 + fgroup]
            acc = torch.full((wa.shape[0], rows, po), -torch.inf, dtype=torch.float32,
                             device=img.device)
            for c in range(wa.shape[1]):
                u = torch.einsum("rab,fcbq->fracq", src3, wb[:, c])
                out_c = torch.einsum("fracq,fcaq->frcq", u, wa[:, c])
                acc = torch.maximum(acc, out_c.amax(dim=2))
                del u, out_c
            frames[g0:g0 + wa.shape[0]] = acc.clamp_min(0)
    return frames.transpose(1, 2).contiguous() if r_axis == 1 else frames


def _check(img):
    if not isinstance(img, torch.Tensor):
        raise TypeError("img must be a torch.Tensor")
    if img.dtype != torch.float32:
        raise TypeError(f"img must be float32, got {img.dtype}")
    if img.dim() != 3 or img.numel() == 0:
        raise ValueError(f"img must be a non-empty (z, y, x) volume, got shape "
                         f"{tuple(img.shape)}")


def mip_rot(img, mats, out_shape, r_axis, *, chunk=32, fgroup=1, plan=None):
    """The rotating MIP's frames for rotations that pass axis ``r_axis``
    through (``models.projections.mip3d_params``' passthrough check): a
    (n, rows, po) stack for ``r_axis=2``, (n, po, rows) for ``r_axis=1``,
    on the volume's device. ``mats`` is the (n, 12) stack, ``out_shape``
    the rotated grid (z, y, x). A CPU tensor runs :func:`mip_rot_torch`
    on the tap tables that ``plan(shape_zyx, mats, out_shape, r_axis,
    chunk, device=...)`` gives (default: :func:`tap_tables`, uncached) in
    groups of ``fgroup`` frames; a CUDA tensor launches K8, which needs
    neither, or the call raises."""
    _check(img)
    rows, na, nb, zo, po = extents(tuple(img.shape), out_shape, r_axis)
    if img.device.type == "cpu":
        if plan is None:
            was, wbs = tap_tables(mats, zo, na, nb, po, chunk, r_axis, img.device)
        else:
            was, wbs = plan(tuple(img.shape), mats, out_shape, r_axis, chunk,
                            device=img.device)
        return mip_rot_torch(img, was, wbs, r_axis, fgroup)
    if img.device.type != "cuda":
        raise ValueError(f"mip_rot runs on CPU or CUDA tensors, not {img.device}")
    return _launch(img, mats, r_axis, rows, na, nb, zo, po)


def _launch(img, mats, r_axis, rows, na, nb, zo, po):
    global LAUNCHES
    lib = _library()
    src = rows_first(img, r_axis)
    coef = torch.from_numpy(coefficients(mats, r_axis)).to(img.device)
    n = coef.shape[0]
    shape = (n, rows, po) if r_axis == 2 else (n, po, rows)
    out = torch.empty(shape, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.mil_mip_rot(src.data_ptr(), coef.data_ptr(), out.data_ptr(), n, rows, na,
                              nb, zo, po, int(r_axis == 1), stream)
    build.check(lib, err, "mip_rot kernel launch")
    LAUNCHES += 1
    return out
