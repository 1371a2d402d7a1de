"""K5 and K4: the fused affine resample + NCC partial sums of
registration, without and with the gradient in the 12 matrix entries —
wrapper, launch counters and plain PyTorch versions.

:func:`corr3d` takes a source and a target (z, y, x) float32 volume of one
shape and a 12-vector matrix, and returns a float64 vector on the volumes'
device: ``[ss, st]`` (K5) or, with ``grad=True``, ``[ss, st, gs(12),
gt(12)]`` (K4), where gs = d(ss/2)/dm and gt = d(st)/dm. A CPU tensor runs
the plain version (:func:`corr3d_torch`: ``ops/affine.py``'s gather and
autograd through it); a CUDA tensor runs the hand-written kernel
``csrc/corr.cu`` (which replaces the JAX package's Pallas kernels
``microimagelib_tpu/ops/pallas_corr.py::_kernel`` and ``::_grad_kernel``),
or the call raises. The kernel is exact for every matrix: there is no fit
check and no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.ops.affine import corr3d_grad_torch, corr3d_partials

__all__ = ["corr3d", "corr3d_torch", "plain", "corr3d_partials",
           "corr3d_grad_torch", "K4_LAUNCHES", "K5_LAUNCHES", "PLAIN_CALLS"]

# kernel launches made by corr3d on CUDA tensors: K5 (grad=False), K4
K5_LAUNCHES = 0
K4_LAUNCHES = 0
# calls of the plain version through plain(): CPU tensors, or
# MIL_NCC_IMPL=gather|mxu (ops/corr.py)
PLAIN_CALLS = 0

# output voxels per block: each of the 128 threads sums ~32 in fp32
VOXELS_PER_BLOCK = 4096
_INT_MAX = 2 ** 31 - 1

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mil_corr3d.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.mil_corr3d.restype = i
        lib.mil_corr3d_blocks.argtypes = [i] * 3
        lib.mil_corr3d_blocks.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def rows_per_block(sx):
    """Output rows (one z, y each) per block of the kernel."""
    return max(1, VOXELS_PER_BLOCK // int(sx))


def matrix12(tmx):
    """The 12 matrix entries as a C-contiguous float32 numpy array."""
    if isinstance(tmx, torch.Tensor):
        tmx = tmx.detach().cpu().numpy()
    m = np.ascontiguousarray(np.asarray(tmx, np.float32).reshape(-1))
    if m.shape != (12,):
        raise ValueError(f"the matrix must have 12 entries, got {m.shape[0]}")
    return m


def corr3d_torch(src, tgt, tmx, grad=False):
    """Plain version of :func:`corr3d` (same packed float64 result, on the
    volumes' device)."""
    if grad:
        ss, st, gs, gt = corr3d_grad_torch(src, tgt, tmx)
        return torch.cat([ss[None], st[None], gs, gt])
    return torch.stack(corr3d_partials(src, tgt, tmx))


def plain(src, tgt, tmx, grad=False):
    """:func:`corr3d_torch`, counted in :data:`PLAIN_CALLS`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return corr3d_torch(src, tgt, tmx, grad)


def _check(src, tgt):
    for name, t in (("src", src), ("tgt", tgt)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise TypeError(f"{name} must be a 3-D float32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if src.shape != tgt.shape:
        raise ValueError(f"src {tuple(src.shape)} and tgt {tuple(tgt.shape)} "
                         "differ in shape")
    if src.device != tgt.device:
        raise ValueError(f"src is on {src.device}, tgt on {tgt.device}")
    if min(src.shape) < 1 or max(src.shape) > _INT_MAX \
            or src.shape[0] * src.shape[1] > _INT_MAX:
        raise ValueError(f"corr3d does not take the grid {tuple(src.shape)}")


def corr3d(src, tgt, tmx, grad=False):
    """K5 (``grad=False``): float64 ``[ss, st]``; K4 (``grad=True``):
    float64 ``[ss, st, gs(12), gt(12)]``, on the volumes' device. ss and st
    are sum s^2 and sum s*t for s = ``src`` resampled through ``tmx`` onto
    the target grid (strict lower mask), t = ``tgt``."""
    _check(src, tgt)
    m = matrix12(tmx)
    if src.device.type == "cpu":
        return plain(src, tgt, m, grad)
    if src.device.type != "cuda":
        raise ValueError(f"corr3d runs on CPU or CUDA tensors, not {src.device}")
    return _launch(src, tgt, m, grad)


def _launch(src, tgt, m, grad):
    global K4_LAUNCHES, K5_LAUNCHES
    lib = _library()
    sz, sy, sx = src.shape
    rows = rows_per_block(sx)
    blocks = lib.mil_corr3d_blocks(sz, sy, rows)
    nv = 26 if grad else 2
    partials = torch.empty((blocks, nv), dtype=torch.float64, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.mil_corr3d(src.data_ptr(), tgt.data_ptr(), m.ctypes.data,
                             partials.data_ptr(), sz, sy, sx, rows, int(grad),
                             stream)
    build.check(lib, err, "corr3d kernel launch")
    if grad:
        K4_LAUNCHES += 1
    else:
        K5_LAUNCHES += 1
    # the counterpart of the TPU wrapper's jnp.sum over the spread
    # partials: one row per block, summed in float64 (deterministic)
    return partials.sum(dim=0)
