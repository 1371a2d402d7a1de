"""K7: the copy shaped like K1's launches — wrapper, launch counter and
plain PyTorch version.

:func:`pipe_copy` computes ``aux + 1e-6 * roll(v, -shift, 0)`` rounded
as one float32 FMA. A CPU tensor runs :func:`pipe_copy_torch`; a CUDA
tensor runs the hand-written kernel ``csrc/pipe_copy.cu`` (which replaces
the Pallas kernel ``tools/conv_roofline.py::copy_kernel``) in the launch
geometry of K1's z pass (``"z"``) or xy pass (``"xy"``), or the call
raises. Its time is the device-memory ceiling of that launch shape
(``microimagelib_tpu_torch/tools/conv_roofline.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import build

__all__ = ["pipe_copy", "pipe_copy_torch", "fma_f32", "LAUNCHES", "GEOMETRIES"]

# kernel launches made by pipe_copy (one per call on a CUDA tensor)
LAUNCHES = 0

GEOMETRIES = {"z": 0, "xy": 1}
SCALE = float(np.float32(1e-6))   # the float32 constant of the kernel's FMA
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mil_pipe_copy.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.mil_pipe_copy.restype = i
        _lib = lib
    return _lib


def fma_f32(x, y, z):
    """``x * y + z`` of float32 tensors (``y`` may be a float that float32
    holds exactly) rounded once to float32, as CUDA's ``fmaf``.

    In float64 the product is exact (24 x 24 bits) and the sum is rounded
    to odd (the TwoSum error decides the last bit), so the one rounding to
    float32 that follows is the correctly rounded FMA; a plain float64 sum
    would round twice and miss it where the sum lands on a float32
    midpoint."""
    p = x.double() * (y.double() if isinstance(y, torch.Tensor) else y)
    a = z.double()
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)         # s + err == a + p exactly
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.copysign(torch.full_like(s, torch.inf), err)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def pipe_copy_torch(v, aux, shift):
    """Plain version of :func:`pipe_copy`, equal to the kernel's
    ``fmaf(v[(z + shift) mod nz], 1e-6f, aux[z])`` bit for bit."""
    return fma_f32(torch.roll(v, -shift, 0), SCALE, aux)


def _check(t, name):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 3 or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (z, y, x) volume, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pipe_copy(v, aux, shift, geometry="xy"):
    """``aux + 1e-6 * roll(v, -shift, 0)`` (float32, one FMA per voxel) on
    (nz, ny, nx) volumes; ``shift`` is taken modulo nz. ``geometry`` picks
    the launch shape on the card: ``"z"`` (K1's z pass) or ``"xy"`` (K1's
    xy pass); both give the same bits."""
    if geometry not in GEOMETRIES:
        raise ValueError(f"unknown geometry {geometry!r}")
    _check(v, "v")
    _check(aux, "aux")
    if aux.shape != v.shape:
        raise ValueError(f"aux has shape {tuple(aux.shape)}, v {tuple(v.shape)}")
    if aux.device != v.device:
        raise ValueError(f"aux is on {aux.device}, v on {v.device}")
    shift = int(shift) % v.shape[0]
    if v.device.type == "cpu":
        return pipe_copy_torch(v, aux, shift)
    if v.device.type != "cuda":
        raise ValueError(f"pipe_copy runs on CPU or CUDA tensors, not {v.device}")
    return _launch(v, aux, shift, geometry)


def _launch(v, aux, shift, geometry):
    global LAUNCHES
    lib = _library()
    nz, ny, nx = v.shape
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.mil_pipe_copy(v.data_ptr(), aux.data_ptr(), out.data_ptr(),
                                nz, ny, nx, shift, GEOMETRIES[geometry], stream)
    build.check(lib, err, "pipe_copy kernel launch")
    LAUNCHES += 1
    return out
