"""K2: one whole Richardson-Lucy iteration in one launch — wrapper, launch
counter and plain PyTorch version.

:func:`rl_iter_fused` takes an :class:`~microimagelib_tpu_torch.ops.
conv_sep.RLFusedPlan` and returns ``max(est * bp(img / fwd(est)),
smallvalue)``. A CPU tensor runs :func:`rl_iter_fused_torch` (K1's plain
version in ratio mode, then in update mode); a CUDA tensor runs the
hand-written kernel ``csrc/rl_fused.cu`` (which replaces the JAX
package's Pallas kernel ``microimagelib_tpu/ops/conv_sep.py::_rl_kernel``),
or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.kernels.conv_sep import _check, conv3_sep_torch

__all__ = ["rl_iter_fused", "rl_iter_fused_torch", "LAUNCHES", "LAST_CONFIG"]

# kernel launches made by rl_iter_fused (one per call on a CUDA tensor)
LAUNCHES = 0
# the last launch's (grid blocks, blocks per SM, z planes per task of the
# forward and the back-projector stage, shared-memory bytes per block)
LAST_CONFIG = None

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i = ctypes.c_void_p, ctypes.c_int
        stage = [p] * 3 + [i] * 7
        lib.mil_rl_iter_fused.argtypes = ([p] * 4 + stage + stage + [i] * 3
                                          + [ctypes.c_float, p, p])
        lib.mil_rl_iter_fused.restype = i
        _lib = lib
    return _lib


def rl_iter_fused_torch(est, img, plan, smallvalue=0.01):
    """Plain version of :func:`rl_iter_fused`: K1's plain version in
    ratio mode, then in update mode."""
    ratio = conv3_sep_torch(est, plan.fwd, aux=img, mode="ratio")
    return conv3_sep_torch(ratio, plan.bp, aux=est, mode="update",
                           smallvalue=smallvalue)


def rl_iter_fused(est, img, plan, smallvalue=0.01):
    """One RL iteration ``max(est * bp(img / fwd(est)), smallvalue)`` of the
    (z, y, x) float32 ``est`` against the clamped image ``img``, with the
    projector pair of ``plan`` (from ``plan_rl_fused``)."""
    _check(est, "est", plan.shape)
    _check(img, "img", plan.shape)
    if img.device != est.device:
        raise ValueError(f"img is on {img.device}, est on {est.device}")
    if est.device.type == "cpu":
        return rl_iter_fused_torch(est, img, plan, smallvalue)
    if est.device.type != "cuda":
        raise ValueError(f"rl_iter_fused runs on CPU or CUDA tensors, "
                         f"not {est.device}")
    return _launch(est, img, plan, smallvalue)


def _stage_args(plan, device):
    tz, ty, tx, _rolls = plan.tensors(device)
    return (tz.data_ptr(), ty.data_ptr(), tx.data_ptr(), plan.rank, plan.a,
            plan.nsteps, ty.shape[1], plan.oy, tx.shape[1], plan.ox)


def _launch(est, img, plan, smallvalue):
    global LAUNCHES, LAST_CONFIG
    lib = _library()
    nz, ny, nx = est.shape
    out = torch.empty_like(est)
    ratio = torch.empty_like(est)
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(est.device):
        stream = torch.cuda.current_stream(est.device).cuda_stream
        err = lib.mil_rl_iter_fused(
            est.data_ptr(), img.data_ptr(), out.data_ptr(), ratio.data_ptr(),
            *_stage_args(plan.fwd, est.device), *_stage_args(plan.bp, est.device),
            nz, ny, nx, float(smallvalue), ctypes.addressof(info), stream)
    build.check(lib, err, "rl_fused kernel launch")
    LAUNCHES += 1
    LAST_CONFIG = tuple(info)
    return out
