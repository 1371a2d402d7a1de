"""K1: the separable compact-PSF circular convolution with the fused RL
epilogue — wrapper, launch counter and plain PyTorch version.

:func:`conv3_sep` takes a plan from ``ops/conv_sep.py``. A CPU tensor
runs :func:`conv3_sep_torch`; a CUDA tensor runs the hand-written kernel
``csrc/conv_sep.cu`` (which replaces the JAX package's Pallas kernel
``microimagelib_tpu/ops/conv_sep.py::_kernel``), or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from microimagelib_tpu_torch.kernels import build

__all__ = ["conv3_sep", "conv3_sep_torch", "LAUNCHES"]

# kernel launches made by conv3_sep (one per call on a CUDA tensor)
LAUNCHES = 0

_MODES = {"plain": 0, "ratio": 1, "update": 2}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mil_conv3_sep.argtypes = ([p] * 8 + [i] * 11
                                      + [ctypes.c_float, p])
        lib.mil_conv3_sep.restype = i
        _lib = lib
    return _lib


def _epilogue(acc, aux, mode, smallvalue):
    if mode == "ratio":
        return aux / acc
    if mode == "update":
        return torch.clamp_min(aux * acc, smallvalue)
    return acc


def conv3_sep_torch(v, plan, aux=None, mode="plain", smallvalue=0.01):
    """Plain version of :func:`conv3_sep`: ``torch.roll`` and multiply-add
    over the taps, per rank z (with the per-tap xy rolls), then y, then x,
    then the epilogue — the kernel's order."""
    acc = torch.zeros_like(v)
    for r in range(plan.rank):
        zs = torch.zeros_like(v)
        for s in range(plan.nsteps):
            t = float(plan.tz[r, s])
            if t == 0.0:
                continue
            dy, dx = (0, 0) if plan.rolls is None else plan.rolls[s]
            zs.add_(torch.roll(v, (plan.a - s, int(dy), int(dx)), (0, 1, 2)),
                    alpha=t)
        ys = torch.zeros_like(v)
        for i in range(plan.ty.shape[1]):
            ys.add_(torch.roll(zs, plan.oy + i, 1), alpha=float(plan.ty[r, i]))
        xs = zs.zero_()
        for j in range(plan.tx.shape[1]):
            xs.add_(torch.roll(ys, plan.ox + j, 2), alpha=float(plan.tx[r, j]))
        acc += xs
    return _epilogue(acc, aux, mode, smallvalue)


def _check(t, name, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the plan "
                         f"expects {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def conv3_sep(v, plan, aux=None, mode="plain", smallvalue=0.01):
    """Circular convolution of ``v`` (z, y, x) float32 with the planned
    separable kernel; matches irfftn(rfftn(v) * gen_otf(psf)).

    mode 'plain': conv(v). 'ratio': aux / conv(v). 'update':
    max(aux * conv(v), smallvalue) — the RL elementwise stages
    (reference:src/api_subfunc.cu:3404-3416)."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check(v, "v", plan.shape)
    if aux is None:
        if mode != "plain":
            raise ValueError("aux is required for mode %r" % (mode,))
    else:
        _check(aux, "aux", plan.shape)
        if aux.device != v.device:
            raise ValueError(f"aux is on {aux.device}, v on {v.device}")
    if v.device.type == "cpu":
        return conv3_sep_torch(v, plan, aux, mode, smallvalue)
    if v.device.type != "cuda":
        raise ValueError(f"conv3_sep runs on CPU or CUDA tensors, "
                         f"not {v.device}")
    return _launch(v, plan, aux, mode, smallvalue)


def _launch(v, plan, aux, mode, smallvalue):
    global LAUNCHES
    lib = _library()
    tz, ty, tx, rolls = plan.tensors(v.device)
    nz, ny, nx = v.shape
    out = torch.empty_like(v)
    scratch = torch.empty((plan.rank, nz, ny, nx), dtype=torch.float32,
                          device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.mil_conv3_sep(
            v.data_ptr(), (v if aux is None else aux).data_ptr(),
            out.data_ptr(), scratch.data_ptr(), tz.data_ptr(),
            None if rolls is None else rolls.data_ptr(),
            ty.data_ptr(), tx.data_ptr(),
            nz, ny, nx, plan.rank, plan.a, plan.nsteps,
            ty.shape[1], plan.oy, tx.shape[1], plan.ox,
            _MODES[mode], float(smallvalue), stream)
    build.check(lib, err, "conv_sep kernel launch")
    LAUNCHES += 1
    return out
