"""The registration cost's hot op: NCC partial sums of the affine-resampled
source against the target, with or without their gradient in the matrix
(the JAX package's ``ops/pallas_corr.py`` and the dispatch of
``ops/affine_fast.py``).

:func:`corr3d_partials_pallas` is K5 and :func:`corr3d_grad_pallas` K4
(``kernels/corr.py``, ``csrc/corr.cu``); they keep the JAX package's names.
Each call syncs once: it returns host (CPU) float64 0-d tensors, which is
where the optimizers read them.

``MIL_NCC_IMPL`` selects the route, read per call from the array's own
device: ``auto`` (default) or ``pallas`` take the kernel on a CUDA tensor;
``gather`` or ``mxu`` take the plain version on any device. A CPU tensor
always takes the plain version. There is no fallback between the two: a
CUDA tensor on the kernel route launches the kernel or raises.
"""

from __future__ import annotations

import os

import torch

from microimagelib_tpu_torch.kernels import corr as K

__all__ = ["corr3d_partials_pallas", "corr3d_grad_pallas", "corr3d_auto",
           "resolve_ncc_impl", "NCCPartials"]

_IMPLS = ("auto", "pallas", "gather", "mxu")


def resolve_ncc_impl(arr):
    """'pallas' (the kernels) or 'gather' (the plain version) for the
    tensor ``arr``, from ``MIL_NCC_IMPL`` and ``arr``'s device: the kernels
    only for a CUDA tensor under ``auto``/``pallas``; ``gather``/``mxu``
    (the one-hot MXU form is a TPU formulation; here it is the gather)
    name the plain version everywhere."""
    impl = os.environ.get("MIL_NCC_IMPL", "auto")
    if impl not in _IMPLS:
        raise ValueError(f"MIL_NCC_IMPL={impl!r}: expected one of {_IMPLS}")
    if impl in ("gather", "mxu") or arr.device.type != "cuda":
        return "gather"
    return "pallas"


def _packed(src, tgt, tmx, grad, impl):
    if impl is None:
        impl = resolve_ncc_impl(src)
    if impl == "pallas":
        out = K.corr3d(src, tgt, tmx, grad)
    elif impl == "gather":
        out = K.plain(src, tgt, K.matrix12(tmx), grad)
    else:
        raise ValueError(f"unknown NCC implementation {impl!r}")
    return out.cpu()


def corr3d_partials_pallas(src, tgt, tmx):
    """K5: (ss, st) as host float64 0-d tensors (the plain version for a
    CPU tensor)."""
    v = _packed(src, tgt, tmx, False, "pallas")
    return v[0], v[1]


def corr3d_grad_pallas(src, tgt, tmx):
    """K4: (ss, st, gs, gt) as host float64 tensors, gs = d(ss/2)/dm and
    gt = d(st)/dm (the plain version for a CPU tensor)."""
    v = _packed(src, tgt, tmx, True, "pallas")
    return v[0], v[1], v[2:14], v[14:26]


def corr3d_auto(src, tgt, tmx, impl=None):
    """(ss, st) through the route :func:`resolve_ncc_impl` picks for
    ``src`` (or ``impl``)."""
    v = _packed(src, tgt, tmx, False, impl)
    return v[0], v[1]


class NCCPartials(torch.autograd.Function):
    """``NCCPartials.apply(m, src, tgt, impl)``: (ss, st) of a 12-vector
    matrix ``m`` (a CPU float32 tensor) as host float64 0-d tensors,
    differentiable in ``m``; ``impl`` as for :func:`corr3d_auto`. The
    forward runs K4 when ``m`` needs a gradient (saving gs and gt) and K5
    when it does not; the backward returns 2*g_ss*gs + g_st*gt."""

    @staticmethod
    def forward(ctx, m, src, tgt, impl):
        grad = bool(ctx.needs_input_grad[0])
        v = _packed(src, tgt, m, grad, impl)
        if grad:
            ctx.save_for_backward(v[2:14], v[14:26])
        return v[0], v[1]

    @staticmethod
    def backward(ctx, g_ss, g_st):
        gs, gt = ctx.saved_tensors
        gm = 2.0 * g_ss * gs + g_st * gt
        return gm.to(torch.float32), None, None, None
