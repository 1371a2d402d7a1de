"""Elementwise and reduction operations under the reference's names: API
parity with its kernel and launcher inventory
(reference:include/cukernel.cuh:74-392, reference:src/api_subfunc.cu:92-539),
as the JAX package's ``ops/elementwise.py`` has them.

The port's pipelines write these as plain tensor expressions; the named
wrappers exist so that call sites ported from the reference API find every
operation. Each takes and returns tensors, on any device.
"""

from __future__ import annotations

import torch

from microimagelib_tpu_torch.ops.basics import max3d_with_coords

__all__ = ["add3d", "sub3d", "multi3d", "div3d", "add_value", "multi_value", "max_value",
           "multicomplex", "multidcomplex", "multicomplex_norm", "conj3d", "sum3d", "sum1d",
           "reduce_z", "max_z", "max3d"]


def add3d(a, b):
    return torch.add(a, b)


def sub3d(a, b):
    return torch.sub(a, b)


def multi3d(a, b):
    return torch.mul(a, b)


def div3d(a, b):
    """Elementwise division — like the reference kernel, no zero guard
    (reference:include/cukernel.cuh:196-208)."""
    return torch.div(a, b)


def add_value(a, v):
    return a + v


def multi_value(a, v):
    return a * v


def max_value(a, v):
    """max(a, v) — the RL clamp primitive (``maxvalue3Dgpukernel``)."""
    return torch.maximum(a, torch.as_tensor(v, dtype=a.dtype, device=a.device))


def multicomplex(a, b):
    """Complex multiply (``multicomplex3Dkernel``,
    reference:include/cukernel.cuh:140-158)."""
    return a * b


def multidcomplex(a, b):
    """Double-complex multiply (``multidcomplex3Dkernel``)."""
    return a.to(torch.complex128) * b.to(torch.complex128)


def multicomplex_norm(a, b):
    """Normalized complex multiply: (a*b)/|a*b|, 0 where the magnitude is
    0 — the phasor cross-power kernel (``multicomplexnorm3Dkernel``,
    reference:include/cukernel.cuh:156-178)."""
    prod = a * b
    mag = torch.abs(prod)
    return torch.where(mag != 0, prod / mag, torch.zeros((), dtype=prod.dtype,
                                                         device=prod.device))


def conj3d(a):
    return torch.conj_physical(a)


def sum3d(a):
    """Full-volume sum (``sum3Dgpu``: z-collapse then host double sum,
    reference:src/api_subfunc.cu:385-402), in a's type."""
    return torch.sum(a)


def sum1d(a):
    """Strided partial-sum reduction equivalent (``sumgpu1D``)."""
    return torch.sum(a.reshape(-1))


def reduce_z(a):
    """Per-(y, x) sum over z (``reduceZ``,
    reference:include/cukernel.cuh:349-360)."""
    return torch.sum(a, dim=0)


def max_z(a):
    """Per-(y, x) max and argmax over z, the first maximum (``maxZkernel``,
    reference:include/cukernel.cuh:362-379)."""
    return torch.amax(a, dim=0), torch.argmax(a, dim=0)


def max3d(a):
    """Max value + (x, y, z) coordinates (``max3Dgpu``)."""
    return max3d_with_coords(a)
