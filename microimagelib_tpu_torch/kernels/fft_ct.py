"""K3: the FFT circular convolution irfftn(rfftn(v) * otf) — wrapper,
launch counter and plain PyTorch version.

:func:`conv3_ct` takes a float32 (nz, ny, nx) volume and the natural-order
complex64 half-spectrum OTF (nz, ny, nx//2+1) that ``gen_otf`` makes. A CPU
tensor runs :func:`conv3_ct_torch`; a CUDA tensor runs the hand-written
kernel ``csrc/fft_ct.cu`` (which replaces the JAX package's Pallas kernels
``microimagelib_tpu/ops/fft_pallas.py::_kernel_a/_kernel_b/_kernel_c``),
or the call raises. The kernel computes every 1-D transform itself: no
cuFFT, no ``torch.fft`` and no cuBLAS on the CUDA path. An axis whose
length has a :func:`radix_plan` takes the kernel's length-specialised
transform (register butterflies of those radices); any other length takes
its generic mixed-radix path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import build

__all__ = ["conv3_ct", "conv3_ct_torch", "ct_specialised", "ct_supported", "radix_plan",
           "spec_pitch", "kernel_attrs", "kernel_plan", "LAUNCHES",
           "LAUNCHES_SPECIALISED"]

# conv3_ct calls on a CUDA tensor (each is five kernel launches)
LAUNCHES = 0
# of those calls, the ones whose transform along each axis took the
# length-specialised path
LAUNCHES_SPECIALISED = {"x": 0, "y": 0, "z": 0}

# the radices of the length-specialised transforms, in pass order; the
# kernel's own table (csrc/fft_ct.cu Len<N>::plan) is held to this one on
# the card through kernel_plan
_PLANS = {64: (8, 8), 128: (8, 4, 4), 192: (8, 8, 3), 256: (8, 8, 4), 320: (8, 8, 5),
          384: (8, 4, 4, 3), 512: (8, 8, 8), 576: (8, 8, 3, 3), 640: (8, 4, 4, 5),
          704: (8, 8, 11), 768: (8, 8, 4, 3), 1024: (8, 8, 4, 4)}
# spectrum rows are padded to a multiple of this many complex64 (128 bytes)
PITCH_QUANTUM = 16

# longest line on any axis (csrc/fft_ct.cu kMaxLen: two shared buffers of
# one 8192-point complex line are 128 KB of the 227 KB a block may use)
MAX_LEN = 8192

_lib = None
_TABLES = {}


def ct_supported(shape):
    """Whether the kernel takes a (z, y, x) grid: nx even, every axis at
    most :data:`MAX_LEN`. Every length works (radix-4/2 passes and one
    dense pass for the odd factor). This accepts every shape the JAX
    package's ``ct_supported`` accepts with all axes <= 8192, and lifts its
    512 x 512 plane cap, which is a TPU VMEM limit."""
    nz, ny, nx = (int(s) for s in shape)
    return (nx >= 2 and nx % 2 == 0 and nz >= 1 and ny >= 1
            and max(nz, ny, nx) <= MAX_LEN)


def radix_plan(n):
    """The radices, in pass order, of the kernel's length-specialised
    transform of length ``n``, or None where ``n`` takes the generic path."""
    return _PLANS.get(int(n))


def ct_specialised(shape):
    """Whether every axis of a (z, y, x) grid takes the kernel's
    length-specialised transform."""
    return _len_mask(shape) == 7


def spec_pitch(nx):
    """Row pitch, in complex64 values, of the kernel's spectrum scratch:
    nx//2 + 1 rounded up to :data:`PITCH_QUANTUM`."""
    kx = nx // 2 + 1
    return -(-kx // PITCH_QUANTUM) * PITCH_QUANTUM


def _len_mask(shape):
    """Bit a set (0 x, 1 y, 2 z) where that axis has a :func:`radix_plan`."""
    nz, ny, nx = shape
    return sum(1 << a for a, n in enumerate((nx, ny, nz)) if radix_plan(n))


def conv3_ct_torch(v, otf):
    """Plain version of :func:`conv3_ct` (``torch.fft``)."""
    return torch.fft.irfftn(torch.fft.rfftn(v) * otf, s=tuple(v.shape))


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mil_conv3_ct.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.mil_conv3_ct.restype = i
        lib.mil_conv3_ct_attrs.argtypes = [i] * 4 + [p]
        lib.mil_conv3_ct_attrs.restype = i
        lib.mil_conv3_ct_plan.argtypes = [i, p]
        lib.mil_conv3_ct_plan.restype = i
        _lib = lib
    return _lib


def twiddles(n):
    """(n, 2) float32 table of (cos, sin)(2 pi t / n), built in float64
    and rounded once."""
    ang = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def _table(n, device):
    key = (n, str(device))
    tab = _TABLES.get(key)
    if tab is None:
        tab = torch.from_numpy(twiddles(n)).to(device)
        _TABLES[key] = tab
    return tab


def conv3_ct(v, otf):
    """Circular convolution ``irfftn(rfftn(v) * otf, s=v.shape)`` of a
    float32 (nz, ny, nx) tensor with a complex64 (nz, ny, nx//2+1) OTF on
    the same device. Raises on a grid :func:`ct_supported` refuses."""
    if not isinstance(v, torch.Tensor) or not isinstance(otf, torch.Tensor):
        raise TypeError("conv3_ct takes torch tensors")
    if v.dtype != torch.float32 or v.dim() != 3:
        raise TypeError(f"v must be a 3-D float32 tensor, got {v.dtype} "
                        f"{tuple(v.shape)}")
    nz, ny, nx = v.shape
    if otf.dtype != torch.complex64 or tuple(otf.shape) != (nz, ny, nx // 2 + 1):
        raise ValueError(f"otf must be complex64 {(nz, ny, nx // 2 + 1)}, got "
                         f"{otf.dtype} {tuple(otf.shape)}")
    if otf.device != v.device:
        raise ValueError(f"otf is on {otf.device}, v on {v.device}")
    if not ct_supported(v.shape):
        raise ValueError(f"conv3_ct does not take the grid {tuple(v.shape)}")
    if v.device.type == "cpu":
        return conv3_ct_torch(v, otf)
    if v.device.type != "cuda":
        raise ValueError(f"conv3_ct runs on CPU or CUDA tensors, not {v.device}")
    if not (v.is_contiguous() and otf.is_contiguous()):
        raise ValueError("v and otf must be contiguous")
    if v.data_ptr() % 16:   # the x launches read v as float4
        raise ValueError("v must start on a 16-byte boundary")
    return _launch(v, otf)


def _launch(v, otf):
    global LAUNCHES
    lib = _library()
    nz, ny, nx = v.shape
    mask = _len_mask(v.shape)
    out = torch.empty_like(v)
    spec = torch.empty((nz, ny, spec_pitch(nx)), dtype=torch.complex64,
                       device=v.device)
    tabs = [_table(n, v.device) for n in (nx, ny, nz)]
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.mil_conv3_ct(v.data_ptr(), otf.data_ptr(), spec.data_ptr(),
                               out.data_ptr(), *(t.data_ptr() for t in tabs),
                               nz, ny, nx, mask, stream)
    build.check(lib, err, "fft_ct kernel launch")
    LAUNCHES += 1
    for a, axis in enumerate("xyz"):
        if mask >> a & 1:
            LAUNCHES_SPECIALISED[axis] += 1
    return out


def kernel_attrs(shape, device=None):
    """What each of the five launches at ``shape`` compiled to, on the
    current (or the given) CUDA device: a list of dicts, in launch order,
    of registers and spilled bytes a thread, static and dynamic shared
    bytes a block, threads a block and resident blocks per SM."""
    lib = _library()
    nz, ny, nx = (int(s) for s in shape)
    vals = (ctypes.c_int * 30)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.mil_conv3_ct_attrs(nz, ny, nx, _len_mask(shape), vals)
    build.check(lib, err, "fft_ct kernel attributes")
    keys = ("registers", "spill_bytes", "static_smem", "dynamic_smem", "threads",
            "blocks_per_sm")
    return [dict(zip(keys, vals[6 * i:6 * i + 6])) for i in range(5)]


def kernel_plan(n):
    """What the compiled kernel does with an axis of length ``n``: (the
    spectrum's row pitch where ``n`` is nx, the radices of its
    length-specialised transform in pass order, () on the generic path).
    Equals (:func:`spec_pitch`, :func:`radix_plan`) where the two tables
    agree."""
    out = (ctypes.c_int * 8)()
    count = _library().mil_conv3_ct_plan(int(n), out)
    return out[0], tuple(out[1:1 + count])
