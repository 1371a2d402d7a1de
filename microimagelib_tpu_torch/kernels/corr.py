"""K5, K4 and K6: the fused affine resample + NCC partial sums of
registration, without and with the gradient in the 12 matrix entries, and
the sums of N matrices in one launch — wrappers, launch counters and plain
PyTorch versions.

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

:func:`corr3d_nprobe` takes (N, 12) matrices and returns (N, 2) float64
``[ss, st]`` rows: K6 on a CUDA tensor (``csrc/corr.cu``, replacing
``microimagelib_tpu/ops/pallas_corr.py::_kernel_nprobe``), whose row i
equals K5's result for matrix i bit for bit; :func:`corr3d_nprobe_torch`
on a CPU tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.ops.affine import corr3d_grad_torch, corr3d_partials

__all__ = ["corr3d", "corr3d_torch", "plain", "corr3d_nprobe",
           "corr3d_nprobe_torch", "plain_nprobe", "corr3d_partials",
           "corr3d_grad_torch", "launch_plan", "kernel_plan", "kernel_attrs",
           "K4_LAUNCHES", "K5_LAUNCHES", "K6_LAUNCHES", "PLAIN_CALLS"]

# kernel launches made by corr3d on CUDA tensors: K5 (grad=False), K4; and
# by corr3d_nprobe: K6 (one per group of at most MAX_PROBES matrices)
K5_LAUNCHES = 0
K4_LAUNCHES = 0
K6_LAUNCHES = 0
# calls of the plain versions through plain() and plain_nprobe(): CPU
# tensors, or MIL_NCC_IMPL=gather|mxu (ops/corr.py)
PLAIN_CALLS = 0
# matrices one K6 launch takes (csrc/corr.cu kMaxProbes)
MAX_PROBES = 8

# The launch plan, as csrc/corr.cu::make_plan computes it.
THREADS = 128
WARPS = THREADS // 32
H100_SMS = 132
# resident blocks per SM the kernels' launch bounds promise: K5 (and K6,
# which takes K5's plan), K4
RESIDENT = {False: 6, True: 4}
MIN_BLOCKS_PER_SM = 2        # the fill the plan aims for
VX_CHOICES = (4, 2, 1)       # voxels a thread a step, widest first
_INT_MAX = 2 ** 31 - 1

_lib = None
_sms = {}
_work = {}


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mil_corr3d.argtypes = [p] * 4 + [ll, p] + [i] * 4 + [p]
        lib.mil_corr3d.restype = i
        lib.mil_corr3d_nprobe.argtypes = [p] * 3 + [i, p, ll, p] + [i] * 3 + [p]
        lib.mil_corr3d_nprobe.restype = i
        lib.mil_corr3d_max_probes.restype = i
        if lib.mil_corr3d_max_probes() != MAX_PROBES:
            raise RuntimeError("kernels/corr.py and csrc/corr.cu disagree on "
                               "the probes per K6 launch")
        lib.mil_corr3d_plan.argtypes = [i] * 5 + [p]
        lib.mil_corr3d_plan.restype = i
        lib.mil_corr3d_attrs.argtypes = [i] * 3 + [p]
        lib.mil_corr3d_attrs.restype = i
        _lib = lib
    return _lib


def launch_plan(shape, grad, sm_count=H100_SMS):
    """The kernels' launch plan for a (sz, sy, sx) grid on a card of
    ``sm_count`` SMs: K4 (``grad``) or K5 (K6 takes K5's). A dict of ``vx``
    voxels a thread a step (lane l of a warp takes x = x0 + l + 32 j,
    j < vx, of one row), ``wsegs`` warp tasks a row, ``tasks`` (rows x
    wsegs), ``steps`` tasks a warp (a block of :data:`WARPS` warps takes
    WARPS x steps consecutive tasks), ``blocks`` and ``wide`` (1: 64-bit
    voxel offsets, for grids of 2^31 voxels or more).

    vx is the widest of :data:`VX_CHOICES` that gives
    :data:`MIN_BLOCKS_PER_SM` blocks an SM with one task a warp and pads a
    row by at most 1/8 (else 1); steps is the fewest that keeps the grid
    within one wave of the blocks :data:`RESIDENT` keeps on the card."""
    return dict(zip(_PLAN_KEYS, _plan(tuple(int(n) for n in shape), bool(grad),
                                      int(sm_count))))


@functools.lru_cache(maxsize=256)
def _plan(shape, grad, sm_count):
    sz, sy, sx = shape
    rows = sz * sy
    want = MIN_BLOCKS_PER_SM * sm_count
    for vx in VX_CHOICES:
        span = 32 * vx
        wsegs = -(-sx // span)
        tasks = rows * wsegs
        if -(-tasks // WARPS) >= want and 8 * (wsegs * span - sx) <= sx:
            break
    steps = -(-tasks // (WARPS * RESIDENT[grad] * sm_count))
    return vx, wsegs, tasks, steps, -(-tasks // (WARPS * steps)), int(rows * sx > _INT_MAX)


_PLAN_KEYS = ("vx", "wsegs", "tasks", "steps", "blocks", "wide")


def kernel_plan(shape, grad, sm_count=H100_SMS):
    """The compiled kernels' own plan (``mil_corr3d_plan``), as a dict with
    :func:`launch_plan`'s keys."""
    lib = _library()
    out = (ctypes.c_longlong * 6)()
    err = lib.mil_corr3d_plan(*(int(n) for n in shape), int(bool(grad)), sm_count, out)
    build.check(lib, err, "corr3d plan")
    return dict(zip(_PLAN_KEYS, out))


def kernel_attrs(kind, vx, wide=0, device=None):
    """What an instantiation compiled to on the current (or the given) CUDA
    device: ``kind`` "K5", "K4" or "K6", ``vx`` and ``wide`` as the plan
    gives them. A dict of registers and spilled bytes a thread, static
    shared bytes and resident blocks per SM."""
    lib = _library()
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.mil_corr3d_attrs(("K5", "K4", "K6").index(kind), int(vx), int(wide), vals)
    build.check(lib, err, "corr3d kernel attributes")
    return dict(zip(("registers", "spill_bytes", "static_smem", "blocks_per_sm"), vals))


def _sm_count(device):
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _workspace(device, stream, n):
    """The (device, stream)'s workspace of at least ``n`` doubles: the
    kernels' ticket (zero between launches) and then their block rows.
    Grown, zeroed, when a plan needs more; launches on one stream run in
    order, so they share it."""
    key = (device.index, stream)
    w = _work.get(key)
    if w is None or w.numel() < n:
        w = _work[key] = torch.zeros(n, dtype=torch.float64, device=device)
    return w


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


def matrices12(m12s):
    """(N, 12) matrix entries as a C-contiguous float32 numpy array."""
    if isinstance(m12s, torch.Tensor):
        m12s = m12s.detach().cpu().numpy()
    m = np.ascontiguousarray(np.asarray(m12s, np.float32))
    if m.ndim != 2 or m.shape[1] != 12 or m.shape[0] < 1:
        raise ValueError(f"expected (N, 12) matrices, got {m.shape}")
    return m


def corr3d_nprobe_torch(src, tgt, m12s):
    """Plain version of :func:`corr3d_nprobe`: (N, 2) float64 rows on the
    volumes' device, one :func:`corr3d_partials` per matrix."""
    return torch.stack([torch.stack(corr3d_partials(src, tgt, m))
                        for m in matrices12(m12s)])


def plain_nprobe(src, tgt, m12s):
    """:func:`corr3d_nprobe_torch`, counted once in :data:`PLAIN_CALLS`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return corr3d_nprobe_torch(src, tgt, m12s)


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
    if src.is_cuda:
        return _launch(src, tgt, tmx, grad)
    if src.device.type != "cpu":
        raise ValueError(f"corr3d runs on CPU or CUDA tensors, not {src.device}")
    return plain(src, tgt, matrix12(tmx), grad)


def _on(device):
    """The device's context, or none when it is current already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _host_matrix(tmx):
    """(array, address) of the 12 float32 matrix entries in host memory:
    the caller's own array when it is a C-contiguous float32 numpy array or
    CPU tensor of 12 entries, else :func:`matrix12`'s copy."""
    if isinstance(tmx, torch.Tensor):
        if tmx.device.type == "cpu" and tmx.dtype == torch.float32 \
                and tmx.numel() == 12 and tmx.is_contiguous():
            return tmx, tmx.data_ptr()
    elif isinstance(tmx, np.ndarray) and tmx.dtype == np.float32 and tmx.size == 12 \
            and tmx.flags.c_contiguous:
        return tmx, tmx.ctypes.data
    m = matrix12(tmx)
    return m, m.ctypes.data


def _launch(src, tgt, tmx, grad):
    global K4_LAUNCHES, K5_LAUNCHES
    lib = _library()
    m, m_ptr = _host_matrix(tmx)
    dev = src.device
    sz, sy, sx = src.shape
    nv = 26 if grad else 2
    blocks = _plan((sz, sy, sx), grad, _sm_count(dev))[4]
    out = torch.empty(nv, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = _workspace(dev, stream, 1 + blocks * nv)
    with _on(dev):
        err = lib.mil_corr3d(src.data_ptr(), tgt.data_ptr(), m_ptr,
                             work.data_ptr(), work.numel(), out.data_ptr(), sz, sy,
                             sx, int(grad), stream)
    build.check(lib, err, "corr3d kernel launch")
    if grad:
        K4_LAUNCHES += 1
    else:
        K5_LAUNCHES += 1
    return out


def corr3d_nprobe(src, tgt, m12s):
    """K6: (N, 2) float64 ``[ss, st]`` rows of the (N, 12) matrices
    ``m12s``, on the volumes' device; row i is :func:`corr3d` (K5) of
    matrix i, bit for bit. Groups of up to :data:`MAX_PROBES` matrices
    share one launch."""
    _check(src, tgt)
    ms = matrices12(m12s)
    if src.device.type == "cpu":
        return plain_nprobe(src, tgt, ms)
    if src.device.type != "cuda":
        raise ValueError(f"corr3d_nprobe runs on CPU or CUDA tensors, not "
                         f"{src.device}")
    return torch.cat([_launch_nprobe(src, tgt, ms[i:i + MAX_PROBES])
                      for i in range(0, ms.shape[0], MAX_PROBES)])


def _launch_nprobe(src, tgt, ms):
    global K6_LAUNCHES
    lib = _library()
    dev = src.device
    sz, sy, sx = src.shape
    n = ms.shape[0]
    blocks = _plan((sz, sy, sx), False, _sm_count(dev))[4]
    out = torch.empty((n, 2), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = _workspace(dev, stream, 1 + blocks * 2 * MAX_PROBES)
    with _on(dev):
        err = lib.mil_corr3d_nprobe(src.data_ptr(), tgt.data_ptr(), ms.ctypes.data,
                                    n, work.data_ptr(), work.numel(), out.data_ptr(),
                                    sz, sy, sx, stream)
    build.check(lib, err, "corr3d_nprobe kernel launch")
    K6_LAUNCHES += 1
    return out
