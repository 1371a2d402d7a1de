"""K1: the separable compact-PSF circular convolution with the fused RL
epilogue — wrapper, launch counter, launch plan and plain PyTorch version.

:func:`conv3_sep` takes a plan from ``ops/conv_sep.py``. A CPU tensor
runs :func:`conv3_sep_torch`; a CUDA tensor runs the hand-written kernel
``csrc/conv_sep.cu`` (which replaces the JAX package's Pallas kernel
``microimagelib_tpu/ops/conv_sep.py::_kernel``) in one launch that
allocates nothing but ``out``, or the call raises. :func:`launch_plan` is
the host's copy of the kernel's tile, run and ring plan (what
:func:`kernel_plan` reads from the compiled kernel).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import build

__all__ = ["conv3_sep", "conv3_sep_torch", "zpass_torch", "xypass_torch", "LAUNCHES",
           "SPECS", "launch_plan", "plan_of", "kernel_plan", "kernel_attrs"]

# kernel launches made by conv3_sep (one per call on a CUDA tensor)
LAUNCHES = 0

# The launch plan, as csrc/conv_sep.cu::make_plan computes it.
THREADS = 256
SMEM_PER_SM = 233472      # 228 KB of shared memory an SM (H100)
SMEM_PER_BLOCK = 232448   # 227 KB a block may use
SMEM_RESERVED = 1024      # the runtime's share per block
H100_SMS = 132
# (rank, z taps, y taps, x taps) that compile to the kernel's specialised,
# fully unrolled stages: the bench 9^3 Gaussian, the tilted (17, 9, 25)
# measured-PSF class and the dual-view / fusion PSFs of views A and B
SPECS = ((1, 9, 9, 9), (4, 17, 9, 17), (1, 25, 15, 15), (1, 15, 15, 25))
# output planes a step of each: each ring value loaded feeds the z sums of
# both planes on the rank-1 paths
SPEC_ZQ = (2, 1, 2, 2)
# output tiles (rows, columns) in order of preference
TILES = ((32, 32), (16, 64), (16, 32), (8, 64), (8, 32), (8, 16), (4, 16), (4, 8))
# switches that force a path other plans take (0 = the plan's own): the
# generic instantiation; z taps from device memory without a ring
GENERIC, NO_RING = 1, 2

_MODES = {"plain": 0, "ratio": 1, "update": 2}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mil_conv3_sep.argtypes = [p] * 7 + [i] * 15 + [ctypes.c_float, i, p]
        lib.mil_conv3_sep.restype = i
        lib.mil_conv3_sep_plan.argtypes = [i] * 11 + [p]
        lib.mil_conv3_sep_plan.restype = i
        lib.mil_conv3_sep_attrs.argtypes = [i, i, p]
        lib.mil_conv3_sep_attrs.restype = i
        _lib = lib
    return _lib


def _align4(n):
    return (n + 3) & ~3


def _geometry(ty, tx, ly, lx, ry, rx, ring):
    """(hy, hx, iy, ix, mp): the z-sum tile (output tile plus the y/x
    stencil halo), a ring plane (the z-sum tile widened by the roll span;
    without a ring the z-sum tile) and the y-stencil tile's row pitch. The
    z-sum tile's and a ring plane's rows are hx and ix rounded up to 4."""
    hy, hx = ty + ly - 1, tx + lx - 1
    return (hy, hx, hy + (ry if ring else 0), hx + (rx if ring else 0),
            tx - 4 + 4 * ((lx + 6) // 4))


def _smem_bytes(ty, tx, ring, rg, zq, rank, nsteps, ly, lx, ry, rx):
    """Shared bytes of a block, carved as the kernel carves them: z taps
    [s][4], y and x taps, the ring, the z sums and y-stencil tiles of zq
    planes (each float section 16-byte aligned, rows of 4-float
    multiples), then the row and column tables and two ints a tap."""
    hy, hx, iy, ix, mp = _geometry(ty, tx, ly, lx, ry, rx, ring > 0)
    floats = (4 * nsteps + _align4(rank * (ly + lx)) + ring * iy * _align4(ix)
              + zq * rg * (hy * _align4(hx) + ty * mp))
    return 4 * (floats + iy + ix + 2 * nsteps)


def launch_plan(shape, rank, nsteps, ly, lx, ry=0, rx=0, sm_count=H100_SMS, flags=0):
    """The kernel's launch plan for a (nz, ny, nx) grid and a plan of
    ``rank``, ``nsteps`` z taps, ``ly``/``lx`` y/x taps and roll spans
    ``ry``/``rx`` (max - min of the per-tap dy/dx), on a card of
    ``sm_count`` SMs: a dict of ``path`` (index into :data:`SPECS`, -1 the
    generic instantiation), tile ``ty`` x ``tx``, ``run`` z planes a block
    over ``nruns`` runs, ``ring`` depth in planes (0: z taps from device
    memory), ``prefetch`` steps in flight, ``zq`` output planes a step
    (:data:`SPEC_ZQ` on a specialised path, else 1), ``rank_group``,
    ``smem`` bytes and ``blocks_per_sm`` by shared memory; None where
    nothing fits. The ring holds a step's z window and ``prefetch`` steps'
    planes more: nsteps - 1 + zq (prefetch + 1).

    Among the tiles, prefetch depths (2, then 1) and rank groups (all
    ranks, or one at a time without a ring) that fit a block, the one with
    the most outputs in flight per SM (tile area x resident blocks, at most
    2) times the outputs' share of the z-sum tile (the z stage's work grows
    with the halo), ties to more blocks, then to the order of
    :data:`TILES`; a ring before none. Then the number of runs along z that minimises waves x
    (run + the planes that fill the ring)."""
    nz, ny, nx = shape
    spec = -1 if flags & GENERIC else (SPECS.index((rank, nsteps, ly, lx))
                                       if (rank, nsteps, ly, lx) in SPECS else -1)
    best = None
    for ring_ok in ((True, False) if not flags & NO_RING else (False,)):
        score = (0, 0)
        for ty, tx in TILES:
            for pf in ((2, 1) if ring_ok else (0,)):
                for rg in ((rank,) if ring_ok else tuple(dict.fromkeys((rank, 1)))):
                    zq = SPEC_ZQ[spec] if ring_ok and spec >= 0 else 1
                    ring = nsteps - 1 + zq * (pf + 1) if ring_ok else 0
                    smem = _smem_bytes(ty, tx, ring, rg, zq, rank, nsteps, ly, lx, ry, rx)
                    if smem > SMEM_PER_BLOCK:
                        continue
                    bps = min(2, SMEM_PER_SM // (smem + SMEM_RESERVED))
                    hy, hx = ty + ly - 1, tx + lx - 1
                    key = (ty * tx * bps * ty * tx / (hy * hx), bps)
                    if key > score:
                        score = key
                        best = dict(path=spec if ring else -1, ty=ty, tx=tx, ring=ring,
                                    prefetch=pf, zq=zq, rank_group=rg, smem=smem,
                                    blocks_per_sm=bps)
        if best is not None:
            break
    if best is None:
        return None
    tiles = -(-ny // best["ty"]) * -(-nx // best["tx"])
    slots = sm_count * best["blocks_per_sm"]
    fill = nsteps - 1 if best["ring"] else 0
    cost = None
    for n in range(1, nz + 1):
        run = -(-nz // n)
        nruns = -(-nz // run)
        c = -(-tiles * nruns // slots) * (run + fill)
        if cost is None or c < cost:
            cost, best["run"], best["nruns"] = c, run, nruns
    return best


def _roll_span(plan):
    """(dymin, dymax, dxmin, dxmax) of the plan's per-tap rolls (0 without)."""
    if plan.rolls is None:
        return 0, 0, 0, 0
    r = np.asarray(plan.rolls)
    return int(r[:, 0].min()), int(r[:, 0].max()), int(r[:, 1].min()), int(r[:, 1].max())


def plan_of(plan, sm_count=H100_SMS, flags=0):
    """:func:`launch_plan` for a ``SepPlan``."""
    dy0, dy1, dx0, dx1 = _roll_span(plan)
    return launch_plan(plan.shape, plan.rank, plan.nsteps, plan.ty.shape[1],
                       plan.tx.shape[1], dy1 - dy0, dx1 - dx0, sm_count, flags)


_PLAN_KEYS = ("path", "ty", "tx", "run", "nruns", "ring", "prefetch", "zq", "rank_group",
              "smem", "blocks_per_sm")


def kernel_plan(shape, rank, nsteps, ly, lx, ry=0, rx=0, sm_count=H100_SMS, flags=0):
    """The compiled kernel's own plan (``mil_conv3_sep_plan``), as a dict
    with :func:`launch_plan`'s keys; None where it refuses."""
    out = (ctypes.c_int * 11)()
    err = _library().mil_conv3_sep_plan(*(int(n) for n in shape), rank, nsteps, ly, lx,
                                        ry, rx, sm_count, flags, out)
    return None if err else dict(zip(_PLAN_KEYS, out))


def kernel_attrs(plan, device=None):
    """What the instantiation a :func:`launch_plan` dict launches compiled
    to, on the current (or the given) CUDA device, at its shared bytes:
    registers and spilled bytes a thread, static shared bytes a block and
    resident blocks per SM."""
    lib = _library()
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.mil_conv3_sep_attrs(int(plan["path"]), int(plan["smem"]), vals)
    build.check(lib, err, "conv_sep kernel attributes")
    return dict(zip(("registers", "spill_bytes", "static_smem", "blocks_per_sm"), vals))


def _epilogue(acc, aux, mode, smallvalue):
    if mode == "ratio":
        return aux / acc
    if mode == "update":
        return torch.clamp_min(aux * acc, smallvalue)
    return acc


def zpass_torch(v, plan):
    """The plain version's first stage: the (R, nz, ny, nx) rank volumes
    of the z taps (with the per-tap xy rolls), which the kernel keeps on
    chip."""
    zs = torch.zeros((plan.rank, *v.shape), dtype=v.dtype, device=v.device)
    for r in range(plan.rank):
        for s in range(plan.nsteps):
            t = float(plan.tz[r, s])
            if t == 0.0:
                continue
            dy, dx = (0, 0) if plan.rolls is None else plan.rolls[s]
            zs[r].add_(torch.roll(v, (plan.a - s, int(dy), int(dx)), (0, 1, 2)),
                       alpha=t)
    return zs


def xypass_torch(zs, plan, aux=None, mode="plain", smallvalue=0.01):
    """The plain version's second stage: per rank volume the y taps, then
    the x taps, summed over the ranks, then the epilogue."""
    acc = torch.zeros_like(zs[0])
    for r in range(plan.rank):
        ys = torch.zeros_like(acc)
        for i in range(plan.ty.shape[1]):
            ys.add_(torch.roll(zs[r], plan.oy + i, 1), alpha=float(plan.ty[r, i]))
        xs = torch.zeros_like(acc)
        for j in range(plan.tx.shape[1]):
            xs.add_(torch.roll(ys, plan.ox + j, 2), alpha=float(plan.tx[r, j]))
        acc += xs
    return _epilogue(acc, aux, mode, smallvalue)


def conv3_sep_torch(v, plan, aux=None, mode="plain", smallvalue=0.01):
    """Plain version of :func:`conv3_sep`: ``torch.roll`` and multiply-add
    over the taps, per rank z (with the per-tap xy rolls), then y, then x,
    then the epilogue — the kernel's order, in two stages."""
    return xypass_torch(zpass_torch(v, plan), plan, aux, mode, smallvalue)


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


def conv3_sep(v, plan, aux=None, mode="plain", smallvalue=0.01, *, flags=0):
    """Circular convolution of ``v`` (z, y, x) float32 with the planned
    separable kernel; matches irfftn(rfftn(v) * gen_otf(psf)).

    mode 'plain': conv(v). 'ratio': aux / conv(v). 'update':
    max(aux * conv(v), smallvalue) — the RL elementwise stages
    (reference:src/api_subfunc.cu:3404-3416). ``flags``: :data:`GENERIC`
    and/or :data:`NO_RING` force the path other plans take (the same
    bits), 0 for the plan's own; a CPU tensor ignores them."""
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
    return _launch(v, plan, aux, mode, smallvalue, flags)


def _launch(v, plan, aux, mode, smallvalue, flags):
    global LAUNCHES
    lib = _library()
    tz, ty, tx, rolls = plan.tensors(v.device)
    nz, ny, nx = v.shape
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.mil_conv3_sep(
            v.data_ptr(), (v if aux is None else aux).data_ptr(),
            out.data_ptr(), tz.data_ptr(),
            None if rolls is None else rolls.data_ptr(),
            ty.data_ptr(), tx.data_ptr(),
            nz, ny, nx, plan.rank, plan.a, plan.nsteps,
            ty.shape[1], plan.oy, tx.shape[1], plan.ox, *_roll_span(plan),
            _MODES[mode], float(smallvalue), int(flags), stream)
    build.check(lib, err, "conv_sep kernel launch")
    LAUNCHES += 1
    return out
