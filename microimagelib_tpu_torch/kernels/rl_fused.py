"""K2: one whole Richardson-Lucy iteration in one launch — wrapper, launch
counter, launch plan and plain PyTorch version.

:func:`rl_iter_fused` takes an :class:`~microimagelib_tpu_torch.ops.
conv_sep.RLFusedPlan` and returns ``max(est * bp(img / fwd(est)),
smallvalue)``. A CPU tensor runs :func:`rl_iter_fused_torch` (K1's plain
version in ratio mode, then in update mode); a CUDA tensor runs the
hand-written kernel ``csrc/rl_fused.cu`` (which replaces the JAX
package's Pallas kernel ``microimagelib_tpu/ops/conv_sep.py::_rl_kernel``),
or the call raises. The kernel runs K1's block stage twice in one launch
and keeps the ratio in a ring of z planes (:func:`launch_plan`, the
host's copy of the kernel's plan, which :func:`kernel_plan` reads from
the compiled kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.kernels.conv_sep import _check, conv3_sep_torch

__all__ = ["rl_iter_fused", "rl_iter_fused_torch", "launch_plan", "kernel_plan",
           "kernel_attrs", "LAUNCHES", "LAST_CONFIG"]

# kernel launches made by rl_iter_fused (one per call on a CUDA tensor)
LAUNCHES = 0
# the last launch's plan (launch_plan's keys) with its grid blocks,
# resident blocks per SM, ring and store bytes and the sync scheme
LAST_CONFIG = None

# The plan, as csrc/rl_fused.cu::make_k2_plan computes it: the groups
# stage 2 trails stage 1 by, beyond its reach (2 ran no faster on an H100)
LAG = 1
SYNC = "ticket"   # tasks in ticket order; per-group counters, acquire/release

_PLAN_KEYS = ("path", "group", "ngroups", "deferred", "lag", "head", "ring", "smem",
              "ty_fwd", "tx_fwd", "ty_bp", "tx_bp", "ring_fwd", "ring_bp")
_lib = None
_work = {}
_sms = {}


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i = ctypes.c_void_p, ctypes.c_int
        stage = [p] * 3 + [i] * 7
        lib.mil_rl_iter_fused.argtypes = ([p] * 4 + [i, p, i] + stage + stage + [i] * 3
                                          + [ctypes.c_float] + [i] * 2 + [p, p])
        lib.mil_rl_iter_fused.restype = i
        lib.mil_rl_fused_plan.argtypes = [i] * 16 + [p]
        lib.mil_rl_fused_plan.restype = i
        lib.mil_rl_fused_attrs.argtypes = [i, i, p]
        lib.mil_rl_fused_attrs.restype = i
        _lib = lib
    return _lib


def _stage_shape(p):
    """(rank, z taps, a, y taps, x taps) of a SepPlan."""
    return p.rank, p.nsteps, p.a, p.ty.shape[1], p.tx.shape[1]


def _store_layout(nz, a2, b2, g):
    """(ngroups, deferred, lag, head, ring) of the ratio store for groups
    of ``g`` planes; head = nz and ring = 0 where it is the whole volume."""
    la = -(-b2 // g)
    ngroups = -(-nz // g)
    deferred = min(-(-a2 // g), ngroups)
    ring = g * (1 + la + LAG) + a2
    head = min(deferred * g + b2, nz)
    if head + ring >= nz:
        head, ring = nz, 0
    return ngroups, deferred, la + LAG, head, ring


def launch_plan(plan, sm_count=K.H100_SMS, group=0, flags=0):
    """The kernel's plan for an ``RLFusedPlan`` (``flags`` as K1's): a dict
    of ``path`` (the K1 instantiation both stages take: a :data:`K.SPECS`
    index where the two stages' plans share it, else -1 the generic one),
    ``group`` z planes a group over ``ngroups`` groups, ``deferred``
    (stage-2 groups that read the last planes and run last, ceil(a2 /
    group)), ``lag`` (stage 2 of group g follows stage 1 of group g + lag:
    the back projector's reach above, ceil(b2 / group), and :data:`LAG`),
    the ratio store's ``head`` planes kept in place and ``ring`` slots (0:
    the store is the whole volume), ``smem`` bytes a block, and each
    stage's K1 tile and ring depth. The ring is group x (1 + lag) + a2
    planes for the back projector's z reach a2 below and b2 above.
    ``group`` 0
    takes the largest group whose store (head + ring) holds at most half a
    volume, or one group of nz planes where none of at least a z window
    (the longer stage's z taps - 1) does: each group costs every tile a z
    window of warm-up planes, so fewer groups run faster. None where a
    stage does not fit. Cached per plan and arguments."""
    kp = _launch_plan(plan, sm_count, group, flags)
    return None if kp is None else dict(kp)


@functools.lru_cache(maxsize=64)
def _launch_plan(plan, sm_count, group, flags):
    nz = plan.shape[0]
    stages = (plan.fwd, plan.bp)
    for _ in range(2):
        st = [K.launch_plan(plan.shape, r, ns, ly, lx, 0, 0, sm_count, flags)
              for r, ns, _a, ly, lx in map(_stage_shape, stages)]
        if None in st:
            return None
        if st[0]["path"] == st[1]["path"]:
            break
        flags |= K.GENERIC
    a2, b2 = plan.bp.a, plan.bp.nsteps - 1 - plan.bp.a
    if group:
        g = min(group, nz)
    else:
        window = max(plan.fwd.nsteps, plan.bp.nsteps) - 1
        g = next((t for t in range(nz, max(window, 1) - 1, -1)
                  if 2 * sum(_store_layout(nz, a2, b2, t)[3:]) <= nz), nz)
    ngroups, deferred, lag, head, ring = _store_layout(nz, a2, b2, g)
    return dict(path=st[0]["path"], group=g, ngroups=ngroups, deferred=deferred,
                lag=lag, head=head, ring=ring,
                smem=max(st[0]["smem"], st[1]["smem"]),
                ty_fwd=st[0]["ty"], tx_fwd=st[0]["tx"], ty_bp=st[1]["ty"],
                tx_bp=st[1]["tx"], ring_fwd=st[0]["ring"], ring_bp=st[1]["ring"])


def kernel_plan(plan, sm_count=K.H100_SMS, group=0, flags=0):
    """The compiled kernel's own plan (``mil_rl_fused_plan``), as a dict
    with :func:`launch_plan`'s keys; None where it refuses."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    args = [*plan.shape, *_stage_shape(plan.fwd), *_stage_shape(plan.bp)]
    err = _library().mil_rl_fused_plan(*(int(n) for n in args), sm_count, group, flags,
                                       out)
    return None if err else dict(zip(_PLAN_KEYS, out))


def kernel_attrs(kplan, device=None):
    """What the instantiation a :func:`launch_plan` dict launches compiled
    to, on the current (or the given) CUDA device, at its shared bytes:
    registers and spilled bytes a thread and resident blocks per SM."""
    lib = _library()
    vals = (ctypes.c_int * 3)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.mil_rl_fused_attrs(int(kplan["path"]), int(kplan["smem"]), vals)
    build.check(lib, err, "rl_fused kernel attributes")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm"), vals))


def rl_iter_fused_torch(est, img, plan, smallvalue=0.01):
    """Plain version of :func:`rl_iter_fused`: K1's plain version in
    ratio mode, then in update mode."""
    ratio = conv3_sep_torch(est, plan.fwd, aux=img, mode="ratio")
    return conv3_sep_torch(ratio, plan.bp, aux=est, mode="update",
                           smallvalue=smallvalue)


def rl_iter_fused(est, img, plan, smallvalue=0.01, *, group=0, flags=0):
    """One RL iteration ``max(est * bp(img / fwd(est)), smallvalue)`` of the
    (z, y, x) float32 ``est`` against the clamped image ``img``, with the
    projector pair of ``plan`` (from ``plan_rl_fused``). On the card,
    ``group`` (0: the plan's own) and ``flags`` (K1's
    :data:`K.GENERIC` / :data:`K.NO_RING`) pick the launch plan: every
    choice gives the same bits. A CPU tensor ignores them."""
    _check(est, "est", plan.shape)
    _check(img, "img", plan.shape)
    if img.device != est.device:
        raise ValueError(f"img is on {img.device}, est on {est.device}")
    if est.device.type == "cpu":
        return rl_iter_fused_torch(est, img, plan, smallvalue)
    if est.device.type != "cuda":
        raise ValueError(f"rl_iter_fused runs on CPU or CUDA tensors, "
                         f"not {est.device}")
    return _launch(est, img, plan, smallvalue, group, flags)


def _stage_args(plan, device):
    tz, ty, tx, _rolls = plan.tensors(device)
    return (tz.data_ptr(), ty.data_ptr(), tx.data_ptr(), plan.rank, plan.a,
            plan.nsteps, ty.shape[1], plan.oy, tx.shape[1], plan.ox)


def _workspace(device, stream, n):
    """The (device, stream)'s ticket, block count and task flags: at least
    ``n`` int32 zeros between launches (each launch leaves them 0); grown,
    zeroed, when a plan needs more. Launches on one stream run in order,
    so they share it."""
    key = (device.index, stream)
    w = _work.get(key)
    if w is None or w.numel() < n:
        w = _work[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return w


def _tiles(shape, kp, stage):
    """Output tiles of a stage's K1 plan on the grid."""
    return -(-shape[1] // kp["ty_" + stage]) * -(-shape[2] // kp["tx_" + stage])


def _sm_count(device):
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _launch(est, img, plan, smallvalue, group, flags):
    global LAUNCHES, LAST_CONFIG
    lib = _library()
    dev = est.device
    nz, ny, nx = est.shape
    kp = launch_plan(plan, _sm_count(dev), group, flags)
    if kp is None:
        raise ValueError(f"rl_iter_fused: no launch plan fits {plan.shape}")
    out = torch.empty_like(est)
    store = torch.empty((kp["head"] + kp["ring"], ny, nx), dtype=est.dtype, device=dev)
    info = (ctypes.c_int * (2 + len(_PLAN_KEYS)))()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ctr = _workspace(dev, stream, 2 + kp["ngroups"] * (_tiles(plan.shape, kp, "fwd")
                                                            + _tiles(plan.shape, kp, "bp")))
        err = lib.mil_rl_iter_fused(
            est.data_ptr(), img.data_ptr(), out.data_ptr(), store.data_ptr(),
            store.shape[0], ctr.data_ptr(), ctr.numel(),
            *_stage_args(plan.fwd, dev), *_stage_args(plan.bp, dev),
            nz, ny, nx, float(smallvalue), int(group), int(flags),
            ctypes.addressof(info), stream)
    build.check(lib, err, "rl_fused kernel launch")
    LAUNCHES += 1
    compiled = dict(zip(_PLAN_KEYS, info[2:]))
    if compiled != kp:
        raise RuntimeError(f"rl_fused: the kernel planned {compiled}, the host {kp}")
    plane_bytes = 4 * ny * nx
    LAST_CONFIG = dict(kp, grid=info[0], blocks_per_sm=info[1], sync=SYNC,
                       ring_bytes=kp["ring"] * plane_bytes,
                       store_bytes=store.shape[0] * plane_bytes)
    return out
