"""Maximum-intensity projection outputs: packed 2D MPs and rotating 3D MIP
movies (``mp2dgpu``/``mp3dgpu``/``mip3dgpu``,
reference:src/apifunc.cpp:485-644; the JAX package's
``models/projections.py``).

The rotating MIP has the JAX package's three routes, picked by
:func:`mip3d_params` under the same environment knobs:

- ``gather``: each frame a rotate (``affine_transform_3d`` through the
  ``rot_to_matrix`` of its angle) followed by a z max clipped at 0;
- ``matmul``: a rotation about x or y leaves that axis invariant, so a
  frame is one dense one-hot bilinear matrix W (s, p) applied to every
  invariant row by ``torch.matmul`` in float32;
- ``factored``: the same resample with per-axis 2-tap weights. A CUDA
  volume runs the hand-written kernel K8 (``kernels/mip_rot.py``,
  ``csrc/mip_rot.cu``); a CPU volume contracts the per-frame tap tables
  of :func:`mip3d_factored_plan` (cached) as the JAX package does.

All three give the same frames within float32 rounding."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from microimagelib_tpu_torch.kernels.mip_rot import (
    coefficients,
    coordinate,
    extents,
    fp32_matmul,
    mip_rot,
    rows_first,
    tap_tables,
)
from microimagelib_tpu_torch.models.deconvolution import _as_tensor
from microimagelib_tpu_torch.ops.affine import affine_transform_3d
from microimagelib_tpu_torch.ops.basics import max_projection
from microimagelib_tpu_torch.ops.matrix import rot_to_matrix
from microimagelib_tpu_torch.utils.device import free_memory_mb, resolve_device
from microimagelib_tpu_torch.utils.envflags import env_on

__all__ = ["mp2d", "mp2d_packed", "mip3d_params", "mip3d_factored_plan", "mip3d_frames",
           "mip3d", "mp3d"]


def _volume(img, device):
    return _as_tensor(img, resolve_device(img, device))


def _mp2d_flat(img, z_proj, x_proj, y_proj):
    """The requested panels raveled into one tensor, in the reference's
    order: XY (z-MIP), YZ (x-MIP), ZX (y-MIP)."""
    parts = []
    if z_proj:
        parts.append(max_projection(img, 1).reshape(-1))
    if x_proj:
        parts.append(max_projection(img, 3).reshape(-1))
    if y_proj:
        parts.append(max_projection(img, 2).reshape(-1))
    if not parts:
        return torch.zeros(0, dtype=torch.float32, device=img.device)
    return torch.cat(parts)


def _split_mp2d(flat, shape, z_proj, x_proj, y_proj):
    """The panels of :func:`_mp2d_flat`'s host copy, keyed 'xy', 'yz', 'zx'."""
    sz, sy, sx = shape
    out = {}
    off = 0
    if z_proj:
        out["xy"] = flat[off:off + sy * sx].reshape(sy, sx)
        off += sy * sx
    if x_proj:
        out["yz"] = flat[off:off + sz * sy].reshape(sz, sy)
        off += sz * sy
    if y_proj:
        out["zx"] = flat[off:off + sx * sz].reshape(sx, sz)
    return out


def mp2d(img, z_proj=True, x_proj=True, y_proj=True, *, device=None):
    """2D max projections. Returns a dict of 2D numpy arrays keyed 'xy'
    (z-MIP, (y, x)), 'yz' (x-MIP, (z, y)), 'zx' (y-MIP, (x, z)) — the three
    panels the reference packs into one buffer
    (reference:src/apifunc.cpp:485-505), fetched in one copy. The reference
    gates the third panel on flagZProj (a copy-paste slip); this gates it
    on y_proj as the interface documents. Runs on the tensor's device, or
    for a numpy array on ``device`` (default cuda:0)."""
    img = _volume(img, device)
    flat = _mp2d_flat(img, z_proj, x_proj, y_proj).cpu().numpy()
    return _split_mp2d(flat, tuple(img.shape), z_proj, x_proj, y_proj)


def _rotate_and_mip_all(img, mats, out_shape):
    """The gather route: for each matrix, ``img`` resampled onto the
    rotated grid and its z max, clipped at 0. (n, out_shape[1], out_shape[2])."""
    frames = torch.empty((len(mats), out_shape[1], out_shape[2]),
                         dtype=torch.float32, device=img.device)
    for i, m in enumerate(mats):
        rot = affine_transform_3d(img, m, out_shape)
        frames[i] = torch.clamp_min(rot.amax(dim=0), 0)
        del rot
    return frames


def _rotate_and_mip_all_matmul(img, mats, out_shape, r_axis):
    """The one-hot matmul route (JAX ``:75-149``): per frame, the dense
    bilinear matrix W (na * nb, zo * po) built by comparison with the four
    clamped corners (coincident corners add, as the gather's clamped taps
    do; zero outside the +-0.5 validity box), one float32 ``torch.matmul``
    of the (rows, na * nb) source with it, TF32 off, then the max over z'
    clipped at 0, transposed to (po, rows) for ``r_axis=1``."""
    rows, na, nb, zo, po = extents(tuple(img.shape), out_shape, r_axis)
    dev = img.device
    src2 = rows_first(img, r_axis).reshape(rows, na * nb)
    coef = torch.from_numpy(coefficients(mats, r_axis)).to(dev)
    zs = torch.arange(zo, dtype=torch.float32, device=dev)[:, None]
    bs = torch.arange(po, dtype=torch.float32, device=dev)[None, :]
    row_ids = torch.arange(na * nb, dtype=torch.int32, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n = coef.shape[0]
    frames = torch.empty((n, rows, po) if r_axis == 2 else (n, po, rows),
                         dtype=torch.float32, device=dev)
    with fp32_matmul():
        for k in range(n):
            kb, kbz, kb0, ka, kaz, ka0 = coef[k]
            cb = coordinate(kb, kbz, kb0, bs, zs)
            ca = coordinate(ka, kaz, ka0, bs, zs)
            valid = (cb >= -0.5) & (ca >= -0.5) & (cb < nb - 0.5) & (ca < na - 0.5)
            a0, b0 = torch.floor(ca), torch.floor(cb)
            fa, fb = ca - a0, cb - b0
            a0r, b0r = a0.to(torch.int32), b0.to(torch.int32)
            a0i, a1i = torch.clamp(a0r, 0, na - 1), torch.clamp(a0r + 1, 0, na - 1)
            b0i, b1i = torch.clamp(b0r, 0, nb - 1), torch.clamp(b0r + 1, 0, nb - 1)
            wv = valid.to(torch.float32)
            corners = ((a0i * nb + b0i, (1 - fa) * (1 - fb)),
                       (a0i * nb + b1i, (1 - fa) * fb),
                       (a1i * nb + b0i, fa * (1 - fb)),
                       (a1i * nb + b1i, fa * fb))
            w_mat = torch.zeros((na * nb, zo * po), dtype=torch.float32, device=dev)
            for idx, w in corners:
                w_mat += torch.where(row_ids == idx.reshape(1, -1), (w * wv).reshape(1, -1),
                                     zero)
            out = torch.matmul(src2, w_mat)
            del w_mat
            frame = torch.clamp_min(out.reshape(rows, zo, po).amax(dim=1), 0)
            frames[k] = frame.T if r_axis == 1 else frame
            del out
    return frames


_FACTORED_TABLE_CACHE = {}


def mip3d_factored_plan(shape_zyx, mats, out_shape, r_axis, chunk, *, device=None):
    """The image-independent half of the factored route: the per-frame
    2-tap tables (was, wbs) of ``kernels.mip_rot.tap_tables`` for a volume
    shape, rotation stack and z' chunk, on ``device`` (default cuda:0;
    'cpu' for the CPU). Cached, as the JAX package caches them: at most 2
    entries, keyed (sz, sy, sx, frames, r_axis, chunk) and the device, kept
    only where the tables fit a quarter of the device's free memory (always
    on the CPU, which has no memory stats); ``MIL_MIP_TABLE_CACHE=0``
    disables. K8 needs no tables: only the plain version reads them."""
    device = resolve_device(None, device)
    sz, sy, sx = shape_zyx
    _rows, na, nb, zo, po = extents(shape_zyx, out_shape, r_axis)
    key = (sz, sy, sx, len(mats), r_axis, chunk, str(device))
    hit = _FACTORED_TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    was, wbs = tap_tables(mats, zo, na, nb, po, chunk, r_axis, device)
    if env_on("MIL_MIP_TABLE_CACHE", True):
        free_mb = free_memory_mb(device)
        tbytes = (was.numel() + wbs.numel()) * 4
        if free_mb < 0 or tbytes <= free_mb * 1048576 * 0.25:
            while len(_FACTORED_TABLE_CACHE) >= 2:
                _FACTORED_TABLE_CACHE.pop(next(iter(_FACTORED_TABLE_CACHE)))
            _FACTORED_TABLE_CACHE[key] = (was, wbs)
    return was, wbs


def _rotate_and_mip_all_factored(img, mats, out_shape, r_axis, chunk, fgroup=1):
    """The factored route (JAX ``:277-297``): the joint bilinear weight of
    output point (z', q) factors per axis, w[(a, b), (z', q)] = wa[a, (z',
    q)] * wb[b, (z', q)], and the per-axis validity masks multiply to the
    joint +-0.5 box, so the frames equal the gather route's. K8 on a CUDA
    volume; on the CPU the plain contraction of the cached tables."""
    return mip_rot(img, mats, out_shape, r_axis, chunk=chunk, fgroup=fgroup,
                   plan=mip3d_factored_plan)


def mip3d_params(shape_zyx, r_axis, project_num=36, impl=None, *, device=None):
    """Route and parameters of the rotating MIP at a fixed volume shape, as
    the JAX package picks them: a dict with 'impl' ('gather', 'matmul' or
    'factored'), 'mats' ((project_num, 12) numpy float32, the reference's
    angle step 3.14159*2/project_num), 'out_shape' (the rotated grid, (z,
    y, x)) and, for 'factored', 'chunk', 'fgroup' and 'prec' ('high' or
    'highest', ``MIL_MIP_PRECISION``; the port's routes compute in float32
    either way). ``impl`` overrides ``MIL_MIP_IMPL`` (auto | gather |
    matmul | factored). The matmul and factored routes need a passthrough
    stack (the rotation axis passes through and feeds no other axis); any
    other takes 'gather'. The memory cap is ``MIL_MIP_MATMUL_MAX_BYTES``,
    else 60% / 2 of ``device``'s free memory, 3 GiB where it has no memory
    stats (the CPU, the default). ``auto`` on the CPU is the JAX package's
    rule: 'matmul' while W's bytes are at most the cap and
    ``MIL_MIP_FACTORED_MIN_W_BYTES`` (2^29), else 'factored'. On a CUDA
    ``device`` it is 'factored' (K8) for every passthrough stack:
    chip_smoke.py Phase 21 on an NVIDIA H100 80GB HBM3 (700 W) timed each
    route's call alone about both axes, 36 frames, and K8's was the
    fastest at each shape: 1.9-2.6 ms at (128, 128, 128) against the
    gather route's 71-73 ms and the matmul route's 805-807 ms (W 2.1 GB a
    frame); 4.9-5.1 ms at (320, 320, 320) and 5.9-7.1 ms at (320, 512,
    320) against the gather route's 1.16-1.32 s and 2.12-2.28 s (W of
    84-239 GB a frame there: over any cap). PERF.md section 6."""
    sz, sy, sx = shape_zyx
    if r_axis == 1:
        im_rot = int(round(math.hypot(sy, sz)))
        out_shape = (im_rot, im_rot, sx)
    elif r_axis == 2:
        im_rot = int(round(math.hypot(sx, sz)))
        out_shape = (im_rot, sy, im_rot)
    else:
        raise ValueError("r_axis must be 1 (X) or 2 (Y)")
    step = 3.14159 * 2 / project_num
    mats = np.stack([rot_to_matrix(step * i, sx, sy, sz, r_axis)
                     for i in range(project_num)]).astype(np.float32)
    if r_axis == 2:
        # y passes through and feeds neither x nor z (the matmul and
        # factored routes drop m[0,1] and m[2,1])
        passthrough = (np.allclose(mats[:, 4:8], [0.0, 1.0, 0.0, 0.0])
                       and np.allclose(mats[:, 1], 0.0)
                       and np.allclose(mats[:, 9], 0.0))
        s, p = sz * sx, out_shape[0] * out_shape[2]
    else:
        passthrough = (np.allclose(mats[:, 0:4], [1.0, 0.0, 0.0, 0.0])
                       and np.allclose(mats[:, 4], 0.0)
                       and np.allclose(mats[:, 8], 0.0))
        s, p = sz * sy, out_shape[0] * out_shape[1]
    on_cuda = device is not None and torch.device(device).type == "cuda"
    env_cap = os.environ.get("MIL_MIP_MATMUL_MAX_BYTES")
    if env_cap is not None:
        cap = int(env_cap)
    else:
        # W and its build's temporaries (~2x W) within 60% of free memory
        free_mb = free_memory_mb(device)
        cap = (3 << 30) if free_mb < 0 else int(free_mb * 1048576 * 0.6 / 2)
    if impl is None:
        impl = os.environ.get("MIL_MIP_IMPL", "auto")
    if impl == "auto":
        crossover = int(os.environ.get("MIL_MIP_FACTORED_MIN_W_BYTES", str(1 << 29)))
        if not passthrough:
            impl = "gather"
        elif not on_cuda and s * p * 4 <= min(cap, crossover):
            impl = "matmul"
        else:
            impl = "factored"
    params = {"out_shape": out_shape, "mats": mats}
    if impl == "factored" and passthrough:
        params["impl"] = "factored"
        # the plain version's rows * na * chunk * po intermediate within
        # ~1/4 of the cap; frames group first, the rest widens the chunk
        rows, na, _nb, _zo, po = extents(shape_zyx, out_shape, r_axis)
        per_z = rows * na * po * 4
        budget = int(max(cap, 1 << 28) // 4 // max(per_z, 1))
        params["fgroup"] = max(1, min(int(mats.shape[0]), budget,
                                      int(os.environ.get("MIL_MIP_FGROUP", "36"))))
        params["chunk"] = max(1, min(32, budget // params["fgroup"]))
        prec = os.environ.get("MIL_MIP_PRECISION", "high")
        if prec not in ("high", "highest"):
            raise ValueError(f"MIL_MIP_PRECISION must be 'high' or 'highest', not {prec!r}")
        params["prec"] = prec
    elif impl == "matmul" and passthrough:
        params["impl"] = "matmul"
    else:
        params["impl"] = "gather"
    return params


def mip3d_frames(img, r_axis, project_num=36, impl=None):
    """The (project_num, H, W) frame stack of :func:`mip3d` as a tensor on
    the volume's device, with no host copy, on the route
    :func:`mip3d_params` picks for that device (``impl`` overrides
    ``MIL_MIP_IMPL``)."""
    p = mip3d_params(tuple(img.shape), r_axis, project_num, impl, device=img.device)
    mats, out_shape = p["mats"], p["out_shape"]
    if p["impl"] == "factored":
        return _rotate_and_mip_all_factored(img, mats, out_shape, r_axis, p["chunk"],
                                            p["fgroup"])
    if p["impl"] == "matmul":
        return _rotate_and_mip_all_matmul(img, mats, out_shape, r_axis)
    return _rotate_and_mip_all(img, mats, out_shape)


def mip3d(img, r_axis, project_num=36, *, device=None):
    """Rotating 3D MIP movie about the X (r_axis=1) or Y (r_axis=2) axis
    (``mip3dgpu``, reference:src/apifunc.cpp:576-644). img: (z, y, x).
    Returns a (project_num, H, W) numpy stack: r_axis=1 -> (round(hypot(sy,
    sz)), sx); r_axis=2 -> (sy, round(hypot(sx, sz)))."""
    return mip3d_frames(_volume(img, device), r_axis, project_num).cpu().numpy()


def mp3d(img, x_axis=True, y_axis=True, project_num=36, *, device=None):
    """Both-axis rotating MIPs (``mp3dgpu``,
    reference:src/apifunc.cpp:507-574). Returns a dict with 'x' and/or 'y'."""
    img = _volume(img, device)
    out = {}
    if x_axis:
        out["x"] = mip3d(img, 1, project_num)
    if y_axis:
        out["y"] = mip3d(img, 2, project_num)
    return out


def mp2d_packed(img, z_proj=True, x_proj=True, y_proj=True, *, device=None):
    """Packed single-buffer variant of the reference API: one flat array of
    [XY panel | YZ panel | ZX panel] plus the 6-element size vector
    (sx, sy, sy, sz, sz, sx) (``mp2dgpu``, reference:src/apifunc.cpp:
    485-505). Panels not requested stay zero, as the reference leaves them
    in its zeroed buffer."""
    img = _volume(img, device)
    sz, sy, sx = img.shape
    buf = np.zeros(sx * sy + sy * sz + sz * sx, dtype=np.float32)
    mps = mp2d(img, z_proj, x_proj, y_proj)
    if z_proj:
        buf[: sx * sy] = mps["xy"].ravel()
    if x_proj:
        buf[sx * sy: sx * sy + sy * sz] = mps["yz"].ravel()
    if y_proj:
        buf[sx * sy + sy * sz:] = mps["zx"].ravel()
    size_mp = np.array([sx, sy, sy, sz, sz, sx], dtype=np.uint32)
    return buf, size_mp
