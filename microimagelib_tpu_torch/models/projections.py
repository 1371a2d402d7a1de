"""Maximum-intensity projection outputs: packed 2D MPs and rotating 3D MIP
movies (``mp2dgpu``/``mp3dgpu``/``mip3dgpu``,
reference:src/apifunc.cpp:485-644; the JAX package's
``models/projections.py``).

Each rotating-MIP frame is a rotate (``affine_transform_3d`` through the
``rot_to_matrix`` of its angle) followed by a z max clipped at 0, all on
the volume's device. The JAX package's one-hot matmul and factored routes
are forms for the TPU's matrix unit and are not ported: every route here
is the gather route."""

from __future__ import annotations

import math

import numpy as np
import torch

from microimagelib_tpu_torch.models.deconvolution import _as_tensor
from microimagelib_tpu_torch.ops.affine import affine_transform_3d
from microimagelib_tpu_torch.ops.basics import max_projection
from microimagelib_tpu_torch.ops.matrix import rot_to_matrix
from microimagelib_tpu_torch.utils.device import resolve_device

__all__ = ["mp2d", "mp2d_packed", "mip3d_params", "mip3d_frames", "mip3d", "mp3d"]


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


def mip3d_params(shape_zyx, r_axis, project_num=36, impl=None):
    """Route and parameters of the rotating MIP at a fixed volume shape: a
    dict with 'impl' (always 'gather'; ``impl`` is accepted for the JAX
    package's signature), 'mats' ((project_num, 12) numpy float32, the
    reference's angle step 3.14159*2/project_num) and 'out_shape' (the
    rotated grid, (z, y, x))."""
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
    return {"impl": "gather", "mats": mats, "out_shape": out_shape}


def mip3d_frames(img, r_axis, project_num=36, impl=None):
    """The (project_num, H, W) frame stack of :func:`mip3d` as a tensor on
    the volume's device, with no host copy: for each angle, the volume
    rotated onto the rotated grid and its z max, clipped at 0."""
    p = mip3d_params(tuple(img.shape), r_axis, project_num, impl)
    out_shape = p["out_shape"]
    frames = torch.empty((project_num, out_shape[1], out_shape[2]),
                         dtype=torch.float32, device=img.device)
    for i, m in enumerate(p["mats"]):
        rot = affine_transform_3d(img, m, out_shape)
        frames[i] = torch.clamp_min(rot.amax(dim=0), 0)
        del rot
    return frames


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
