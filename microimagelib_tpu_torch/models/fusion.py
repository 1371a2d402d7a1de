"""diSPIM dual-view fusion of one timepoint: isotropic resampling, view-B
rotation, registration, joint RL deconvolution (the JAX package's
``models/fusion.py``; reference:src/spim_fusion.cpp:84-688 and
``fusion_dualview``, reference:src/api_decon.cpp:988-1266).

Pipeline (sizes follow the reference's math,
reference:src/spim_fusion.cpp:336-363):
  1. target grid = view A resampled to isotropic pixelSizex1 voxels:
     (x, y, z) -> (x, round(y*py1/px1), round(z*pz1/px1))
  2. view B: scale each axis by its pixel ratio, optionally rotate +-90
     about Y (swapping x/z extents), resample to the isotropic grid
  3. register B onto A (regChoice / affMethod as reg3d; its ladders in K9
     over K4/K5's bodies, the Powell finisher's line searches over K6's
     under ``MIL_REG_BATCH_LS=1``)
  4. joint RL deconvolution of A and registered B (K1 pairs, or K2 under
     ``MIL_CONV_SEP_FUSED=1``)

Devices: ``mem_mode`` 0 runs on the CPU (the kernels' plain versions);
1, 2 and -1 on ``device`` (default cuda:0). ``mem_mode`` passes through
to the registration and the decon: 2 (or -1 beyond the memory budget)
takes their memory-saving tiers (the streamed final transform, the
low-memory registration, the streamed RL), whose volumes live in host
memory. Otherwise the views stay on the device from the resample to the
decon.
"""

from __future__ import annotations

import time

import numpy as np

from microimagelib_tpu_torch.models.deconvolution import (
    _as_tensor,
    _host_np,
    decon_dualview,
)
from microimagelib_tpu_torch.models.registration import _reg_device, checkmatrix, reg3d
from microimagelib_tpu_torch.ops.basics import rot_by_y_axis
from microimagelib_tpu_torch.ops.resample import resize3d_separable
from microimagelib_tpu_torch.utils.device import resolve_device
from microimagelib_tpu_torch.utils.trace import span, spanned, to_host

__all__ = ["imresize3d", "imoperation3d", "fusion_sizes", "preprocess_views",
           "fusion_dualview"]


def imresize3d(img, out_shape_zyx, device=None):
    """Resample via a pure-scaling affine matrix (``imresize3d``,
    reference:src/apifunc.cpp:429-446). The transform is diagonal, so the
    trilinear resample factorizes into three products
    (``ops/resample.py``). numpy in/out; runs on ``device`` (default
    cuda:0; ``device="cpu"`` for the CPU)."""
    src = _as_tensor(img, resolve_device(img, device))
    return resize3d_separable(src, out_shape_zyx).cpu().numpy()


def imoperation3d(img, op_choice, device=None):
    """+-90-degree Y rotation (``imoperation3D``,
    reference:src/apifunc.cpp:448-483). op_choice 1: +90, 2: -90, 0: none.
    Output x/z extents swap. numpy in/out; runs on ``device`` (default
    cuda:0; ``device="cpu"`` for the CPU)."""
    dev = resolve_device(img, device)
    if op_choice == 0:
        return np.asarray(img, np.float32)
    if op_choice in (1, 2):
        src = _as_tensor(img, dev)
        return rot_by_y_axis(src, 1 if op_choice == 1 else -1).cpu().numpy()
    raise ValueError("Wrong operation choice")


def fusion_sizes(size_a_xyz, size_b_xyz, pixel_a, pixel_b, im_rotation):
    """Compute the isotropic grid sizes (reference:src/spim_fusion.cpp:
    336-363). Returns (target_xyz, viewb_xyz, op_choice)."""
    ax, ay, az = size_a_xyz
    bx, by, bz = size_b_xyz
    pax, pay, paz = pixel_a
    pbx, pby, pbz = pixel_b
    tgt = (ax,
           int(round(ay * pay / pax)),
           int(round(az * paz / pax)))
    tmp = (int(round(bx * pbx / pax)),
           int(round(by * pby / pax)),
           int(round(bz * pbz / pax)))
    if im_rotation == 1:
        return tgt, (tmp[2], tmp[1], tmp[0]), 1
    if im_rotation == -1:
        return tgt, (tmp[2], tmp[1], tmp[0]), 2
    return tgt, tmp, 0


def preprocess_views(img_a, img_b, pixel_a, pixel_b, im_rotation, device=None,
                     verbose=False, as_device=False):
    """Steps 1-2: isotropize A; rotate+isotropize B on ``device`` (default:
    view A's device when it is a tensor, else cuda:0; ``device="cpu"`` for
    the CPU). Returns (a_iso, b_iso) as (z, y, x) float32 arrays on the
    isotropic grid: numpy by default, tensors on the device with
    ``as_device=True`` (no host round trip between the steps)."""
    dev = resolve_device(img_a, device)
    a = _as_tensor(img_a, dev)
    b = _as_tensor(img_b, dev)
    size_a = (a.shape[2], a.shape[1], a.shape[0])
    size_b = (b.shape[2], b.shape[1], b.shape[0])
    tgt_xyz, b_xyz, op_choice = fusion_sizes(size_a, size_b, pixel_a, pixel_b,
                                             im_rotation)
    tgt_zyx = (tgt_xyz[2], tgt_xyz[1], tgt_xyz[0])
    b_zyx = (b_xyz[2], b_xyz[1], b_xyz[0])
    if tuple(a.shape) != tgt_zyx:
        if verbose:
            print("\tImage 1 interpolation ...")
        a = resize3d_separable(a, tgt_zyx)
    if op_choice != 0:
        if verbose:
            print("\tImage 2 rotation ...")
        b = rot_by_y_axis(b, 1 if op_choice == 1 else -1)
    if tuple(b.shape) != b_zyx:
        if verbose:
            print("\tImage 2 interpolation ...")
        b = resize3d_separable(b, b_zyx)
    a, b = a.contiguous(), b.contiguous()
    if as_device:
        return a, b
    return a.cpu().numpy(), b.cpu().numpy()


@spanned("mil.fusion")
def fusion_dualview(img_a, img_b, psf_a, psf_b,
                    pixel_a=(0.1625, 0.1625, 1.0), pixel_b=(0.1625, 0.1625, 1.0),
                    im_rotation=-1, reg_choice=2, aff_method=7, flag_tmx=False,
                    tmx=None, ftol=1e-4, it_limit=3000, n_iters=10,
                    const_initial=False, psf_bp_a=None, psf_bp_b=None,
                    device=None, mem_mode=-1, verbose=False, records=None,
                    save_reg_callback=None):
    """Full fusion of one timepoint. Returns (decon, tmx, reg_b, a_iso).

    ``reg_b`` stays on the device (a tensor, like reg3d's
    ``as_device=True``): it feeds the decon without a host round trip; in
    memory mode 2 it is host numpy, from the streamed transform.
    ``a_iso`` and ``decon`` are numpy; on CUDA (memory mode 1) each lies
    in a block of pinned host memory from torch's caching host allocator
    (:func:`~microimagelib_tpu_torch.utils.trace.to_host`), the caller's
    own until dropped, when the block goes back to the allocator for the
    next timepoint. A live timepoint holds each array's size rounded up
    to a power of two: two 256 MiB blocks for (320, 512, 320) float32.

    The registration fallback of the reference: if ``checkmatrix``
    rejects the result of choice 2, 3 or 4, the registration is repeated
    with plain affine choice 2 (reference:src/api_decon.cpp:1243-1248).

    save_reg_callback(a_iso, reg_b) receives both registered views as
    numpy arrays.

    ``records`` follows the reference's 22-slot fusionRecords contract
    (reference:src/api_decon.cpp:1015-1016, :1233-1264): [0:11] the full
    reg3d records, [11:21] the full decon records, [21] total fusion
    seconds."""
    t0 = time.time()
    if records is None:
        records = np.zeros(22, dtype=np.float64)
    # the views' device, as the registration resolves it
    _mode, dev = _reg_device(tuple(np.shape(img_a)), mem_mode, device)
    with span("mil.fusion.preprocess"):
        a_iso, b_iso = preprocess_views(img_a, img_b, pixel_a, pixel_b,
                                        im_rotation, dev, verbose, as_device=True)

    with span("mil.fusion.reg"):
        reg_b, out_tmx, reg_records = reg3d(
            a_iso, b_iso, reg_choice, aff_method, flag_tmx, tmx,
            ftol, it_limit, device=dev, mem_mode=mem_mode, verbose=verbose,
            as_device=True)
        sz, sy, sx = a_iso.shape
        if reg_choice in (2, 3, 4) and not checkmatrix(out_tmx, sx, sy, sz):
            if verbose:
                print("\t... registration result rejected by checkmatrix, retrying plain affine")
            reg_b, out_tmx, reg_records = reg3d(
                a_iso, b_iso, 2, aff_method, flag_tmx, tmx,
                ftol, it_limit, device=dev, mem_mode=mem_mode, verbose=verbose,
                as_device=True)
    records[0:11] = np.asarray(reg_records[:11], dtype=np.float64)
    del b_iso

    if save_reg_callback is not None:
        save_reg_callback(_host_np(a_iso), _host_np(reg_b))

    decon_records = np.zeros(10, dtype=np.float64)
    with span("mil.fusion.decon"):
        decon = decon_dualview(
            a_iso, reg_b, psf_a, psf_b, n_iters=n_iters, const_initial=const_initial,
            psf_bp_a=psf_bp_a, psf_bp_b=psf_bp_b, device=dev, mem_mode=mem_mode,
            verbose=verbose, records=decon_records)
    records[11:21] = decon_records
    records[21] = time.time() - t0
    return decon, out_tmx, reg_b, to_host(a_iso)
