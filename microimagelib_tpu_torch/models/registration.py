"""2-D/3-D intensity-based registration: phase correlation (phasor), the
exhaustive 2-D MIP shift search, and Powell- or L-BFGS-optimized affine
registration over normalized cross-correlation with the reference's
DOF-escalation ladder and retry semantics, a multi-resolution pyramid,
and the ``reg3d``/``reg2d`` dispatchers (the JAX package's
``models/registration.py``).

The cost of one 3-D evaluation is one fused resample + NCC call on the
card: K5 (sums) or K4 (sums and gradient), ``ops/corr.py``. The optimizers
run on the host in float32 with one device sync per evaluation; the
registration state lives in closures, so the library is re-entrant. The
phasor runs on ``torch.fft``; the 2-D costs and the box ZNCC of the
phasor's wraparound check are plain torch on the volumes' device.

Devices: ``mem_mode`` 0 runs on the CPU (the kernels' plain versions); 1
on ``device`` (default cuda:0); 2 the memory-saving tier on ``device``: a
pair that fits keeps the mode-1 search and streams the final transform
through host-staged z windows, a pair beyond the memory budget
(``models.deconvolution.hbm_budget_bytes``) runs
:func:`_reg3d_affine_lowmem` (a host-pooled coarse ladder on the card,
then a streamed full-resolution polish) and the host-staged phasor
:func:`reg3d_phasor_lowmem`; -1 mode 1 when the ladder's ~5-volume working
set fits the budget, else mode 2.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import time

import numpy as np
import torch

from microimagelib_tpu_torch.models.decon_streamed import (
    _chunk_counts,
    _Mover,
    _pass_rfft2,
    _spans,
    np_align_size_3d,
)
from microimagelib_tpu_torch.models.deconvolution import (
    _as_tensor,
    _host_np,
    hbm_budget_bytes,
)
from microimagelib_tpu_torch.models.registration_device import (
    cost_eval_reg_device,
    linmin_reg_device,
    reg_ladder_device,
)
from microimagelib_tpu_torch.models.registration_grad import reg_ladder_grad
from microimagelib_tpu_torch.ops.affine import (
    _host_tensor,
    affine_transform_2d,
    affine_transform_3d,
    affine_transform_3d_streamed,
    corr2d_partials,
    corr2d_partials_batch,
    corr3d_partials,
    corr3d_partials_streamed,
)
from microimagelib_tpu_torch.ops.basics import (
    align_size_3d,
    circshift,
    imshift,
    max3d_with_coords,
    max_projection,
)
from microimagelib_tpu_torch.ops.corr import corr3d_auto, resolve_ncc_impl
from microimagelib_tpu_torch.ops.lbfgs import lbfgs_env
from microimagelib_tpu_torch.ops.matrix import (
    compose_affine,
    dof_to_matrix,
    identity_tmx,
    matrix_to_params,
    params_to_matrix,
)
from microimagelib_tpu_torch.ops.powell import EvalCounter, powell
from microimagelib_tpu_torch.utils.device import (
    committed_platform,
    free_memory_mb,
    resolve_device,
)
from microimagelib_tpu_torch.utils.envflags import env_on
from microimagelib_tpu_torch.utils.trace import span, spanned, to_host

NDIM = 12      # the affine matrix's free parameters (reference ``NDIM``)


# --------------------------------------------------------------------------
# Plausibility gate
# --------------------------------------------------------------------------

def checkmatrix(m, sx, sy, sz):
    """Affine sanity gate: diagonal scales in [0.5, 1.4], their sum in
    [2, 4], translations below 0.8x the extent
    (reference:src/api_reg.cpp:247-262)."""
    m = np.asarray(m, dtype=np.float64).reshape(12)
    if not (0.5 <= m[0] <= 1.4 and 0.5 <= m[5] <= 1.4 and 0.5 <= m[10] <= 1.4):
        return False
    tr = m[0] + m[5] + m[10]
    if not (2.0 <= tr <= 4.0):
        return False
    if abs(m[3]) > 0.8 * sx or abs(m[7]) > 0.8 * sy or abs(m[11]) > 0.8 * sz:
        return False
    return True


# --------------------------------------------------------------------------
# Memory mode and device
# --------------------------------------------------------------------------

def _reg_mode1_fits(shape, device):
    """Whether the mode-1 ladder's working set (source + target + a few
    temporaries, ~5 volumes) fits 0.92 of the device memory budget
    (:func:`hbm_budget_bytes`; always for the CPU without
    ``MIL_HBM_BUDGET_MB``)."""
    budget = hbm_budget_bytes(device)
    if budget is None:
        return True
    return 5 * int(np.prod(shape)) * 4 <= budget * 0.92


def _reg_device(shape, mem_mode, device):
    """(mode, torch.device) for ``mem_mode`` (the reference's
    ``reg3d_affine2`` probe, reference:src/api_reg.cpp:330-372): 0 the
    CPU; 1 and 2 ``device`` (default cuda:0, ``device="cpu"`` the CPU);
    -1 mode 1 when the mode-1 working set fits the budget, else 2."""
    if mem_mode == 0:
        return 0, torch.device("cpu")
    if mem_mode not in (-1, 1, 2):
        raise ValueError(f"Invalid memory mode {mem_mode}")
    dev = resolve_device(None, device)
    if mem_mode == -1:
        return (1 if _reg_mode1_fits(shape, dev) else 2), dev
    return int(mem_mode), dev


def _beyond_budget(mode, shape, dev):
    """Mode 2 on a pair that does not fit the budget: the tier where the
    device never holds a whole volume."""
    return mode == 2 and not _reg_mode1_fits(shape, dev)


# --------------------------------------------------------------------------
# Standalone affine application (atrans3dgpu equivalents)
# --------------------------------------------------------------------------

def atrans3dgpu(img2, tmx, out_shape_zyx, device=None, mem_mode=-1):
    """Apply a 3x4 matrix to a volume, producing ``out_shape_zyx``
    (reference:src/api_reg.cpp:58-85). numpy in/out. mem_mode 0 runs on
    the CPU, 1 on ``device``; 2 (or -1 when source and output exceed the
    memory budget) streams the transform: the source stays in host memory
    and each output z block goes to the device with only the source rows
    it can sample (:func:`~microimagelib_tpu_torch.ops.affine.affine_transform_3d_streamed`,
    bit-equal to mode 1)."""
    img2 = np.asarray(img2, np.float32)
    dev = torch.device("cpu") if mem_mode == 0 else resolve_device(None, device)
    if mem_mode == -1:
        budget = hbm_budget_bytes(dev)
        need = 4 * (img2.size + int(np.prod(out_shape_zyx))) * 4
        mem_mode = 2 if budget is not None and need > budget * 0.92 else 1
    if mem_mode == 2:
        return affine_transform_3d_streamed(
            img2, np.asarray(tmx, np.float32), tuple(out_shape_zyx),
            budget_bytes=hbm_budget_bytes(dev), device=dev)
    out = affine_transform_3d(_as_tensor(img2, dev), tmx, tuple(out_shape_zyx))
    return out.cpu().numpy()


def atrans3dgpu_16bit(img2_u16, tmx, out_shape_zyx, device=None, mem_mode=-1):
    """16-bit path: interpolate in float, truncate back to uint16
    (reference:src/api_reg.cpp:87-113, with the sane semantics the JAX
    package defines: float trilinear, then integer truncation)."""
    out = atrans3dgpu(np.asarray(img2_u16, np.float32), tmx, out_shape_zyx,
                      device, mem_mode)
    return out.astype(np.uint16)


# --------------------------------------------------------------------------
# ZNCC (whole-volume)
# --------------------------------------------------------------------------

def zncc(a, b):
    """Zero-normalized cross correlation of two equal-shape volumes
    (``zncc1``, reference:src/api_subfunc.cu:2414-2441); -2.0 sentinel on
    zero energy. Tensors stay on their device; sums in float64."""
    a = _as_tensor(a)
    b = _as_tensor(b, a.device)
    am = a - a.mean()
    bm = b - b.mean()
    f64 = torch.float64
    st = float(torch.sum(am * bm, dtype=f64))
    tt = float(torch.sum(am * am, dtype=f64))
    ss = float(torch.sum(bm * bm, dtype=f64))
    denom = math.sqrt(tt * ss)
    if denom == 0:
        return -2.0
    return st / denom


# --------------------------------------------------------------------------
# Phase correlation (phasor) registration
# --------------------------------------------------------------------------

def _phasor_surface(img1, img2):
    """Normalized cross-power spectrum back in real space, on
    ``torch.fft`` over all axes of the 2-D or 3-D inputs."""
    dims = tuple(range(img1.ndim))
    prod = torch.conj(torch.fft.rfftn(img1, dim=dims)) * torch.fft.rfftn(img2, dim=dims)
    mag = prod.abs()
    norm = torch.where(mag != 0, prod / mag, torch.zeros((), dtype=prod.dtype,
                                                          device=prod.device))
    return torch.fft.irfftn(norm, s=tuple(img1.shape), dim=dims)


def _phasor_shift_nd(img1, img2):
    """Raw phasor peak -> integer shift per axis (x, y, z ordering for 3D;
    x, y for 2D). Mirrors circshift-by-half then argmax-minus-half
    (reference:src/api_subfunc.cu:2476-2492)."""
    surf = _phasor_surface(img1, img2)
    if surf.ndim == 2:
        sy, sx = surf.shape
        surf = circshift(surf[None], sx // 2, sy // 2, 0)
        _, (x, y, _z) = max3d_with_coords(surf)
        return [int(x) - sx // 2, int(y) - sy // 2]
    sz, sy, sx = surf.shape
    surf = circshift(surf, sx // 2, sy // 2, sz // 2)
    _, (x, y, z) = max3d_with_coords(surf)
    return [int(x) - sx // 2, int(y) - sy // 2, int(z) - sz // 2]


def _candidate_boxes(shifts, sizes):
    """Per-axis crop interpretations for the wraparound check: index 0
    keeps the found shift, 1 flips to the complementary one
    (reference:src/api_subfunc.cu:2496-2589). Returns (combs, offs, cs,
    valid) with one row per of the 2^nd combinations."""
    beta = 4
    nd = len(shifts)
    crop_sizes, offsets = [], []
    for i in range(nd):
        ab = abs(shifts[i])
        crop_sizes.append([sizes[i] - ab, ab])
        if shifts[i] > 0:
            offsets.append([0, sizes[i] - ab])
        else:
            offsets.append([ab, 0])
    combs, offs, cs, valid = [], [], [], []
    for comb in itertools.product(*([range(2)] * nd)):
        combs.append(comb)
        offs.append([offsets[i][comb[i]] for i in range(nd)])
        cs.append([crop_sizes[i][comb[i]] for i in range(nd)])
        valid.append(not any(crop_sizes[i][comb[i]] <= sizes[i] // beta
                             for i in range(nd)))
    return combs, offs, cs, valid


def _box_znccs(a, b, offs_xyz, cs_xyz, valid):
    """ZNCC of a and b over each box [off, off + cs) (x, y, z per row), by
    cropping; sums in float64. -3 for an invalid or empty box, -2 where a
    box has no variance. Both volumes are centered by their global means
    first, as the JAX package does (no change to any box's ZNCC)."""
    a = a - a.mean()
    b = b - b.mean()
    f64 = torch.float64
    out = []
    for off, cs, ok in zip(offs_xyz, cs_xyz, valid):
        box = tuple(slice(o, o + c) for o, c in zip(off[::-1], cs[::-1]))
        ab, bb = a[box], b[box]
        n = ab.numel()
        if not ok or n == 0:
            out.append(-3.0)
            continue
        sa, sb = float(ab.sum(dtype=f64)), float(bb.sum(dtype=f64))
        saa = float((ab * ab).sum(dtype=f64))
        sbb = float((bb * bb).sum(dtype=f64))
        sab = float((ab * bb).sum(dtype=f64))
        va = saa - sa * sa / n
        vb = sbb - sb * sb / n
        cov = sab - sa * sb / n
        denom = math.sqrt(max(va, 0.0) * max(vb, 0.0))
        out.append(cov / denom if denom > 0 else -2.0)
    return np.asarray(out)


def _disambiguate_shifts(img1, img2, shifts, dims_xyz):
    """Wraparound disambiguation: when any |shift| exceeds size/4, compare
    ZNCC over the up-to-8 (3D) / 4 (2D) crop interpretations and flip the
    winning axes to the complementary shift
    (reference:src/api_subfunc.cu:2496-2589)."""
    beta = 4
    nd = len(shifts)
    sizes = dims_xyz
    if not any(abs(shifts[i]) > sizes[i] // beta for i in range(nd)):
        return shifts
    a3 = img1 if nd == 3 else img1[None]
    b3 = img2 if nd == 3 else img2[None]
    sh3 = list(shifts) + [0] * (3 - nd)
    shifted = imshift(b3, -sh3[0], -sh3[1], -sh3[2])
    combs, offs, cs, valid = _candidate_boxes(shifts, sizes)
    if not any(valid):
        return shifts
    # (x, y, z) rows; in 2D the z box is the whole (unit) axis
    offs3 = [list(o) + [0] * (3 - nd) for o in offs]
    cs3 = [list(c) + [1] * (3 - nd) for c in cs]
    ccs = _box_znccs(a3, shifted, offs3, cs3, valid)
    best = combs[int(np.argmax(ccs))]
    out = list(shifts)
    for i in range(nd):
        if best[i] == 1:
            out[i] = shifts[i] - sizes[i] if shifts[i] > 0 else shifts[i] + sizes[i]
    return out


def reg3d_phasor(img1, img2, *, device=None):
    """3D phase correlation with 8-case wraparound disambiguation
    (``reg3d_phasor1``, reference:src/api_subfunc.cu:2465-2590). Inputs
    are (z, y, x) tensors (run on their device) or numpy arrays (run on
    ``device``, default cuda:0) of equal shape; returns (sx, sy, sz)
    integer shifts (x, y, z order)."""
    dev = resolve_device(img1, device)
    a = _as_tensor(img1, dev)
    b = _as_tensor(img2, dev)
    sz, sy, sx = a.shape
    shifts = _phasor_shift_nd(a, b)
    return _disambiguate_shifts(a, b, shifts, [sx, sy, sz])


def reg2d_phasor(img1, img2, *, device=None):
    """2D analog (``reg2d_phasor1``, reference:src/api_subfunc.cu:2127-2224)."""
    dev = resolve_device(img1, device)
    a = _as_tensor(img1, dev)
    b = _as_tensor(img2, dev)
    sy, sx = a.shape
    shifts = _phasor_shift_nd(a, b)
    return _disambiguate_shifts(a, b, shifts, [sx, sy])


# --------------------------------------------------------------------------
# Low-memory (host-staged) 3-D phasor: the reference's reg3d_phasor2
# --------------------------------------------------------------------------

def _crosspow_chunk(s1, s2):
    """The streamed middle pass of the phasor on a y chunk of both rFFT2
    spectra: FFT along z, normalized cross-power, inverse z FFT."""
    prod = torch.conj(torch.fft.fft(s1, dim=0)) * torch.fft.fft(s2, dim=0)
    mag = prod.abs()
    norm = torch.where(mag != 0, prod / mag,
                       torch.zeros((), dtype=prod.dtype, device=prod.device))
    return torch.fft.ifft(norm, dim=0)


def _irfft2_argmax_slab(spec_slab, x_out):
    """(peak value, flat index within the slab) of the slab's surface:
    irFFT2 over (y, x), then the first maximum in C order."""
    surf = torch.fft.irfft2(spec_slab, s=(spec_slab.shape[1], x_out))
    idx = torch.argmax(surf)
    return float(surf.reshape(-1)[idx]), int(idx)


def _box_stats_slab(a_slab, b_slab, z0, offs_xyz, cs_xyz):
    """Per-slab partial sums (n, sa, sb, saa, sbb, sab) in float64 of each
    candidate box (x, y, z offsets and sizes; the slab holds global z rows
    [z0, z0 + cz)), by cropping the box's rows that fall in the slab."""
    f64 = torch.float64
    cz = a_slab.shape[0]
    out = np.zeros((len(offs_xyz), 6), np.float64)
    for k, (off, cs) in enumerate(zip(offs_xyz, cs_xyz)):
        lo = max(off[2], z0) - z0
        hi = min(off[2] + cs[2], z0 + cz) - z0
        if hi <= lo:
            continue
        box = (slice(lo, hi), slice(off[1], off[1] + cs[1]),
               slice(off[0], off[0] + cs[0]))
        a, b = a_slab[box], b_slab[box]
        out[k] = [a.numel(), float(a.sum(dtype=f64)), float(b.sum(dtype=f64)),
                  float((a * a).sum(dtype=f64)), float((b * b).sum(dtype=f64)),
                  float((a * b).sum(dtype=f64))]
    return out


def reg3d_phasor_lowmem(img1, img2, budget_bytes=None, *, device=None):
    """3-D phase correlation with the device never holding a whole volume:
    the memory-saving ``reg3d_phasor2`` (reference:src/api_subfunc.cu:
    2591-2726). Both spectra, the cross-power surface and the wraparound
    check's box statistics stream through host buffers in z-slab / y-chunk
    passes on ``device`` (default cuda:0; ``device="cpu"`` for the CPU),
    in chunks sized by ``budget_bytes`` as the streamed RL sizes them.
    Returns the shifts of :func:`reg3d_phasor`."""
    mv = _Mover(resolve_device(None, device))
    a = mv.host_copy(_host_np(img1), torch.float32)
    b = mv.host_copy(_host_np(img2), torch.float32)
    sz, sy, sx = a.shape
    xh = sx // 2 + 1
    nz, ny = _chunk_counts((sz, sy, sx), budget_bytes)
    spec1 = mv.host((sz, sy, xh), torch.complex64)
    spec2 = mv.host((sz, sy, xh), torch.complex64)
    _pass_rfft2(mv, a, spec1, nz)
    _pass_rfft2(mv, b, spec2, nz)
    for sl in _spans(sy, ny):
        mv.down(spec1[:, sl], _crosspow_chunk(mv.up(spec1[:, sl]),
                                              mv.up(spec2[:, sl])))
    del spec2
    best_val, best_idx = -math.inf, 0
    for sl in _spans(sz, nz):
        v, idx = _irfft2_argmax_slab(mv.up(spec1[sl]), sx)
        if v > best_val:
            best_val, best_idx = v, idx + sl.start * sy * sx
    del spec1
    pz, rem = divmod(best_idx, sy * sx)
    py, px = divmod(rem, sx)

    def wrap(p, n):
        return ((p + n // 2) % n) - n // 2

    shifts = [wrap(px, sx), wrap(py, sy), wrap(pz, sz)]
    sizes = [sx, sy, sz]
    if not any(abs(shifts[i]) > sizes[i] // 4 for i in range(3)):
        return shifts
    combs, offs, cs, valid = _candidate_boxes(shifts, sizes)
    if not any(valid):
        return shifts
    # the zero-filling shift of the moving volume, on the host
    shifted = imshift(b, -shifts[0], -shifts[1], -shifts[2])
    acc = np.zeros((len(combs), 6), np.float64)
    for sl in _spans(sz, nz):
        acc += _box_stats_slab(mv.up(a[sl]), mv.up(shifted[sl]), sl.start,
                               offs, cs)
    ccs = np.full(len(combs), -3.0)
    for k in range(len(combs)):
        n, sa, sb, saa, sbb, sab = acc[k]
        if not valid[k] or n <= 0:
            continue
        va = saa - sa * sa / n
        vb = sbb - sb * sb / n
        cov = sab - sa * sb / n
        denom = math.sqrt(max(va, 0.0) * max(vb, 0.0))
        ccs[k] = cov / denom if denom > 0 else -2.0
    best = combs[int(np.argmax(ccs))]
    out = list(shifts)
    for i in range(3):
        if best[i] == 1:
            out[i] = (shifts[i] - sizes[i] if shifts[i] > 0
                      else shifts[i] + sizes[i])
    return out


# --------------------------------------------------------------------------
# 2D registration: shift-grid search and Powell affine
# --------------------------------------------------------------------------

def _host64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _prep_2d(img1, img2, device):
    """Mean-subtract both 2D images in float64 on the host; return them as
    float32 tensors on ``device`` with the target's SD."""
    t = _host64(img1)
    s = _host64(img2)
    t_ms = t - t.mean()
    sd_t = math.sqrt(float((t_ms * t_ms).sum()))
    if sd_t == 0:
        raise ValueError("SD of image 1 is zero, empty image input")
    s_ms = s - s.mean()
    return (torch.as_tensor(t_ms.astype(np.float32), device=device),
            torch.as_tensor(s_ms.astype(np.float32), device=device), sd_t)


def _cost2d(src, tgt, sd_t):
    def cost(p6):
        ss, st = corr2d_partials(src, tgt, np.asarray(p6, np.float32))
        ssf = math.sqrt(float(ss))
        if ssf == 0:
            return 2.0
        return -(float(st) / ssf) / sd_t
    return cost


def reg2d_shiftalign(img1, img2, tmx_init=None, shift_region=0.4, total_step=40,
                     x_only=False, records=None, *, device=None):
    """Exhaustive 2D translation grid search over +-shift_region*size in
    2*total_step steps per axis (``reg2d_shiftalign1``/``X1``,
    reference:src/api_subfunc.cu:1859-2120). The candidates go to the
    device in chunks of 256; the best is the first strictly above a best
    value that starts at 0, so an all-negative grid keeps the shift at
    (0, 0) as in the reference. Returns (reg_ms, tmx6): the transformed
    mean-subtracted source (numpy) and the found 6-parameter matrix."""
    t0 = time.time()
    dev = resolve_device(img2, device)
    sy1, sx1 = np.shape(img1)
    sy2, sx2 = np.shape(img2)
    tgt, src, sd_t = _prep_2d(img1, img2, dev)
    if tmx_init is not None:
        aff = np.asarray(tmx_init, np.float64).copy()
    else:
        aff = np.array([1, 0, (sx2 - sx1) // 2, 0, 1, (sy2 - sy1) // 2], np.float64)
    cost = _cost2d(src, tgt, sd_t)
    initial_cost = -cost(aff.astype(np.float32))
    if records is not None:
        records[4] = initial_cost

    off_x, off_y = aff[2], aff[5]
    step_x = sx2 * shift_region / total_step
    steps = np.arange(-int(total_step), int(total_step))
    cand_x = off_x + step_x * steps
    if x_only:
        n = cand_x.size
        cands = np.stack([
            np.broadcast_to(aff[0], (n,)), np.broadcast_to(aff[1], (n,)), cand_x,
            np.broadcast_to(aff[3], (n,)), np.broadcast_to(aff[4], (n,)),
            np.broadcast_to(aff[5], (n,)),
        ], axis=1).astype(np.float32)
    else:
        step_y = sy2 * shift_region / total_step
        cand_y = off_y + step_y * steps
        gx, gy = np.meshgrid(cand_x, cand_y, indexing="ij")
        flat_x, flat_y = gx.ravel(), gy.ravel()
        n = flat_x.size
        cands = np.stack([
            np.broadcast_to(aff[0], (n,)), np.broadcast_to(aff[1], (n,)), flat_x,
            np.broadcast_to(aff[3], (n,)), np.broadcast_to(aff[4], (n,)), flat_y,
        ], axis=1).astype(np.float32)
    best_cost = 0.0
    best_x, best_y = 0.0, 0.0
    chunk = 256
    for i in range(0, len(cands), chunk):
        ss_b, st_b = corr2d_partials_batch(src, tgt, cands[i:i + chunk])
        ss_b = ss_b.cpu().numpy()
        st_b = st_b.cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            ncc = np.where(np.sqrt(ss_b) == 0, -2.0, st_b / np.sqrt(ss_b) / sd_t)
        j = int(np.argmax(ncc))
        if ncc[j] > best_cost:
            best_cost = float(ncc[j])
            best_x = float(cands[i + j, 2])
            best_y = float(cands[i + j, 5])
    aff_out = aff.copy()
    aff_out[2] = best_x
    if not x_only:
        aff_out[5] = best_y
    fret = -cost(aff_out.astype(np.float32))
    reg = affine_transform_2d(src, aff_out.astype(np.float32), (sy1, sx1))
    if records is not None:
        records[5] = fret
        records[7] = time.time() - t0
        records[8] = (2 * int(total_step)) ** 2 if not x_only else 2 * int(total_step)
    return reg.cpu().numpy(), aff_out.astype(np.float32)


def reg2d_affine(img1, img2, tmx_init=None, aff_method=1, ftol=1e-4, it_limit=3000,
                 records=None, *, device=None):
    """2D Powell affine registration, 6 parameters, mean-subtracted NCC
    (``reg2d_affine1``, reference:src/api_subfunc.cu:2232-2336), on the NR
    Powell of ``ops/powell.py``. Returns (registered original source
    (numpy), tmx6)."""
    t0 = time.time()
    dev = resolve_device(img2, device)
    sy1, sx1 = np.shape(img1)
    sy2, sx2 = np.shape(img2)
    tgt, src, sd_t = _prep_2d(img1, img2, dev)
    if tmx_init is not None:
        aff = np.asarray(tmx_init, np.float64).copy()
    else:
        aff = np.array([1, 0, (sx2 - sx1) // 2, 0, 1, (sy2 - sy1) // 2], np.float64)
    cost = _cost2d(src, tgt, sd_t)
    counter = EvalCounter(cost)
    if records is not None:
        records[1] = -counter(aff)
    fret = None
    if aff_method > 0:
        aff, fret, _, counter = powell(aff, cost, ftol, it_limit, counter=counter)
    # final resample of the ORIGINAL (non-mean-subtracted) source
    reg = affine_transform_2d(_as_tensor(img2, dev), aff.astype(np.float32),
                              (sy1, sx1))
    if records is not None:
        records[3] = -fret if fret is not None else records[1]
        records[5] = counter.count
        records[7] = time.time() - t0
    return reg.cpu().numpy(), aff.astype(np.float32)


def reg2d(img1, img2, reg_choice=2, flag_tmx=False, tmx=None, ftol=1e-4,
          it_limit=3000, records=None, *, device=None):
    """2D registration dispatcher (``reg2d``,
    reference:src/api_reg.cpp:115-244). reg_choice: 0 apply matrix,
    1 shift grid, 2 affine, 3 phasor. Returns (registered, tmx6, records)
    with the registered image as numpy; runs on ``device`` (default: the
    tensor's device, else cuda:0; ``device="cpu"`` for the CPU)."""
    if records is None:
        records = np.zeros(11, dtype=np.float64)
    dev = resolve_device(img1, device)
    sy1, sx1 = np.shape(img1)
    if reg_choice == 0:
        if flag_tmx and tmx is not None:
            reg = affine_transform_2d(_as_tensor(img2, dev),
                                      np.asarray(tmx, np.float32), (sy1, sx1))
            return reg.cpu().numpy(), np.asarray(tmx, np.float32), records
        return (_host64(img2).astype(np.float32),
                np.array([1, 0, 0, 0, 1, 0], np.float32), records)
    if reg_choice == 1:
        reg, out = reg2d_shiftalign(img1, img2, tmx if flag_tmx else None, 0.4, 40,
                                    records=records, device=dev)
        return reg, out, records
    if reg_choice == 2:
        reg, out = reg2d_affine(img1, img2, tmx if flag_tmx else None, 1, ftol,
                                it_limit, records, device=dev)
        return reg, out, records
    if reg_choice == 3:
        if np.shape(img1) != np.shape(img2):
            raise ValueError("Image size of the 2D images is not matched")
        shifts = reg2d_phasor(img1, img2, device=dev)
        src = _as_tensor(img2, dev)
        reg = imshift(src[None], -shifts[0], -shifts[1], 0)[0]
        out = np.array([1, 0, shifts[0], 0, 1, shifts[1]], np.float32)
        return reg.cpu().numpy(), out, records
    raise ValueError("Wrong registration choice")


# --------------------------------------------------------------------------
# 3D affine registration core
# --------------------------------------------------------------------------

@spanned("mil.reg.final_transform")
def _final_transform(img2, aff_coef, out_shape, mem_mode, device=None):
    """Final re-sample of the ORIGINAL source: a tensor on its device, or
    for mode 2 host numpy, streamed through ``device`` in z blocks from a
    host copy of the source (bit-equal to the resident transform)."""
    if mem_mode == 2:
        return affine_transform_3d_streamed(
            _host_np(img2), np.asarray(aff_coef, np.float32), tuple(out_shape),
            budget_bytes=hbm_budget_bytes(device), device=device)
    return affine_transform_3d(img2, aff_coef, tuple(out_shape))


def _host_ms(vol, mv):
    """``vol`` minus its float64 mean, rounded to float32, in a host buffer
    of ``mv`` (pinned for a CUDA device), with the float64 energy: the
    streamed cost's preprocessed volume."""
    vol = torch.as_tensor(vol)
    mean = float(vol.sum(dtype=torch.float64)) / vol.numel()
    out = mv.host(tuple(vol.shape), torch.float32)
    energy = 0.0
    for sl in _spans(vol.shape[0], max(1, vol.shape[0] // 8)):
        d = vol[sl].double() - mean
        out[sl] = d
        energy += float((out[sl].double() ** 2).sum())
    return out, energy


def _reg3d_affine_lowmem(img1, img2, aff_method, flag_tmx, tmx, ftol,
                         it_limit, verbose, records, device, engine,
                         want_reg=True):
    """Affine registration of a pair beyond the device memory budget: the
    device never holds a whole volume (the memory-saving ``reg3d_affine2``,
    reference:src/api_subfunc.cu:2995-3266, still held one volume and a
    texture on the GPU):

      1. both volumes are mean-pooled on the host until ~5 volumes of the
         pooled pair fit half the budget, and the mode-1 ladder runs
         there on ``device`` (K4/K5);
      2. the scaled-up matrix is polished at full resolution with the
         streamed NCC cost (``corr3d_partials_streamed``: one source
         window and one target block on the device at a time), at most
         MIL_REG_STREAM_BUDGET evaluations (default 100);
         MIL_REG_STREAM_POLISH=1 lifts the cap to ``it_limit``, =0 skips
         the polish;
      3. the final transform of the source streams through z windows.

    Returns (registered, tmx12, records) like :func:`reg3d_affine`; the
    registered volume is host numpy (None for ``want_reg=False``)."""
    t_start = time.time()
    if records is None:
        records = np.zeros(11, dtype=np.float64)
    img1, img2 = _host_tensor(img1), _host_tensor(img2)
    budget = hbm_budget_bytes(device)
    # coarse level: pool until ~5 volumes fit in half the budget
    vox_budget = (budget * 0.5 / 20.0) if budget else 96 ** 3
    factor = _auto_pool_factors(tuple(img1.shape), budget=vox_budget)
    if verbose:
        print(f"\t... beyond-HBM registration: coarse ladder at "
              f"1/{factor} resolution, streamed full-resolution cost")
    tmx_c = (_tmx_full_to_coarse(tmx, factor)
             if (flag_tmx and tmx is not None) else None)
    _, m_coarse, rec_c = reg3d_affine(
        _mean_pool(img1, factor), _mean_pool(img2, factor), aff_method,
        tmx_c is not None, tmx_c, ftol, it_limit, verbose, None, device,
        engine, mem_mode=1, want_reg=False)
    m_full = _tmx_coarse_to_full(m_coarse, factor)
    records[2] = rec_c[3]

    mv = _Mover(device)
    tgt_ms, st2 = _host_ms(img1, mv)
    src_ms, _ = _host_ms(img2, mv)
    sd_t = math.sqrt(st2)
    if sd_t == 0:
        raise ValueError("SD of image 1 is zero, empty image input")
    n_evals = 0

    def cost_streamed(src, m12):
        nonlocal n_evals
        n_evals += 1
        ss, st = corr3d_partials_streamed(src, tgt_ms,
                                          np.asarray(m12, np.float32),
                                          budget_bytes=budget, device=device)
        ssf = math.sqrt(ss)
        if ssf == 0:
            return 2.0
        return -(st / ssf) / sd_t

    t_e = time.time()
    fret = cost_streamed(src_ms, m_full)
    records[1] = rec_c[1]
    records[4] = (time.time() - t_e) * 1000.0

    t_iter0 = time.time()
    polish_env = os.environ.get("MIL_REG_STREAM_POLISH", "budget")
    if polish_env == "0":
        polish_cap = 0
    elif polish_env == "1":
        polish_cap = int(it_limit)
    else:
        polish_cap = min(int(it_limit),
                         int(os.environ.get("MIL_REG_STREAM_BUDGET", "100")))
    if polish_cap > 0:
        # polish the REQUESTED model (dofNum semantics, reference:src/
        # api_subfunc.cu:2893-2916): methods >= 5 search the 12 matrix
        # parameters from the coarse result; methods 1-4 pre-transform the
        # source by the coarse matrix (streamed) and search the residual
        # DOF model from identity
        if aff_method >= 5:
            def cost12(p):
                return cost_streamed(src_ms, params_to_matrix(p))

            p0 = matrix_to_params(np.asarray(m_full, np.float64))
            p_min, fret, _, _ = powell(p0, cost12, ftol, polish_cap,
                                       counter=EvalCounter(cost12))
            m_full = params_to_matrix(p_min).astype(np.float32)
        else:
            pre = _final_transform(img2, m_full, tuple(img1.shape), 2, device)
            pre_ms, _ = _host_ms(pre, mv)
            del pre
            dof_num = {1: 3, 2: 6, 3: 7, 4: 9}[aff_method]

            def full_dof(sub):
                full = np.zeros(9, np.float64)
                full[6:9] = 1.0
                full[:dof_num] = sub
                return full

            def cost_dof_stream(sub):
                return cost_streamed(pre_ms, dof_to_matrix(full_dof(sub), dof_num))

            sub0 = np.zeros(dof_num, np.float64)
            if dof_num >= 7:
                sub0[6:dof_num] = 1.0
            p_min, fret, _, _ = powell(sub0, cost_dof_stream, ftol, polish_cap,
                                       counter=EvalCounter(cost_dof_stream))
            m_full = compose_affine(np.asarray(m_full, np.float32),
                                    dof_to_matrix(full_dof(p_min), dof_num))

    records[3] = -fret
    records[5] = n_evals
    records[6] = time.time() - t_iter0
    reg = (_final_transform(img2, m_full, tuple(img1.shape), 2, device)
           if want_reg else None)
    records[7] = time.time() - t_start
    if verbose:
        print(f"\t... optimized cross correlation value: {-fret:f};")
        print(f"\t... time cost for registration: {records[7]:f} s;")
    return reg, np.asarray(m_full, np.float32), records


def _reg_stats(src_base, tgt):
    """Mean-subtracted volumes and their energies (sums in float64), the
    reference's separate reduction launches
    (reference:src/api_subfunc.cu:2802-2824)."""
    f64 = torch.float64
    n = src_base.numel()
    src_ms = src_base - float(torch.sum(src_base, dtype=f64)) / n
    tgt_ms = tgt - float(torch.sum(tgt, dtype=f64)) / n
    return (src_ms, tgt_ms, float(torch.sum(src_ms * src_ms, dtype=f64)),
            float(torch.sum(tgt_ms * tgt_ms, dtype=f64)))


def _report_ladder(aff_method, stage, records, verbose):
    if aff_method in (6, 7) and np.isfinite(stage[-2 if aff_method == 7 else 0]):
        records[2] = -float(stage[2] if aff_method == 7 else stage[0])
    if verbose and aff_method == 7:
        for lbl, c in zip(("3 DOF", "6 DOF", "9 DOF"), stage[:3]):
            if np.isfinite(c):
                print(f"\t... cross correlation value after {lbl}: {-float(c):f};")


def reg3d_affine(img1, img2, aff_method=7, flag_tmx=False, tmx=None, ftol=1e-4,
                 it_limit=3000, verbose=False, records=None, device=None,
                 engine="auto", mem_mode=-1, *, want_reg=True,
                 finish_sweeps=None, grad_finish=None):
    """Core 3D affine registration (``reg3d_affine1``,
    reference:src/api_subfunc.cu:2732-2994).

    img1: target (fixed), img2: source (moving), equal (z, y, x) shapes,
    numpy arrays or tensors. aff_method 0-7 as the reference ladder;
    flag_tmx/tmx is the input matrix. Returns (registered source, tmx12,
    records); the registered source is numpy, a tensor on the device for
    ``want_reg='device'``, or None for ``want_reg=False``.

    engine: 'grad' (L-BFGS over K4's gradient, then a Powell finisher over
    K5), 'device' (the Powell ladder over K5), 'host' (the NR Powell of
    ``ops/powell.py``, float64, one K5 call per evaluation), 'hybrid' (that
    Powell with each line minimization the float32 mnbrak + brent of
    ``ops/powell_device.py`` over K5); 'auto' takes MIL_REG_ENGINE when
    set, else 'grad' on a CUDA device while MIL_REG_GRAD is on (default)
    and 'device' otherwise.

    mem_mode (:func:`_reg_device`): 2 streams the final transform through
    host-staged z windows and, for a pair beyond the memory budget, runs
    :func:`_reg3d_affine_lowmem`.

    records layout (len 8+): [1] initial NCC, [2] intermediate NCC,
    [3] final NCC, [4] per-eval ms, [5] total evals, [6] iteration s,
    [7] total s (reference:src/api_reg.cpp:295-300).

    finish_sweeps: cap on the grad engine's Powell finisher sweeps (0 =
    run to ftol; None = MIL_REG_FINISH_SWEEPS, default 1). grad_finish:
    run the finisher at all (None = MIL_REG_GRAD_FINISH, default on)."""
    t_start = time.time()
    if records is None:
        records = np.zeros(11, dtype=np.float64)
    if tuple(np.shape(img1)) != tuple(np.shape(img2)):
        raise ValueError(
            f"reg3d_affine needs equal shapes, got {tuple(np.shape(img1))} vs "
            f"{tuple(np.shape(img2))}; use reg3d, which aligns the source first")
    mem_mode, dev = _reg_device(tuple(np.shape(img1)), mem_mode, device)
    if _beyond_budget(mem_mode, tuple(np.shape(img1)), dev):
        if aff_method != 0:
            return _reg3d_affine_lowmem(img1, img2, aff_method, flag_tmx, tmx,
                                        ftol, it_limit, verbose, records, dev,
                                        engine, want_reg=want_reg)
        # apply only: the streamed transform or the source itself, on the
        # host
        if flag_tmx and tmx is not None:
            out_tmx = np.asarray(tmx, np.float32).copy()
            reg = (_final_transform(img2, out_tmx, tuple(np.shape(img1)), 2, dev)
                   if want_reg else None)
        else:
            out_tmx = identity_tmx()
            reg = _host_np(img2) if want_reg else None
        records[7] = time.time() - t_start
        if verbose:
            print("\t... no registration performed!")
        return reg, out_tmx, records
    img1 = _as_tensor(img1, dev)
    img2 = _as_tensor(img2, dev)

    def _finish_reg(aff_coef):
        """The final full-volume transform of the source: None for
        ``want_reg=False`` (pyramid levels need only the matrix), left on
        the device for ``want_reg='device'``; host numpy in mode 2."""
        if not want_reg:
            return None
        reg = _final_transform(img2, aff_coef, img1.shape, mem_mode, dev)
        if isinstance(reg, np.ndarray) or want_reg == "device":
            return reg
        return to_host(reg)

    if aff_method == 0:
        if flag_tmx and tmx is not None:
            out_tmx = np.asarray(tmx, np.float32).copy()
            reg = _finish_reg(out_tmx)
        else:
            out_tmx = identity_tmx()
            reg = (None if not want_reg else
                   img2 if want_reg == "device" else img2.cpu().numpy())
        records[7] = time.time() - t_start
        if verbose:
            print("\t... no registration performed!")
        return reg, out_tmx, records

    aff_initial = identity_tmx().astype(np.float64)
    src_base = img2
    if flag_tmx and tmx is not None:
        if aff_method == 5:
            aff_initial = np.asarray(tmx, np.float64).copy()
        else:
            src_base = affine_transform_3d(img2, np.asarray(tmx, np.float32),
                                           img1.shape)

    src_ms, tgt_ms, se2, st2 = _reg_stats(src_base, img1)
    del src_base
    if math.sqrt(se2) == 0:
        raise ValueError("SD of image 2 is zero, empty image input or empty "
                         "image after initial transformation")
    sd_t = math.sqrt(st2)
    if sd_t == 0:
        raise ValueError("SD of image 1 is zero, empty image input")
    ncc_impl = resolve_ncc_impl(src_ms)

    def cost_from_matrix(m12):
        ss, st = corr3d_auto(src_ms, tgt_ms, np.asarray(m12, np.float32),
                             impl=ncc_impl)
        ssf = math.sqrt(float(ss))
        if ssf == 0:
            return 2.0
        return -(float(st) / ssf) / sd_t

    def cost12(p):
        return cost_from_matrix(params_to_matrix(p))

    def cost_dof(dof_vec, dof_num):
        return cost_from_matrix(dof_to_matrix(dof_vec, dof_num))

    # one counter shared across ladder stages so it_limit caps the total,
    # as the reference's itNumStatic does
    counter = EvalCounter(None)

    t1 = time.time()
    p_init = matrix_to_params(aff_initial)
    initial_cost = cost12(p_init)
    records[1] = -initial_cost
    records[4] = (time.time() - t1) * 1000.0
    if verbose:
        print(f"\t... initial cross correlation value: {-initial_cost:f};")
        print(f"\t... time cost for single sub iteration: {records[4]:f} ms;")

    t_iter0 = time.time()
    if engine == "auto" and os.environ.get("MIL_REG_ENGINE"):
        engine = os.environ.get("MIL_REG_ENGINE")
    if engine == "auto":
        on_card = committed_platform(src_ms) == "cuda"
        engine = "grad" if on_card and env_on("MIL_REG_GRAD", True) else "device"
    ladder = None
    if engine in ("grad", "device") and aff_method in (1, 2, 3, 4, 5, 6, 7):
        if engine == "grad":
            sweeps = (int(os.environ.get("MIL_REG_FINISH_SWEEPS", "1"))
                      if finish_sweeps is None else int(finish_sweeps))
            ls_mi, ls_pa = lbfgs_env()
            ladder = reg_ladder_grad(
                src_ms, tgt_ms, sd_t, p_init, aff_method, ftol, it_limit,
                ncc_impl=ncc_impl,
                finish=(env_on("MIL_REG_GRAD_FINISH", True)
                        if grad_finish is None else bool(grad_finish)),
                batch_ls=env_on("MIL_REG_BATCH_LS"),
                finish_sweeps=(None if sweeps <= 0 else sweeps),
                ls_max_iters=ls_mi, ls_patience=ls_pa)
        else:
            ladder = reg_ladder_device(src_ms, tgt_ms, sd_t, p_init, aff_method,
                                       ftol, it_limit, ncc_impl=ncc_impl,
                                       batch_ls=env_on("MIL_REG_BATCH_LS"))
    if ladder is not None:
        aff_dev, fret_dev, stage, nev = ladder
        aff_coef = np.asarray(aff_dev, np.float32)
        fret = float(fret_dev)
        _report_ladder(aff_method, np.asarray(stage), records, verbose)
        counter.count = int(nev)
    else:
        if engine == "hybrid":
            def stage(p0, mode, this_ftol):
                def func(p):
                    return float(cost_eval_reg_device(src_ms, tgt_ms, sd_t, p,
                                                      mode, ncc_impl=ncc_impl))

                def linmin_fn(p, xi):
                    return linmin_reg_device(src_ms, tgt_ms, sd_t, p, xi, mode,
                                             ncc_impl=ncc_impl)

                counter.func = func
                p_min, f_min, _, _ = powell(p0, func, this_ftol, it_limit,
                                            counter=counter, linmin_fn=linmin_fn)
                return p_min, f_min
        else:
            def stage(p0, mode, this_ftol):
                if mode == "p12":
                    fn = cost12
                else:
                    dof_num = int(mode[3:])

                    def fn(sub):
                        full = np.zeros(9, np.float64)
                        full[6:9] = 1.0
                        full[:dof_num] = sub
                        return cost_dof(full, dof_num)
                counter.func = fn
                p_min, f_min, _, _ = powell(p0, fn, this_ftol, it_limit,
                                            counter=counter)
                return p_min, f_min
        aff_coef, fret = _powell_ladder(aff_method, ftol, p_init, records,
                                        verbose, stage)

    if flag_tmx and tmx is not None and aff_method != 5:
        aff_coef = compose_affine(np.asarray(tmx, np.float32), aff_coef)
    records[3] = -fret
    records[5] = counter.count
    records[6] = time.time() - t_iter0
    if verbose:
        print(f"\t... optimized cross correlation value: {-fret:f};")
        print(f"\t... total sub iteration number: {counter.count};")
        print(f"\t... time cost for all iterations: {records[6]:f} s;")
    reg = _finish_reg(aff_coef)
    records[7] = time.time() - t_start
    if verbose:
        print(f"\t... time cost for registration: {records[7]:f} s;")
    return reg, np.asarray(aff_coef, np.float32), records


def _powell_ladder(aff_method, ftol, p_init, records, verbose, stage):
    """The affMethod ladder over host Powell stages (the 'host' and
    'hybrid' engines): ``stage(p0, mode, ftol) -> (p_min, f_min)`` runs
    Powell on the mode's cost, 'dofN' (the first N entries of a 9-DOF
    vector, as the reference passes dofNum as Powell's dimensionality,
    reference:src/api_subfunc.cu:2893-2916) or 'p12'. Returns (aff_coef,
    fret)."""
    dof9 = np.zeros(9, dtype=np.float64)
    dof9[6:9] = 1.0

    def run_dof_stage(dof_num, this_ftol):
        sub, f_min = stage(dof9[:dof_num].copy(), f"dof{dof_num}", this_ftol)
        dof9[:dof_num] = sub
        return f_min

    if aff_method in (1, 2, 3, 4):
        dof_num = {1: 3, 2: 6, 3: 7, 4: 9}[aff_method]
        fret = run_dof_stage(dof_num, ftol)
        return dof_to_matrix(dof9, dof_num), fret
    if aff_method == 5:
        p, fret = stage(p_init.astype(np.float64), "p12", ftol)
        return params_to_matrix(p), fret
    if aff_method == 6:
        fret = run_dof_stage(6, 0.01)
        records[2] = -fret
        if verbose:
            print(f"\t... cross correlation value after 6 DOF: {-fret:f};")
        p = matrix_to_params(dof_to_matrix(dof9, 6)).astype(np.float64)
        p, fret = stage(p, "p12", ftol)
        return params_to_matrix(p), fret
    if aff_method == 7:
        fret = None
        for dof_num, this_ftol in ((3, 0.01), (6, 0.01), (9, 0.005)):
            fret = run_dof_stage(dof_num, this_ftol)
            if verbose:
                print(f"\t... cross correlation value after {dof_num} DOF: "
                      f"{-fret:f};")
        records[2] = -fret
        p = matrix_to_params(dof_to_matrix(dof9, 9)).astype(np.float64)
        p, fret = stage(p, "p12", ftol)
        return params_to_matrix(p), fret
    raise ValueError("Wrong affine registration method")


# --------------------------------------------------------------------------
# multi-resolution pyramid
# --------------------------------------------------------------------------

def _pool_factors(k):
    """Normalize a pooling spec to per-axis (kz, ky, kx)."""
    if np.isscalar(k):
        return (int(k),) * 3
    kz, ky, kx = (int(v) for v in k)
    return kz, ky, kx


def _mean_pool(vol, k):
    """Per-axis mean pooling of a tensor (trailing remainders cropped). k:
    scalar or (kz, ky, kx)."""
    kz, ky, kx = _pool_factors(k)
    sz, sy, sx = vol.shape
    vol = vol[: sz - sz % kz, : sy - sy % ky, : sx - sx % kx]
    return vol.reshape(sz // kz, kz, sy // ky, ky, sx // kx, kx).mean(dim=(1, 3, 5))


def _k_xyz(k):
    """Pooling factors in matrix (x, y, z) coordinate order."""
    kz, ky, kx = _pool_factors(k)
    return np.array([kx, ky, kz], np.float64)


def _tmx_coarse_to_full(m_c, k):
    """Matrix found on a pooled grid -> full-resolution matrix. Pooled
    voxel centers sit at full coordinate k_i*i + (k_i-1)/2 per axis, so
    A_f[i,j] = k_i*A_c[i,j]/k_j and t_f = K@t_c + delta - A_f@delta with
    delta_i = (k_i-1)/2."""
    m = np.asarray(m_c, np.float64).reshape(3, 4)
    kv = _k_xyz(k)
    delta = (kv - 1) / 2.0
    a_full = m[:, :3] * kv[:, None] / kv[None, :]
    t_full = kv * m[:, 3] + delta - a_full @ delta
    out = np.concatenate([a_full, t_full[:, None]], axis=1)
    return out.reshape(12).astype(np.float32)


def _tmx_full_to_coarse(m_f, k):
    m = np.asarray(m_f, np.float64).reshape(3, 4)
    kv = _k_xyz(k)
    delta = (kv - 1) / 2.0
    a_coarse = m[:, :3] / kv[:, None] * kv[None, :]
    t_coarse = (m[:, 3] - delta + m[:, :3] @ delta) / kv
    out = np.concatenate([a_coarse, t_coarse[:, None]], axis=1)
    return out.reshape(12).astype(np.float32)


def _auto_pool_factors(shape, budget=None):
    """Per-axis pyramid pooling factors: halve z and y until the coarse
    level is under ``budget`` voxels (default MIL_REG_PYRAMID_BUDGET,
    160k); pool x only while the pooled extent stays a multiple of 128.
    Each axis pools only while its coarse extent stays >= 8, and the loop
    stops when no axis can pool further."""
    if budget is None:
        budget = int(os.environ.get("MIL_REG_PYRAMID_BUDGET", str(160_000)))
    sz0, sy0, sx0 = shape
    kz = ky = kx = 1

    def vox():
        return (sz0 // kz) * (sy0 // ky) * (sx0 // kx)

    while vox() > budget:
        progressed = False
        if (sx0 // (kx * 2)) % 128 == 0 and sx0 // (kx * 2) >= 128:
            kx *= 2
            progressed = True
        if sz0 // (kz * 2) >= 8:
            kz *= 2
            progressed = True
        if sy0 // (ky * 2) >= 8:
            ky *= 2
            progressed = True
        if not progressed:
            break
    return (kz, ky, kx)


def pyramid_levels(factor):
    """The pooling factors the pyramid visits in order, full resolution
    excluded: the coarse factor, then (with MIL_REG_PYRAMID_MID, default
    on) each halving on the way up."""
    levels = [_pool_factors(factor)]
    if env_on("MIL_REG_PYRAMID_MID", True):
        fmid = tuple(max(1, v // 2) for v in levels[0])
        while any(v > 1 for v in fmid):
            levels.append(fmid)
            fmid = tuple(max(1, v // 2) for v in fmid)
    return levels


def reg3d_affine_pyramid(img1, img2, aff_method=7, flag_tmx=False, tmx=None,
                         ftol=1e-4, it_limit=3000, verbose=False, records=None,
                         device=None, engine="auto", factor=None, mem_mode=-1,
                         *, want_reg=True, on_level=None):
    """Coarse-to-fine affine registration: the DOF ladder on a mean-pooled
    pair, a polish of the requested model at each halved pooling on the
    way up (MIL_REG_PYRAMID_MID, default on), then a full-resolution stage
    seeded by the scaled matrix. Same objective at full resolution; the
    pyramid changes the search trajectory, not the transform model.

    MIL_REG_FINISH_LEVEL: 'mid' (default) keeps the grad engine's Powell
    finisher through the last mid level and runs the full-resolution stage
    L-BFGS-only; 'full' keeps it at every level.

    factor: pooling factor (auto: :func:`_auto_pool_factors`).
    ``on_level(label, shape, seconds)``, when given, is called after each
    level (for profiling)."""
    mem_mode, dev = _reg_device(tuple(np.shape(img1)), mem_mode, device)
    if _beyond_budget(mem_mode, tuple(np.shape(img1)), dev):
        # the beyond-budget tier pools its own coarse level
        return reg3d_affine(img1, img2, aff_method, flag_tmx, tmx, ftol,
                            it_limit, verbose, records, dev, engine, 2,
                            want_reg=want_reg)
    img1 = _as_tensor(img1, dev)
    img2 = _as_tensor(img2, dev)
    if records is None:
        records = np.zeros(11, dtype=np.float64)
    if factor is None:
        factor = _auto_pool_factors(tuple(img1.shape))
    if aff_method == 0 or all(v == 1 for v in _pool_factors(factor)):
        return reg3d_affine(img1, img2, aff_method, flag_tmx, tmx, ftol,
                            it_limit, verbose, records, dev, engine,
                            mem_mode, want_reg=want_reg)
    levels = pyramid_levels(factor)

    @contextlib.contextmanager
    def level(label, shape):
        """One level's ``mil.reg.level`` span; with ``on_level``, a sync
        at its end and the call."""
        t = time.time()
        with span("mil.reg.level"):
            yield
            if on_level is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if on_level is not None:
            on_level(label, shape, time.time() - t)

    with span("mil.reg.pool"):
        c1 = _mean_pool(img1, factor)
        c2 = _mean_pool(img2, factor)
    tmx_c = (_tmx_full_to_coarse(tmx, factor)
             if (flag_tmx and tmx is not None) else None)
    if verbose:
        print(f"\t... pyramid: coarse search at 1/{_pool_factors(factor)} "
              f"resolution {tuple(c1.shape)}")
    with level(f"coarse {levels[0]}", tuple(c1.shape)):
        _, m_coarse, rec_c = reg3d_affine(c1, c2, aff_method, flag_tmx, tmx_c, ftol,
                                          it_limit, verbose, None, dev, engine,
                                          mem_mode, want_reg=False)
    del c1, c2
    m_init = _tmx_coarse_to_full(m_coarse, factor)
    # polish with the REQUESTED transform model (dofNum is Powell's exact
    # dimensionality in the reference, reference:src/api_subfunc.cu:
    # 2893-2916); the escalation methods 6/7 already end at 12 DOF
    polish_method = {1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 5, 7: 5}[aff_method]
    mids = levels[1:]
    mid_finish = (os.environ.get("MIL_REG_FINISH_LEVEL", "mid") == "mid"
                  and bool(mids))
    for fm in mids:
        with span("mil.reg.pool"):
            m1 = _mean_pool(img1, fm)
            m2 = _mean_pool(img2, fm)
        if verbose:
            print(f"\t... pyramid: mid polish at 1/{fm} resolution")
        init = _tmx_full_to_coarse(m_init, fm)
        with level(f"mid {fm}", tuple(m1.shape)):
            _, m_mid, _rec_m = reg3d_affine(m1, m2, polish_method, True, init, ftol,
                                            it_limit, verbose, None, dev, engine,
                                            mem_mode, want_reg=False)
        del m1, m2
        m_init = _tmx_coarse_to_full(m_mid, fm)
    if verbose:
        print(f"\t... pyramid: full-resolution polish (method {polish_method})")
    with level("full", tuple(img1.shape)):
        reg, m_full, records = reg3d_affine(
            img1, img2, polish_method, True, m_init, ftol, it_limit, verbose, records,
            dev, engine, mem_mode, want_reg=want_reg,
            grad_finish=(False if mid_finish else None))
    records[2] = rec_c[3]  # coarse-stage NCC as the intermediate record
    return reg, m_full, records


# --------------------------------------------------------------------------
# reg3d dispatcher
# --------------------------------------------------------------------------

@spanned("mil.reg")
def reg3d(img1, img2, reg_choice=2, aff_method=7, flag_tmx=False, tmx=None,
          ftol=1e-4, it_limit=3000, device=None, mem_mode=-1, verbose=False,
          records=None, engine="auto", pyramid="auto", *, as_device=False,
          want_reg=None, grad_finish=None, on_level=None):
    """Main 3D registration entry (``reg3d``,
    reference:src/api_reg.cpp:264-607).

    reg_choice: 0 apply-matrix only; 1 phasor; 2 affine; 3 phasor ->
    affine; 4 2D-MIP-shift-align -> affine. The source is centered-aligned
    to the target's shape first when sizes differ
    (reference:src/api_reg.cpp:398-407). Returns (registered, tmx12,
    records); ``as_device=True`` leaves the registered volume a tensor on
    the device, ``want_reg=False`` skips the final transform (None).
    Without ``as_device`` a volume registered on CUDA comes back as numpy
    in a block of pinned host memory from torch's caching host allocator
    (:func:`~microimagelib_tpu_torch.utils.trace.to_host`), the caller's
    own until dropped; the block holds the volume's size rounded up to a
    power of two.
    ``pyramid='auto'`` pools above 96^3 voxels unless engine='host';
    ``on_level`` goes to :func:`reg3d_affine_pyramid`."""
    t0 = time.time()
    if records is None:
        records = np.zeros(11, dtype=np.float64)
    if reg_choice not in (0, 1, 2, 3, 4):
        raise ValueError("Wrong registration choice")
    mem_mode_requested = mem_mode
    mem_mode, dev = _reg_device(tuple(np.shape(img1)), mem_mode, device)
    records[8] = free_memory_mb(dev)
    beyond = _beyond_budget(mem_mode, tuple(np.shape(img1)), dev)
    if beyond:
        # the volumes stay in host memory end to end; the low-memory tier
        # pools its own coarse level, so the pyramid is skipped
        img1 = _host_np(img1)
        img2 = _host_np(img2)
        if img1.shape != img2.shape:
            img2 = np_align_size_3d(img2, img1.shape)
        pyramid = False
    else:
        img1 = _as_tensor(img1, dev)
        img2 = _as_tensor(img2, dev)
        if img1.shape != img2.shape:
            img2 = align_size_3d(img2, tuple(img1.shape))
    records[0] = 1
    records[9] = free_memory_mb(dev)

    if pyramid == "auto":
        pyramid = int(np.prod(img1.shape)) > 96 ** 3 and engine != "host"
    want = False if want_reg is False else ("device" if as_device else True)

    def run_affine(method, flag, mx):
        if pyramid:
            return reg3d_affine_pyramid(
                img1, img2, method, flag, mx, ftol, it_limit, verbose,
                records, dev, engine, mem_mode=mem_mode, want_reg=want,
                on_level=on_level)
        # grad_finish (non-pyramid engines only; the pyramid places its
        # own finisher per MIL_REG_FINISH_LEVEL)
        return reg3d_affine(img1, img2, method, flag, mx, ftol, it_limit,
                            verbose, records, dev, engine, mem_mode,
                            want_reg=want, grad_finish=grad_finish)

    def run_phasor():
        # the host-staged phasor (the reference's reg3d_phasor2,
        # reference:src/api_subfunc.cu:2591-2726): mode 2, or auto when the
        # phasor's ~6 volumes exceed the budget
        budget = hbm_budget_bytes(dev)
        use_lowmem = mem_mode == 2 or (
            mem_mode_requested == -1 and budget is not None
            and 6 * int(np.prod(img1.shape)) * 4 > budget * 0.92)
        if use_lowmem:
            if verbose:
                print("\t... phasor in host-staged memory-saving mode")
            return reg3d_phasor_lowmem(img1, img2, budget_bytes=budget,
                                       device=dev)
        return reg3d_phasor(img1, img2)

    def shift_tmx(shifts):
        t = identity_tmx()
        t[3], t[7], t[11] = shifts
        return t

    if reg_choice == 0:
        if mem_mode == 2 and flag_tmx and tmx is not None:
            out_tmx = np.asarray(tmx, np.float32).copy()
            reg = (_final_transform(img2, out_tmx, tuple(img1.shape), 2, dev)
                   if want else None)
        else:
            reg, out_tmx, records = reg3d_affine(
                img1, img2, 0, flag_tmx, tmx, ftol, it_limit, verbose, records,
                dev, engine, mem_mode, want_reg=want)
    elif reg_choice == 1:
        shifts = run_phasor()
        out_tmx = shift_tmx(shifts)
        if not want:
            reg = None
        elif mem_mode == 2:
            reg = _final_transform(img2, out_tmx, tuple(img1.shape), 2, dev)
        else:
            reg = imshift(img2, -shifts[0], -shifts[1], -shifts[2])
    elif reg_choice == 2:
        reg, out_tmx, records = run_affine(aff_method, flag_tmx, tmx)
    elif reg_choice == 3:
        reg, out_tmx, records = run_affine(aff_method, True,
                                           shift_tmx(run_phasor()))
    else:
        if verbose:
            print("\t... 2D MIP registration ... ")
        vol1, vol2 = (torch.as_tensor(v) for v in (img1, img2))
        # XY MIPs -> 2D shift align (both axes)
        _, tmx1 = reg2d_shiftalign(max_projection(vol1, 1),
                                   max_projection(vol2, 1), None, 0.3, 30,
                                   x_only=False, device=dev)
        # ZX MIPs -> X-only align (x of the MIP = volume z); carries the
        # found x-shift into the unsearched second component like the
        # reference (tmx2[5] = tmx1[2], reference:src/api_reg.cpp:494)
        t2_init = np.array([1, 0, 0, 0, 1, tmx1[2]], np.float32)
        _, tmx2 = reg2d_shiftalign(max_projection(vol1, 2),
                                   max_projection(vol2, 2), t2_init, 0.3, 30,
                                   x_only=True, device=dev)
        del vol1, vol2
        t = shift_tmx((tmx1[2], tmx1[5], tmx2[2]))
        if verbose:
            print(f"\t... shift translation, X: {t[3]:.1f}; Y: {t[7]:.1f}; "
                  f"Z: {t[11]:.1f}")
            print("\t... 3D registration ... ")
        reg, out_tmx, records = run_affine(aff_method, True, t)
    records[7] = time.time() - t0
    records[10] = free_memory_mb(dev)
    if isinstance(reg, torch.Tensor) and not as_device:
        reg = to_host(reg)
    return reg, out_tmx, records


def reg_3dgpu(img1, img2, aff_method=7, input_tmx=False, tmx=None, ftol=1e-4,
              it_limit=3000, device=None, records=None, *, mem_mode=1):
    """Legacy wrapper: MIP-initialized registration with checkmatrix
    fallback to plain affine (``reg_3dgpu``,
    reference:src/api_reg.cpp:609-652). Memory mode 1 on ``device`` as in
    the JAX package; ``mem_mode=0`` runs it on the CPU."""
    reg_choice = 2 if input_tmx else 4
    reg, out_tmx, records = reg3d(img1, img2, reg_choice, aff_method, input_tmx,
                                  tmx, ftol, it_limit, device, mem_mode, False,
                                  records)
    sz, sy, sx = np.shape(img1)
    if not checkmatrix(out_tmx, sx, sy, sz):
        reg, out_tmx, records = reg3d(img1, img2, 2, aff_method, input_tmx,
                                      tmx, ftol, it_limit, device, mem_mode,
                                      False, records)
    return reg, out_tmx, records
