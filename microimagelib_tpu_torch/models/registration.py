"""3D intensity-based affine registration: Powell- or L-BFGS-optimized
normalized cross-correlation with the reference's DOF-escalation ladder
and retry semantics, a multi-resolution pyramid, and the ``reg3d``
dispatcher (the JAX package's ``models/registration.py``, 3-D affine
part).

The cost of one evaluation is one fused resample + NCC call on the card:
K5 (sums) or K4 (sums and gradient), ``ops/corr.py``. The optimizers run on
the host in float32 with one device sync per evaluation; the registration
state lives in closures, so the library is re-entrant.

Devices: ``mem_mode`` 0 runs on the CPU (the kernels' plain versions); 1
on the CUDA ``device`` (default cuda:0); -1 mode 1 when the ladder's
~5-volume working set fits the device's free memory. Mode 2 (host-staged
streaming, ``_reg3d_affine_lowmem``) is not ported. Neither are the
phasor and 2-D MIP choices of ``reg3d`` (1, 3, 4) nor the ``hybrid``
engine: ROADMAP.md, queues 3 (fusion, MIPs and batch) and 4 (memory
tiers).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from microimagelib_tpu_torch.models.deconvolution import _as_tensor
from microimagelib_tpu_torch.models.registration_device import reg_ladder_device
from microimagelib_tpu_torch.models.registration_grad import reg_ladder_grad
from microimagelib_tpu_torch.ops.affine import affine_transform_3d
from microimagelib_tpu_torch.ops.basics import align_size_3d
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
    require_cuda,
)
from microimagelib_tpu_torch.utils.envflags import env_on


def _not_ported(what, where):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md, {where}")


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
    temporaries, ~5 volumes) fits the device's free memory (always true
    for the CPU)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type != "cuda":
        return True
    free = torch.cuda.mem_get_info(device)[0]
    return 5 * int(np.prod(shape)) * 4 <= free * 0.92


def _resolve_reg_mem_mode(shape, mem_mode, device):
    """-1 auto / 0 CPU / 1 device-resident / 2 memory-saving: auto takes 1
    when the mode-1 working set fits, else 2 (the reference's
    ``reg3d_affine2`` probe, reference:src/api_reg.cpp:330-372)."""
    if mem_mode in (0, 1, 2):
        return int(mem_mode)
    if mem_mode != -1:
        raise ValueError(f"Invalid memory mode {mem_mode}")
    device = require_cuda(device)
    return 1 if _reg_mode1_fits(shape, device) else 2


def _reg_device(shape, mem_mode, device):
    """(mode, torch.device): 0 -> the CPU, 1 -> the CUDA device; 2 raises."""
    mode = _resolve_reg_mem_mode(shape, mem_mode, device)
    if mode == 2:
        raise _not_ported("registration memory mode 2 (host-staged streaming, "
                          "_reg3d_affine_lowmem)", "queue 4 (memory tiers)")
    if mode == 0:
        return 0, torch.device("cpu")
    return 1, require_cuda(device)


# --------------------------------------------------------------------------
# Standalone affine application (atrans3dgpu equivalents)
# --------------------------------------------------------------------------

def atrans3dgpu(img2, tmx, out_shape_zyx, device=None, mem_mode=-1):
    """Apply a 3x4 matrix to a volume, producing ``out_shape_zyx``
    (reference:src/api_reg.cpp:58-85). numpy in/out. mem_mode 0 runs on
    the CPU, 1 on the CUDA ``device``, -1 on the device when source and
    output fit its free memory; mode 2 (streamed) is not ported."""
    img2 = np.asarray(img2, np.float32)
    if mem_mode == -1:
        dev = require_cuda(device)
        need = 4 * (img2.size + int(np.prod(out_shape_zyx))) * 4
        if need > torch.cuda.mem_get_info(dev)[0] * 0.92:
            mem_mode = 2
    if mem_mode == 2:
        raise _not_ported("the streamed affine transform (memory mode 2)",
                          "queue 4 (memory tiers)")
    dev = torch.device("cpu") if mem_mode == 0 else require_cuda(device)
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
# 3D affine registration core
# --------------------------------------------------------------------------

def _final_transform(img2, aff_coef, out_shape, mem_mode):
    """Final re-sample of the ORIGINAL source (mode 2, streamed, is not
    ported)."""
    if mem_mode == 2:
        raise _not_ported("the streamed final transform (memory mode 2)",
                          "queue 4 (memory tiers)")
    return affine_transform_3d(img2, aff_coef, tuple(out_shape))


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
    ``ops/powell.py``, float64, one K5 call per evaluation); 'auto' takes
    MIL_REG_ENGINE when set, else 'grad' on a CUDA device while
    MIL_REG_GRAD is on (default) and 'device' otherwise. 'hybrid' is not
    ported.

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
    img1 = _as_tensor(img1, dev)
    img2 = _as_tensor(img2, dev)

    def _finish_reg(aff_coef):
        """The final full-volume transform of the source: None for
        ``want_reg=False`` (pyramid levels need only the matrix), left on
        the device for ``want_reg='device'``."""
        if not want_reg:
            return None
        reg = _final_transform(img2, aff_coef, img1.shape, mem_mode)
        return reg if want_reg == "device" else reg.cpu().numpy()

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
    if engine == "hybrid":
        raise _not_ported("the 'hybrid' registration engine",
                          "queue 4 (memory tiers)")

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
        aff_coef, fret = _host_ladder(aff_method, ftol, it_limit, counter,
                                      cost12, cost_dof, p_init, records,
                                      verbose)

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


def _host_ladder(aff_method, ftol, it_limit, counter, cost12, cost_dof,
                 p_init, records, verbose):
    """The 'host' engine: the NR Powell of ops/powell.py over the ladder.
    Returns (aff_coef, fret)."""
    def run_powell(p0, fn, this_ftol):
        counter.func = fn
        p_min, f_min, _, _ = powell(p0, fn, this_ftol, it_limit, counter=counter)
        return p_min, f_min

    dof9 = np.zeros(9, dtype=np.float64)
    dof9[6:9] = 1.0

    def run_dof_stage(dof_num, this_ftol):
        """Optimize only the first ``dof_num`` DOF components, as the
        reference passes dofNum as Powell's dimensionality
        (reference:src/api_subfunc.cu:2893-2916)."""
        sub0 = dof9[:dof_num].copy()

        def fn(sub):
            full = dof9.copy()
            full[:dof_num] = sub
            return cost_dof(full, dof_num)

        sub_min, f_min = run_powell(sub0, fn, this_ftol)
        dof9[:dof_num] = sub_min
        return f_min

    if aff_method in (1, 2, 3, 4):
        dof_num = {1: 3, 2: 6, 3: 7, 4: 9}[aff_method]
        fret = run_dof_stage(dof_num, ftol)
        return dof_to_matrix(dof9, dof_num), fret
    if aff_method == 5:
        p, fret = run_powell(p_init.astype(np.float64), cost12, ftol)
        return params_to_matrix(p), fret
    if aff_method == 6:
        fret = run_dof_stage(6, 0.01)
        records[2] = -fret
        if verbose:
            print(f"\t... cross correlation value after 6 DOF: {-fret:f};")
        p = matrix_to_params(dof_to_matrix(dof9, 6)).astype(np.float64)
        p, fret = run_powell(p, cost12, ftol)
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
        p, fret = run_powell(p, cost12, ftol)
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

    def timed(label, shape, fn):
        t = time.time()
        out = fn()
        if on_level is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            on_level(label, shape, time.time() - t)
        return out

    c1 = _mean_pool(img1, factor)
    c2 = _mean_pool(img2, factor)
    tmx_c = (_tmx_full_to_coarse(tmx, factor)
             if (flag_tmx and tmx is not None) else None)
    if verbose:
        print(f"\t... pyramid: coarse search at 1/{_pool_factors(factor)} "
              f"resolution {tuple(c1.shape)}")
    _, m_coarse, rec_c = timed(f"coarse {levels[0]}", tuple(c1.shape),
                               lambda: reg3d_affine(
                                   c1, c2, aff_method, flag_tmx, tmx_c, ftol,
                                   it_limit, verbose, None, dev, engine,
                                   mem_mode, want_reg=False))
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
        m1 = _mean_pool(img1, fm)
        m2 = _mean_pool(img2, fm)
        if verbose:
            print(f"\t... pyramid: mid polish at 1/{fm} resolution")
        init = _tmx_full_to_coarse(m_init, fm)
        _, m_mid, _rec_m = timed(f"mid {fm}", tuple(m1.shape),
                                 lambda: reg3d_affine(
                                     m1, m2, polish_method, True, init, ftol,
                                     it_limit, verbose, None, dev, engine,
                                     mem_mode, want_reg=False))
        del m1, m2
        m_init = _tmx_coarse_to_full(m_mid, fm)
    if verbose:
        print(f"\t... pyramid: full-resolution polish (method {polish_method})")
    reg, m_full, records = timed(
        "full", tuple(img1.shape),
        lambda: reg3d_affine(img1, img2, polish_method, True, m_init, ftol,
                             it_limit, verbose, records, dev, engine,
                             mem_mode, want_reg=want_reg,
                             grad_finish=(False if mid_finish else None)))
    records[2] = rec_c[3]  # coarse-stage NCC as the intermediate record
    return reg, m_full, records


# --------------------------------------------------------------------------
# reg3d dispatcher
# --------------------------------------------------------------------------

def reg3d(img1, img2, reg_choice=2, aff_method=7, flag_tmx=False, tmx=None,
          ftol=1e-4, it_limit=3000, device=None, mem_mode=-1, verbose=False,
          records=None, engine="auto", pyramid="auto", *, as_device=False,
          want_reg=None, grad_finish=None, on_level=None):
    """Main 3D registration entry (``reg3d``,
    reference:src/api_reg.cpp:264-607).

    reg_choice: 0 apply-matrix only; 2 affine. The phasor (1), phasor ->
    affine (3) and 2-D MIP -> affine (4) choices are not ported yet. The
    source is centered-aligned to the target's shape first when sizes
    differ (reference:src/api_reg.cpp:398-407). Returns (registered,
    tmx12, records); ``as_device=True`` leaves the registered volume a
    tensor on the device, ``want_reg=False`` skips the final transform
    (None). ``pyramid='auto'`` pools above 96^3 voxels unless
    engine='host'; ``on_level`` goes to :func:`reg3d_affine_pyramid`."""
    t0 = time.time()
    if records is None:
        records = np.zeros(11, dtype=np.float64)
    if reg_choice in (1, 3, 4):
        raise _not_ported(f"reg_choice {reg_choice} (phasor / 2-D MIP "
                          "registration)", "queue 3 (fusion, MIPs and batch)")
    if reg_choice not in (0, 2):
        raise ValueError("Wrong registration choice")
    mem_mode, dev = _reg_device(tuple(np.shape(img1)), mem_mode, device)
    records[8] = free_memory_mb(dev)
    img1 = _as_tensor(img1, dev)
    img2 = _as_tensor(img2, dev)
    if img1.shape != img2.shape:
        img2 = align_size_3d(img2, tuple(img1.shape))
    records[0] = 1
    records[9] = free_memory_mb(dev)

    if pyramid == "auto":
        pyramid = img1.numel() > 96 ** 3 and engine != "host"
    want = False if want_reg is False else ("device" if as_device else True)

    if reg_choice == 0:
        reg, out_tmx, records = reg3d_affine(
            img1, img2, 0, flag_tmx, tmx, ftol, it_limit, verbose, records,
            dev, engine, mem_mode, want_reg=want)
    elif pyramid:
        reg, out_tmx, records = reg3d_affine_pyramid(
            img1, img2, aff_method, flag_tmx, tmx, ftol, it_limit, verbose,
            records, dev, engine, mem_mode=mem_mode, want_reg=want,
            on_level=on_level)
    else:
        # grad_finish (non-pyramid engines only; the pyramid places its
        # own finisher per MIL_REG_FINISH_LEVEL)
        reg, out_tmx, records = reg3d_affine(
            img1, img2, aff_method, flag_tmx, tmx, ftol, it_limit, verbose,
            records, dev, engine, mem_mode, want_reg=want,
            grad_finish=grad_finish)
    records[7] = time.time() - t0
    records[10] = free_memory_mb(dev)
    if isinstance(reg, torch.Tensor) and not as_device:
        reg = reg.cpu().numpy()
    return reg, out_tmx, records
