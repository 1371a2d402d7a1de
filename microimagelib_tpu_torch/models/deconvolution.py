"""Single-view Richardson-Lucy deconvolution with a matched (flipped-PSF)
or unmatched back projector, in PyTorch.

Two routes run the same RL iteration (reference:src/api_subfunc.cu:
3404-3416): the separable route — two launches of the compact-PSF conv
kernel per iteration (ops/conv_sep.py, csrc/conv_sep.cu), taken whenever
the planner accepts both projectors — and the FFT route
(``torch.fft``, i.e. cuFFT on the card) for PSFs the planner refuses, or
for every PSF when ``MIL_CONV_SEP=0``.

Numerics: normalized transforms; the two inverse-FFT scale factors of the
reference's unnormalized cuFFT cancel between the ratio and the update.

Fidelity choices mirrored from the reference (and the JAX package):
  * observed image clamped to >= SMALLVALUE=0.01 before iterating, and
    the estimate re-clamped each iteration (reference:src/api_subfunc.cu:
    24, 3380, 3416)
  * "constant initial" uses the image SUM (the reference's ``meanValue``
    is ``sum3Dgpu`` without division — reference:src/api_subfunc.cu:3382)
  * images padded to the FFT grid with replicate-edge values; PSFs
    sum-normalized, center-aligned, circularly split to the origin
    (``genOTFgpu`` reference:src/api_subfunc.cu:3269-3307)
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from microimagelib_tpu_torch.ops.basics import (
    align_size_3d,
    crop_center,
    pad_psf_to_origin,
    pad_stack_edge,
    snap_fft_size,
)
from microimagelib_tpu_torch.ops.conv_sep import conv3_sep, plan_sep_pair
from microimagelib_tpu_torch.utils.device import free_memory_mb, require_cuda
from microimagelib_tpu_torch.utils.envflags import env_on

SMALLVALUE = 0.01


def _as_tensor(x, device=None, dtype=torch.float32):
    """Tensor view of ``x`` (tensor or numpy/array-like) with ``dtype`` on
    ``device`` (default: where a tensor already is, else the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype)
    arr = np.ascontiguousarray(x)
    if not arr.flags.writeable:   # e.g. a JAX array's host view
        arr = arr.copy()
    return torch.as_tensor(arr, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# OTF preparation
# --------------------------------------------------------------------------

def gen_otf(psf, fft_shape, normalize=True, device=None):
    """PSF -> OTF (complex64, rFFT half-spectrum) on the (z, y, x) grid
    ``fft_shape``: optional sum-normalization, centered re-size when the
    PSF exceeds the grid, circular split around the PSF center to the
    origin, forward rFFT (``genOTFgpu``, reference:src/api_subfunc.cu:
    3269-3307). ``psf`` is a tensor or a numpy array; the OTF lands on
    ``device`` (default: the psf tensor's device, else the CPU)."""
    psf = _as_tensor(psf, device)
    if normalize:
        psf = psf / psf.sum()
    if any(p > f for p, f in zip(psf.shape, fft_shape)):
        psf = align_size_3d(psf, fft_shape)
    return torch.fft.rfftn(pad_psf_to_origin(psf, fft_shape))


# --------------------------------------------------------------------------
# RL loops
# --------------------------------------------------------------------------

def _conv_spec(x, otf, shape):
    return torch.fft.irfftn(torch.fft.rfftn(x) * otf, s=shape)


def _sep_plans(psf, psf_bp, fft_shape):
    """Plan the separable route for the projector pair, or None for the
    FFT route. ``MIL_CONV_SEP=0`` (or ``off``) forces the FFT route;
    otherwise the separable route is taken whenever the planner accepts
    both projectors. Tolerance cascade: exact to fp32 first, then the
    measured-PSF tier (1e-4 relative projector error moves the RL fixed
    point far less than fp32 FFT noise, and admits tilted/curved PSFs at
    low rank); ``MIL_CONV_SEP_TOL`` pins one tolerance."""
    if os.environ.get("MIL_CONV_SEP", "auto") in ("0", "off"):
        return None
    tol_env = os.environ.get("MIL_CONV_SEP_TOL")
    tols = (float(tol_env),) if tol_env else (1e-6, 1e-4)
    for tol in tols:
        pair = plan_sep_pair(psf, psf_bp, fft_shape, tol=tol)
        if pair is not None:
            return pair
    return None


def _initial(img, const_initial):
    """Clamped image and the starting estimate: the image itself, or the
    constant image SUM (the reference's quirk; one value for every route,
    filled on the device without a host read)."""
    img = img.clamp_min(SMALLVALUE)
    if const_initial:
        return img, torch.empty_like(img).fill_(img.sum())
    return img, img


def _rl_loop(step, est0, n_iters, accel, stop_tol=None):
    """Run up to ``n_iters`` RL iterations of ``step``: plain fixed-count
    loop, or — with ``accel`` — Biggs-Andrews vector extrapolation
    (y_k = x_{k-1} + alpha_k (x_{k-1} - x_{k-2}),
    alpha_k = <g_{k-1}, g_{k-2}> / <g_{k-2}, g_{k-2}> clamped to [0, 1),
    g = x - y; Biggs & Andrews, Appl. Opt. 36:1766, 1997; MIL_RL_ACCEL=1).

    ``stop_tol``: stop once the relative L1 update
    ||x_k - x_{k-1}||_1 / ||x_{k-1}||_1 falls below it (MIL_RL_STOP_TOL).
    That test reads one number back to the host per iteration, so only
    this mode pays it; the fixed-count loop never synchronises."""
    if not accel and stop_tol is None:
        est = est0
        for _ in range(n_iters):
            est = step(est)
        return est

    def rel(x2, x1):
        return float((x2 - x1).abs().sum()
                     / x1.abs().sum().clamp_min(1e-20))

    if not accel:
        x, r = est0, math.inf
        for _ in range(n_iters):
            if not r > stop_tol:
                break
            x2 = step(x)
            r = rel(x2, x)
            x = x2
        return x

    x1 = x2 = est0
    g1 = g2 = torch.zeros_like(est0)
    r = math.inf
    for k in range(n_iters):
        if stop_tol is not None and not r > stop_tol:
            break
        alpha = 0.0
        if k >= 2:
            den = (g2 * g2).sum()
            alpha = torch.where(den > 0, (g1 * g2).sum() / den,
                                torch.zeros_like(den)).clamp(0.0, 0.9999)
        y = torch.clamp_min(x1 + alpha * (x1 - x2), SMALLVALUE)
        x = step(y)
        x1, x2, g1, g2 = x, x1, x - y, g1
        if stop_tol is not None:
            r = rel(x1, x2)
    return x1


def _accel_env():
    return env_on("MIL_RL_ACCEL")


def _stop_env(stop_tol=None):
    """Resolve the early-stop tolerance: explicit kwarg wins, else
    MIL_RL_STOP_TOL (unset/0 = off, the reference's fixed-count loop)."""
    if stop_tol is not None:
        return float(stop_tol) or None
    env = os.environ.get("MIL_RL_STOP_TOL")
    return float(env) if env else None


def _rl_single_sep(img, fwd, bp, n_iters, const_initial, accel=False,
                   stop_tol=None):
    """RL over the separable conv kernel: ratio and update are each ONE
    launch (mode='ratio'/'update'). Unlike the TPU plans, these have no
    frame shift, so the image is not pre-rolled."""
    img, est0 = _initial(img, const_initial)

    def step(est):
        ratio = conv3_sep(est, fwd, aux=img, mode="ratio")
        return conv3_sep(ratio, bp, aux=est, mode="update",
                         smallvalue=SMALLVALUE)

    return _rl_loop(step, est0, n_iters, accel, stop_tol)


def _rl_single(img, otf, otf_bp, n_iters, const_initial, accel=False,
               stop_tol=None):
    """RL over FFT convolutions (the JAX package's ``_rl_single`` with
    ``fft_impl='xla'``)."""
    shape = tuple(img.shape)
    img, est0 = _initial(img, const_initial)

    def step(est):
        ratio = img / _conv_spec(est, otf, shape)
        return torch.clamp_min(est * _conv_spec(ratio, otf_bp, shape),
                               SMALLVALUE)

    return _rl_loop(step, est0, n_iters, accel, stop_tol)


def rl_decon_single(img, otf, otf_bp, n_iters, const_initial=False,
                    psf=None, psf_bp=None, stop_tol=None):
    """Single-view RL on a pre-padded FFT-grid image; returns the estimate
    on the same grid and device (``decon_singleview_OTF1`` loop,
    reference:src/api_subfunc.cu:3404-3416).

    ``img`` is a float32 tensor (or a numpy array, run on the CPU). When
    the raw projectors are given (``psf``, optional ``psf_bp``; host
    arrays) and the planner accepts both, the separable route runs;
    otherwise the FFT route, with ``otf``/``otf_bp`` (tensors or numpy
    arrays, e.g. built by the JAX package) or, when they are None, OTFs
    built here from the PSFs."""
    img = _as_tensor(img)
    shape = tuple(img.shape)
    if psf is not None:
        psf_np = np.asarray(psf, np.float32)
        bp_np = (np.asarray(psf_bp, np.float32) if psf_bp is not None
                 else psf_np[::-1, ::-1, ::-1])
        pair = _sep_plans(psf_np, bp_np, shape)
        if pair is not None:
            return _rl_single_sep(img, *pair, n_iters, const_initial,
                                  _accel_env(), _stop_env(stop_tol))
        if otf is None:
            otf = gen_otf(psf_np, shape, device=img.device)
            otf_bp = gen_otf(bp_np, shape, device=img.device)
    otf = _as_tensor(otf, img.device, torch.complex64)
    otf_bp = _as_tensor(otf_bp, img.device, torch.complex64)
    return _rl_single(img, otf, otf_bp, n_iters, const_initial,
                      _accel_env(), _stop_env(stop_tol))


# --------------------------------------------------------------------------
# Memory mode (the reference's gpuMemMode, reference:src/api_decon.cpp:
# 111-135)
# --------------------------------------------------------------------------

def _workingset_bytes(fft_shape):
    """Device-resident working set of the single-view RL loop on the FFT
    grid: ~6 grid-sized buffers, the tier the reference sizes its probe
    against (reference:src/api_decon.cpp:402-413)."""
    return 6 * fft_shape[0] * fft_shape[1] * fft_shape[2] * 4


def _resolve_device(mem_mode, fft_shape, device):
    """(mode, torch.device) for ``mem_mode``: 0 the CPU; 1 the given CUDA
    device (default cuda:0); -1 mode 1 when the working set fits the
    device's free memory, else an error; 2 (host-staged streaming) is not
    ported yet."""
    if mem_mode == 0:
        return 0, torch.device("cpu")
    if mem_mode == 2:
        raise NotImplementedError(
            "mem_mode 2 (host-staged streaming, models/decon_streamed.py) is "
            "not ported yet: ROADMAP.md, 'memory tiers and multi-device'")
    if mem_mode not in (-1, 1):
        raise ValueError(f"Invalid memory mode {mem_mode}")
    device = require_cuda(device)
    if mem_mode == -1:
        free = torch.cuda.mem_get_info(device)[0]
        need = _workingset_bytes(fft_shape)
        if need > free * 0.92:
            raise RuntimeError(
                f"the {need / 1048576:.0f} MB RL working set does not fit "
                f"the {free / 1048576:.0f} MB free on {device}, and the "
                "host-staged streaming mode is not ported yet")
    return 1, device


# --------------------------------------------------------------------------
# Full entry (host orchestration, numpy in/out)
# --------------------------------------------------------------------------

def _fft_grid(shape_zyx, tpu_friendly=True):
    return tuple(snap_fft_size(int(s), tpu_friendly) for s in shape_zyx)


def decon_singleview(img, psf, n_iters=20, const_initial=False, psf_bp=None,
                     device=None, mem_mode=-1, verbose=False, records=None,
                     tpu_friendly_fft=True):
    """Single-view RL deconvolution, full pipeline
    (``decon_singleview``, reference:src/api_decon.cpp:53-331).

    img, psf: (z, y, x) arrays (img may be a tensor). ``psf_bp`` switches
    to the unmatched back projector (reference ``flagUnmatch``);
    otherwise the back projector is the flipped PSF. Returns the
    deconvolved volume with img's shape as float32 numpy.

    ``records`` (len-10, optional) is filled with the reference telemetry
    layout: [0] memory mode used, [1..5] free device memory snapshots MB
    (-1 on the CPU), [6..9] init/preproc/decon/total seconds
    (reference:src/api_decon.cpp:56-59).

    ``mem_mode``: 0 the CPU; 1 the CUDA ``device`` (a ``torch.device``,
    default cuda:0); -1 mode 1 when the working set fits the device's free
    memory, else an error; 2 (host-staged streaming) raises
    NotImplementedError."""
    t0 = time.time()
    img_shape = tuple(img.shape)
    psf_np = np.asarray(psf, dtype=np.float32)
    fft_shape = _fft_grid(img_shape, tpu_friendly_fft)
    if verbose:
        print(f"...Image size {img_shape[2]} x {img_shape[1]} x {img_shape[0]}")
        print(f"...PSF size {psf_np.shape[2]} x {psf_np.shape[1]} x {psf_np.shape[0]}")
        print(f"...FFT size {fft_shape[2]} x {fft_shape[1]} x {fft_shape[0]}")
    mode, device = _resolve_device(mem_mode, fft_shape, device)
    if records is not None:
        records[1] = free_memory_mb(device)
    img_t = _as_tensor(img, device)
    t1 = time.time()

    padded = (pad_stack_edge(img_t, fft_shape)
              if fft_shape != img_shape else img_t)
    bp_np = np.asarray(psf_bp, np.float32) if psf_bp is not None else None
    t2 = time.time()
    if records is not None:
        records[2] = free_memory_mb(device)

    est = rl_decon_single(padded, None, None, n_iters, const_initial,
                          psf=psf_np, psf_bp=bp_np)
    if records is not None:
        records[3] = free_memory_mb(device)
    out = crop_center(est, img_shape) if fft_shape != img_shape else est
    out_np = out.cpu().numpy()
    t3 = time.time()
    if records is not None:
        records[0] = mode
        records[4] = free_memory_mb(device)
        records[5] = free_memory_mb(device)
        records[6] = t1 - t0
        records[7] = t2 - t1
        records[8] = t3 - t2
        records[9] = t3 - t0
    return out_np
