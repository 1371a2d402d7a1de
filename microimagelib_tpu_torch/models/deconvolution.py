"""Richardson-Lucy deconvolution in PyTorch: single-view and joint
dual-view, with matched (flipped-PSF) or unmatched back projectors (the
Guo et al. 2020 Wiener-Butterworth acceleration, models/backprojector.py).

Two routes run the same RL iteration (reference:src/api_subfunc.cu:
3404-3416, dual view 3634-3660): the separable route — two launches of
the compact-PSF conv kernel K1 per view and iteration (ops/conv_sep.py,
csrc/conv_sep.cu), taken where the planner accepts every projector and,
on a CUDA volume, the plans are cheap enough that K1 beats the FFT route
(:func:`sep_auto_takes`), or with ``MIL_CONV_SEP_FUSED=1`` one launch of
K2 per view and iteration
(the whole iteration fused, ops/conv_sep.py::rl_iter_fused,
csrc/rl_fused.cu) — and the FFT route for PSFs the planner refuses (Wiener-Butterworth back
projectors among them), or for every PSF when ``MIL_CONV_SEP=0``. The FFT
route convolves with the hand-written kernel K3 (ops/fft_ct.py,
csrc/fft_ct.cu) or with ``torch.fft``, as :func:`_fft_impl` decides.

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
from microimagelib_tpu_torch.kernels.conv_sep import plan_of
from microimagelib_tpu_torch.models.decon_streamed import (
    np_crop_center,
    np_pad_stack_edge,
    rl_decon_dual_streamed,
    rl_decon_single_streamed,
)
from microimagelib_tpu_torch.ops.conv_sep import (
    conv3_sep,
    plan_rl_fused,
    plan_sep_pair,
    rl_iter_fused,
)
from microimagelib_tpu_torch.ops.fft_ct import conv3_ct, ct_specialised, ct_supported
from microimagelib_tpu_torch.utils.device import (
    free_memory_mb,
    require_cuda,
    resolve_device,
)
from microimagelib_tpu_torch.utils.envflags import env_on
from microimagelib_tpu_torch.utils.trace import span, spanned, to_host

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
    ``device`` (default: the psf tensor's device, else cuda:0;
    ``device="cpu"`` for the CPU)."""
    psf = _as_tensor(psf, resolve_device(psf, device))
    if normalize:
        psf = psf / psf.sum()
    if any(p > f for p, f in zip(psf.shape, fft_shape)):
        psf = align_size_3d(psf, fft_shape)
    return torch.fft.rfftn(pad_psf_to_origin(psf, fft_shape))


# --------------------------------------------------------------------------
# RL loops
# --------------------------------------------------------------------------

_AXES = (-3, -2, -1)


def _conv_spec(x, otf, shape):
    """``torch.fft`` convolution over the last three axes (a leading batch
    axis broadcasts against the OTF)."""
    return torch.fft.irfftn(torch.fft.rfftn(x, dim=_AXES) * otf, s=shape,
                            dim=_AXES)


def _on_cuda(arr):
    return isinstance(arr, torch.Tensor) and arr.is_cuda


# Default of MIL_FFT_CT_MIN_VOXELS: the smallest voxel count from which K3
# beats torch.fft at that grid and every larger one among the measured
# grids whose three axes all take K3's length-specialised transform, by
# device time on an NVIDIA H100 (PERF.md section 6): (64, 128, 128), Phase
# 2's third route-ladder grid, where an RL iteration took 0.064-0.072 ms
# on K3 against 0.127-0.136 on torch.fft; above it chip_smoke.py's Phase 5
# ladder, where K3 won on every such grid from 128^3 (2^21) to
# (1024, 512, 512) and (128, 1024, 1024). No smaller grid is measured.
# The rule serves device time: at (64, 128, 128) both routes are bound by
# the host's launches back to back, and there the two routes' medians
# swapped order between two runs (K3 0.215 against 0.161 ms an iteration,
# then 0.128 against 0.200), while the device times held to 1%.
CT_MIN_VOXELS = 2 ** 20


def _fft_impl(shape, arr=None):
    """The FFT route's convolution: 'ct' (K3, :func:`conv3_ct`) or 'torch'
    (``torch.fft``). ``MIL_FFT_IMPL`` as in the JAX package: ``xla`` and
    ``matmul`` run ``torch.fft`` (the matmul DFT is not ported);
    ``pallas`` runs K3 wherever :func:`ct_supported` holds (its plain
    version on a CPU tensor); ``auto`` (default) runs K3 on a CUDA
    ``arr`` of at least ``MIL_FFT_CT_MIN_VOXELS`` voxels (default
    :data:`CT_MIN_VOXELS`) whose every axis takes K3's length-specialised
    transform (:func:`ct_specialised`: every length the FFT size policy
    gives from 64 to 1024), else ``torch.fft``: K3's generic path, which
    any other length takes, ran 1.6-1.7x slower than ``torch.fft`` on an
    H100 (at 384, before 384 had a plan). No specialised length is routed
    to ``torch.fft`` by name: on the H100 K3 beat ``torch.fft`` on every
    measured grid of specialised lengths from 2^20 voxels on."""
    impl = os.environ.get("MIL_FFT_IMPL", "auto")
    if impl in ("xla", "matmul"):
        return "torch"
    if impl == "pallas":
        return "ct" if ct_supported(shape) else "torch"
    if not _on_cuda(arr):
        return "torch"
    vox = shape[0] * shape[1] * shape[2]
    ct_min = int(os.environ.get("MIL_FFT_CT_MIN_VOXELS") or CT_MIN_VOXELS)
    return "ct" if vox >= ct_min and ct_specialised(shape) else "torch"


def _convolver(fft_impl, shape, otfs):
    """The FFT route's convolution and its OTFs. K3 reads C-order
    operands, so its OTFs are re-laid once here, outside the loop;
    ``torch.fft`` keeps the strided half spectrum cuFFT hands back, which
    its inverse transform reads faster (~2 ms per iteration at 512^3 on an
    H100)."""
    if fft_impl == "ct":
        return ((lambda x, otf: conv3_ct(x.contiguous(), otf)),
                [o.contiguous() for o in otfs])
    return (lambda x, otf: _conv_spec(x, otf, shape)), list(otfs)


# MIL_CONV_SEP=auto on a CUDA volume, per FFT route that _fft_impl takes:
# the largest tap cost, rank x (z + y + x taps), of a plan for which the K1
# route ran faster per RL iteration than that FFT route, on an NVIDIA H100
# (chip_smoke.py Phases 2, 3, 7 and 14 and Phase 2's route ladder at 512^3
# and at (192, 640, 640); PERF.md section 6), as (plans that run one of
# K1's specialised instantiations, plans that run its generic one).
# Specialised: the bench 9^3 PSF (cost 27) beat K3 and torch.fft on both
# ladder grids; the 25^3 dual-view and fusion PSFs (55) lost to K3 on
# both, and to torch.fft at (192, 640, 640) (6.404 against 5.554 ms an
# iteration; at 512^3 they won by 2.6%, 9.427 against 9.673); the tilted
# rank-4 class (172) lost to both. Generic, on both grids: cost 9 beat K3
# and 15 lost to it; cost 21 beat torch.fft and 33 and above lost to it.
# At (64, 128, 128), Phase 2's third ladder grid, where _fft_impl takes
# K3, the ceilings against K3 held by device time: cost 9 and the
# specialised 27 won, 15 tied, 21 and the specialised 55 lost. Back to
# back, where the host's launches set the pace, K1's two launches an
# iteration beat K3 up to cost 33 and at 55; the rule serves device time
# there too (see CT_MIN_VOXELS).
SEP_MAX_TAP_COST = {"ct": (27, 9), "torch": (27, 21)}


def tap_cost(plan):
    """rank x (z + y + x taps): K1's work per voxel grows with it."""
    return plan.rank * (plan.nsteps + plan.ty.shape[1] + plan.tx.shape[1])


def k1_specialised(plan):
    """Whether K1 runs ``plan`` on one of its specialised instantiations."""
    pl = plan_of(plan)
    return pl is not None and pl["path"] >= 0


def sep_auto_takes(plans, fft_impl):
    """Whether ``MIL_CONV_SEP=auto`` on a CUDA volume takes the separable
    route for these K1 plans (every projector of the deconvolution) over
    the FFT route ``fft_impl`` ('ct' or 'torch', as :func:`_fft_impl`
    decides): where every plan's :func:`tap_cost` is at most that route's
    :data:`SEP_MAX_TAP_COST` for the plan's instantiation."""
    spec, generic = SEP_MAX_TAP_COST[fft_impl]
    return all(tap_cost(p) <= (spec if k1_specialised(p) else generic) for p in plans)


def _sep_plans(psf, psf_bp, fft_shape, arr=None):
    """Plan the separable route for the projector pair: ('fused',
    RLFusedPlan) — the whole iteration in one K2 launch — or ('pair',
    (fwd, bp)) for a K1 ratio launch and a K1 update launch; None for the
    FFT route. ``MIL_CONV_SEP=0`` (or ``off``) forces the FFT route;
    ``1`` takes the separable route whenever the planner accepts both
    projectors; ``auto`` (default) does so too, except that on a CUDA
    ``arr`` a K1 pair must pass :func:`sep_auto_takes` against the FFT
    route :func:`_fft_impl` takes for ``fft_shape``.
    ``MIL_CONV_SEP_FUSED=1`` opts into the fused form (default off, as in
    the JAX package) and into the separable route; a pair that K2 does not
    take (per-tap rolls) stays a pair. Tolerance cascade: exact to fp32
    first, then the measured-PSF tier (1e-4 relative projector error moves
    the RL fixed point far less than fp32 FFT noise, and admits
    tilted/curved PSFs at low rank); ``MIL_CONV_SEP_TOL`` pins one
    tolerance."""
    mode = os.environ.get("MIL_CONV_SEP", "auto")
    if mode in ("0", "off"):
        return None
    tol_env = os.environ.get("MIL_CONV_SEP_TOL")
    fused_env = env_on("MIL_CONV_SEP_FUSED")
    for tol in (float(tol_env),) if tol_env else (1e-6, 1e-4):
        if fused_env:
            fused = plan_rl_fused(psf, psf_bp, fft_shape, tol=tol)
            if fused is not None:
                return "fused", fused
        pair = plan_sep_pair(psf, psf_bp, fft_shape, tol=tol)
        if pair is not None:
            if (mode == "auto" and not fused_env and _on_cuda(arr)
                    and not sep_auto_takes(pair, _fft_impl(fft_shape, arr))):
                return None
            return "pair", pair
    return None


def _initial(img, const_initial):
    """Clamped image and the starting estimate: the image itself, or the
    constant image SUM (the reference's quirk; one value for every route,
    filled on the device without a host read)."""
    img = img.clamp_min(SMALLVALUE)
    if const_initial:
        return img, torch.empty_like(img).fill_(img.sum())
    return img, img


def _initial_dual(img_a, img_b, const_initial):
    """Clamped views and the dual-view starting estimate: (a + b) / 2, or
    the constant (sum a + sum b) / 2 filled on the device. Sums run over
    the last three axes, so a batch of timepoints gets one per volume."""
    img_a = img_a.clamp_min(SMALLVALUE)
    img_b = img_b.clamp_min(SMALLVALUE)
    if const_initial:
        mean = (img_a.sum(dim=_AXES, keepdim=True)
                + img_b.sum(dim=_AXES, keepdim=True)) / 2
        return img_a, img_b, torch.empty_like(img_a).copy_(
            mean.expand_as(img_a))
    return img_a, img_b, (img_a + img_b) * 0.5


@spanned("mil.rl.loop")
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
            with span("mil.rl.iter"):
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
            with span("mil.rl.iter"):
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
        with span("mil.rl.iter"):
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


def _rl_single_sep_fused(img, plan, n_iters, const_initial, accel=False,
                         stop_tol=None):
    """RL where each iteration is ONE launch of K2 (``rl_iter_fused``).
    The plan has no frame shift, so the image is not pre-rolled."""
    img, est0 = _initial(img, const_initial)

    def step(est):
        return rl_iter_fused(est, img, plan, SMALLVALUE)

    return _rl_loop(step, est0, n_iters, accel, stop_tol)


def _rl_single(img, otf, otf_bp, n_iters, const_initial, fft_impl,
               accel=False, stop_tol=None):
    """RL over FFT convolutions, by K3 (``fft_impl='ct'``) or ``torch.fft``
    (``'torch'``)."""
    conv, (otf, otf_bp) = _convolver(fft_impl, tuple(img.shape), (otf, otf_bp))
    img, est0 = _initial(img, const_initial)

    def step(est):
        ratio = img / conv(est, otf)
        return torch.clamp_min(est * conv(ratio, otf_bp), SMALLVALUE)

    return _rl_loop(step, est0, n_iters, accel, stop_tol)


def rl_decon_single(img, otf, otf_bp, n_iters, const_initial=False,
                    psf=None, psf_bp=None, stop_tol=None, *, device=None):
    """Single-view RL on a pre-padded FFT-grid image; returns the estimate
    on the same grid and device (``decon_singleview_OTF1`` loop,
    reference:src/api_subfunc.cu:3404-3416).

    ``img`` is a float32 tensor, run on its device, or a numpy array, run
    on ``device`` (default cuda:0; ``device="cpu"`` for the CPU). When
    the raw projectors are given (``psf``, optional ``psf_bp``; host
    arrays) and the planner accepts both, the separable route runs;
    otherwise the FFT route, with ``otf``/``otf_bp`` (tensors or numpy
    arrays, e.g. built by the JAX package) or, when they are None, OTFs
    built here from the PSFs."""
    img = _as_tensor(img, resolve_device(img, device))
    shape = tuple(img.shape)
    if psf is not None:
        psf_np = np.asarray(psf, np.float32)
        bp_np = (np.asarray(psf_bp, np.float32) if psf_bp is not None
                 else psf_np[::-1, ::-1, ::-1])
        route = _sep_plans(psf_np, bp_np, shape, img)
        if route is not None:
            kind, plan = route
            if kind == "fused":
                return _rl_single_sep_fused(img, plan, n_iters, const_initial,
                                            _accel_env(), _stop_env(stop_tol))
            return _rl_single_sep(img, *plan, n_iters, const_initial,
                                  _accel_env(), _stop_env(stop_tol))
        if otf is None:
            otf = gen_otf(psf_np, shape, device=img.device)
            otf_bp = gen_otf(bp_np, shape, device=img.device)
    otf = _as_tensor(otf, img.device, torch.complex64)
    otf_bp = _as_tensor(otf_bp, img.device, torch.complex64)
    return _rl_single(img, otf, otf_bp, n_iters, const_initial,
                      _fft_impl(shape, img), _accel_env(), _stop_env(stop_tol))


def _rl_dual_sep(img_a, img_b, fwd_a, bp_a, fwd_b, bp_b, n_iters,
                 const_initial, accel=False, stop_tol=None):
    """Dual-view RL over the separable conv kernel: per iteration view A
    then view B, each a 'ratio' and an 'update' launch of K1."""
    img_a, img_b, est0 = _initial_dual(img_a, img_b, const_initial)

    def half(est, img, fwd, bp):
        ratio = conv3_sep(est, fwd, aux=img, mode="ratio")
        return conv3_sep(ratio, bp, aux=est, mode="update",
                         smallvalue=SMALLVALUE)

    def step(est):
        est = half(est, img_a, fwd_a, bp_a)
        return half(est, img_b, fwd_b, bp_b)

    return _rl_loop(step, est0, n_iters, accel, stop_tol)


def _rl_dual_sep_fused(img_a, img_b, plan_a, plan_b, n_iters, const_initial,
                       accel=False, stop_tol=None):
    """Dual-view RL where each view's half-iteration is ONE launch of K2:
    two launches per iteration, view A then view B."""
    img_a, img_b, est0 = _initial_dual(img_a, img_b, const_initial)

    def step(est):
        est = rl_iter_fused(est, img_a, plan_a, SMALLVALUE)
        return rl_iter_fused(est, img_b, plan_b, SMALLVALUE)

    return _rl_loop(step, est0, n_iters, accel, stop_tol)


def _as_pair(route):
    """A route's (fwd, bp) K1 plans: a fused plan holds both."""
    kind, plan = route
    return plan if kind == "pair" else (plan.fwd, plan.bp)


def _rl_dual(img_a, img_b, otf_a, otf_b, otf_bp_a, otf_bp_b, n_iters,
             const_initial, fft_impl, accel=False, stop_tol=None):
    """Dual-view RL over FFT convolutions (K3 or ``torch.fft``): view A
    then view B per iteration. A leading batch axis on the views runs a
    group of timepoints at once (``torch.fft`` only)."""
    conv, (otf_a, otf_b, otf_bp_a, otf_bp_b) = _convolver(
        fft_impl, tuple(img_a.shape[-3:]), (otf_a, otf_b, otf_bp_a, otf_bp_b))
    img_a, img_b, est0 = _initial_dual(img_a, img_b, const_initial)

    def half(est, img, otf, otf_bp):
        ratio = img / conv(est, otf)
        return torch.clamp_min(est * conv(ratio, otf_bp), SMALLVALUE)

    def step(est):
        est = half(est, img_a, otf_a, otf_bp_a)
        return half(est, img_b, otf_b, otf_bp_b)

    return _rl_loop(step, est0, n_iters, accel, stop_tol)


def rl_decon_dual(img_a, img_b, otf_a, otf_b, otf_bp_a, otf_bp_b, n_iters,
                  const_initial=False, psf_a=None, psf_b=None,
                  psf_bp_a=None, psf_bp_b=None, stop_tol=None, *, device=None):
    """Joint dual-view RL on pre-padded FFT-grid views: view A then view B
    per iteration (``decon_dualview_OTF1``, reference:src/api_subfunc.cu:
    3634-3660). Returns the estimate on the grid and device of ``img_a``:
    a tensor's own device, or for a numpy array ``device`` (default
    cuda:0; ``device="cpu"`` for the CPU).

    With the raw projectors (``psf_a``/``psf_b``, optional unmatched
    ``psf_bp_a``/``psf_bp_b``; host arrays) the separable route runs when
    the planner accepts all four; otherwise the FFT route, with the given
    OTFs (tensors or numpy arrays, e.g. built by the JAX package) or, when
    ``otf_a`` is None, all four built here from the PSFs."""
    img_a = _as_tensor(img_a, resolve_device(img_a, device))
    img_b = _as_tensor(img_b, img_a.device)
    shape = tuple(img_a.shape)
    if psf_a is not None and psf_b is not None:
        pa = np.asarray(psf_a, np.float32)
        pb = np.asarray(psf_b, np.float32)
        bpa = (np.asarray(psf_bp_a, np.float32) if psf_bp_a is not None
               else pa[::-1, ::-1, ::-1])
        bpb = (np.asarray(psf_bp_b, np.float32) if psf_bp_b is not None
               else pb[::-1, ::-1, ::-1])
        route_a = _sep_plans(pa, bpa, shape, img_a)
        route_b = _sep_plans(pb, bpb, shape, img_a) if route_a is not None else None
        if route_b is not None:
            if route_a[0] == route_b[0] == "fused":
                return _rl_dual_sep_fused(img_a, img_b, route_a[1],
                                          route_b[1], n_iters, const_initial,
                                          _accel_env(), _stop_env(stop_tol))
            # mixed fused/pair (one view's pick carries per-tap rolls, which
            # K2 does not take): both views run as K1 pairs
            return _rl_dual_sep(img_a, img_b, *_as_pair(route_a),
                                *_as_pair(route_b), n_iters, const_initial,
                                _accel_env(), _stop_env(stop_tol))
        if otf_a is None:
            otf_a, otf_b, otf_bp_a, otf_bp_b = (
                gen_otf(p, shape, device=img_a.device)
                for p in (pa, pb, bpa, bpb))
    otfs = [_as_tensor(o, img_a.device, torch.complex64)
            for o in (otf_a, otf_b, otf_bp_a, otf_bp_b)]
    return _rl_dual(img_a, img_b, *otfs, n_iters, const_initial,
                    _fft_impl(shape, img_a), _accel_env(), _stop_env(stop_tol))


# --------------------------------------------------------------------------
# Memory mode (the reference's gpuMemMode, reference:src/api_decon.cpp:
# 111-135): 1 device-resident, 2 host-staged streaming
# (models/decon_streamed.py)
# --------------------------------------------------------------------------

def _workingset_bytes(fft_shape, dual=False):
    """Device-resident working set of the RL loop on the FFT grid: ~9
    grid-sized float32 buffers for dual view, ~6 for single view, the
    tiers the reference sizes its probe against
    (reference:src/api_decon.cpp:402-413)."""
    vol = fft_shape[0] * fft_shape[1] * fft_shape[2] * 4
    return (9 if dual else 6) * vol


def hbm_budget_bytes(device=None):
    """Free device memory in bytes, the budget of the memory tiers:
    ``MIL_HBM_BUDGET_MB`` when set (to test the tiering deterministically,
    or to act as a smaller card), else the free memory of the CUDA
    ``device`` (default cuda:0): ``torch.cuda.mem_get_info`` (the
    reference's ``cudaMemGetInfo``) plus what PyTorch's caching allocator
    holds there unused; None for the CPU."""
    env = os.environ.get("MIL_HBM_BUDGET_MB")
    if env:
        return float(env) * 1048576.0
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type != "cuda":
        return None
    device = require_cuda(device)
    with span("mil.mem_query"):
        return float(torch.cuda.mem_get_info(device)[0]
                     + torch.cuda.memory_reserved(device)
                     - torch.cuda.memory_allocated(device))


def _resolve_mem_mode(mem_mode, fft_shape, dual, device, verbose=False):
    """(mode, torch.device) for ``mem_mode`` (the reference's gpuMemMode,
    reference:src/api_decon.cpp:111-135): 0 the CPU; 1 device-resident and
    2 host-staged streaming, both on ``device`` (default cuda:0;
    ``device="cpu"`` runs them on the CPU); -1 mode 1 when the working set
    fits 0.92 of :func:`hbm_budget_bytes`, else mode 2 (mode 1 when there
    is no budget: the CPU without ``MIL_HBM_BUDGET_MB``)."""
    if mem_mode == 0:
        return 0, torch.device("cpu")
    if mem_mode not in (-1, 1, 2):
        raise ValueError(f"Invalid memory mode {mem_mode}")
    device = resolve_device(None, device)
    if mem_mode != -1:
        return int(mem_mode), device
    budget = hbm_budget_bytes(device)
    if budget is None:
        return 1, device
    need = _workingset_bytes(fft_shape, dual)
    mode = 1 if need <= budget * 0.92 else 2
    if verbose and mode == 2:
        print(f"...device memory budget {budget/1048576:.0f} MB below the "
              f"{need/1048576:.0f} MB working set: host-staged streaming mode")
    return mode, device


def _host_np(x):
    """A float32 numpy view or copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _finish_records(records, mode, device, t0, t1, t2, t3):
    if records is not None:
        records[0] = mode
        records[4] = free_memory_mb(device)
        records[5] = free_memory_mb(device)
        records[6] = t1 - t0
        records[7] = t2 - t1
        records[8] = t3 - t2
        records[9] = t3 - t0


# --------------------------------------------------------------------------
# Full entry (host orchestration, numpy in/out)
# --------------------------------------------------------------------------

def _fft_grid(shape_zyx, tpu_friendly=True):
    return tuple(snap_fft_size(int(s), tpu_friendly) for s in shape_zyx)


@spanned("mil.decon")
def decon_singleview(img, psf, n_iters=20, const_initial=False, psf_bp=None,
                     device=None, mem_mode=-1, verbose=False, records=None,
                     tpu_friendly_fft=True):
    """Single-view RL deconvolution, full pipeline
    (``decon_singleview``, reference:src/api_decon.cpp:53-331).

    img, psf: (z, y, x) arrays (img may be a tensor). ``psf_bp`` switches
    to the unmatched back projector (reference ``flagUnmatch``);
    otherwise the back projector is the flipped PSF. Returns the
    deconvolved volume with img's shape as float32 numpy. In memory mode
    1 on CUDA the array lies in pinned host memory from torch's caching
    host allocator (:func:`~microimagelib_tpu_torch.utils.trace.to_host`),
    the caller's own until dropped, when its block goes back to the
    allocator for the next result; a live result holds its size rounded
    up to a power of two (a 512^3 float32 volume is 2^29 bytes, a block of
    its own size; a (320, 512, 320) one, 210 MB, takes 256 MiB).

    ``records`` (len-10, optional) is filled with the reference telemetry
    layout: [0] memory mode used, [1..5] free device memory snapshots MB
    (-1 on the CPU), [6..9] init/preproc/decon/total seconds
    (reference:src/api_decon.cpp:56-59).

    ``mem_mode`` (:func:`_resolve_mem_mode`): 0 the CPU; 1 device-resident
    on ``device`` (a ``torch.device``, default cuda:0); 2 host-staged
    streaming through ``device`` (``models/decon_streamed.py``: the device
    holds one chunk at a time); -1 mode 1 when the working set fits the
    device memory budget (:func:`hbm_budget_bytes`), else mode 2."""
    t0 = time.time()
    img_shape = tuple(img.shape)
    psf_np = np.asarray(psf, dtype=np.float32)
    fft_shape = _fft_grid(img_shape, tpu_friendly_fft)
    if verbose:
        print(f"...Image size {img_shape[2]} x {img_shape[1]} x {img_shape[0]}")
        print(f"...PSF size {psf_np.shape[2]} x {psf_np.shape[1]} x {psf_np.shape[0]}")
        print(f"...FFT size {fft_shape[2]} x {fft_shape[1]} x {fft_shape[0]}")
    mode, device = _resolve_mem_mode(mem_mode, fft_shape, False, device, verbose)
    if records is not None:
        records[1] = free_memory_mb(device)
    bp_np = np.asarray(psf_bp, np.float32) if psf_bp is not None else None

    if mode == 2:
        img_np = _host_np(img)
        t1 = time.time()
        padded = (np_pad_stack_edge(img_np, fft_shape)
                  if fft_shape != img_shape else img_np)
        t2 = time.time()
        if records is not None:
            records[2] = free_memory_mb(device)
        est = rl_decon_single_streamed(
            padded, psf_np, bp_np if bp_np is not None else psf_np[::-1, ::-1, ::-1],
            n_iters, const_initial, budget_bytes=hbm_budget_bytes(device),
            device=device)
        if records is not None:
            records[3] = free_memory_mb(device)
        out_np = np_crop_center(est, img_shape).copy()
        _finish_records(records, 2, device, t0, t1, t2, time.time())
        return out_np

    img_t = _as_tensor(img, device)
    t1 = time.time()

    padded = (pad_stack_edge(img_t, fft_shape)
              if fft_shape != img_shape else img_t)
    t2 = time.time()
    if records is not None:
        records[2] = free_memory_mb(device)

    est = rl_decon_single(padded, None, None, n_iters, const_initial,
                          psf=psf_np, psf_bp=bp_np)
    if records is not None:
        records[3] = free_memory_mb(device)
    out = crop_center(est, img_shape) if fft_shape != img_shape else est
    out_np = to_host(out)
    _finish_records(records, mode, device, t0, t1, t2, time.time())
    return out_np


@spanned("mil.decon")
def decon_dualview(img_a, img_b, psf_a, psf_b, n_iters=10, const_initial=False,
                   psf_bp_a=None, psf_bp_b=None, device=None, mem_mode=-1,
                   verbose=False, records=None, tpu_friendly_fft=True):
    """Joint dual-view RL deconvolution, full pipeline
    (``decon_dualview``, reference:src/api_decon.cpp:333-704). The views
    must share a shape (validated like reference:src/decon_dv.cpp:
    167-188). Unmatched back projectors apply only when BOTH are given,
    matching the reference's single ``flagUnmatch``; otherwise each view
    back-projects with its flipped PSF. Returns float32 numpy with the
    views' shape, in pinned host memory in memory mode 1 on CUDA, as in
    :func:`decon_singleview`. ``records`` and ``mem_mode`` as there
    (``verbose`` prints only the streaming mode's line, as in the JAX
    package)."""
    t0 = time.time()
    shape_a = tuple(img_a.shape)
    shape_b = tuple(img_b.shape)
    if shape_a != shape_b:
        raise ValueError(f"Dual-view images must match in size: {shape_a} vs {shape_b}")
    psf_a_np = np.asarray(psf_a, dtype=np.float32)
    psf_b_np = np.asarray(psf_b, dtype=np.float32)
    fft_shape = _fft_grid(shape_a, tpu_friendly_fft)
    mode, device = _resolve_mem_mode(mem_mode, fft_shape, True, device, verbose)
    if records is not None:
        records[1] = free_memory_mb(device)
    unmatch = psf_bp_a is not None and psf_bp_b is not None
    bp_a = np.asarray(psf_bp_a, np.float32) if unmatch else None
    bp_b = np.asarray(psf_bp_b, np.float32) if unmatch else None

    if mode == 2:
        views = [_host_np(v) for v in (img_a, img_b)]
        t1 = time.time()
        pads = [np_pad_stack_edge(v, fft_shape) if fft_shape != shape_a else v
                for v in views]
        del views
        t2 = time.time()
        if records is not None:
            records[2] = free_memory_mb(device)
        est = rl_decon_dual_streamed(
            *pads, psf_a_np, psf_b_np,
            bp_a if unmatch else psf_a_np[::-1, ::-1, ::-1],
            bp_b if unmatch else psf_b_np[::-1, ::-1, ::-1],
            n_iters, const_initial, budget_bytes=hbm_budget_bytes(device),
            device=device)
        if records is not None:
            records[3] = free_memory_mb(device)
        out_np = np_crop_center(est, shape_a).copy()
        _finish_records(records, 2, device, t0, t1, t2, time.time())
        return out_np

    img_a = _as_tensor(img_a, device)
    img_b = _as_tensor(img_b, device)
    t1 = time.time()

    pad_a = pad_stack_edge(img_a, fft_shape) if fft_shape != shape_a else img_a
    pad_b = pad_stack_edge(img_b, fft_shape) if fft_shape != shape_a else img_b
    t2 = time.time()
    if records is not None:
        records[2] = free_memory_mb(device)

    est = rl_decon_dual(pad_a, pad_b, None, None, None, None, n_iters,
                        const_initial, psf_a=psf_a_np, psf_b=psf_b_np,
                        psf_bp_a=bp_a, psf_bp_b=bp_b)
    if records is not None:
        records[3] = free_memory_mb(device)
    out = crop_center(est, shape_a) if fft_shape != shape_a else est
    out_np = to_host(out)
    _finish_records(records, mode, device, t0, t1, t2, time.time())
    return out_np


def decon_dualview_prepared(pad_a, pad_b, otf_a, otf_b, otf_bp_a, otf_bp_b,
                            n_iters, const_initial, out_shape):
    """Batch-mode fast path: views already padded to the FFT grid and
    precomputed OTFs, reused across timepoints (the reference's
    ``decon_dualview_batch`` with precomputed OTFs,
    reference:src/api_decon.cpp:707-985). Returns a tensor on the views'
    device, cropped to ``out_shape``."""
    est = rl_decon_dual(pad_a, pad_b, otf_a, otf_b, otf_bp_a, otf_bp_b,
                        n_iters, const_initial)
    if tuple(out_shape) != tuple(est.shape):
        est = crop_center(est, out_shape)
    return est


def decon_dualview_prepared_batch(pads_a, pads_b, otf_a, otf_b, otf_bp_a,
                                  otf_bp_b, n_iters, const_initial,
                                  out_shape):
    """Grouped batch decon: a GROUP of prepared timepoints, pads_* of shape
    (g, z, y, x) on the FFT grid, runs through one RL loop batched over the
    leading axis — one launch sequence instead of one per timepoint
    (reference:src/spim_fusion_batch.cpp:613-627). Returns a (g, *out_shape)
    tensor. Groups convolve with ``torch.fft``: K3 takes one volume, and the
    JAX package likewise keeps groups off its Pallas kernel."""
    return _rl_dual_batch(pads_a, pads_b, otf_a, otf_b, otf_bp_a, otf_bp_b,
                          n_iters, const_initial, tuple(out_shape))


def _rl_dual_batch(pads_a, pads_b, otf_a, otf_b, otf_bp_a, otf_bp_b,
                   n_iters, const_initial, out_shape):
    pads_a = _as_tensor(pads_a)
    pads_b = _as_tensor(pads_b, pads_a.device)
    otfs = [_as_tensor(o, pads_a.device, torch.complex64)
            for o in (otf_a, otf_b, otf_bp_a, otf_bp_b)]
    est = _rl_dual(pads_a, pads_b, *otfs, n_iters, const_initial, "torch")
    if tuple(out_shape) != tuple(est.shape[1:]):
        est = crop_center(est, out_shape)
    return est
