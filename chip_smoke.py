#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``microimagelib_tpu_torch/csrc/``
with nvcc (sm_90a, one nvcc per source, in parallel), then:

  1. compares the separable-conv kernel (K1, one launch a call) with its
     plain PyTorch version on the card, in all three epilogue modes, for
     six PSF/grid cases (max|diff| <= 1e-5 * max|ref|: both are fp32 FMAs,
     only the summation order differs), checks that two launches and each
     of the kernel's measurement switches give the same bits, and that the
     compiled launch plan is the host's;
  2. runs ``decon_singleview`` on a 512^3 volume with the 9^3 Gaussian
     PSF of bench.py, 10 iterations, on the separable route
     (MIL_CONV_SEP=1), and checks it against the ``torch.fft`` route
     (rtol 2e-4, atol 2e-4 * max) and that K1 launched exactly 20 times;
     prints the route MIL_CONV_SEP=auto takes there, K1's launch plan,
     registers and resident blocks, the peak device memory of one K1 call,
     its time against the z-shaped K7 copy at 512^3 and the time of each
     measurement switch;
  3. the same for a 45-degree tilted (17, 9, 25) PSF on a (256, 512, 512)
     volume (rank > 1 with per-tap rolls; rtol/atol 5e-4);
  4. runs the deconSingleView CLI on a 200 x 512 x 512 16-bit TIFF (on
     the route auto takes);
  5. compares the FFT-convolution kernel (K3) with complex128
     ``torch.fft`` and with its fp32 plain version at ten grids, odd
     factors 3 and 5 among them and 128, 256, 320 and 512 on every axis
     (max|diff| <= 1e-4 * max|ref|), checking that the kernel's radix
     plans and spectrum pitch are the host's and which axes took the
     length-specialised transforms; at (320, 512, 512) the five launches'
     device times (torch.profiler), each against the bytes it must move
     and the z-shaped K7 copy's rate, and each kernel's registers, shared
     bytes and resident blocks; then K3 against ``torch.fft`` on a ladder
     of eleven grids and the voxel count from which K3 wins on those whose
     every axis takes the specialised transform;
  6. runs ``decon_dualview`` on two (320, 512, 512) views with
     anisotropic 25^3 PSFs and Wiener-Butterworth back projectors, 2
     iterations, MIL_FFT_IMPL=pallas: exactly 8 K3 calls, no K1 launch,
     and within 2e-3 of the same run on ``torch.fft``;
  7. the same views with matched (flipped) PSFs, 10 iterations: the
     separable route (MIL_CONV_SEP=1), exactly 40 K1 launches, within 2e-4
     of the FFT route; the route auto takes;
  8. the genBackProjector and deconDualView CLIs on two 200 x 512 x 512
     16-bit TIFFs (grid (256, 512, 512), MIL_FFT_IMPL=pallas, so K3 runs);
  9. compares the registration kernels K5 (resample + NCC sums) and K4
     (the sums and their gradient in the matrix) with their plain
     versions at the five levels of Phase 10's pyramid and the fusion's
     (320, 512, 320), five matrices (ss, st within rtol 1e-5; gs, gt
     within 2e-4 x max|ref|; two launches bit for bit), checks that the
     compiled launch plan is the host's, that no instantiation spills and
     that a call launches one kernel, and prints per level the plan,
     registers, device time per launch, ms per call back to back, the
     wrapper's host microseconds per call and the bound;
 10. registers a (256, 512, 512) bead volume with its copy moved by the
     reg128 matrix of bench_all.py: ``reg3d``, choice 2, method 7, the
     automatic pyramid, default knobs. Checks NCC >= 0.95, the matrix
     within 0.5 voxel of the truth over the central half-box, K4 and K5
     launched at every level and no plain-version call; prints each
     level's evaluations, launches, K4/K5 device time per launch, kernel
     ms and host share. Then the same pipeline at (128, 256, 256) on the kernels and
     on ``MIL_NCC_IMPL=gather``: NCC within 1e-3, translations within
     0.35 voxel;
 11. the reg3D CLI on two 200 x 512 x 512 16-bit TIFFs, -regc 2 -affm 7
     -bit 16 -otmx;
 12. compares the one-launch RL iteration kernel (K2) with its plain
     version (max|diff| <= 2e-5 x max|ref|) and with a K1 ratio launch
     followed by a K1 update launch (bit for bit) for the 9^3 bench PSF,
     the fusion PSFs (z reach 12 for view A, x reach 12 for view B) and a
     rank-2 pair at (64, 128, 128), (37, 96, 160), (83, 96, 160) (view A
     in 8-plane groups, the ratio in its ring) and (320, 512, 320); two
     launches give identical bits; the compiled plan is the host's; prints
     each launch's plan (groups, ratio store, grid), registers and spills;
     at the fusion grid times K2 against the K1 pair, prints the peak
     device memory of one call of each and checks that the ratio store is
     smaller than a volume;
 13. compares the N-probe NCC kernel (K6) with K5 (each probe bit for bit)
     and with its plain version (rtol 1e-5) for 8 probes along a line plus
     a 35-degree probe at every level shape of Phase 14's registration
     ((10, 16, 320) ... (320, 512, 320)) and at the five pyramid shapes of
     Phase 10, and times one 8-probe call against 8 K5 calls; K6's numbers
     in the kernels line are those of the largest level where Phase 14
     launched it;
 14. runs ``fusion_dualview`` at full width: bead truth on the isotropic
     (320, 512, 320) grid, view A blurred along z and view B moved by the
     reg128 matrix, blurred along x and rotated, both sampled to raw
     (52, 512, 320) at 0.1625 / 1.0 um pixels; choice 2, method 7,
     matched PSFs, 10 iterations; (a) with MIL_CONV_SEP_FUSED=1
     MIL_REG_BATCH_LS=1 (20 K2 launches, no K1 launch, K6 launched, no
     plain call), (b) with both off (40 K1 launches or 40 K3 calls, as
     auto's route for the fusion PSFs says); (a) against (b): NCC within
     1e-3, matrices within 0.5 voxel; each within FUSION_TRUTH_VOXELS of
     the true matrix and at least the true matrix's NCC on the
     registration's own cost (the CPU test against the JAX package sets
     the distance); the decon of one registered pair with and without K2
     within 2e-4; per-step wall times, ms per dual-view iteration on K2,
     the K1 pair, K3 and ``torch.fft``, and per pyramid level the syncs,
     evaluations, device time per launch and host share with and without
     K6;
 15. the spimFusion CLI on the same views as 16-bit TIFFs, -bit 16 -otmx,
     with K2 and K6 on;
 16. compares the copy in K1's launch shapes (K7) with its plain version,
     bit for bit, in both geometries at 512^3 (shift 4) and at five
     smaller shapes, two of them off the chunk multiples and one with an
     nx that is not a multiple of 4; two launches
     give identical bits; holds it against ``torch.add(aux, v,
     alpha=1e-6)`` (within 1 ulp: that call need not round as one FMA)
     and times the three; then runs
     the roofline tool (``microimagelib_tpu_torch.tools.conv_roofline``)
     at 512^3 in-process, prints its lines and checks it printed every
     metric, each finite and positive, and that K1 and K7 launched in its
     run.

It prints the card's name and power limit beside every time, ms per RL
iteration for the K1, K2, K3 and ``torch.fft`` routes, one JSON line
describing each kernel (its time, its plain version's, the least time the
card could take for the same work and the time of the nearest PyTorch
library call), and as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
then nonzero and that line is not printed. Needs one CUDA device; there
is no CPU path.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from microimagelib_tpu_torch.cli import decon_dv, decon_sv, gen_bp, reg3d as reg3d_cli
from microimagelib_tpu_torch.cli import spim_fusion as fusion_cli
from microimagelib_tpu_torch.io.tiff import readtifstack, readtifstack_16to16, writetifstack
from microimagelib_tpu_torch.io.tmx import read_tmx
from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.kernels import fft_ct as F
from microimagelib_tpu_torch.kernels import pipe_copy as P
from microimagelib_tpu_torch.kernels import rl_fused as KF
from microimagelib_tpu_torch.models import deconvolution as D
from microimagelib_tpu_torch.models import fusion as FU
from microimagelib_tpu_torch.models import gen_backprojector
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.ops.affine import affine_transform_3d
from microimagelib_tpu_torch.ops.basics import rot_by_y_axis
from microimagelib_tpu_torch.ops.conv_sep import plan_rl_fused, plan_sep
from microimagelib_tpu_torch.ops.matrix import dof_to_matrix
from microimagelib_tpu_torch.ops.resample import resize3d_separable
from microimagelib_tpu_torch.tools import conv_roofline

SEED = 0
N_ITERS = 10
DUAL_SHAPE = (320, 512, 512)
WB_ITERS = 2          # Guo 2020's count with Wiener-Butterworth projectors
REG_SHAPE = (256, 512, 512)
REG_DOF = [2.0, -1.5, 1.0, 2.0, -1.0, 1.5, 1, 1, 1]   # bench_all.py:122
FUSION_SHAPE = (320, 512, 320)   # isotropic grid of the diSPIM views
FUSION_RAW = (52, 512, 320)      # raw views: 1.0 um steps, 0.1625 um pixels
FUSION_PIXEL = (0.1625, 0.1625, 1.0)
# the truth gate of Phase 14 (voxels from the true matrix over the central
# half-box): on these views at a reduced geometry both the port and the
# JAX package land 2.6-2.7 voxels off (tests/test_torch_fusion.py, CPU),
# rounded up to 3 for their spread from run to run
FUSION_TRUTH_VOXELS = 3.0
LADDER = (-2.618, -1.0, -0.382, 0.382, 1.0, 1.618, 2.618, 4.236)
# K2's small grids: the second with nz not a multiple of 8; the third with
# 8-plane groups, so that the ratio lives in the ring at nz off the group
K2_SMALL = ((64, 128, 128), (37, 96, 160), (83, 96, 160))
# Phase 10's pyramid level shapes (x = 128, 256, 512), which Phase 13 checks
# K6 at beside the fusion's own levels
REG_LEVELS = ((16, 32, 128), (32, 64, 256), (64, 128, 512), (128, 256, 512),
              REG_SHAPE)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# fp32 operations per valid voxel, counted from csrc/corr.cu: coordinates
# 6, box 6, floor and fractions 6, seven lerps 21, ss/st 4 (K5); the three
# derivative lerps 19 and the gradient sums 24 on top (K4)
CORR_OPS = {False: 43, True: 86}
# K7's (shape, shift) cases: the roofline's 512^3 with the bench plan's z
# reach; two shapes off the 8-plane run and the 1024-vector chunk, the last
# with nz - 1; one chunk; the TPU's shift at the CPU test's shape; an nx
# that is not a multiple of 4 (4-byte accesses)
PIPE_COPY_CASES = (((512, 512, 512), 4), ((24, 40, 100), 0), ((37, 96, 160), 36),
                   ((8, 16, 64), 0), ((32, 128, 128), 8), ((9, 7, 301), 3))


def gauss3(p, s):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    k = np.exp(-z[:, None, None] ** 2 / (2 * s[0] ** 2)
               - y[None, :, None] ** 2 / (2 * s[1] ** 2)
               - x[None, None, :] ** 2 / (2 * s[2] ** 2))
    return (k / k.sum()).astype(np.float32)


def bench_psf():
    """The 9^3 Gaussian of bench.py."""
    zz, yy, xx = np.meshgrid(*[np.arange(9) - 4] * 3, indexing="ij")
    psf = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 4.5).astype(np.float32)
    return psf / psf.sum()


def tilted_psf(p=(17, 9, 25), sl=4.0, ss=1.2, st=1.2):
    """Anisotropic Gaussian tilted 45 degrees in the z-x plane: the
    measured light-sheet PSF class (as tests/test_conv_sep.py builds it)."""
    z, y, x = (np.arange(n) - n // 2 for n in p)
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
    u, w = (xx + zz) / np.sqrt(2.0), (xx - zz) / np.sqrt(2.0)
    k = np.exp(-u ** 2 / (2 * sl ** 2) - w ** 2 / (2 * ss ** 2)
               - yy ** 2 / (2 * st ** 2))
    return (k / k.sum()).astype(np.float32)


def flip(p):
    return np.ascontiguousarray(p[::-1, ::-1, ::-1])


@contextlib.contextmanager
def env(**kw):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up call, timed
    with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def alone_cuda_ms(fn, reps):
    """Mean ms of ``fn`` with the device idle before each call (CUDA events
    around each call alone), after one warm-up call."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def check_close(name, out, ref, rtol, atol_rel):
    out, ref = np.asarray(out), np.asarray(ref)
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {out.shape} != {ref.shape}")
    if not np.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    m = float(np.abs(ref).max())
    err = np.abs(out - ref)
    bad = err > atol_rel * m + rtol * np.abs(ref)
    print(f"  {name}: max|diff| {err.max():.6g} = {err.max() / m:.3g} x max|ref| "
          f"(rtol {rtol}, atol {atol_rel} x max)")
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} voxels out of tolerance")


def bound(nbytes, ops):
    """(ms, 'bytes' | 'operations'): the least time the card could take —
    the larger of the bytes over the memory rate and the fp32 operations
    over the fp32 rate (H100 SXM data sheet)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t = time.time()
    lib_path = build.build()
    print(f"built {lib_path.relative_to(build.BUILD_ROOT.parent.parent)} "
          f"in {time.time() - t:.1f} s")
    rng = np.random.default_rng(SEED)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- Phase 1: K1 against its plain version on the card -------------
    print("Phase 1: conv3_sep kernel vs conv3_sep_torch on the card")
    cases = [
        ("a bench 9^3 gaussian", bench_psf(), (64, 128, 128), {}),
        ("b tilted (17,9,25) + rolls", tilted_psf(), (32, 64, 256),
         dict(align=True, tol=1e-4)),
        ("c even 8^3", gauss3((8, 8, 8), (1.2, 1.2, 1.2)), (32, 64, 128), {}),
        ("d oversized (5,41,9) on ny=32", gauss3((5, 41, 9), (1.0, 4.0, 1.5)),
         (32, 32, 128), {}),
        ("e nx=100 (not /128)", bench_psf(), (24, 40, 100), {}),
        ("f fusion A 25 z taps, nz=37", fusion_psfs()[0], (37, 64, 96), {}),
    ]
    for name, psf, shape, kw in cases:
        plan = plan_sep(psf, shape, **kw)
        if plan is None:
            raise AssertionError(f"{name}: planner refused")
        if "rolls" in name and plan.rolls is None:
            raise AssertionError(f"{name}: no per-tap rolls planned")
        v = on_card(rng.random(shape, dtype=np.float32) * 100)
        aux = on_card(rng.random(shape, dtype=np.float32) + 0.5)
        host, compiled = K.plan_of(plan), k1_kernel_plan(plan)
        if host != compiled:
            raise AssertionError(f"{name}: kernel plan {compiled}, host {host}")
        for mode in ("plain", "ratio", "update"):
            before = K.LAUNCHES
            out = K.conv3_sep(v, plan, aux=aux, mode=mode)
            torch.cuda.synchronize()
            if K.LAUNCHES != before + 1:
                raise AssertionError(f"{name} {mode}: launch count did not rise")
            ref = K.conv3_sep_torch(v, plan, aux=aux, mode=mode)
            check_close(f"{name} rank {plan.rank} {mode}", out.cpu(), ref.cpu(),
                        0.0, 1e-5)
            for flags in K1_FORCED:
                if not torch.equal(out.view(torch.int32), K.conv3_sep(
                        v, plan, aux=aux, mode=mode, flags=flags).view(torch.int32)):
                    raise AssertionError(f"{name} {mode}: switches {flags} change the bits")
        print(f"  {name}: plan {host}; two launches and the forced ring-less and "
              f"generic paths give the same bits")

    # ---- Phase 2: the headline configuration ---------------------------
    print(f"Phase 2: decon_singleview 512^3, bench PSF, {N_ITERS} iterations")
    psf = bench_psf()
    img = rng.random((512, 512, 512), dtype=np.float32) * 100 + 1
    with env(MIL_CONV_SEP="1"):
        fwd, bp = D._sep_plans(psf, flip(psf), img.shape)[1]
    route2 = auto_route([psf], img.shape, dev)
    print(f"  MIL_CONV_SEP=auto takes the {route2} route here (tap cost "
          f"{D.tap_cost(fwd)}, ceilings {D.SEP_MAX_TAP_COST})")
    if route2 != "separable":
        raise AssertionError(f"the default 512^3 decon takes the {route2} route, not K1")
    img_d = on_card(img)
    imgc = img_d.clamp_min(D.SMALLVALUE)
    est = imgc * 1.0
    kern = {}
    for mode, plan, aux in (("ratio", fwd, imgc), ("update", bp, est)):
        out = K.conv3_sep(est, plan, aux=aux, mode=mode)
        ref = K.conv3_sep_torch(est, plan, aux=aux, mode=mode)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check_close(f"K1 512^3 {mode}", out.cpu(), ref.cpu(), 0.0, 1e-5)
        kern[mode] = err
        del out, ref
    k_ms = cuda_ms(lambda: K.conv3_sep(est, fwd, aux=imgc, mode="ratio"), 20)
    p_ms = cuda_ms(lambda: K.conv3_sep_torch(est, fwd, aux=imgc, mode="ratio"), 3)
    print(f"  K1 at 512^3 (ratio mode): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
          f"[{card}]")
    k1_report(est, fwd, imgc, k_ms, card, "512^3")
    k1_lib_ms = conv3d_library_ms(est, psf, fwd, card)
    n_vox = est.numel()
    taps = fwd.nsteps + fwd.ty.shape[1] + fwd.tx.shape[1]
    k1_bound = bound(3 * 4 * n_vox, n_vox * (2 * fwd.rank * taps + 1))

    K.LAUNCHES = 0
    rec = np.zeros(10)
    with env(MIL_CONV_SEP="1"):
        out_k = D.decon_singleview(img, psf, n_iters=N_ITERS, device=dev,
                                   mem_mode=1, records=rec)
    main_launches = K.LAUNCHES
    print(f"  separable route: {main_launches} K1 launches, decon {rec[8]:.3f} s, "
          f"total {rec[9]:.3f} s (records {rec.tolist()})")
    if main_launches != 2 * N_ITERS:
        raise AssertionError(f"expected {2 * N_ITERS} K1 launches, got {main_launches}")
    with env(MIL_CONV_SEP="0", MIL_FFT_IMPL="xla"):
        out_f = D.decon_singleview(img, psf, n_iters=N_ITERS, device=dev, mem_mode=1)
    if K.LAUNCHES != main_launches:
        raise AssertionError("the FFT route launched K1")
    check_close("512^3 separable vs torch.fft route", out_k, out_f, 2e-4, 2e-4)
    del out_k, out_f, est
    iter_ms = rl_iteration_ms(img_d, psf, fwd, bp, card, "512^3")
    check_auto_route(route2, img.shape, dev, iter_ms["kernel_route"], iter_ms["k3_route"],
                     iter_ms["torch_fft_route"], "512^3")
    route_ladder(img_d, iter_ms, card)
    del img_d, imgc

    # ---- Phase 3: the measured-PSF class -------------------------------
    print(f"Phase 3: decon_singleview (256, 512, 512), tilted PSF, {N_ITERS} iterations")
    tpsf = tilted_psf()
    img3 = rng.random((256, 512, 512), dtype=np.float32) * 100 + 1
    with env(MIL_CONV_SEP="1"):
        fwd3, bp3 = D._sep_plans(tpsf, flip(tpsf), img3.shape)[1]
    route3 = auto_route([tpsf], img3.shape, dev)
    print(f"  plans: fwd rank {fwd3.rank}, {fwd3.nsteps} z taps, "
          f"{fwd3.ty.shape[1]} y, {fwd3.tx.shape[1]} x taps, rolls "
          f"{fwd3.rolls is not None}; bp rank {bp3.rank}; MIL_CONV_SEP=auto takes the "
          f"{route3} route (tap cost {D.tap_cost(fwd3)})")
    if fwd3.rank < 2 or fwd3.rolls is None or bp3.rolls is None:
        raise AssertionError("the tilted PSF did not plan at rank > 1 with rolls")
    K.LAUNCHES = 0
    with env(MIL_CONV_SEP="1"):
        out_k = D.decon_singleview(img3, tpsf, n_iters=N_ITERS, device=dev, mem_mode=1)
    if K.LAUNCHES != 2 * N_ITERS:
        raise AssertionError(f"expected {2 * N_ITERS} K1 launches, got {K.LAUNCHES}")
    with env(MIL_CONV_SEP="0", MIL_FFT_IMPL="xla"):
        out_f = D.decon_singleview(img3, tpsf, n_iters=N_ITERS, device=dev, mem_mode=1)
    check_close("tilted separable vs torch.fft route", out_k, out_f, 5e-4, 5e-4)
    del out_k, out_f
    img3_d = on_card(img3)
    est3 = img3_d.clamp_min(D.SMALLVALUE)
    out = K.conv3_sep(est3, fwd3, aux=est3, mode="ratio")
    ref = K.conv3_sep_torch(est3, fwd3, aux=est3, mode="ratio")
    check_close("K1 tilted (256,512,512) ratio", out.cpu(), ref.cpu(), 0.0, 1e-5)
    del out, ref
    k3_ms = cuda_ms(lambda: K.conv3_sep(est3, fwd3, aux=est3, mode="ratio"), 10)
    p3_ms = cuda_ms(lambda: K.conv3_sep_torch(est3, fwd3, aux=est3, mode="ratio"), 2)
    print(f"  K1 at (256,512,512) tilted rank {fwd3.rank} (ratio mode): kernel "
          f"{k3_ms:.3f} ms, plain {p3_ms:.3f} ms [{card}]")
    k1_report(est3, fwd3, est3, k3_ms, card, "tilted (256,512,512)")
    ms3 = rl_iteration_ms(img3_d, tpsf, fwd3, bp3, card, "tilted (256,512,512)")
    check_auto_route(route3, img3.shape, dev, ms3["kernel_route"], ms3["k3_route"],
                     ms3["torch_fft_route"], "tilted (256,512,512)")
    del img3_d, est3

    # ---- Phase 4: the CLI ----------------------------------------------
    print("Phase 4: deconSingleView CLI, 200 x 512 x 512 16-bit TIFF")
    with tempfile.TemporaryDirectory() as tmp:
        f_img, f_psf, f_out = (os.path.join(tmp, n) for n in
                               ("img.tif", "psf.tif", "out.tif"))
        writetifstack(f_img, rng.random((200, 512, 512), dtype=np.float32)
                      * 1000 + 100, 16)
        writetifstack(f_psf, psf, 32)
        route = auto_route([psf], D._fft_grid((200, 512, 512)), dev)
        before, before_ct = K.LAUNCHES, F.LAUNCHES
        rc = decon_sv.main(["-i", f_img, "-fp", f_psf, "-o", f_out,
                            "-it", str(N_ITERS), "-bit", "32"])
        if rc != 0:
            raise AssertionError(f"CLI returned {rc}")
        res, size = readtifstack(f_out)
        if res.shape != (200, 512, 512) or not np.isfinite(res).all():
            raise AssertionError(f"CLI output bad: shape {res.shape}")
        n1, n3 = K.LAUNCHES - before, F.LAUNCHES - before_ct
        if (n1, n3) != {"separable": (2 * N_ITERS, 0), "K3": (0, 2 * N_ITERS),
                        "torch.fft": (0, 0)}[route]:
            raise AssertionError(f"CLI: {n1} K1 launches, {n3} K3 calls on the {route} route")
        print(f"  CLI output {size} (x, y, z), finite, auto's {route} route: {n1} K1 "
              f"launches, {n3} K3 calls")
    torch.cuda.synchronize()

    ct = phase5_k3(dev, rng, card)
    ct_launches, psfs = phase6_dual_wb(dev, rng, card)
    phase7_dual_matched(dev, psfs, card)
    phase8_dual_cli(rng, psfs)
    torch.cuda.synchronize()
    corr = phase9_corr(dev, card)
    corr_launches = phase10_reg(dev, card)
    phase11_reg_cli(dev)
    torch.cuda.synchronize()
    k2 = phase12_k2(dev, card)
    k6 = phase13_k6(dev, card)
    main14, views = phase14_fusion(dev, card)
    phase15_fusion_cli(views, card)
    torch.cuda.synchronize()
    k7 = phase16_roofline(dev, card)
    # K6 was held against K5 at every shape the fusion launched it at; its
    # JSON numbers are those of the largest such shape
    unchecked = set(main14["k6_shapes"]) - set(k6)
    if not main14["k6_shapes"] or unchecked:
        raise AssertionError(f"K6 launched at {main14['k6_shapes']}, Phase 13 did not "
                             f"check {sorted(unchecked)}")
    k6_shape = max(main14["k6_shapes"], key=lambda s: int(np.prod(s)))
    print(f"K6's numbers below are at {k6_shape}, the largest level the fusion's "
          f"finisher launched K6 at (of {main14['k6_shapes']})")
    k6 = k6[k6_shape]

    print(f"iteration ms at 512^3 [{card}]: " + json.dumps(iter_ms))
    nz, ny, nx = DUAL_SHAPE
    n_ct, n_spec = nz * ny * nx, nz * ny * (nx // 2 + 1)
    k3_bound = bound(8 * n_ct + 8 * n_spec,
                     2 * 2.5 * n_ct * math.log2(n_ct) + 6 * n_spec)
    kernels = [{
        "name": "conv3_sep",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/conv_sep.cu",
        "replaces": "microimagelib_tpu/ops/conv_sep.py:506",
        "launches": main_launches,
        "max_abs_err": max(kern.values()),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": k1_lib_ms,
    }, {
        "name": "conv3_ct",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/fft_ct.cu",
        "replaces": "microimagelib_tpu/ops/fft_pallas.py:296",
        "launches": ct_launches,
        "max_abs_err": ct["max_abs_err"],
        "ms": ct["ms"],
        "plain_ms": ct["plain_ms"],
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        # conv3_ct_torch is the torch.fft library route itself
        "library_ms": ct["plain_ms"],
    }]
    for grad, name, line in ((False, "corr3d_partials", 112),
                             (True, "corr3d_grad", 380)):
        c = corr[grad]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "microimagelib_tpu_torch/csrc/corr.cu",
            "replaces": f"microimagelib_tpu/ops/pallas_corr.py:{line}",
            "launches": corr_launches[grad],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0],
            "bound_by": c["bound"][1],
            "library_ms": None,   # no single PyTorch call computes the sums
            "device_ms_per_level": c["levels"],
        })
    kernels.insert(1, {
        "name": "rl_iter_fused",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/rl_fused.cu",
        "replaces": "microimagelib_tpu/ops/conv_sep.py:670",
        "launches": main14["k2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound"][0],
        "bound_by": k2["bound"][1],
        "library_ms": None,   # no single PyTorch call computes an RL iteration
    })
    kernels.append({
        "name": "corr3d_partials_nprobe",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/corr.cu",
        "replaces": "microimagelib_tpu/ops/pallas_corr.py:242",
        "launches": main14["k6"],
        "max_abs_err": k6["max_abs_err"],
        "ms": k6["ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound"][0],
        "bound_by": k6["bound"][1],
        "library_ms": None,   # no single PyTorch call computes the sums
    })
    kernels.append({
        "name": "pipe_copy",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/pipe_copy.cu",
        "replaces": "tools/conv_roofline.py:130",
        "launches": k7["launches"],
        "max_abs_err": k7["max_abs_err"],
        "ms": k7["ms"],
        "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound"][0],
        "bound_by": k7["bound"][1],
        "library_ms": k7["library_ms"],
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# Phase 5's gate grids: the first four, then the card test's grids that put
# 128, 256, 320 and 512 on each axis (and an odd row count)
K3_GRIDS = ((32, 32, 128), (64, 96, 128), DUAL_SHAPE, (256, 512, 512),
            (128, 256, 128), (320, 48, 512), (64, 512, 320), (256, 40, 256), (5, 3, 512),
            (512, 24, 64))
# grids, by voxel count, on which K3 is timed against torch.fft. Among those
# whose every axis takes the length-specialised transform, the smallest
# count from which K3 wins at that grid and every larger one is the FFT
# route's auto threshold (models/deconvolution.py CT_MIN_VOXELS); the rest
# (z 64 in the first, generic lengths snap_fft_size gives in the last three)
# show what the generic path costs, where auto takes torch.fft
K3_LADDER = ((128, 128, 128), (128, 128, 256), (64, 256, 256), (128, 256, 256),
             (128, 256, 512), (128, 512, 512), (256, 512, 512), DUAL_SHAPE,
             (64, 384, 384), (192, 384, 384), (384, 512, 512))


def k3_inputs(shape, rng, dev):
    """A volume from ``rng`` and the OTF of a random PSF (seeded), on the card."""
    psf = np.random.default_rng(SEED).random(shape, dtype=np.float32)
    otf = torch.fft.rfftn(torch.from_numpy(psf / psf.sum()).to(dev)).contiguous()
    v = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100).to(dev)
    return v, otf


def phase5_k3(dev, rng, card):
    """K3 against complex128 torch.fft and its fp32 plain version at
    K3_GRIDS, with the axes that took the length-specialised path; the
    five launches' split at DUAL_SHAPE; the ladder and the threshold it
    gives. Returns the kernel's JSON numbers at DUAL_SHAPE and the
    threshold."""
    print("Phase 5: conv3_ct kernel vs complex128 torch.fft and conv3_ct_torch")
    res = {}
    lengths = sorted({n for shape in K3_GRIDS + K3_LADDER for n in shape})
    for n in lengths:   # the kernel's plan tables against the host's
        want = (F.spec_pitch(n), F.radix_plan(n) or ())
        if F.kernel_plan(n) != want:
            raise AssertionError(f"K3 length {n}: kernel plan {F.kernel_plan(n)}, "
                                 f"host {want}")
    print(f"  kernel plans and pitches match the host's at lengths {lengths}")
    # the grids added after the first four draw from their own generator, so
    # the later phases' data stay as they were
    own = np.random.default_rng(SEED + 5)
    for i, shape in enumerate(K3_GRIDS):
        v, otf = k3_inputs(shape, rng if i < 4 else own, dev)
        before, spec_before = F.LAUNCHES, dict(F.LAUNCHES_SPECIALISED)
        out = F.conv3_ct(v, otf)
        torch.cuda.synchronize()
        if F.LAUNCHES != before + 1:
            raise AssertionError(f"K3 {shape}: launch count did not rise")
        rose = {a: F.LAUNCHES_SPECIALISED[a] - spec_before[a] for a in "xyz"}
        want = {a: int(F.radix_plan(n) is not None) for a, n in zip("zyx", shape)}
        if rose != want:
            raise AssertionError(f"K3 {shape}: specialised axes {rose}, expected {want}")
        ref = torch.fft.irfftn(torch.fft.rfftn(v.double()) * otf.to(torch.complex128),
                               s=shape).float()
        check_close(f"K3 {shape} (specialised {''.join(a for a in 'xyz' if rose[a]) or '-'})"
                    " vs complex128", out.cpu(), ref.cpu(), 0.0, 1e-4)
        del ref
        plain = F.conv3_ct_torch(v, otf)
        check_close(f"K3 {shape} vs conv3_ct_torch", out.cpu(), plain.cpu(), 0.0, 1e-4)
        if shape == DUAL_SHAPE:
            res["max_abs_err"] = float((out - plain).abs().max())
        del out, plain, v, otf
        torch.cuda.empty_cache()
    split, timed = k3_split(dev, card)
    res.update(ms=timed["ms"], plain_ms=timed["plain_ms"], split=split)

    print(f"  K3 against torch.fft by grid (CUDA events, 10 calls) [{card}]:")
    ladder = []
    for shape in K3_LADDER:
        v, otf = k3_inputs(shape, own, dev)
        k_ms = cuda_ms(lambda: F.conv3_ct(v, otf), 10)
        t_ms = cuda_ms(lambda: F.conv3_ct_torch(v, otf), 10)
        full = F.ct_specialised(shape)
        if full:
            ladder.append((int(np.prod(shape)), k_ms, t_ms))
        generic = "".join(a for a, n in zip("zyx", shape) if not F.radix_plan(n))
        print(f"    {shape} ({int(np.prod(shape))} voxels, generic axes "
              f"{generic or '-'}): K3 {k_ms:.3f} ms, torch.fft {t_ms:.3f} ms "
              f"({'K3' if k_ms < t_ms else 'torch.fft'} wins; auto takes "
              f"{D._fft_impl(shape, v)})")
        del v, otf
        torch.cuda.empty_cache()
    ladder.sort()
    res["threshold"] = next((vox for i, (vox, _k, _t) in enumerate(ladder)
                             if all(k < t for _v, k, t in ladder[i:])), None)
    print(f"  on the all-specialised grids K3 wins from {res['threshold']} voxels on "
          f"(None: nowhere); the FFT route's auto default is {D.CT_MIN_VOXELS}")
    return res


# K3's five launches in order, each with the kernel names that run it (the
# y launches of the first version shared one name, y_kernel)
K3_LAUNCHES = (("x forward", ("x_forward",)), ("y forward", ("y_forward", "y_kernel")),
               ("z x OTF", ("z_kernel",)), ("y inverse", ("y_inverse", "y_kernel")),
               ("x inverse", ("x_inverse",)))


def k3_launch_bytes(shape):
    """Bytes each of K3's five launches must move at ``shape``: v and out
    float32, the half spectrum and the OTF complex64, each read or written
    once per launch."""
    nz, ny, nx = shape
    vol, spec = 4 * nz * ny * nx, 8 * nz * ny * (nx // 2 + 1)
    return {"x forward": vol + spec, "y forward": 2 * spec, "z x OTF": 3 * spec,
            "y inverse": 2 * spec, "x inverse": spec + vol}


def k3_split(dev, card, shape=DUAL_SHAPE):
    """K3's five launches at ``shape``: device time per launch by
    torch.profiler (``device_split``), each launch's bytes and its rate
    against the z-shaped K7 copy timed at the same shape in this run; then
    K3 and ``torch.fft`` per call. Returns {launch: ms} and the call times."""
    prng = np.random.default_rng(SEED + 5)
    v = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100).to(dev)
    otf = torch.fft.rfftn(v / v.sum()).contiguous()
    aux = v + 1
    ceil = 12 * v.numel() / (cuda_ms(lambda: P.pipe_copy(v, aux, 4, "z"), 20) * 1e-3)
    del aux
    rows = device_split(lambda: F.conv3_ct(v, otf), 10, f"K3 {shape}", card)
    nbytes = k3_launch_bytes(shape)
    split = {}
    print(f"  K3 {shape} by launch, against the z-shaped K7 copy's {ceil / 1e12:.3f} "
          f"TB/s at that shape [{card}]:")
    for launch, names in K3_LAUNCHES:
        hits = [ms for key, ms, _n in rows if any(n in key for n in names)]
        if len(hits) != 1:
            raise AssertionError(f"K3 split: {len(hits)} kernels for {launch}")
        ms = split[launch] = hits[0]
        rate = nbytes[launch] / (ms * 1e-3)
        print(f"    {launch}: {ms:.4f} ms, {nbytes[launch] / 1e6:.1f} MB, "
              f"{rate / 1e12:.3f} TB/s = {100 * rate / ceil:.1f}% of the copy")
    total = sum(nbytes.values())
    print(f"    five launches {sum(split.values()):.4f} ms for {total / 1e9:.3f} GB; "
          f"at the copy's rate {total / ceil * 1e3:.4f} ms")
    k_ms = cuda_ms(lambda: F.conv3_ct(v, otf), 10)
    t_ms = cuda_ms(lambda: F.conv3_ct_torch(v, otf), 10)
    print(f"  K3 {shape}: kernel {k_ms:.3f} ms, torch.fft {t_ms:.3f} ms per call [{card}]")
    attrs = F.kernel_attrs(shape)
    for (launch, _names), a in zip(K3_LAUNCHES, attrs):
        print(f"    {launch}: {a['registers']} registers ({a['spill_bytes']} bytes "
              f"spilled) a thread, {a['static_smem'] + a['dynamic_smem']} shared bytes "
              f"and {a['threads']} threads a block, {a['blocks_per_sm']} blocks "
              f"({a['blocks_per_sm'] * a['threads'] // 32} warps) per SM")
    del v, otf
    torch.cuda.empty_cache()
    return split, {"ms": k_ms, "plain_ms": t_ms, "copy_bps": ceil, "attrs": attrs}


def dual_psfs():
    """25^3 Gaussians, sigmas (z, y, x) (3.5, 1.2, 1.2) for view A and
    (1.2, 1.2, 3.5) for view B, and their Wiener-Butterworth back
    projectors (gen_backprojector's defaults)."""
    pa = gauss3((25, 25, 25), (3.5, 1.2, 1.2))
    pb = gauss3((25, 25, 25), (1.2, 1.2, 3.5))
    return pa, pb, gen_backprojector(pa), gen_backprojector(pb)


def phase6_dual_wb(dev, rng, card):
    """The slice's headline: dual view with WB back projectors on K3.
    Returns K3's launch count on that path and the PSFs."""
    print(f"Phase 6: decon_dualview {DUAL_SHAPE}, WB back projectors, "
          f"{WB_ITERS} iterations")
    psfs = pa, pb, wa, wb = dual_psfs()
    if D._sep_plans(pa, wa, DUAL_SHAPE) is not None:
        raise AssertionError("the planner accepted a WB back projector")
    a = rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1
    b = rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1
    K.LAUNCHES = 0
    F.LAUNCHES = 0
    rec = np.zeros(10)
    with env(MIL_FFT_IMPL="pallas"):   # K3 whatever the auto threshold
        out_k = D.decon_dualview(a, b, pa, pb, n_iters=WB_ITERS, psf_bp_a=wa,
                                 psf_bp_b=wb, device=dev, mem_mode=1, records=rec)
    ct_launches, sep_launches = F.LAUNCHES, K.LAUNCHES
    print(f"  K3 route: {ct_launches} K3 calls, {sep_launches} K1 launches, "
          f"decon {rec[8]:.3f} s (records {rec.tolist()}) [{card}]")
    if ct_launches != 4 * WB_ITERS or sep_launches != 0:
        raise AssertionError(f"expected {4 * WB_ITERS} K3 calls and no K1 launch, "
                             f"got {ct_launches} and {sep_launches}")
    rec_x = np.zeros(10)
    with env(MIL_FFT_IMPL="xla"):
        out_x = D.decon_dualview(a, b, pa, pb, n_iters=WB_ITERS, psf_bp_a=wa,
                                 psf_bp_b=wb, device=dev, mem_mode=1, records=rec_x)
    if F.LAUNCHES != ct_launches:
        raise AssertionError("the torch.fft route launched K3")
    print(f"  torch.fft route: decon {rec_x[8]:.3f} s (records {rec_x.tolist()}) "
          f"[{card}]")
    check_close("dual WB K3 vs torch.fft route", out_k, out_x, 2e-3, 2e-3)
    del out_k, out_x
    a_d, b_d = (torch.from_numpy(x).to(dev) for x in (a, b))
    otfs = [D.gen_otf(p, DUAL_SHAPE, device=dev) for p in (pa, pb, wa, wb)]
    ms = {impl: cuda_ms(lambda: D._rl_dual(a_d, b_d, *otfs, WB_ITERS, False, impl),
                        2) / WB_ITERS
          for impl in ("ct", "torch")}
    print(f"  ms per dual-view iteration {DUAL_SHAPE}, WB [{card}]: "
          f"K3 route {ms['ct']:.3f}, torch.fft route {ms['torch']:.3f}")
    del a_d, b_d, otfs
    torch.cuda.empty_cache()
    return ct_launches, psfs


def phase7_dual_matched(dev, psfs, card):
    """Matched (flipped) PSFs: the separable route, against the FFT route."""
    print(f"Phase 7: decon_dualview {DUAL_SHAPE}, matched PSFs, {N_ITERS} iterations")
    pa, pb = psfs[:2]
    rng = np.random.default_rng(SEED + 7)
    a = rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1
    b = rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1
    K.LAUNCHES = 0
    with env(MIL_CONV_SEP="1"):
        out_k = D.decon_dualview(a, b, pa, pb, n_iters=N_ITERS, device=dev, mem_mode=1)
    if K.LAUNCHES != 4 * N_ITERS:
        raise AssertionError(f"expected {4 * N_ITERS} K1 launches, got {K.LAUNCHES}")
    route7 = auto_route([pa, pb], DUAL_SHAPE, dev)
    print(f"  separable route: {K.LAUNCHES} K1 launches; MIL_CONV_SEP=auto takes the "
          f"{route7} route")
    before = F.LAUNCHES
    with env(MIL_CONV_SEP="0"):
        out_f = D.decon_dualview(a, b, pa, pb, n_iters=N_ITERS, device=dev, mem_mode=1)
    print(f"  FFT route: {F.LAUNCHES - before} K3 calls")
    check_close("dual matched separable vs FFT route", out_k, out_f, 2e-4, 2e-4)
    del out_k, out_f
    a_d, b_d = (torch.from_numpy(x).to(dev) for x in (a, b))
    with env(MIL_CONV_SEP="1"):
        plans = [p for psf in (pa, pb) for p in D._sep_plans(psf, flip(psf), DUAL_SHAPE)[1]]
    print(f"  tap costs {[D.tap_cost(p) for p in plans]}")
    otfs = [D.gen_otf(p, DUAL_SHAPE, device=dev) for p in (pa, pb, flip(pa), flip(pb))]
    ms = {"K1 route": cuda_ms(lambda: D._rl_dual_sep(a_d, b_d, *plans, N_ITERS,
                                                     False), 2) / N_ITERS}
    for name, impl in (("K3 route", "ct"), ("torch.fft route", "torch")):
        ms[name] = cuda_ms(lambda: D._rl_dual(a_d, b_d, *otfs, N_ITERS, False,
                                              impl), 2) / N_ITERS
    print(f"  ms per dual-view iteration {DUAL_SHAPE}, matched 25^3 [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    check_auto_route(route7, DUAL_SHAPE, dev, ms["K1 route"], ms["K3 route"],
                     ms["torch.fft route"], "dual matched")
    del a_d, b_d, otfs
    torch.cuda.empty_cache()


def phase8_dual_cli(rng, psfs):
    """genBackProjector, then deconDualView -bp1 -bp2 on 16-bit TIFFs."""
    print(f"Phase 8: genBackProjector + deconDualView CLIs, 200 x 512 x 512 "
          f"16-bit TIFFs, {WB_ITERS} iterations")
    with tempfile.TemporaryDirectory() as tmp:
        f = {n: os.path.join(tmp, n + ".tif")
             for n in ("a", "b", "pa", "pb", "wa", "wb", "out")}
        base = rng.random((200, 512, 512), dtype=np.float32) * 1000 + 100
        writetifstack(f["a"], base, 16)
        writetifstack(f["b"], np.roll(base, 3, axis=2), 16)
        del base
        writetifstack(f["pa"], psfs[0], 32)
        writetifstack(f["pb"], psfs[1], 32)
        for src, dst in (("pa", "wa"), ("pb", "wb")):
            if gen_bp.main(["-fp", f[src], "-o", f[dst]]) != 0:
                raise AssertionError("genBackProjector failed")
        before_ct, before_sep = F.LAUNCHES, K.LAUNCHES
        t = time.time()
        with env(MIL_FFT_IMPL="pallas"):   # K3 whatever the auto threshold
            rc = decon_dv.main(["-i1", f["a"], "-i2", f["b"], "-fp1", f["pa"],
                                "-fp2", f["pb"], "-bp1", f["wa"], "-bp2", f["wb"],
                                "-o", f["out"], "-it", str(WB_ITERS), "-bit", "32"])
        wall = time.time() - t
        if rc != 0:
            raise AssertionError(f"deconDualView returned {rc}")
        res, size = readtifstack(f["out"])
        if res.shape != (200, 512, 512) or not np.isfinite(res).all():
            raise AssertionError(f"deconDualView output bad: shape {res.shape}")
        n_ct = F.LAUNCHES - before_ct
        if n_ct != 4 * WB_ITERS or K.LAUNCHES != before_sep:
            raise AssertionError(f"deconDualView: {n_ct} K3 calls, "
                                 f"{K.LAUNCHES - before_sep} K1 launches")
        print(f"  deconDualView output {size} (x, y, z), finite, {n_ct} K3 calls, "
              f"{wall:.3f} s in main()")


def conv3d_library_ms(v, psf, plan, card):
    """K1's library yardstick: one cuDNN ``F.conv3d`` (TF32 off) of the
    circularly padded volume with the flipped PSF, the plain-mode
    convolution K1 computes; its agreement with K1 is printed."""
    pz, py, px = psf.shape
    w = torch.from_numpy(flip(psf)).to(v.device)[None, None]
    # conv3d correlates: with the flipped PSF, output i reads v[i + k - b]
    # for b = p - 1 - p//2 before-padding, the PSF centre at p//2
    vp = torch.nn.functional.pad(v[None, None], (px - 1 - px // 2, px // 2,
                                                 py - 1 - py // 2, py // 2,
                                                 pz - 1 - pz // 2, pz // 2),
                                 mode="circular")
    out = torch.nn.functional.conv3d(vp, w)[0, 0]
    ref = K.conv3_sep(v, plan, mode="plain")
    err = float((out - ref).abs().max() / ref.abs().max())
    ms = cuda_ms(lambda: torch.nn.functional.conv3d(vp, w), 3)
    print(f"  library yardstick for K1: F.conv3d of the circularly padded 512^3 "
          f"volume, {ms:.3f} ms (differs from K1 plain mode by {err:.3g} x max) "
          f"[{card}]")
    del vp, out, ref
    torch.cuda.empty_cache()
    return ms


CORR_MATRICES = {
    "shift": np.array([1, 0, 0, 0.6, 0, 1, 0, -0.8, 0, 0, 1, 0.3], np.float32),
    "shear-scale": np.array([0.99, 0.05, 0, 0.2, -0.05, 0.99, 0, 0.1,
                             0, 0.02, 1.01, -0.4], np.float32),
    "rot10": dof_to_matrix([0.5, -0.3, 0.2, 10.0, 0, 0, 1, 1, 1], 6),
    "partly-outside": dof_to_matrix([6.0, -3.0, 2.0, 4.0, 0, 0, 1, 1, 1], 6),
    "reg128-truth": dof_to_matrix(REG_DOF, 6),
}


def host_us(fn, reps):
    """Host microseconds per call of ``fn`` with no sync between calls
    (the wrapper's issue cost while the device queue has room), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def call_device_ms(rows):
    """Device ms of one call from ``device_split``'s rows: each kernel's
    time per launch, summed (each kernel launches once a call)."""
    return sum(ms for _key, ms, _n in rows) if rows else float("nan")


# Phase 9's shapes: Phase 10's pyramid levels, then the largest level of
# the fusion's registration that launches K4 and K5
CORR_SHAPES = tuple(REG_LEVELS) + (FUSION_SHAPE,)


def phase9_corr(dev, card):
    """K5 and K4 against their plain versions on the card at every level
    of Phase 10's pyramid and the fusion's full level; per level the
    launch plan (compiled = host mirror), the instantiation's registers,
    device time per launch (torch.profiler: one kernel a call), ms per
    call back to back (CUDA events), the wrapper's host microseconds per
    call and the bound. Returns, per kernel, the JSON numbers at REG_SHAPE
    and the device ms per launch at every shape."""
    print("Phase 9: corr3d kernels K5 (sums) and K4 (sums + gradient) vs "
          "their plain versions")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {False: {"levels": {}}, True: {"levels": {}}}
    for shape in CORR_SHAPES:
        prng = np.random.default_rng(SEED + 9)
        src = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        tgt = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        n_vox = src.numel()
        for grad in (False, True):
            name_k = "K4" if grad else "K5"
            plan = C.launch_plan(shape, grad, sms)
            if C.kernel_plan(shape, grad, sms) != plan:
                raise AssertionError(f"{name_k} {shape}: compiled plan "
                                     f"{C.kernel_plan(shape, grad, sms)} != {plan}")
            attrs = C.kernel_attrs(name_k, plan["vx"], plan["wide"])
            if attrs["spill_bytes"]:
                raise AssertionError(f"{name_k} {shape}: spills {attrs}")
            err = 0.0
            for name, m in CORR_MATRICES.items():
                before = (C.K4_LAUNCHES, C.K5_LAUNCHES)
                out = C.corr3d(src, tgt, m, grad=grad).cpu().numpy()
                if (C.K4_LAUNCHES - before[0], C.K5_LAUNCHES - before[1]) != \
                        ((1, 0) if grad else (0, 1)):
                    raise AssertionError("corr3d: launch count did not rise")
                again = C.corr3d(src, tgt, m, grad=grad).cpu().numpy()
                if not np.array_equal(out, again):
                    raise AssertionError(f"{name}: two launches differ")
                ref = C.corr3d_torch(src, tgt, m, grad=grad).cpu().numpy()
                rel = np.abs(out[:2] - ref[:2]) / np.abs(ref[:2])
                if rel.max() > 1e-5:
                    raise AssertionError(f"{shape} {name}: ss/st off by {rel}")
                g_err = 0.0
                if grad:
                    for lo, hi in ((2, 14), (14, 26)):
                        sc = np.abs(ref[lo:hi]).max()
                        g_err = max(g_err, np.abs(out[lo:hi] - ref[lo:hi]).max() / sc)
                    if g_err > 2e-4:
                        raise AssertionError(f"{shape} {name}: gradient off by "
                                             f"{g_err:.3g} x max")
                err = max(err, float(np.abs(out - ref).max()))
                print(f"  {name_k} {shape} {name}: ss/st rel "
                      f"{rel.max():.3g}" + (f", gs/gt {g_err:.3g} x max" if grad
                                            else ""))
            m = CORR_MATRICES["reg128-truth"]

            def call():
                return C.corr3d(src, tgt, m, grad=grad)

            rows = device_split(call, 10, f"{name_k} at {shape}", card)
            if len(rows) > 1 or any("corr_kernel" not in r[0] for r in rows):
                raise AssertionError(f"{name_k} {shape}: a call launched {rows}, not one "
                                     "corr_kernel")
            dev_ms = call_device_ms(rows)
            ms = cuda_ms(call, 20)
            us = host_us(call, 50)
            plain_ms = cuda_ms(lambda: C.corr3d_torch(src, tgt, m, grad=grad), 2)
            valid = float(C.corr3d_torch(torch.ones_like(src), src, m)[0])
            b = bound(8 * valid, CORR_OPS[grad] * valid)
            print(f"  {name_k} at {shape}: plan vx {plan['vx']} steps {plan['steps']} "
                  f"blocks {plan['blocks']} wide {plan['wide']}, {attrs['registers']} "
                  f"registers, {attrs['blocks_per_sm']} blocks/SM; device {dev_ms:.4f} ms "
                  f"per launch, {ms:.4f} ms per call back to back (CUDA events), host "
                  f"{us:.1f} us per call, {8 * n_vox / dev_ms / 1e6:.1f} GB/s of src+tgt, "
                  f"plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]")
            res[grad]["levels"]["x".join(map(str, shape))] = dev_ms
            if shape == REG_SHAPE:
                res[grad].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  "bound": b})
        del src, tgt
        torch.cuda.empty_cache()
    return res


def device_split(fn, reps, label, card):
    """Device time per launch of each kernel ``fn`` launches, by
    torch.profiler, with the number of launches the trace holds out of the
    ``reps`` calls (a trace can miss some; printed, 'not measured' when the
    trace has none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):    # a trace late in a long process can come back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / 1e3 / e.count, e.count)
                for e in prof.key_averages() if e.device_time_total > 0 and e.count]
        if rows:
            break
    text = ", ".join(f"{k[:40]} {v:.4f} ms ({n} in the trace)" for k, v, n in
                     sorted(rows, key=lambda r: -r[1])) or "not measured"
    print(f"  {label}, device time per launch by kernel, {reps} calls: {text} [{card}]")
    return rows


def beads(shape, seed, dev, sigma=3.0):
    """bench_all.py's _blobs at ``shape``: 80 beads per 128^3 voxels in the
    central half of each axis, amplitudes 80-200, smoothed by a
    sum-normalized Gaussian (here with torch.fft on the card)."""
    rng = np.random.default_rng(seed)
    n = int(round(80 * np.prod(shape) / 128 ** 3))
    pos = [rng.integers(s // 4, 3 * s // 4, size=n) for s in shape]
    amp = rng.uniform(80, 200, size=n).astype(np.float32)
    vol = torch.zeros(shape, dtype=torch.float32, device=dev)
    vol[tuple(torch.from_numpy(p).to(dev) for p in pos)] = torch.from_numpy(amp).to(dev)
    g = 1.0
    for ax, s in enumerate(shape):
        d = torch.arange(s, dtype=torch.float64, device=dev)
        d = torch.minimum(d, s - d)          # circular distance to the origin
        k = torch.exp(-d * d / (2 * sigma ** 2))
        g = g * k.reshape([-1 if i == ax else 1 for i in range(3)])
    g = (g / g.sum()).float()
    return torch.fft.irfftn(torch.fft.rfftn(vol) * torch.fft.rfftn(g), s=shape)


def inverse12(m):
    a = np.vstack([np.asarray(m, np.float64).reshape(3, 4), [0, 0, 0, 1]])
    return np.linalg.inv(a)[:3].reshape(12)


def box_error(m, truth, shape):
    """Max distance (voxels) between where ``m`` and ``truth`` map the
    corners of the central half-box of ``shape`` (z, y, x)."""
    sz, sy, sx = shape
    pts = np.array([[x, y, z, 1.0] for x in (sx / 4, 3 * sx / 4)
                    for y in (sy / 4, 3 * sy / 4) for z in (sz / 4, 3 * sz / 4)])
    a = np.asarray(m, np.float64).reshape(3, 4)
    b = np.asarray(truth, np.float64).reshape(3, 4)
    return float(np.abs(pts @ a.T - pts @ b.T).max())


def phase10_reg(dev, card):
    """The slice at full width. Returns the K5 and K4 launch counts of the
    main path's run."""
    print(f"Phase 10: reg3d {REG_SHAPE}, choice 2, method 7, automatic pyramid "
          "(default knobs)")
    true_m = dof_to_matrix(REG_DOF, 6)
    vol = beads(REG_SHAPE, SEED, dev)
    moved = affine_transform_3d(vol, true_m, REG_SHAPE)
    levels = []

    def on_level(label, shape, secs):
        levels.append((label, shape, secs, C.K4_LAUNCHES, C.K5_LAUNCHES))

    torch.cuda.synchronize()
    C.K4_LAUNCHES = C.K5_LAUNCHES = C.PLAIN_CALLS = 0
    t = time.time()
    reg, tmx, rec = R.reg3d(vol, moved, reg_choice=2, aff_method=7, device=dev,
                            as_device=True, on_level=on_level)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {True: C.K4_LAUNCHES, False: C.K5_LAUNCHES}
    plain = C.PLAIN_CALLS
    err = box_error(tmx, inverse12(true_m), REG_SHAPE)
    print(f"  reg3d: {wall:.3f} s, NCC {rec[3]:.6f} (initial {rec[1]:.6f}), "
          f"{int(rec[5])} full-resolution evaluations, {launches[True]} K4 and "
          f"{launches[False]} K5 launches, {plain} plain-version calls, matrix "
          f"{np.round(tmx, 5).tolist()}, {err:.4f} voxel from the truth over the "
          f"central half-box [{card}]")
    if not np.isfinite(reg.sum().item()) or tuple(reg.shape) != REG_SHAPE:
        raise AssertionError("registered volume is not finite or has the wrong shape")
    if rec[3] < 0.95 or err > 0.5 or plain != 0:
        raise AssertionError(f"registration failed: NCC {rec[3]}, {err} voxel, "
                             f"{plain} plain calls")
    prev4 = prev5 = 0
    for label, shape, secs, n4, n5 in levels:
        d4, d5 = n4 - prev4, n5 - prev5
        prev4, prev5 = n4, n5
        if d4 == 0 or d5 == 0:
            raise AssertionError(f"level {label}: {d4} K4 and {d5} K5 launches")
        src = R._mean_pool(vol, tuple(s // t for s, t in zip(REG_SHAPE, shape))) \
            if shape != REG_SHAPE else vol
        tgt = torch.roll(src, 1, 2).contiguous()
        m = R._tmx_full_to_coarse(tmx, tuple(s // t for s, t in zip(REG_SHAPE, shape)))
        t4 = cuda_ms(lambda: C.corr3d(src, tgt, m, grad=True), 10)
        t5 = cuda_ms(lambda: C.corr3d(src, tgt, m, grad=False), 10)
        g4, g5 = (call_device_ms(device_split(lambda: C.corr3d(src, tgt, m, grad=g), 10,
                                              f"K{4 if g else 5} level {label}", card))
                  for g in (True, False))
        kern_ms = d4 * g4 + d5 * g5
        print(f"  level {label} {shape}: {d4 + d5} evaluations ({d4} K4, {d5} K5), "
              f"{secs:.3f} s, kernel {kern_ms / (d4 + d5):.4f} ms per evaluation "
              f"(device K4 {g4:.4f}, K5 {g5:.4f} ms per launch; back to back K4 "
              f"{t4:.4f}, K5 {t5:.4f} ms per call), kernel {kern_ms:.3f} ms of the level, "
              f"host share {1 - kern_ms / 1e3 / secs:.3f} [{card}]")
    del reg, vol, moved
    torch.cuda.empty_cache()

    shape = (128, 256, 256)
    vol = beads(shape, SEED + 1, dev)
    moved = affine_transform_3d(vol, true_m, shape)
    out = {}
    for impl in ("auto", "gather"):
        k4, k5, plain = C.K4_LAUNCHES, C.K5_LAUNCHES, C.PLAIN_CALLS
        t = time.time()
        with env(MIL_NCC_IMPL=impl):
            _, tmx2, rec2 = R.reg3d(vol, moved, reg_choice=2, aff_method=7,
                                    device=dev, want_reg=False)
        kernels = C.K4_LAUNCHES - k4 + C.K5_LAUNCHES - k5
        plains = C.PLAIN_CALLS - plain
        print(f"  {shape} MIL_NCC_IMPL={impl}: {time.time() - t:.3f} s, NCC "
              f"{rec2[3]:.6f}, {kernels} kernel launches, {plains} plain calls, "
              f"{box_error(tmx2, inverse12(true_m), shape):.4f} voxel from the "
              f"truth [{card}]")
        if (impl == "auto") != (kernels > 0) or (impl == "gather") != (plains > 0):
            raise AssertionError(f"MIL_NCC_IMPL={impl} took the wrong route")
        out[impl] = (rec2[3], tmx2)
    if abs(out["auto"][0] - out["gather"][0]) > 1e-3 or \
            np.abs(out["auto"][1][[3, 7, 11]] - out["gather"][1][[3, 7, 11]]).max() > 0.35:
        raise AssertionError("kernel and plain routes disagree")
    del vol, moved
    torch.cuda.empty_cache()
    return launches


def phase11_reg_cli(dev):
    """reg3D CLI, -regc 2 -affm 7 -bit 16 -otmx, on 16-bit TIFFs."""
    shape = (200, 512, 512)
    print(f"Phase 11: reg3D CLI, two {shape[2]} x {shape[1]} x {shape[0]} "
          "16-bit TIFFs, -regc 2 -affm 7 -bit 16 -otmx")
    true_m = dof_to_matrix(REG_DOF, 6)
    vol = beads(shape, SEED + 2, dev) * 2000 + 100
    moved = affine_transform_3d(vol, true_m, shape)
    with tempfile.TemporaryDirectory() as tmp:
        f = {n: os.path.join(tmp, n) for n in ("t.tif", "s.tif", "r.tif", "m.tmx")}
        writetifstack(f["t.tif"], vol.cpu().numpy(), 16)
        writetifstack(f["s.tif"], moved.cpu().numpy(), 16)
        del vol, moved
        k4, k5 = C.K4_LAUNCHES, C.K5_LAUNCHES
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = reg3d_cli.main(["-t", f["t.tif"], "-s", f["s.tif"], "-o", f["r.tif"],
                                 "-regc", "2", "-affm", "7", "-bit", "16",
                                 "-otmx", f["m.tmx"], "-verbOFF"])
        if rc != 0:
            raise AssertionError(f"reg3D returned {rc}")
        for ln in buf.getvalue().splitlines():
            if "Time cost" in ln:
                print("  " + ln.strip("*").strip())
        out, size = readtifstack_16to16(f["r.tif"])
        if out.shape != shape or out.dtype != np.uint16:
            raise AssertionError(f"reg3D output {out.shape} {out.dtype}")
        m = read_tmx(f["m.tmx"])
        err = box_error(m, inverse12(true_m), shape)
        print(f"  reg3D output {size} (x, y, z) uint16, {C.K4_LAUNCHES - k4} K4 and "
              f"{C.K5_LAUNCHES - k5} K5 launches, matrix {err:.4f} voxel from the truth")
        if C.K4_LAUNCHES == k4 or C.K5_LAUNCHES == k5 or err > 0.5:
            raise AssertionError("reg3D did not register on the kernels")
    torch.cuda.empty_cache()


def fusion_psfs():
    """The diSPIM views' 25^3 Gaussians: sigmas (z, y, x) (3.5, 1.2, 1.2)
    for view A (z reach 12 on the isotropic grid), (1.2, 1.2, 3.5) for B."""
    return (gauss3((25, 25, 25), (3.5, 1.2, 1.2)),
            gauss3((25, 25, 25), (1.2, 1.2, 3.5)))


def k2_bound(plan):
    """(ms, by) of one K2 launch: est and img read once, out written once;
    an fp32 multiply and add per tap and rank of both stages, plus the
    ratio, the product and the max per voxel."""
    n = int(np.prod(plan.shape))
    taps = sum(p.rank * (p.nsteps + p.ty.shape[1] + p.tx.shape[1])
               for p in (plan.fwd, plan.bp))
    return bound(3 * 4 * n, n * (2 * taps + 3))


def phase12_k2(dev, card):
    """K2 against its plain version and the K1 pair; its plan, peak memory
    and ms per launch at the fusion grid beside the K1 pair's. Returns K2's
    JSON numbers for view A's plan there."""
    print("Phase 12: rl_iter_fused kernel (K2) vs rl_iter_fused_torch and the K1 pair")
    pa, pb = fusion_psfs()
    r2 = gauss3((7, 9, 11), (1.0, 1.5, 2.0)) + 0.3 * gauss3((7, 9, 11), (2.0, 1.0, 0.8))
    # (name, psf, grid, group: 0 the plan's own)
    cases = [("bench 9^3", bench_psf(), K2_SMALL[0], 0),
             ("fusion A (z reach 12)", pa, K2_SMALL[0], 0),
             ("fusion B (x reach 12)", pb, K2_SMALL[0], 0),
             ("rank-2 pair", r2, K2_SMALL[0], 0),
             ("fusion A", pa, K2_SMALL[1], 0),
             ("fusion A, 8-plane groups", pa, K2_SMALL[2], 8),
             ("bench 9^3", bench_psf(), FUSION_SHAPE, 0),
             ("fusion A (z reach 12)", pa, FUSION_SHAPE, 0),
             ("fusion B (x reach 12)", pb, FUSION_SHAPE, 0)]
    res = {}
    for name, psf, shape, group in cases:
        plan = plan_rl_fused(psf, flip(psf), shape)
        if plan is None:
            raise AssertionError(f"{name} {shape}: plan_rl_fused refused")
        host, compiled = KF.launch_plan(plan, group=group), KF.kernel_plan(plan, group=group)
        if host != compiled:
            raise AssertionError(f"{name} {shape}: kernel plan {compiled}, host {host}")
        prng = np.random.default_rng(SEED + 12)
        est = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
        img = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
        before = KF.LAUNCHES
        out = KF.rl_iter_fused(est, img, plan, group=group)
        again = KF.rl_iter_fused(est, img, plan, group=group)
        torch.cuda.synchronize()
        if KF.LAUNCHES != before + 2:
            raise AssertionError(f"{name}: K2 launch count did not rise")
        if not torch.equal(out, again):
            raise AssertionError(f"{name} {shape}: two K2 launches differ")
        ref = KF.rl_iter_fused_torch(est, img, plan)
        err = float((out - ref).abs().max())
        m = float(ref.abs().max())
        del ref
        pair = K.conv3_sep(K.conv3_sep(est, plan.fwd, aux=img, mode="ratio"),
                           plan.bp, aux=est, mode="update")
        same = bool(torch.equal(out, pair))
        del out, again, pair
        attrs = KF.kernel_attrs(host)
        print(f"  {name} {shape}: ranks {plan.fwd.rank}/{plan.bp.rank}, z taps "
              f"{plan.fwd.nsteps}/{plan.bp.nsteps}, x taps {plan.fwd.tx.shape[1]}/"
              f"{plan.bp.tx.shape[1]}; vs plain {err:.6g} = {err / m:.3g} x max; "
              f"equals the K1 pair bit for bit: {same}; launch {KF.LAST_CONFIG}; "
              f"{attrs['registers']} registers ({attrs['spill_bytes']} bytes spilled)")
        if err > 2e-5 * m or not same:
            raise AssertionError(f"{name} {shape}: K2 disagrees")
        if shape == FUSION_SHAPE:
            torch.cuda.synchronize()
            t = time.perf_counter()
            KF.rl_iter_fused(est, img, plan)
            host_ms = (time.perf_counter() - t) * 1e3
            k_ms = cuda_ms(lambda: KF.rl_iter_fused(est, img, plan), 10)
            alone_ms = alone_cuda_ms(lambda: KF.rl_iter_fused(est, img, plan), 5)
            pair_ms = cuda_ms(lambda: K.conv3_sep(
                K.conv3_sep(est, plan.fwd, aux=img, mode="ratio"), plan.bp,
                aux=est, mode="update"), 10)
            plain_ms = cuda_ms(lambda: KF.rl_iter_fused_torch(est, img, plan), 2)
            peak = {}
            for what, fn in (("K2", lambda: KF.rl_iter_fused(est, img, plan)),
                             ("K1 pair", lambda: K.conv3_sep(
                                 K.conv3_sep(est, plan.fwd, aux=img, mode="ratio"),
                                 plan.bp, aux=est, mode="update"))):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peak[what] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            b = k2_bound(plan)
            cfg = KF.LAST_CONFIG
            print(f"  K2 at {shape}, {name}: {k_ms:.4f} ms per launch ({alone_ms:.4f} "
                  f"ms for a launch alone), K1 ratio + update {pair_ms:.4f} ms "
                  f"({k_ms / pair_ms:.3f} x), plain {plain_ms:.3f} ms, bound "
                  f"{b[0]:.4f} ms ({b[1]}), {3 * 4 * est.numel() / k_ms / 1e6:.1f} GB/s "
                  f"of est + img + out; the launch call returns in {host_ms:.4f} ms "
                  f"on the host [{card}]")
            print(f"  K2 at {shape}, {name}: {cfg['group']}-plane groups, ratio store "
                  f"{cfg['head']} head planes + {cfg['ring']} ring planes = "
                  f"{cfg['store_bytes'] / 2 ** 20:.1f} MiB (ring {cfg['ring_bytes'] / 2 ** 20:.1f}"
                  f" MiB); peak device memory of one call {peak['K2']:.1f} MiB, of the "
                  f"K1 pair {peak['K1 pair']:.1f} MiB (out is "
                  f"{est.numel() * 4 / 2 ** 20:.1f} MiB) [{card}]")
            if cfg["store_bytes"] >= est.numel() * 4:
                raise AssertionError(f"{name}: the ratio store is a whole volume")
            if name.startswith("fusion A"):
                res = {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                       "bound": b}
                device_split(lambda: KF.rl_iter_fused(est, img, plan), 5,
                             f"K2 at {shape}", card)
        del est, img
        torch.cuda.empty_cache()
    return res


def probe_matrices():
    """A line search's 8 probes (the ladder of ops/powell_device.py) along
    one direction from the reg128 truth, plus a wild 35-degree probe."""
    base = np.asarray(dof_to_matrix(REG_DOF, 6), np.float32)
    step = np.array([0.002, 0, 0.001, 0.5, 0, 0.001, 0, -0.3, 0, 0, 0.002, 0.2],
                    np.float32)
    mats = [base + np.float32(a) * step for a in LADDER]
    mats.append(np.asarray(dof_to_matrix([0, 0, 0, 35.0, 0, 0, 1, 1, 1], 6), np.float32))
    return np.stack(mats).astype(np.float32)


def fusion_levels():
    """The shapes the fusion's registration runs at: each level of the
    automatic pyramid of FUSION_SHAPE (x stays 320: it pools only while it
    stays a multiple of 128), then full size."""
    return [tuple(s // k for s, k in zip(FUSION_SHAPE, f))
            for f in R.pyramid_levels(R._auto_pool_factors(FUSION_SHAPE))] \
        + [FUSION_SHAPE]


def phase13_k6(dev, card):
    """K6 against K5 per probe and its plain version at every level shape of
    the fusion's registration (Phase 14's main path) and at Phase 10's
    pyramid shapes; one 8-probe call against 8 K5 calls. Returns K6's JSON
    numbers per shape."""
    print("Phase 13: N-probe kernel (K6) vs K5 per probe and corr3d_nprobe_torch")
    mats = probe_matrices()
    eight = mats[:8]
    res = {}
    for shape in fusion_levels() + list(REG_LEVELS):
        prng = np.random.default_rng(SEED + 13)
        src = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        tgt = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        before = C.K6_LAUNCHES
        rows = C.corr3d_nprobe(src, tgt, mats).cpu().numpy()
        if C.K6_LAUNCHES - before != 2:     # 9 matrices: 8 + 1
            raise AssertionError("K6: launch count did not rise")
        if not np.array_equal(rows, C.corr3d_nprobe(src, tgt, mats).cpu().numpy()):
            raise AssertionError(f"K6 {shape}: two launches differ")
        for i, m in enumerate(mats):
            if not np.array_equal(rows[i], C.corr3d(src, tgt, m).cpu().numpy()):
                raise AssertionError(f"K6 {shape}: probe {i} differs from K5")
        plain = C.corr3d_nprobe_torch(src, tgt, mats).cpu().numpy()
        rel = float((np.abs(rows - plain) / np.abs(plain)).max())
        if rel > 1e-5:
            raise AssertionError(f"K6 {shape}: off its plain version by {rel}")
        k6_ms = cuda_ms(lambda: C.corr3d_nprobe(src, tgt, eight), 20)
        k5_ms = cuda_ms(lambda: [C.corr3d(src, tgt, m) for m in eight], 10)
        # as the optimizer calls them: one sync per call
        t = time.time()
        for _ in range(10):
            C.corr3d_nprobe(src, tgt, eight).cpu()
        k6_sync = (time.time() - t) * 100.0
        t = time.time()
        for _ in range(10):
            for m in eight:
                C.corr3d(src, tgt, m).cpu()
        k5_sync = (time.time() - t) * 100.0
        plain_ms = cuda_ms(lambda: C.corr3d_nprobe_torch(src, tgt, eight), 1)
        ones = torch.ones_like(src)
        valid = sum(float(C.corr3d_torch(ones, src, m)[0]) for m in eight)
        b = bound(8 * src.numel(), CORR_OPS[False] * valid)
        print(f"  K6 {shape}: 9 probes = K5 bit for bit, plain rel {rel:.3g}; 8 probes "
              f"{k6_ms:.4f} ms per call vs 8 K5 calls {k5_ms:.4f} ms (CUDA events), "
              f"{k6_sync:.4f} vs {k5_sync:.4f} ms with a sync per call (host clock); "
              f"plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]")
        res[shape] = {"max_abs_err": float(np.abs(rows - plain).max()), "ms": k6_ms,
                      "plain_ms": plain_ms, "bound": b}
        del src, tgt, ones
        torch.cuda.empty_cache()
    return res


def fusion_views(dev):
    """Raw views of a bead truth on the isotropic FUSION_SHAPE grid, as a
    diSPIM records them: A blurred by view A's PSF and sampled in z; B the
    truth moved by the reg128 matrix, blurred by view B's PSF, sampled
    along x (its detection axis) and turned +90 degrees about y, so that
    fusion's -90 degree turn and resample give it back on the isotropic
    grid unshifted. Both raw views are FUSION_RAW (1.0 um steps of
    0.1625 um pixels) in camera counts (x 2000 + 100). Returns
    (a_raw, b_raw) numpy float32."""
    pa, pb = fusion_psfs()
    truth = beads(FUSION_SHAPE, SEED + 14, dev)

    def blur(v, psf):
        otf = D.gen_otf(psf, FUSION_SHAPE, device=dev)
        return torch.fft.irfftn(torch.fft.rfftn(v) * otf, s=FUSION_SHAPE)

    a = resize3d_separable(blur(truth, pa), FUSION_RAW)
    moved = affine_transform_3d(truth, dof_to_matrix(REG_DOF, 6), FUSION_SHAPE)
    del truth
    nz, ny, nx = FUSION_SHAPE
    b = rot_by_y_axis(resize3d_separable(blur(moved, pb), (nz, ny, FUSION_RAW[0])), 1)
    del moved
    views = tuple((v * 2000 + 100).cpu().numpy() for v in (a, b))
    torch.cuda.empty_cache()
    return views


def reg_ncc(target, source, m):
    """The registration's own NCC of ``source`` moved by ``m`` against
    ``target`` (models/registration.py's cost: the mean-subtracted volumes'
    K5 sums, st / sqrt(ss) / sd of the target)."""
    src_ms, tgt_ms, _se2, st2 = R._reg_stats(source, target)
    ss, st = (float(v) for v in C.corr3d(src_ms, tgt_ms, np.asarray(m, np.float32)))
    return st / math.sqrt(ss) / math.sqrt(st2)


def zero_counts():
    K.LAUNCHES = KF.LAUNCHES = F.LAUNCHES = P.LAUNCHES = 0
    F.LAUNCHES_SPECIALISED = dict.fromkeys("xyz", 0)
    C.K4_LAUNCHES = C.K5_LAUNCHES = C.K6_LAUNCHES = C.PLAIN_CALLS = 0


def counts():
    return {"K1": K.LAUNCHES, "K2": KF.LAUNCHES, "K3": F.LAUNCHES,
            "K4": C.K4_LAUNCHES, "K5": C.K5_LAUNCHES, "K6": C.K6_LAUNCHES,
            "K7": P.LAUNCHES, "plain": C.PLAIN_CALLS}


FUSED_ON = {"MIL_CONV_SEP_FUSED": "1", "MIL_REG_BATCH_LS": "1"}
FUSED_OFF = {"MIL_CONV_SEP_FUSED": "0", "MIL_REG_BATCH_LS": "0"}


def phase14_fusion(dev, card):
    """The slice at full width: fusion_dualview with K2 and K6 on (the main
    path) and off. Returns the main run's K2 and K6 launch counts and the
    raw views."""
    print(f"Phase 14: fusion_dualview, raw views {FUSION_RAW} -> {FUSION_SHAPE}, "
          f"choice 2, method 7, {N_ITERS} iterations")
    pa, pb = fusion_psfs()
    t = time.time()
    a_raw, b_raw = fusion_views(dev)
    print(f"  views made in {time.time() - t:.3f} s")
    inv_true = inverse12(dof_to_matrix(REG_DOF, 6))
    route_b = auto_route([pa, pb], FUSION_SHAPE, dev)
    print(f"  MIL_CONV_SEP=auto takes the {route_b} route for the fusion PSFs")
    runs = {}
    for label, flags in (("a", FUSED_ON), ("b", FUSED_OFF)):
        torch.cuda.synchronize()
        rec = np.zeros(22)
        zero_counts()
        t = time.time()
        with env(**flags):
            decon, tmx, reg_b, a_iso = FU.fusion_dualview(
                a_raw, b_raw, pa, pb, FUSION_PIXEL, FUSION_PIXEL, -1, 2, 7,
                n_iters=N_ITERS, device=dev, mem_mode=1, records=rec)
        torch.cuda.synchronize()
        wall = time.time() - t
        n = counts()
        err = box_error(tmx, inv_true, FUSION_SHAPE)
        print(f"  ({label}) {flags}: {wall:.3f} s; steps: preprocess "
              f"{rec[21] - rec[7] - rec[20]:.3f} s, registration {rec[7]:.3f} s, "
              f"decon {rec[20]:.3f} s (iterations {rec[19]:.3f} s), total {rec[21]:.3f} s; "
              f"launches {n}; NCC {rec[3]:.6f} (initial {rec[1]:.6f}), "
              f"{err:.4f} voxel from the true matrix [{card}]")
        print(f"  ({label}) records {rec.tolist()}; matrix {np.round(tmx, 5).tolist()} "
              f"[{card}]")
        if decon.shape != FUSION_SHAPE or not np.isfinite(decon).all():
            raise AssertionError(f"({label}) fused volume bad: {decon.shape}")
        if label == "a" and (n["K2"] != 2 * N_ITERS or n["K1"] != 0 or n["K6"] < 1
                             or n["plain"] != 0):
            raise AssertionError(f"(a) took the wrong kernels: {n}")
        want = {"separable": (4 * N_ITERS, 0), "K3": (0, 4 * N_ITERS),
                "torch.fft": (0, 0)}[route_b]
        if label == "b" and ((n["K1"], n["K3"]) != want or n["K2"] or n["K6"]
                             or n["plain"]):
            raise AssertionError(f"(b) took the wrong kernels for the {route_b} "
                                 f"route: {n}")
        runs[label] = (rec, tmx, reg_b, a_iso, n)
        del decon
    (rec_a, tmx_a, reg_b, a_iso, n_a), (rec_b, tmx_b, _, _, _) = runs["a"], runs["b"]
    d_m = box_error(tmx_a, tmx_b, FUSION_SHAPE)
    print(f"  (a) vs (b): NCC {rec_a[3]:.6f} vs {rec_b[3]:.6f}, matrices {d_m:.4f} voxel "
          "apart over the central half-box")
    if abs(rec_a[3] - rec_b[3]) > 1e-3 or d_m > 0.5:
        raise AssertionError("the K6 and serial registrations disagree")
    # the truth gate (tests/test_torch_fusion.py's CPU check against the JAX
    # package): each run within FUSION_TRUTH_VOXELS of the true matrix, and
    # at least the true matrix's NCC on the registration's own cost
    views_iso = FU.preprocess_views(a_raw, b_raw, FUSION_PIXEL, FUSION_PIXEL, -1, dev,
                                    as_device=True)
    ncc_true = reg_ncc(*views_iso, inv_true)
    for label in ("a", "b"):
        tmx = runs[label][1]
        err, ncc = box_error(tmx, inv_true, FUSION_SHAPE), reg_ncc(*views_iso, tmx)
        print(f"  ({label}) truth gate: {err:.4f} voxel from the true matrix (gate "
              f"{FUSION_TRUTH_VOXELS}), NCC {ncc:.6f} at its matrix, {ncc_true:.6f} at "
              "the true one")
        if err > FUSION_TRUTH_VOXELS or ncc < ncc_true:
            raise AssertionError(f"({label}) the fusion's registration missed the truth "
                                 "gate")
    del views_iso
    outs = {}
    for label, flag in (("K2", "1"), ("K1 pair", "0")):
        with env(MIL_CONV_SEP_FUSED=flag, MIL_CONV_SEP="1"):
            outs[label] = D.decon_dualview(a_iso, reg_b, pa, pb, n_iters=N_ITERS,
                                           device=dev, mem_mode=1)
    check_close("decon of one registered pair, K2 vs K1 pair", outs["K2"],
                outs["K1 pair"], 2e-4, 2e-4)
    print(f"  bit for bit: {bool(np.array_equal(outs['K2'], outs['K1 pair']))}")
    del outs, runs

    a_d = torch.from_numpy(a_iso).to(dev)
    fa = plan_rl_fused(pa, flip(pa), FUSION_SHAPE)
    fb = plan_rl_fused(pb, flip(pb), FUSION_SHAPE)
    otfs = [D.gen_otf(p, FUSION_SHAPE, device=dev) for p in (pa, pb, flip(pa), flip(pb))]
    ms = {"K2": cuda_ms(lambda: D._rl_dual_sep_fused(a_d, reg_b, fa, fb, N_ITERS,
                                                      False), 2) / N_ITERS,
          "K1 pair": cuda_ms(lambda: D._rl_dual_sep(a_d, reg_b, fa.fwd, fa.bp, fb.fwd,
                                                    fb.bp, N_ITERS, False), 2) / N_ITERS,
          "K3": cuda_ms(lambda: D._rl_dual(a_d, reg_b, *otfs, N_ITERS, False,
                                           "ct"), 2) / N_ITERS,
          "torch.fft": cuda_ms(lambda: D._rl_dual(a_d, reg_b, *otfs, N_ITERS, False,
                                                  "torch"), 2) / N_ITERS}
    print(f"  ms per dual-view iteration {FUSION_SHAPE}, fusion PSFs [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    check_auto_route(route_b, FUSION_SHAPE, dev, ms["K1 pair"], ms["K3"], ms["torch.fft"],
                     "fusion PSFs")
    del otfs, reg_b
    torch.cuda.empty_cache()
    k6_shapes = reg_levels(dev, a_raw, b_raw, card)
    return {"k2": n_a["K2"], "k6": n_a["K6"], "k6_shapes": k6_shapes}, (a_raw, b_raw)


def reg_levels(dev, a_raw, b_raw, card):
    """Per pyramid level of the fusion's registration: syncs, evaluations
    and host share, with K6 (MIL_REG_BATCH_LS=1) and without. Returns the
    shapes of the levels where K6 launched."""
    a_iso, b_iso = FU.preprocess_views(a_raw, b_raw, FUSION_PIXEL, FUSION_PIXEL, -1,
                                       dev, as_device=True)
    k6_shapes = []
    for label, flag in (("with K6", "1"), ("serial", "0")):
        levels = []

        def on_level(name, shape, secs):
            levels.append((name, shape, secs, C.K4_LAUNCHES, C.K5_LAUNCHES,
                           C.K6_LAUNCHES))

        torch.cuda.synchronize()
        zero_counts()
        t = time.time()
        with env(MIL_REG_BATCH_LS=flag):
            _, tmx, rec = R.reg3d(a_iso, b_iso, 2, 7, device=dev, want_reg=False,
                                  on_level=on_level)
        wall = time.time() - t
        print(f"  registration {label}: {wall:.3f} s, NCC {rec[3]:.6f}, "
              f"{C.K4_LAUNCHES} K4, {C.K5_LAUNCHES} K5, {C.K6_LAUNCHES} K6 launches [{card}]")
        prev = (0, 0, 0)
        for name, shape, secs, n4, n5, n6 in levels:
            d4, d5, d6 = n4 - prev[0], n5 - prev[1], n6 - prev[2]
            prev = (n4, n5, n6)
            if d6:
                k6_shapes.append(tuple(shape))
            factor = tuple(s // t for s, t in zip(FUSION_SHAPE, shape))
            src = R._mean_pool(a_iso, factor) if shape != FUSION_SHAPE else a_iso
            tgt = torch.roll(src, 1, 2).contiguous()
            m = R._tmx_full_to_coarse(tmx, factor)
            eight = np.stack([m] * 8)
            t4, t5, t6 = (call_device_ms(device_split(fn, 10, f"{k} level {name}", card))
                          for k, fn in (("K4", lambda: C.corr3d(src, tgt, m, grad=True)),
                                        ("K5", lambda: C.corr3d(src, tgt, m, grad=False)),
                                        ("K6", lambda: C.corr3d_nprobe(src, tgt, eight))))
            kern_ms = d4 * t4 + d5 * t5 + d6 * t6
            print(f"    level {name} {shape}: {d4 + d5 + d6} syncs, {d4 + d5 + 8 * d6} "
                  f"evaluations ({d4} K4, {d5} K5, {d6} K6 x 8), {secs:.3f} s, kernel "
                  f"{kern_ms:.3f} ms, host share {1 - kern_ms / 1e3 / secs:.3f} (device "
                  f"K4 {t4:.4f}, K5 {t5:.4f}, K6 {t6:.4f} ms per launch) [{card}]")
            del src, tgt
    del a_iso, b_iso
    torch.cuda.empty_cache()
    return k6_shapes


def phase15_fusion_cli(views, card):
    """spimFusion CLI on the Phase 14 views as 16-bit TIFFs, -bit 16 -otmx,
    with K2 and K6 on."""
    print(f"Phase 15: spimFusion CLI, raw {FUSION_RAW[2]} x {FUSION_RAW[1]} x "
          f"{FUSION_RAW[0]} 16-bit TIFFs, -bit 16 -otmx, K2 and K6 on")
    pa, pb = fusion_psfs()
    with tempfile.TemporaryDirectory() as tmp:
        f = {n: os.path.join(tmp, n) for n in ("a.tif", "b.tif", "pa.tif", "pb.tif",
                                                 "out.tif", "m.tmx")}
        writetifstack(f["a.tif"], views[0], 16)
        writetifstack(f["b.tif"], views[1], 16)
        writetifstack(f["pa.tif"], pa, 32)
        writetifstack(f["pb.tif"], pb, 32)
        zero_counts()
        buf = io.StringIO()
        t = time.time()
        with env(**FUSED_ON), contextlib.redirect_stdout(buf):
            rc = fusion_cli.main(["-i1", f["a.tif"], "-i2", f["b.tif"], "-fp1", f["pa.tif"],
                                  "-fp2", f["pb.tif"], "-o", f["out.tif"], "-regc", "2",
                                  "-affm", "7", "-it", str(N_ITERS), "-bit", "16",
                                  "-otmx", f["m.tmx"], "-verbOFF"])
        wall = time.time() - t
        if rc != 0:
            raise AssertionError(f"spimFusion returned {rc}")
        for ln in buf.getvalue().splitlines():
            if "time cost" in ln.lower():
                print("  " + ln.strip("=* ").strip())
        out, size = readtifstack_16to16(f["out.tif"])
        n = counts()
        tmx = read_tmx(f["m.tmx"])
        err = box_error(tmx, inverse12(dof_to_matrix(REG_DOF, 6)), FUSION_SHAPE)
        print(f"  spimFusion output {size} (x, y, z) {out.dtype}, {wall:.3f} s in main(), "
              f"launches {n}, matrix {err:.4f} voxel from the true one [{card}]")
        if out.shape != FUSION_SHAPE or out.dtype != np.uint16 or not out.any():
            raise AssertionError(f"spimFusion output {out.shape} {out.dtype}")
        if n["K2"] != 2 * N_ITERS or n["K6"] < 1 or n["K1"] or n["plain"]:
            raise AssertionError(f"spimFusion took the wrong kernels: {n}")
    torch.cuda.empty_cache()


def k7_times(v, aux, shift, card):
    """K7 at ``v``'s shape against ``torch.add(aux, v, alpha=1e-6)`` (the
    PyTorch call for the same function at shift 0, within 1 ulp: it need
    not round as one FMA), then ms per call of both geometries and that
    call (the least of three rounds in turns) and of the plain version."""
    n_vox = v.numel()
    lib = torch.add(aux, v, alpha=1e-6)
    d = (P.pipe_copy(v, aux, 0) - lib).abs()
    ulps = float((d / (torch.nextafter(lib.abs(), torch.full_like(lib, math.inf))
                       - lib.abs())).max())
    print(f"  torch.add(aux, v, alpha=1e-6) vs K7 at shift 0, {tuple(v.shape)}: "
          f"{int((d > 0).sum())} voxels differ, at most {ulps:.3g} ulp (tolerance 1 ulp)")
    if ulps > 1:
        raise AssertionError("K7 and torch.add differ by more than 1 ulp")
    del lib, d
    # three rounds of the two geometries and torch.add in turns, the least
    # of each: the card's clock drifts a few percent within a call
    rounds = [{**{g: cuda_ms(lambda: P.pipe_copy(v, aux, shift, g), 20) for g in P.GEOMETRIES},
               "add": cuda_ms(lambda: torch.add(aux, v, alpha=1e-6), 20)} for _ in range(3)]
    ms = {k: min(r[k] for r in rounds) for k in rounds[0]}
    lib_ms = ms["add"]
    plain_ms = cuda_ms(lambda: P.pipe_copy_torch(v, aux, shift), 2)
    b = bound(3 * 4 * n_vox, n_vox)
    print(f"  K7 at {tuple(v.shape)} shift {shift}: z geometry {ms['z']:.4f} ms "
          f"({12 * n_vox / ms['z'] / 1e6:.1f} GB/s), xy geometry {ms['xy']:.4f} ms "
          f"({12 * n_vox / ms['xy'] / 1e6:.1f} GB/s); torch.add {lib_ms:.4f} ms "
          f"({12 * n_vox / lib_ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]}) [{card}]")
    return {"ms": ms["xy"], "plain_ms": plain_ms, "bound": b, "library_ms": lib_ms}


def phase16_roofline(dev, card):
    """K7 against its plain version at PIPE_COPY_CASES and timed at 512^3;
    then the roofline tool at 512^3, its path's run, with the counts zeroed
    before it. Returns K7's JSON numbers."""
    print("Phase 16: pipe_copy kernel (K7) vs pipe_copy_torch; the conv_roofline "
          "tool at 512^3")
    t16 = time.time()
    err = 0.0
    for shape, shift in PIPE_COPY_CASES:
        prng = np.random.default_rng(SEED + 16)
        v = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
        aux = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
        ref = P.pipe_copy_torch(v, aux, shift)
        for geometry in P.GEOMETRIES:
            before = P.LAUNCHES
            out = P.pipe_copy(v, aux, shift, geometry)
            again = P.pipe_copy(v, aux, shift, geometry)
            torch.cuda.synchronize()
            if P.LAUNCHES != before + 2:
                raise AssertionError(f"K7 {shape}: launch count did not rise")
            if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"K7 {shape} {geometry}: two launches differ")
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"K7 {shape} shift {shift} {geometry}: differs "
                                     "from pipe_copy_torch")
            err = max(err, float((out - ref).abs().max()))
        print(f"  K7 {shape} shift {shift}: geometries z and xy equal pipe_copy_torch "
              "bit for bit, two launches identical")
        del out, again, ref
        if shape == (512, 512, 512):
            timed = k7_times(v, aux, shift, card)
        del v, aux
        torch.cuda.empty_cache()

    zero_counts()
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = conv_roofline.main(["--size", "512"])
    torch.cuda.synchronize()
    wall = time.time() - t
    n = counts()
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print("  " + ln)
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    bad = [r["metric"] for r in rows if not (math.isfinite(r["value"]) and r["value"] > 0)]
    print(f"  conv_roofline: {len(rows)} metrics in {wall:.3f} s, launches {n}")
    if rc != 0 or [r["metric"] for r in rows] != list(conv_roofline.METRICS) or bad:
        raise AssertionError(f"conv_roofline: rc {rc}, {len(rows)} metrics, bad {bad}")
    if n["K7"] == 0 or n["K1"] == 0:
        raise AssertionError(f"conv_roofline did not run on K1 and K7: {n}")
    torch.cuda.empty_cache()
    print(f"  Phase 16 took {time.time() - t16:.3f} s")
    return dict(timed, launches=n["K7"], max_abs_err=err)


# the paths K1's switches force, each held bit for bit to the plan's own:
# z taps from device memory (no ring); the generic instantiation
K1_FORCED = (K.NO_RING, K.GENERIC)


def k1_kernel_plan(plan):
    """The compiled kernel's launch plan for ``plan`` on this card's SM count,
    beside which K.plan_of (the host's) must match."""
    dy0, dy1, dx0, dx1 = K._roll_span(plan)
    return K.kernel_plan(plan.shape, plan.rank, plan.nsteps, plan.ty.shape[1],
                         plan.tx.shape[1], dy1 - dy0, dx1 - dx0)


def auto_route(psfs, shape, dev):
    """The route MIL_CONV_SEP=auto takes on a CUDA volume of ``shape`` for
    these PSFs with their flips as back projectors: 'separable' where
    every view plans it, else the FFT route's convolution."""
    probe = torch.empty(0, device=dev)
    if all(D._sep_plans(p, flip(p), shape, probe) is not None for p in psfs):
        return "separable"
    return {"ct": "K3", "torch": "torch.fft"}[D._fft_impl(shape, probe)]


def check_auto_route(route, shape, dev, k1_ms, k3_ms, torch_ms, label):
    """Fail unless ``route`` (auto_route's word for what MIL_CONV_SEP=auto
    takes) is the faster, in this run, of the K1 route and the FFT route
    that _fft_impl takes on ``shape``."""
    fft = {"ct": "K3", "torch": "torch.fft"}[D._fft_impl(shape, torch.empty(0, device=dev))]
    fft_ms = k3_ms if fft == "K3" else torch_ms
    fastest = "separable" if k1_ms < fft_ms else fft
    print(f"  {label}: auto takes the {route} route; measured K1 {k1_ms:.3f} ms against "
          f"{fft} {fft_ms:.3f} ms an iteration")
    if route != fastest:
        raise AssertionError(f"{label}: auto takes the {route} route, the {fastest} route "
                             f"ran faster")


# Phase 2's route ladder at 512^3: rank-1 Gaussians (size, sigmas) whose
# plans run K1's generic instantiation at tap costs 9 to 45 (the points
# that set SEP_MAX_TAP_COST's generic ceilings), and the dual-view PSF of
# view A (cost 55) on its specialised one
ROUTE_LADDER = (((3, 3, 3), (0.6,) * 3), ((5, 5, 5), (0.8,) * 3),
                ((7, 7, 7), (1.1,) * 3), ((11, 11, 11), (1.6,) * 3),
                ((17, 9, 9), (2.5, 1.5, 1.5)), ((13, 13, 13), (2.0,) * 3),
                ((15, 15, 15), (2.2,) * 3), ((25, 25, 25), (3.5, 1.2, 1.2)))


def route_ladder(img_d, iter_ms, card):
    """ms per RL iteration of the K1 route for each ROUTE_LADDER PSF on the
    512^3 image, beside the K3 and torch.fft routes (PSF-independent, from
    Phase 2's iter_ms), with the route sep_auto_takes picks against each.
    A printed mismatch is a finding for SEP_MAX_TAP_COST, not a failure:
    routes within a few percent of each other swap between runs."""
    fft_ms = {"ct": iter_ms["k3_route"], "torch": iter_ms["torch_fft_route"]}
    for size, sigma in ROUTE_LADDER:
        psf = gauss3(size, sigma)
        with env(MIL_CONV_SEP="1"):
            pair = D._sep_plans(psf, flip(psf), tuple(img_d.shape))[1]
        k1 = cuda_ms(lambda: D._rl_single_sep(img_d, *pair, 2, False), 2) / 2
        spec = all(D.k1_specialised(p) for p in pair)
        picks = {impl: D.sep_auto_takes(pair, impl) for impl in fft_ms}
        right = {impl: picks[impl] == (k1 < fft_ms[impl]) for impl in fft_ms}
        print(f"  route ladder {size} sigma {sigma}: tap cost {D.tap_cost(pair[0])}, "
              f"{'specialised' if spec else 'generic'}; K1 route {k1:.3f} ms an iteration "
              f"(K3 {fft_ms['ct']:.3f}, torch.fft {fft_ms['torch']:.3f}); auto takes K1 "
              f"against K3 {picks['ct']}, against torch.fft {picks['torch']}; "
              f"agrees with the times {right} [{card}]")


def k1_report(v, plan, aux, k_ms, card, label):
    """K1 at ``v``'s shape in ratio mode: its launch plan and what the
    instantiation compiled to, the peak device memory of one call beside
    ``out``'s bytes, its time against the z-shaped K7 copy (read v and aux,
    write out: the traffic K1 needs) and the device time of its one launch
    (torch.profiler)."""
    pl = K.plan_of(plan)
    if pl != k1_kernel_plan(plan):
        raise AssertionError(f"K1 {label}: kernel plan {k1_kernel_plan(plan)}, host {pl}")
    attrs = K.kernel_attrs(pl)
    print(f"  K1 {label}: plan {pl}; {attrs['registers']} registers "
          f"({attrs['spill_bytes']} bytes spilled) a thread, {attrs['blocks_per_sm']} "
          f"resident blocks of {K.THREADS} threads per SM [{card}]")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = K.conv3_sep(v, plan, aux=aux, mode="ratio")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out_bytes = out.numel() * 4
    del out
    print(f"  K1 {label}: one call's peak device memory {peak / 2 ** 20:.1f} MiB "
          f"(out is {out_bytes / 2 ** 20:.1f} MiB; the two-launch version added "
          f"{plan.rank} x {out_bytes / 2 ** 20:.1f} MiB of rank volumes)")
    if peak > out_bytes + 2 ** 20:
        raise AssertionError(f"K1 {label}: a call allocated {peak} bytes, out {out_bytes}")
    c_ms = cuda_ms(lambda: P.pipe_copy(v, aux, plan.b, "z"), 20)
    print(f"  K1 {label}: {k_ms:.4f} ms against the z-shaped K7 copy's {c_ms:.4f} ms "
          f"({12 * v.numel() / c_ms / 1e6:.1f} GB/s): {100 * c_ms / k_ms:.1f}% of the "
          f"copy ceiling [{card}]")
    device_split(lambda: K.conv3_sep(v, plan, aux=aux, mode="ratio"), 10, f"K1 {label}",
                 card)
    return c_ms


def rl_iteration_ms(img_d, psf, fwd, bp, card, label):
    """ms per RL iteration on the padded device image for the K1 route,
    the plain separable version, the K3 route and the ``torch.fft`` route
    (one card, one process, CUDA events)."""
    def sep():
        D._rl_single_sep(img_d, fwd, bp, N_ITERS, False)

    def plain():
        img = img_d.clamp_min(D.SMALLVALUE)
        est = img
        for _ in range(2):
            ratio = K.conv3_sep_torch(est, fwd, aux=img, mode="ratio")
            est = K.conv3_sep_torch(ratio, bp, aux=est, mode="update",
                                    smallvalue=D.SMALLVALUE)

    shape = tuple(img_d.shape)
    otf = D.gen_otf(psf, shape, device=img_d.device)
    otf_bp = D.gen_otf(flip(psf), shape, device=img_d.device)

    def fft(impl):
        return lambda: D._rl_single(img_d, otf, otf_bp, N_ITERS, False, impl)

    res = {"kernel_route": cuda_ms(sep, 2) / N_ITERS,
           "plain_separable": cuda_ms(plain, 1) / 2,
           "k3_route": cuda_ms(fft("ct"), 2) / N_ITERS,
           "torch_fft_route": cuda_ms(fft("torch"), 2) / N_ITERS}
    print(f"  ms per RL iteration, {label} [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.items()))
    return res


if __name__ == "__main__":
    sys.exit(main())
