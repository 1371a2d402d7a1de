#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``microimagelib_tpu_torch/csrc/``
with nvcc (sm_90a, one nvcc per source, in parallel), then:

  1. compares the separable-conv kernel (K1) with its plain PyTorch
     version on the card, in all three epilogue modes, for five PSF/grid
     cases (max|diff| <= 1e-5 * max|ref|: both are fp32 FMAs, only the
     summation order differs);
  2. runs ``decon_singleview`` on a 512^3 volume with the 9^3 Gaussian
     PSF of bench.py, 10 iterations, and checks it against the
     ``torch.fft`` route (rtol 2e-4, atol 2e-4 * max) and that K1
     launched exactly 20 times;
  3. the same for a 45-degree tilted (17, 9, 25) PSF on a (256, 512, 512)
     volume (rank > 1 with per-tap rolls; rtol/atol 5e-4);
  4. runs the deconSingleView CLI on a 200 x 512 x 512 16-bit TIFF;
  5. compares the FFT-convolution kernel (K3) with complex128
     ``torch.fft`` and with its fp32 plain version at four grids, odd
     factors 3 and 5 among them (max|diff| <= 1e-4 * max|ref|);
  6. runs ``decon_dualview`` on two (320, 512, 512) views with
     anisotropic 25^3 PSFs and Wiener-Butterworth back projectors, 2
     iterations: exactly 8 K3 calls, no K1 launch, and within 2e-3 of the
     same run on ``torch.fft``;
  7. the same views with matched (flipped) PSFs, 10 iterations: the
     separable route, exactly 40 K1 launches, within 2e-4 of the FFT
     route;
  8. the genBackProjector and deconDualView CLIs on two 200 x 512 x 512
     16-bit TIFFs (grid (256, 512, 512), so K3 runs);
  9. compares the registration kernels K5 (resample + NCC sums) and K4
     (the sums and their gradient in the matrix) with their plain
     versions at (16, 32, 128), (64, 128, 512) and (256, 512, 512), five
     matrices (ss, st within rtol 1e-5; gs, gt within 2e-4 x max|ref|),
     and times them;
 10. registers a (256, 512, 512) bead volume with its copy moved by the
     reg128 matrix of bench_all.py: ``reg3d``, choice 2, method 7, the
     automatic pyramid, default knobs. Checks NCC >= 0.95, the matrix
     within 0.5 voxel of the truth over the central half-box, K4 and K5
     launched at every level and no plain-version call; prints each
     level's evaluations, launches, kernel ms per evaluation and host
     share. Then the same pipeline at (128, 256, 256) on the kernels and
     on ``MIL_NCC_IMPL=gather``: NCC within 1e-3, translations within
     0.35 voxel;
 11. the reg3D CLI on two 200 x 512 x 512 16-bit TIFFs, -regc 2 -affm 7
     -bit 16 -otmx.

It prints the card's name and power limit beside every time, ms per RL
iteration for the K1, K3 and ``torch.fft`` routes, one JSON line
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
from microimagelib_tpu_torch.io.tiff import readtifstack, readtifstack_16to16, writetifstack
from microimagelib_tpu_torch.io.tmx import read_tmx
from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.kernels import fft_ct as F
from microimagelib_tpu_torch.models import deconvolution as D
from microimagelib_tpu_torch.models import gen_backprojector
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.ops.affine import affine_transform_3d
from microimagelib_tpu_torch.ops.conv_sep import plan_sep
from microimagelib_tpu_torch.ops.matrix import dof_to_matrix

SEED = 0
N_ITERS = 10
DUAL_SHAPE = (320, 512, 512)
WB_ITERS = 2          # Guo 2020's count with Wiener-Butterworth projectors
REG_SHAPE = (256, 512, 512)
REG_DOF = [2.0, -1.5, 1.0, 2.0, -1.0, 1.5, 1, 1, 1]   # bench_all.py:122
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# fp32 operations per valid voxel, counted from csrc/corr.cu: coordinates
# 6, box 6, floor and fractions 6, seven lerps 21, ss/st 4 (K5); the three
# derivative lerps 19 and the gradient sums 24 on top (K4)
CORR_OPS = {False: 43, True: 86}


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
    ]
    for name, psf, shape, kw in cases:
        plan = plan_sep(psf, shape, **kw)
        if plan is None:
            raise AssertionError(f"{name}: planner refused")
        if "rolls" in name and plan.rolls is None:
            raise AssertionError(f"{name}: no per-tap rolls planned")
        v = on_card(rng.random(shape, dtype=np.float32) * 100)
        aux = on_card(rng.random(shape, dtype=np.float32) + 0.5)
        for mode in ("plain", "ratio", "update"):
            before = K.LAUNCHES
            out = K.conv3_sep(v, plan, aux=aux, mode=mode)
            torch.cuda.synchronize()
            if K.LAUNCHES != before + 1:
                raise AssertionError(f"{name} {mode}: launch count did not rise")
            ref = K.conv3_sep_torch(v, plan, aux=aux, mode=mode)
            check_close(f"{name} rank {plan.rank} {mode}", out.cpu(), ref.cpu(),
                        0.0, 1e-5)

    # ---- Phase 2: the headline configuration ---------------------------
    print(f"Phase 2: decon_singleview 512^3, bench PSF, {N_ITERS} iterations")
    psf = bench_psf()
    img = rng.random((512, 512, 512), dtype=np.float32) * 100 + 1
    fwd, bp = D._sep_plans(psf, flip(psf), img.shape)
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
    k1_lib_ms = conv3d_library_ms(est, psf, fwd, card)
    n_vox = est.numel()
    taps = fwd.nsteps + fwd.ty.shape[1] + fwd.tx.shape[1]
    k1_bound = bound(3 * 4 * n_vox, n_vox * (2 * fwd.rank * taps + 1))

    K.LAUNCHES = 0
    rec = np.zeros(10)
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
    del img_d, imgc

    # ---- Phase 3: the measured-PSF class -------------------------------
    print(f"Phase 3: decon_singleview (256, 512, 512), tilted PSF, {N_ITERS} iterations")
    tpsf = tilted_psf()
    img3 = rng.random((256, 512, 512), dtype=np.float32) * 100 + 1
    fwd3, bp3 = D._sep_plans(tpsf, flip(tpsf), img3.shape)
    print(f"  plans: fwd rank {fwd3.rank}, {fwd3.nsteps} z taps, "
          f"{fwd3.ty.shape[1]} y, {fwd3.tx.shape[1]} x taps, rolls "
          f"{fwd3.rolls is not None}; bp rank {bp3.rank}")
    if fwd3.rank < 2 or fwd3.rolls is None or bp3.rolls is None:
        raise AssertionError("the tilted PSF did not plan at rank > 1 with rolls")
    K.LAUNCHES = 0
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
    rl_iteration_ms(img3_d, tpsf, fwd3, bp3, card, "tilted (256,512,512)")
    del img3_d, est3

    # ---- Phase 4: the CLI ----------------------------------------------
    print("Phase 4: deconSingleView CLI, 200 x 512 x 512 16-bit TIFF")
    with tempfile.TemporaryDirectory() as tmp:
        f_img, f_psf, f_out = (os.path.join(tmp, n) for n in
                               ("img.tif", "psf.tif", "out.tif"))
        writetifstack(f_img, rng.random((200, 512, 512), dtype=np.float32)
                      * 1000 + 100, 16)
        writetifstack(f_psf, psf, 32)
        before = K.LAUNCHES
        rc = decon_sv.main(["-i", f_img, "-fp", f_psf, "-o", f_out,
                            "-it", str(N_ITERS), "-bit", "32"])
        if rc != 0:
            raise AssertionError(f"CLI returned {rc}")
        res, size = readtifstack(f_out)
        if res.shape != (200, 512, 512) or not np.isfinite(res).all():
            raise AssertionError(f"CLI output bad: shape {res.shape}")
        if K.LAUNCHES - before != 2 * N_ITERS:
            raise AssertionError(f"CLI: {K.LAUNCHES - before} K1 launches")
        print(f"  CLI output {size} (x, y, z), finite, {K.LAUNCHES - before} K1 launches")
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
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase5_k3(dev, rng, card):
    """K3 against complex128 torch.fft and its fp32 plain version; ms per
    convolution at the two large grids. Returns the kernel's JSON numbers
    at DUAL_SHAPE."""
    print("Phase 5: conv3_ct kernel vs complex128 torch.fft and conv3_ct_torch")
    res = {}
    for shape in ((32, 32, 128), (64, 96, 128), DUAL_SHAPE, (256, 512, 512)):
        prng = np.random.default_rng(SEED)
        psf = prng.random(shape, dtype=np.float32)
        otf = torch.fft.rfftn(torch.from_numpy(psf / psf.sum()).to(dev)).contiguous()
        del psf
        v = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100).to(dev)
        before = F.LAUNCHES
        out = F.conv3_ct(v, otf)
        torch.cuda.synchronize()
        if F.LAUNCHES != before + 1:
            raise AssertionError(f"K3 {shape}: launch count did not rise")
        ref = torch.fft.irfftn(torch.fft.rfftn(v.double()) * otf.to(torch.complex128),
                               s=shape).float()
        check_close(f"K3 {shape} vs complex128", out.cpu(), ref.cpu(), 0.0, 1e-4)
        del ref
        plain = F.conv3_ct_torch(v, otf)
        check_close(f"K3 {shape} vs conv3_ct_torch", out.cpu(), plain.cpu(), 0.0, 1e-4)
        err = float((out - plain).abs().max())
        del out, plain
        if shape[0] >= 256:
            k_ms = cuda_ms(lambda: F.conv3_ct(v, otf), 10)
            p_ms = cuda_ms(lambda: F.conv3_ct_torch(v, otf), 10)
            print(f"  K3 at {shape}: kernel {k_ms:.3f} ms, conv3_ct_torch "
                  f"{p_ms:.3f} ms per convolution [{card}]")
            if shape == DUAL_SHAPE:
                res = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
        del v, otf
        torch.cuda.empty_cache()
    return res


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
    out_k = D.decon_dualview(a, b, pa, pb, n_iters=N_ITERS, device=dev, mem_mode=1)
    if K.LAUNCHES != 4 * N_ITERS:
        raise AssertionError(f"expected {4 * N_ITERS} K1 launches, got {K.LAUNCHES}")
    print(f"  separable route: {K.LAUNCHES} K1 launches")
    before = F.LAUNCHES
    with env(MIL_CONV_SEP="0"):
        out_f = D.decon_dualview(a, b, pa, pb, n_iters=N_ITERS, device=dev, mem_mode=1)
    print(f"  FFT route: {F.LAUNCHES - before} K3 calls")
    check_close("dual matched separable vs FFT route", out_k, out_f, 2e-4, 2e-4)
    del out_k, out_f
    a_d, b_d = (torch.from_numpy(x).to(dev) for x in (a, b))
    plans = [p for psf in (pa, pb) for p in D._sep_plans(psf, flip(psf), DUAL_SHAPE)]
    otfs = [D.gen_otf(p, DUAL_SHAPE, device=dev) for p in (pa, pb, flip(pa), flip(pb))]
    ms = {"K1 route": cuda_ms(lambda: D._rl_dual_sep(a_d, b_d, *plans, N_ITERS,
                                                     False), 2) / N_ITERS}
    for name, impl in (("K3 route", "ct"), ("torch.fft route", "torch")):
        ms[name] = cuda_ms(lambda: D._rl_dual(a_d, b_d, *otfs, N_ITERS, False,
                                              impl), 2) / N_ITERS
    print(f"  ms per dual-view iteration {DUAL_SHAPE}, matched 25^3 [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
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


def phase9_corr(dev, card):
    """K5 and K4 against their plain versions on the card at the pyramid's
    x = 128 and 512 levels and the full slice shape; ms per call from CUDA
    events (the launch plus the float64 sum of the block rows), GB/s of the
    two volumes read. Returns K5's and K4's JSON numbers at REG_SHAPE."""
    print("Phase 9: corr3d kernels K5 (sums) and K4 (sums + gradient) vs "
          "their plain versions")
    res = {}
    for shape in ((16, 32, 128), (64, 128, 512), REG_SHAPE):
        prng = np.random.default_rng(SEED + 9)
        src = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        tgt = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        n_vox = src.numel()
        for grad in (False, True):
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
                print(f"  {'K4' if grad else 'K5'} {shape} {name}: ss/st rel "
                      f"{rel.max():.3g}" + (f", gs/gt {g_err:.3g} x max" if grad
                                            else ""))
            m = CORR_MATRICES["reg128-truth"]
            ms = cuda_ms(lambda: C.corr3d(src, tgt, m, grad=grad), 20)
            plain_ms = cuda_ms(lambda: C.corr3d_torch(src, tgt, m, grad=grad), 2)
            valid = float(C.corr3d_torch(torch.ones_like(src), src, m)[0])
            b = bound(8 * valid, CORR_OPS[grad] * valid)
            print(f"  {'K4' if grad else 'K5'} at {shape}: {ms:.4f} ms per call, "
                  f"{8 * n_vox / ms / 1e6:.1f} GB/s of src+tgt, plain "
                  f"{plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]")
            if shape == REG_SHAPE:
                res[grad] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound": b}
                device_split(lambda: C.corr3d(src, tgt, m, grad=grad), 10,
                             f"{'K4' if grad else 'K5'} at {shape}", card)
        del src, tgt
        torch.cuda.empty_cache()
    return res


def device_split(fn, reps, label, card):
    """Device time per call of each kernel ``fn`` launches, by
    torch.profiler (printed; 'not measured' when the trace has none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / reps)
            for e in prof.key_averages() if e.device_time_total > 0]
    text = ", ".join(f"{k[:40]} {v:.4f} ms" for k, v in
                     sorted(rows, key=lambda r: -r[1])) or "not measured"
    print(f"  {label}, device time per call by kernel: {text} [{card}]")


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
        kern_ms = d4 * t4 + d5 * t5
        print(f"  level {label} {shape}: {d4 + d5} evaluations ({d4} K4, {d5} K5), "
              f"{secs:.3f} s, kernel {kern_ms / (d4 + d5):.4f} ms per evaluation "
              f"(K4 {t4:.4f}, K5 {t5:.4f} ms per call), host share "
              f"{1 - kern_ms / 1e3 / secs:.3f} [{card}]")
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
