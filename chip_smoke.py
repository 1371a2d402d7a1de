#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``microimagelib_tpu_torch/csrc/``
with nvcc (sm_90a), then:

  1. compares the separable-conv kernel (K1) with its plain PyTorch
     version on the card, in all three epilogue modes, for five PSF/grid
     cases (max|diff| <= 1e-5 * max|ref|: both are fp32 FMAs, only the
     summation order differs);
  2. runs ``decon_singleview`` on a 512^3 volume with the 9^3 Gaussian
     PSF of bench.py, 10 iterations, and checks it against the port's FFT
     route (rtol 2e-4, atol 2e-4 * max) and that K1 launched exactly 20
     times;
  3. the same for a 45-degree tilted (17, 9, 25) PSF on a (256, 512, 512)
     volume (rank > 1 with per-tap rolls; rtol/atol 5e-4);
  4. runs the deconSingleView CLI on a 200 x 512 x 512 16-bit TIFF.

It prints the card's name and power limit, ms per RL iteration for the
kernel route, the plain separable version and the FFT route, one JSON
line describing each kernel, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
then nonzero and that line is not printed. Needs one CUDA device; there
is no CPU path.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from microimagelib_tpu_torch.cli import decon_sv
from microimagelib_tpu_torch.io.tiff import readtifstack, writetifstack
from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.models import deconvolution as D
from microimagelib_tpu_torch.ops.conv_sep import plan_sep

SEED = 0
N_ITERS = 10


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

    K.LAUNCHES = 0
    rec = np.zeros(10)
    out_k = D.decon_singleview(img, psf, n_iters=N_ITERS, device=dev,
                               mem_mode=1, records=rec)
    main_launches = K.LAUNCHES
    print(f"  separable route: {main_launches} K1 launches, decon {rec[8]:.3f} s, "
          f"total {rec[9]:.3f} s (records {rec.tolist()})")
    if main_launches != 2 * N_ITERS:
        raise AssertionError(f"expected {2 * N_ITERS} K1 launches, got {main_launches}")
    os.environ["MIL_CONV_SEP"] = "0"
    try:
        out_f = D.decon_singleview(img, psf, n_iters=N_ITERS, device=dev, mem_mode=1)
    finally:
        del os.environ["MIL_CONV_SEP"]
    if K.LAUNCHES != main_launches:
        raise AssertionError("the FFT route launched K1")
    check_close("512^3 separable vs FFT route", out_k, out_f, 2e-4, 2e-4)
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
    os.environ["MIL_CONV_SEP"] = "0"
    try:
        out_f = D.decon_singleview(img3, tpsf, n_iters=N_ITERS, device=dev, mem_mode=1)
    finally:
        del os.environ["MIL_CONV_SEP"]
    check_close("tilted separable vs FFT route", out_k, out_f, 5e-4, 5e-4)
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

    print(f"iteration ms at 512^3 [{card}]: " + json.dumps(iter_ms))
    print(json.dumps({"kernels": [{
        "name": "conv3_sep",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/conv_sep.cu",
        "replaces": "microimagelib_tpu/ops/conv_sep.py:506",
        "launches": main_launches,
        "max_abs_err": max(kern.values()),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def rl_iteration_ms(img_d, psf, fwd, bp, card, label):
    """ms per RL iteration on the padded device image for the kernel
    route, the plain separable version and the FFT route (one card, one
    process, CUDA events)."""
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

    def fft():
        D._rl_single(img_d, otf, otf_bp, N_ITERS, False)

    res = {"kernel_route": cuda_ms(sep, 2) / N_ITERS,
           "plain_separable": cuda_ms(plain, 1) / 2,
           "fft_route": cuda_ms(fft, 2) / N_ITERS}
    print(f"  ms per RL iteration, {label} [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.items()))
    return res


if __name__ == "__main__":
    sys.exit(main())
