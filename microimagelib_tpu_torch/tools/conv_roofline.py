"""The separable convolution's roofline on one card: what K1 reaches
against what a copy in K1's launch shape (K7) reaches.

    python -m microimagelib_tpu_torch.tools.conv_roofline                           # cuda:0, 512^3
    python -m microimagelib_tpu_torch.tools.conv_roofline --device cpu --size 32    # plain versions

The port of tools/conv_roofline.py. In one process, on size^3 float32
volumes (``--size``, else ``MIL_BENCH_SIZE``, else 512) with bench.py's
9^3 Gaussian PSF, it measures

  1. ms per iteration of a 10-iteration ``rl_decon_single`` through the
     library dispatch (the separable route: two K1 launches per
     iteration, and the planning on the host), best of 3 after a warm-up;
  2. ms per call of K1 in ratio mode (forward plan) and update mode (back
     projector), chained x10; and the device time of K1's one launch
     (``conv3_sep_kernel``) from ``torch.profiler``, divided by the
     launches the trace holds;
  3. ms per call and GB/s of K7 (``kernels/pipe_copy.py``) chained x10 in
     its two geometries (``_z``, ``_xy``). The z geometry is K1's
     ceiling: one launch that reads v and aux and writes out, as K1 must.
     The shift is the forward plan's z reach b;
  4. GB/s of a plain torch elementwise pass, ``x * 1.0000001``, over
     2 GiB (64 MiB below size 512);

and from them the model: the least traffic of an RL iteration (2 calls x
3 volume passes: K1 moves no more since it keeps its z sums on chip), its
fp32 operations, and what share of the z-geometry K7 ceiling the
iteration and one K1 launch reach.

Output: the card's name and power limit (``nvidia-smi``), then one JSON
line per metric, ``{"metric", "value", "unit", "card"}``. On the CPU
(``--device cpu``, the only way onto it) every kernel runs its plain
PyTorch version and the launch time is that of the plain version's two
stages: numbers that test the plumbing, not device metrics. The CPU path
touches no ``torch.cuda`` API.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from microimagelib_tpu_torch.kernels.conv_sep import conv3_sep, xypass_torch, zpass_torch
from microimagelib_tpu_torch.kernels.pipe_copy import pipe_copy
from microimagelib_tpu_torch.models.deconvolution import gen_otf, rl_decon_single
from microimagelib_tpu_torch.ops.conv_sep import plan_sep_pair

N_ITERS = 10
CHAIN = 10
REPS = 3
# K1's one launch as torch.profiler names it (csrc/conv_sep.cu; a template,
# so the name is matched as a substring)
K1_KERNEL = "conv3_sep_kernel"
# the metrics, in the order the tool prints them
METRICS = ("rl512_ms_per_iter", "plan_fwd_rank", "plan_z_taps", "plan_y_taps",
           "plan_x_taps", "conv_ratio_ms_per_call", "conv_update_ms_per_call",
           "conv_launch_ms", "pipe_copy_shift", "pipe_copy_ms_per_call_z",
           "pipe_copy_bw_z", "pipe_copy_ms_per_call_xy", "pipe_copy_bw_xy",
           "torch_elementwise_bw", "model_traffic_per_iter", "model_fp32_tflop_per_iter",
           "achieved_bw_vs_model", "pct_of_pipe_copy_ceiling", "conv_pct_of_copy_ceiling")


def bench_psf():
    """The 9^3 Gaussian of bench.py, sum-normalized."""
    zz, yy, xx = np.meshgrid(*[np.arange(9) - 4] * 3, indexing="ij")
    psf = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 4.5).astype(np.float32)
    return psf / psf.sum()


def card_line(dev):
    """``nvidia-smi``'s name and power limit of the card; 'cpu' on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def best_ms(fn, cuda, reps=REPS):
    """Least ms of ``reps`` calls of ``fn`` after one warm-up call: CUDA
    events around each call on the card (the device idle before it), the
    host clock on the CPU."""
    fn()
    best = math.inf
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t) * 1e3
        best = min(best, ms)
    return best


def kernel_device_ms(fn, names, reps=CHAIN):
    """Device ms per launch of each kernel in ``names`` (matched as a
    substring of the profiler's key) over ``reps`` calls of ``fn``, from
    ``torch.profiler``: its device time over the launches the trace holds
    (a trace can miss some, and one late in a long process can come back
    empty: up to three traces are taken). Raises when the traces hold none
    of one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
                if e.device_time_total > 0 and e.count]
        if all(any(name in key for key, _t, _n in rows) for name in names):
            break
    out = {}
    for name in names:
        hit = [(t, n) for key, t, n in rows if name in key]
        if not hit:
            raise RuntimeError(f"the profiler trace holds no {name} launch")
        out[name] = sum(t for t, _ in hit) / 1e3 / sum(n for _, n in hit)
    return out


def model(pf, pb, shape):
    """The traffic (GB) and fp32 operations (TFLOP) of one RL iteration,
    a K1 call with the forward plan then one with the back projector's:
    ``traffic`` the least the work needs and what the one-launch K1 moves
    from device memory (v and aux read, out written: 3 volume passes a
    call), ``tflop`` an FMA as 2 operations per tap and rank plus the
    epilogue's one."""
    n = int(np.prod(shape))
    vol_gb = 4 * n / 1e9
    plans = (pf, pb)
    return {
        "traffic": len(plans) * 3 * vol_gb,
        "tflop": sum(n * (2 * p.rank * (p.nsteps + p.ty.shape[1] + p.tx.shape[1]) + 1)
                     for p in plans) / 1e12,
    }


def run(size, dev, emit):
    """The four steps and the model at ``size``^3 on ``dev``; each metric
    goes to ``emit(metric, value, unit)`` as soon as it is known."""
    cuda = dev.type == "cuda"
    shape = (size, size, size)
    vol_gb = 4 * size ** 3 / 1e9
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
    psf = bench_psf()
    bp = np.ascontiguousarray(psf[::-1, ::-1, ::-1])

    # --- 1. the RL iteration through the library dispatch -------------
    otf = gen_otf(psf, shape, device=dev)
    otf_bp = gen_otf(bp, shape, device=dev)
    ms_iter = best_ms(lambda: rl_decon_single(img, otf, otf_bp, N_ITERS, psf=psf,
                                              psf_bp=bp), cuda) / N_ITERS
    del otf, otf_bp
    emit("rl512_ms_per_iter", ms_iter, "ms")

    # --- 2. K1 calls chained, and its two launches --------------------
    pair = plan_sep_pair(psf, bp, shape)
    if pair is None:
        raise RuntimeError(f"the separable planner refused the bench PSF at {shape}")
    pf, pb = pair
    emit("plan_fwd_rank", pf.rank, "rank")
    emit("plan_z_taps", pf.nsteps, "taps")
    emit("plan_y_taps", pf.ty.shape[1], "taps")
    emit("plan_x_taps", pf.tx.shape[1], "taps")

    def chain(mode, plan):
        def fn():
            v = img
            for _ in range(CHAIN):
                v = conv3_sep(v, plan, aux=img, mode=mode)
        return fn

    for mode, plan in (("ratio", pf), ("update", pb)):
        emit(f"conv_{mode}_ms_per_call", best_ms(chain(mode, plan), cuda) / CHAIN, "ms")
    if cuda:
        launch_ms = kernel_device_ms(lambda: conv3_sep(img, pf, aux=img, mode="ratio"),
                                     (K1_KERNEL,))[K1_KERNEL]
    else:
        zs = zpass_torch(img, pf)
        launch_ms = (best_ms(lambda: zpass_torch(img, pf), cuda)
                     + best_ms(lambda: xypass_torch(zs, pf, img, "ratio"), cuda))
        del zs
    emit("conv_launch_ms", launch_ms, "ms")

    # --- 3. K7: the ceiling of each K1 launch shape -------------------
    shift = pf.b
    emit("pipe_copy_shift", shift, "planes")
    copy_bw = {}
    for geometry in ("z", "xy"):
        def copies():
            r = img
            for _ in range(CHAIN):
                r = pipe_copy(r, img, shift, geometry)

        ms = best_ms(copies, cuda) / CHAIN
        copy_bw[geometry] = 3 * vol_gb / (ms / 1e3)
        emit(f"pipe_copy_ms_per_call_{geometry}", ms, "ms")
        emit(f"pipe_copy_bw_{geometry}", copy_bw[geometry], "GB/s")
    del img

    # --- 4. a plain torch elementwise pass over 2 GiB -----------------
    nbig = (1 << 29) if size >= 512 else (1 << 24)
    gen = torch.Generator(device=dev).manual_seed(0)
    big = torch.rand(nbig, generator=gen, device=dev)

    def scale6():
        r = big
        for _ in range(6):
            r = r * 1.0000001

    ms = best_ms(scale6, cuda) / 6
    del big
    emit("torch_elementwise_bw", 2 * nbig * 4 / 1e9 / (ms / 1e3), "GB/s")

    # --- model --------------------------------------------------------
    m = model(pf, pb, shape)
    emit("model_traffic_per_iter", m["traffic"], "GB")
    emit("model_fp32_tflop_per_iter", m["tflop"], "TFLOP")
    achieved = m["traffic"] / (ms_iter / 1e3)
    emit("achieved_bw_vs_model", achieved, "GB/s")
    emit("pct_of_pipe_copy_ceiling", 100.0 * achieved / copy_bw["z"], "%")
    # one K1 launch moves 3 volumes, as the z-geometry copy does
    emit("conv_pct_of_copy_ceiling",
         100.0 * 3 * vol_gb / (launch_ms / 1e3) / copy_bw["z"], "%")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' runs the plain versions)")
    ap.add_argument("--size", type=int, default=None,
                    help="edge of the cubic volume (default MIL_BENCH_SIZE, else 512)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    size = args.size or int(os.environ.get("MIL_BENCH_SIZE", "512"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("conv_roofline: no CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 1
    card = card_line(dev)
    print(card, flush=True)

    def emit(metric, value, unit):
        print(json.dumps({"metric": metric, "value": float(value), "unit": unit,
                          "card": card}), flush=True)

    run(size, dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
