"""Time the registration cost kernels K5 (NCC sums), K4 (sums and
gradient) and K6 (K5's sums of 8 line-search probes in one launch) per
call at the levels of the registration pyramids, on one CUDA device.

    python microimagelib_tpu_torch/tools/corr_levels.py [--root DIR] [--levels ZxYxX,...]
        [--reps N] [--matrix reg128|identity]

For each level and kernel it prints one JSON line: the device time of one
call (``torch.profiler``: the time per launch of each kernel the call
launches, summed), the ms per call of calls back to back (CUDA events),
the wrapper's host microseconds per call (host clock, no sync between
calls) and the least time the card could take (8 bytes per valid voxel
over 3.35 TB/s; K6: the larger of that and its 43 float32 operations per
valid voxel and probe over 67 TFLOP/s). The first line is the card's name
and power limit.

``--root DIR`` imports ``microimagelib_tpu_torch`` from the checkout at
DIR (default: the one holding this file), so that two versions of the
kernels can be timed in turns on one card, each in its own process, e.g.
a parent commit unpacked by ``git archive`` beside the working tree. Only
the package's public ``kernels.corr.corr3d``, ``corr3d_nprobe`` and
``ops.matrix`` are used.
The inputs are uniform random volumes from a numpy seed and the matrix of
``bench_all.py``'s reg128 case (its rotations take each warp's 32
neighbouring voxels across source rows and planes), or with
``--matrix identity`` the identity (each corner row of a warp one
stretch of a source row).
"""

import argparse
import json
import os
import subprocess
import sys
import time

LEVELS = ((16, 32, 128), (32, 64, 256), (64, 128, 512), (128, 256, 512),
          (256, 512, 512), (320, 512, 320))
REG_DOF = [2.0, -1.5, 1.0, 2.0, -1.0, 1.5, 1, 1, 1]
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K6's probes: the line search's ladder (ops/powell_device.py LS_LADDER)
# along a direction of small translations and linear entries
LADDER = (-2.618, -1.0, -0.382, 0.382, 1.0, 1.618, 2.618, 4.236)
STEP = (0.002, 0, 0.001, 0.5, 0, 0.001, 0, -0.3, 0, 0, 0.002, 0.2)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--levels", default=",".join("x".join(map(str, s)) for s in LEVELS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--matrix", choices=("reg128", "identity"), default="reg128")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from microimagelib_tpu_torch.kernels import corr as C
    from microimagelib_tpu_torch.ops.matrix import dof_to_matrix

    if not torch.cuda.is_available():
        print("corr_levels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    dof = REG_DOF if args.matrix == "reg128" else [0, 0, 0, 0, 0, 0, 1, 1, 1]
    m = np.asarray(dof_to_matrix(dof, 6), np.float32)
    eight = np.stack([m + np.float32(a) * np.asarray(STEP, np.float32) for a in LADDER])
    for text in args.levels.split(","):
        shape = tuple(int(n) for n in text.split("x"))
        rng = np.random.default_rng(0)
        src = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        tgt = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        valid = float(C.corr3d_torch(torch.ones_like(src), src, m)[0])
        for kernel in ("K5", "K4", "K6"):
            def call():
                if kernel == "K6":
                    return C.corr3d_nprobe(src, tgt, eight)
                return C.corr3d(src, tgt, m, grad=kernel == "K4")

            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    call()
                torch.cuda.synchronize()
            kernels = {e.key: e.device_time_total / 1e3 / e.count
                       for e in prof.key_averages() if e.device_time_total > 0 and e.count}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                call()
            end.record()
            end.synchronize()
            t = time.perf_counter()
            for _ in range(args.reps):
                call()
            host_us = (time.perf_counter() - t) / args.reps * 1e6
            torch.cuda.synchronize()
            print(json.dumps({
                "root": args.root, "matrix": args.matrix, "level": list(shape),
                "kernel": kernel,
                "device_ms": sum(kernels.values()) if kernels else None,
                "kernels": len(kernels),
                "event_ms": start.elapsed_time(end) / args.reps,
                "host_us": host_us,
                "bound_ms": max(8 * valid / HBM_BYTES_PER_S,
                                43 * 8 * valid / FP32_OPS_PER_S if kernel == "K6" else 0) * 1e3,
                "card": card}))
        del src, tgt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
