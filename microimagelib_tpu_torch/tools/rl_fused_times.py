"""Time the one-launch RL iteration K2 against the K1 ratio + update pair,
K1 alone, and the copy K7 against ``torch.add``, on one CUDA device.

    python microimagelib_tpu_torch/tools/rl_fused_times.py [--root DIR] [--reps N]
        [--groups G,...] [--sweep PSF,...] [--skip-k7]

It prints the card's name and power limit, then one JSON line per
measurement, each with the card:

  * ``k2`` and ``k1_pair``: ms per call (CUDA events, calls back to back
    after a warm-up) of K2 and of a K1 ratio launch followed by a K1 update
    launch, for the bench 9^3 Gaussian and the fusion PSFs of views A and B
    on the fusion grid (320, 512, 320), with K2's peak device memory of one
    call beyond its inputs (``torch.cuda.max_memory_allocated``) and its
    launch plan where the package reports one;
  * ``k2_group``: K2 for each of ``--groups`` (the ratio store's group
    size) at the plans of ``--sweep`` (default view A's), where the
    package's K2 takes them;
  * ``k1``: K1 in ratio mode at 512^3 with the bench PSF;
  * ``k7`` and ``torch_add``: K7 in both geometries at 512^3, shift 4, and
    ``torch.add(aux, v, alpha=1e-6)``, the least of three rounds in turns,
    with GB/s of the 12 bytes a voxel.

``--root DIR`` imports ``microimagelib_tpu_torch`` from the checkout at
DIR (default: the one holding this file), so that two versions of the
kernels can be timed in turns on one card, each in its own process, e.g.
a parent commit unpacked by ``git archive`` beside the working tree. The
inputs are uniform random volumes from a numpy seed.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

FUSION_SHAPE = (320, 512, 320)
CUBE = (512, 512, 512)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gauss3(np, p, s):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    k = np.exp(-z[:, None, None] ** 2 / (2 * s[0] ** 2)
               - y[None, :, None] ** 2 / (2 * s[1] ** 2)
               - x[None, None, :] ** 2 / (2 * s[2] ** 2))
    return (k / k.sum()).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--groups", default="")
    ap.add_argument("--sweep", default="fusion A",
                    help="the PSFs (comma-separated) whose K2 the group sweep times")
    ap.add_argument("--skip-k7", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from microimagelib_tpu_torch.kernels import conv_sep as K
    from microimagelib_tpu_torch.kernels import pipe_copy as P
    from microimagelib_tpu_torch.kernels import rl_fused as KF
    from microimagelib_tpu_torch.ops.conv_sep import plan_rl_fused, plan_sep_pair

    if not torch.cuda.is_available():
        print("rl_fused_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    def emit(**kw):
        print(json.dumps(dict(kw, root=args.root, card=card)), flush=True)

    def volume(shape, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(dev)

    def flip(p):
        return np.ascontiguousarray(p[::-1, ::-1, ::-1])

    takes_group = "group" in inspect.signature(KF.rl_iter_fused).parameters
    psfs = {"bench 9^3": gauss3(np, (9, 9, 9), (1.5, 1.5, 1.5)),
            "fusion A": gauss3(np, (25, 25, 25), (3.5, 1.2, 1.2)),
            "fusion B": gauss3(np, (25, 25, 25), (1.2, 1.2, 3.5))}
    est, img = volume(FUSION_SHAPE, 1), volume(FUSION_SHAPE, 2)
    for name, psf in psfs.items():
        plan = plan_rl_fused(psf, flip(psf), FUSION_SHAPE)

        def pair(plan=plan):
            return K.conv3_sep(K.conv3_sep(est, plan.fwd, aux=img, mode="ratio"),
                               plan.bp, aux=est, mode="update")

        k2_ms = ms(lambda: KF.rl_iter_fused(est, img, plan))
        pair_ms = ms(pair)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = KF.rl_iter_fused(est, img, plan)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        same = bool(torch.equal(out, pair()))
        del out
        emit(what="k2", psf=name, shape=list(FUSION_SHAPE), ms=k2_ms,
             peak_bytes=peak, equals_k1_pair=same,
             config=KF.LAST_CONFIG if isinstance(KF.LAST_CONFIG, dict)
             else list(KF.LAST_CONFIG or ()))
        emit(what="k1_pair", psf=name, shape=list(FUSION_SHAPE), ms=pair_ms)
        if name in args.sweep.split(",") and takes_group and args.groups:
            for g in (int(n) for n in args.groups.split(",")):
                t = ms(lambda: KF.rl_iter_fused(est, img, plan, group=g))
                emit(what="k2_group", psf=name, shape=list(FUSION_SHAPE), group=g, ms=t,
                     ring_bytes=KF.LAST_CONFIG["ring_bytes"],
                     store_bytes=KF.LAST_CONFIG["store_bytes"])
    del est, img
    torch.cuda.empty_cache()

    v, aux = volume(CUBE, 3), volume(CUBE, 4)
    psf = psfs["bench 9^3"]
    fwd, _bp = plan_sep_pair(psf, flip(psf), CUBE)
    emit(what="k1", mode="ratio", shape=list(CUBE),
         ms=ms(lambda: K.conv3_sep(v, fwd, aux=aux, mode="ratio")))
    if not args.skip_k7:
        # three rounds in turns, the least of each
        calls = {"z": lambda: P.pipe_copy(v, aux, 4, "z"),
                 "xy": lambda: P.pipe_copy(v, aux, 4, "xy"),
                 "torch.add": lambda: torch.add(aux, v, alpha=1e-6)}
        rounds = [{k: ms(fn) for k, fn in calls.items()} for _ in range(3)]
        gbs = 12 * v.numel() / 1e6
        for k in calls:
            t = min(r[k] for r in rounds)
            if k == "torch.add":
                emit(what="torch_add", shape=list(CUBE), ms=t, gb_per_s=gbs / t)
            else:
                emit(what="k7", geometry=k, shape=list(CUBE), shift=4, ms=t, gb_per_s=gbs / t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
