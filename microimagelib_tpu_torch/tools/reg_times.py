"""Time 3-D registration per pyramid level and the batch's registration
stage on one CUDA device, for one or more checkouts of the package in
turns.

    python microimagelib_tpu_torch/tools/reg_times.py [--roots DIR,DIR,...]
        [--shape Z,Y,X] [--tps N] [--xy N] [--runs N] [--batch-ls]
        [--engine auto|grad|device|hybrid] [--fusion]

For each root (default: the checkout holding this file) it prints one JSON
line per run of ``reg3d`` (choice 2, method 7, the automatic pyramid,
default knobs; ``--engine`` picks the engine, ``--batch-ls`` sets
MIL_REG_BATCH_LS=1) on a bead volume of ``--shape`` and its copy moved by
the reg128 matrix, or with ``--fusion`` on the fusion's pair (``chip_smoke.py``
Phase 14's diSPIM views, isotropized to (320, 512, 320) as
``fusion_dualview`` registers them), after one warm run: per level the
seconds (the card synchronized at the level's end), the evaluations (K4/K5
launches from the host and, where the checkout has K9, the evaluations K9
ran on each body; K6's launches and K9's passes of its body, up to 8
matrices each), K9's launches and its lines (the hybrid engine's), the
syncs (one a K4/K5/K6 launch, a K9 line, or a level's K9 ladder), the
K4/K5 sums' device time (evaluations x each kernel's device ms per launch
at the level shape, torch.profiler) and the rest of the level's time as
its host share, and, where the checkout's K9 stamps its trace
(``kernels/reg_ladder.py::split_medians``), the medians of each
evaluation's parts in microseconds (rows, hand-over, column sum, the
optimizer's step; overall and per body), from the warm run's ladders run
again with a trace; then, unless ``--tps 0``, one line with the end-to-end
surrogate's (``tools/e2e_surrogate.py``) registration seconds per
timepoint over ``--tps`` timepoints at ``--xy``. The first line is the
card's name and power limit.

The roots run in turns (``tools/turns.py``), e.g. ``--roots
build/parent,.,.,build/parent`` for a parent commit unpacked by ``git
archive`` beside the working tree.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REG_DOF = [2.0, -1.5, 1.0, 2.0, -1.0, 1.5, 1, 1, 1]   # bench_all.py:122


def beads(shape, seed, dev, sigma=3.0):
    """80 beads per 128^3 voxels in the central half of each axis,
    amplitudes 80-200, smoothed by a sum-normalized Gaussian."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = int(round(80 * np.prod(shape) / 128 ** 3))
    pos = [rng.integers(s // 4, 3 * s // 4, size=n) for s in shape]
    amp = rng.uniform(80, 200, size=n).astype(np.float32)
    vol = torch.zeros(shape, dtype=torch.float32, device=dev)
    vol[tuple(torch.from_numpy(p).to(dev) for p in pos)] = torch.from_numpy(amp).to(dev)
    g = 1.0
    for ax, s in enumerate(shape):
        d = torch.arange(s, dtype=torch.float64, device=dev)
        d = torch.minimum(d, s - d)
        k = torch.exp(-d * d / (2 * sigma ** 2))
        g = g * k.reshape([-1 if i == ax else 1 for i in range(3)])
    g = (g / g.sum()).float()
    return torch.fft.irfftn(torch.fft.rfftn(vol) * torch.fft.rfftn(g), s=shape)


def gauss3(p, s):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    k = np.exp(-z[:, None, None] ** 2 / (2 * s[0] ** 2)
               - y[None, :, None] ** 2 / (2 * s[1] ** 2)
               - x[None, None, :] ** 2 / (2 * s[2] ** 2))
    return (k / k.sum()).astype(np.float32)


FUSION_SHAPE = (320, 512, 320)
FUSION_RAW = (52, 512, 320)
FUSION_PIXEL = (0.1625, 0.1625, 1.0)


def fusion_pair(dev):
    """chip_smoke.py's fusion views (a bead truth on FUSION_SHAPE; view A
    blurred along z, view B moved by the reg128 matrix, blurred along x and
    turned about y, both sampled to FUSION_RAW in camera counts),
    isotropized as fusion_dualview registers them: (target, source) on the
    card."""
    import torch

    from microimagelib_tpu_torch.models import deconvolution as D
    from microimagelib_tpu_torch.models import fusion as FU
    from microimagelib_tpu_torch.ops.affine import affine_transform_3d
    from microimagelib_tpu_torch.ops.basics import rot_by_y_axis
    from microimagelib_tpu_torch.ops.matrix import dof_to_matrix
    from microimagelib_tpu_torch.ops.resample import resize3d_separable

    pa = gauss3((25, 25, 25), (3.5, 1.2, 1.2))
    pb = gauss3((25, 25, 25), (1.2, 1.2, 3.5))
    truth = beads(FUSION_SHAPE, 0 + 14, dev)

    def blur(v, psf):
        otf = D.gen_otf(psf, FUSION_SHAPE, device=dev)
        return torch.fft.irfftn(torch.fft.rfftn(v) * otf, s=FUSION_SHAPE)

    a = resize3d_separable(blur(truth, pa), FUSION_RAW)
    moved = affine_transform_3d(truth, dof_to_matrix(REG_DOF, 6), FUSION_SHAPE)
    nz, ny, _nx = FUSION_SHAPE
    b = rot_by_y_axis(resize3d_separable(blur(moved, pb), (nz, ny, FUSION_RAW[0])), 1)
    a_raw, b_raw = ((v * 2000 + 100.0).cpu().numpy() for v in (a, b))
    return FU.preprocess_views(a_raw, b_raw, FUSION_PIXEL, FUSION_PIXEL, -1, dev,
                               as_device=True)


def launch_ms(fn):
    """Device ms a launch of the one kernel ``fn`` launches (torch.profiler
    over 10 calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        rows = [e.device_time_total / 1e3 / e.count for e in prof.key_averages()
                if e.device_time_total > 0 and e.count and "corr_kernel" in e.key]
        if rows:
            return rows[0]
    return float("nan")


def time_root(root, shape, tps, xy, runs, engine="auto", batch_ls=False, fusion=False):
    """JSON lines for the package under ``root``; runs in this process."""
    import contextlib
    import io

    import torch

    from microimagelib_tpu_torch.kernels import corr as C
    from microimagelib_tpu_torch.models import registration as R
    from microimagelib_tpu_torch.models import registration_device as RD
    from microimagelib_tpu_torch.ops.affine import affine_transform_3d
    from microimagelib_tpu_torch.ops.matrix import dof_to_matrix
    from microimagelib_tpu_torch.tools import e2e_surrogate as E2E
    try:
        from microimagelib_tpu_torch.kernels import reg_ladder as RL
    except ImportError:       # a checkout before K9
        RL = None

    def counts():
        n = {"K4": C.K4_LAUNCHES, "K5": C.K5_LAUNCHES, "K6": C.K6_LAUNCHES,
             "lines_plain": getattr(RD, "HOST_LINES", 0)}
        if RL is not None:
            n.update(K9=RL.K9_LAUNCHES, K9_K4=RL.K9_EVALS_K4, K9_K5=RL.K9_EVALS_K5,
                     K9_K6=getattr(RL, "K9_EVALS_K6", 0), K9_lines=getattr(RL, "K9_LINES", 0))
        return n

    if batch_ls:
        os.environ["MIL_REG_BATCH_LS"] = "1"
    dev = torch.device("cuda", 0)
    if fusion:
        vol, moved = fusion_pair(dev)
        shape = tuple(vol.shape)
    else:
        vol = beads(shape, 0, dev)
        moved = affine_transform_3d(vol, dof_to_matrix(REG_DOF, 6), shape)
    per_launch = {}
    splits = {}
    stamped = RL is not None and hasattr(RL, "record_ladders")
    for run in range(runs + 1):
        levels = []

        def on_level(label, lvl_shape, secs):
            levels.append((label, tuple(lvl_shape), secs, counts()))

        torch.cuda.synchronize()
        start = counts()
        with (RL.record_ladders() if run == 0 and stamped
              else contextlib.nullcontext([])) as ladders:
            _, tmx, rec = R.reg3d(vol, moved, reg_choice=2, aff_method=7, device=dev,
                                  as_device=True, on_level=on_level, engine=engine)
        torch.cuda.synchronize()
        if run == 0:
            # the warm run's ladders again, traced: each evaluation's parts
            for c in ladders:
                _, trace = RL.launch(c["src"], c["tgt"], RL.args_of(c), trace_cap=20000)
                splits[tuple(c["src"].shape)] = {
                    name: RL.split_medians(trace, kind) for name, kind in
                    (("all", None), ("K4", 1), ("K5", 0), ("K6", 2))}
            continue          # the warm run
        prev, out = start, []
        for label, lvl_shape, secs, n in levels:
            d = {k: n[k] - prev[k] for k in n}
            prev = n
            if lvl_shape not in per_launch:
                f = tuple(s // t for s, t in zip(shape, lvl_shape))
                src = R._mean_pool(vol, f) if lvl_shape != tuple(shape) else vol
                tgt = torch.roll(src, 1, 2).contiguous()
                m = R._tmx_full_to_coarse(tmx, f)
                per_launch[lvl_shape] = tuple(
                    launch_ms(lambda g=g: C.corr3d(src, tgt, m, grad=g)) for g in (True, False))
            g4, g5 = per_launch[lvl_shape]
            e4 = d["K4"] + d.get("K9_K4", 0)
            e5 = d["K5"] + d.get("K9_K5", 0)
            sums_ms = e4 * g4 + e5 * g5
            ladders = int(d.get("K9", 0) - d.get("K9_lines", 0) > 0)
            out.append({"level": label, "shape": list(lvl_shape), "s": secs,
                        "evals_k4": e4, "evals_k5": e5, "host_k4": d["K4"],
                        "host_k5": d["K5"], "host_k6": d["K6"],
                        "k9_k6_passes": d.get("K9_K6", 0), "k9_launches": d.get("K9", 0),
                        "k9_lines": d.get("K9_lines", 0), "lines_plain": d["lines_plain"],
                        "syncs": d["K4"] + d["K5"] + d["K6"] + d.get("K9_lines", 0) + ladders,
                        "sums_ms": sums_ms, "host_share": 1 - sums_ms / 1e3 / secs})
            if lvl_shape in splits:
                out[-1]["split_us"] = splits[lvl_shape]
        print(json.dumps({"root": root, "run": run, "shape": list(shape), "engine": engine,
                          "batch_ls": batch_ls, "fusion": fusion, "ncc": rec[3],
                          "s": sum(lv["s"] for lv in out), "levels": out}), flush=True)
    del vol, moved
    torch.cuda.empty_cache()
    if tps <= 0:
        return
    with contextlib.redirect_stdout(io.StringIO()):
        E2E.run(tps, xy, device=dev)
        timings = {}
        res = E2E.run(tps, xy, device=dev, timings=timings)
    reg = [timings[t].get("registration", 0.0) for t in sorted(timings)]
    print(json.dumps({"root": root, "surrogate_xy": xy, "timepoints": tps,
                      "registration_s": reg, "registration_s_sum": sum(reg),
                      "wall_s": res["wall_s"], "nccs": res["nccs"]}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=HERE)
    ap.add_argument("--shape", default="256,512,512")
    ap.add_argument("--tps", type=int, default=3)
    ap.add_argument("--xy", type=int, default=320)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--engine", default="auto", choices=("auto", "grad", "device", "hybrid"))
    ap.add_argument("--batch-ls", action="store_true", help="MIL_REG_BATCH_LS=1")
    ap.add_argument("--fusion", action="store_true",
                    help="the fusion's isotropized diSPIM pair, (320, 512, 320)")
    ap.add_argument("--one", help=argparse.SUPPRESS)   # the child: time this root
    args = ap.parse_args(argv)
    if args.one:
        time_root(args.one, tuple(int(n) for n in args.shape.split(",")), args.tps,
                  args.xy, args.runs, args.engine, args.batch_ls, args.fusion)
        return 0
    sys.path.insert(0, HERE)   # run by its path, a tool sees only its own directory
    from microimagelib_tpu_torch.tools import turns

    extra = ["--engine", args.engine] + ["--batch-ls"] * args.batch_ls + \
        ["--fusion"] * args.fusion
    return turns.in_turns(__file__, args.roots,
                          ["--shape", args.shape, "--tps", str(args.tps), "--xy",
                           str(args.xy), "--runs", str(args.runs), *extra])[0]


if __name__ == "__main__":
    sys.exit(main())
