"""Time the time-lapse batch and its rotating MIP on one CUDA device, for
one or more checkouts of the package in turns.

    python microimagelib_tpu_torch/tools/batch_times.py [--roots DIR,DIR,...]
        [--tps N] [--xy N]

For each root (default: the checkout holding this file) it prints one
JSON line: the end-to-end surrogate's (``tools/e2e_surrogate.py``) wall
seconds and timepoints per minute over ``--tps`` timepoints at ``--xy``
(after one warm run of the same size), the seconds of each batch stage
summed over the timepoints, and the rotating MIP about y of a uniform
random volume on the batch's grid, 36 frames, on the route ``auto``
takes there (``mip3d_frames``; CUDA events, the card idle before each
call). The first line is the card's name and power limit.

Each root runs in a process of its own, so that a parent commit unpacked
by ``git archive`` beside the working tree can be timed in turns with it
on one card: ``--roots build/parent,.,.,build/parent``.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_root(root, tps, xy):
    """One JSON line for the package under ``root``; runs in this process."""
    import contextlib
    import io

    import torch

    from microimagelib_tpu_torch.models import projections as PP
    from microimagelib_tpu_torch.tools import e2e_surrogate as E2E

    dev = torch.device("cuda", 0)
    with contextlib.redirect_stdout(io.StringIO()):
        E2E.run(tps, xy, device=dev)
        timings = {}
        res = E2E.run(tps, xy, device=dev, timings=timings)
    stages = {}
    for st in timings.values():
        for k, v in st.items():
            stages[k] = stages.get(k, 0.0) + v
    vol = torch.rand((xy,) * 3, device=dev) * 100
    PP.mip3d_frames(vol, 2, 36)
    total = 0.0
    for _ in range(5):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        PP.mip3d_frames(vol, 2, 36)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    print(json.dumps({"root": root, "timepoints": tps, "xy": xy, "wall_s": res["wall_s"],
                      "tp_per_min": res["tp_per_min"], "nccs": res["nccs"],
                      "stage_s": stages, "mip_ms": total / 5}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=HERE)
    ap.add_argument("--tps", type=int, default=3)
    ap.add_argument("--xy", type=int, default=320)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        time_root(args.roots, args.tps, args.xy)
        return 0
    print(card_line(), flush=True)
    for root in args.roots.split(","):
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--roots",
                             root, "--tps", str(args.tps), "--xy", str(args.xy)],
                            env=env, cwd=root).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
