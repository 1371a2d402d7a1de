"""Time the time-lapse batch and its rotating MIP on one CUDA device, for
one or more checkouts of the package in turns.

    python microimagelib_tpu_torch/tools/batch_times.py [--roots DIR,DIR,...]
        [--tps N] [--xy N]

For each root (default: the checkout holding this file) it prints one
JSON line: the end-to-end surrogate's (``tools/e2e_surrogate.py``) wall
seconds and timepoints per minute over ``--tps`` timepoints at ``--xy``
(after one warm run of the same size, whose pinned host slots torch's
host allocator hands on to the later runs), with the batch's ``timings`` (the
compute stream synchronized between stages) and then without them
(``tp_per_min_own``); the seconds of each batch stage summed over the
timepoints (``stage_s``) and per timepoint (``tp_stage_s``), among them
the transfers' ``upload``, ``upload_copy``, ``slot_wait``, ``fetch`` and
``fetch_copy`` where the package has them; the host bytes of one
timepoint's views and outputs and the pinned bytes the batch's host
rings held (``slot_bytes``, ``pinned_bytes``; null for a package without
them); and the rotating MIP about y of a uniform random volume on the
batch's grid, 36 frames, on the route ``auto`` takes there
(``mip3d_frames``; CUDA events, the card idle before each call). The
first line is the card's name and power limit.

The roots run in turns (``tools/turns.py``), e.g. ``--roots
build/parent,.,.,build/parent`` for a parent commit unpacked by ``git
archive`` beside the working tree.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def time_root(root, tps, xy):
    """One JSON line for the package under ``root``; runs in this process."""
    import contextlib
    import io

    import torch

    from microimagelib_tpu_torch.models import batch as PB
    from microimagelib_tpu_torch.models import projections as PP
    from microimagelib_tpu_torch.tools import e2e_surrogate as E2E

    dev = torch.device("cuda", 0)
    rings = []
    real_ring = getattr(PB, "HostRing", None)   # a package without host rings: none
    if real_ring is not None:
        def make(*args, **kw):
            rings.append(real_ring(*args, **kw))
            return rings[-1]

        PB.HostRing = make
    with contextlib.redirect_stdout(io.StringIO()):
        E2E.run(tps, xy, device=dev)
        rings.clear()   # the warm run's pinned slots go back to torch's host cache
        timings = {}
        res = E2E.run(tps, xy, device=dev, timings=timings)
        # the timed run's upload and output rings
        slot_bytes = [r.bytes_held // sum(r.slots_allocated().values()) for r in rings]
        pinned = [r.bytes_held for r in rings]
        rings.clear()
        res_own = E2E.run(tps, xy, device=dev)
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
                      "wall_s_own": res_own["wall_s"], "tp_per_min_own": res_own["tp_per_min"],
                      "stage_s": stages,
                      "tp_stage_s": {str(t): st for t, st in sorted(timings.items())},
                      "slot_bytes": slot_bytes or None, "pinned_bytes": pinned or None,
                      "mip_ms": total / 5}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=HERE)
    ap.add_argument("--tps", type=int, default=3)
    ap.add_argument("--xy", type=int, default=320)
    ap.add_argument("--one", help=argparse.SUPPRESS)   # the child: time this root
    args = ap.parse_args(argv)
    if args.one:
        time_root(args.one, args.tps, args.xy)
        return 0
    sys.path.insert(0, HERE)   # run by its path, a tool sees only its own directory
    from microimagelib_tpu_torch.tools import turns

    return turns.in_turns(__file__, args.roots, ["--tps", str(args.tps),
                                                 "--xy", str(args.xy)])[0]

if __name__ == "__main__":
    sys.exit(main())
