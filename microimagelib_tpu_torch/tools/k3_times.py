"""Time the FFT convolution kernel K3 against ``torch.fft`` per grid, on
one CUDA device, for one or more checkouts of the package in turns.

    python microimagelib_tpu_torch/tools/k3_times.py [--roots DIR,DIR,...]
        [--grids ZxYxX,...] [--reps N]

For each root (default: the checkout holding this file) and grid it
prints one JSON line: ms per ``conv3_ct`` call and per ``conv3_ct_torch``
(``torch.fft``) call back to back (CUDA events), the device time of each
of K3's five launches (``torch.profiler``, in launch order), the z
launch's registers and spilled bytes a thread (``kernel_attrs``), which
axes took the length-specialised transform, and K3's largest distance
from ``torch.fft`` over its largest value. The first line is the card's
name and power limit.

The roots run in turns (``tools/turns.py``), e.g. ``--roots
build/parent,.,.,build/parent`` for a parent commit unpacked by ``git
archive`` beside the working tree. Only the package's
``kernels.fft_ct`` is used. The inputs are uniform random volumes from a
torch seed on the card and the half spectrum of another as the OTF.
"""

import argparse
import json
import os
import sys

GRIDS = ((320, 512, 512), (384, 512, 512), (512, 512, 512), (576, 512, 512),
         (640, 512, 512), (704, 512, 512), (768, 512, 512), (1024, 512, 512),
         (64, 512, 512), (192, 384, 384), (384, 640, 640), (192, 640, 640))
# K3's launches in order, by the names of their kernels on either path
LAUNCHES = (("x forward", ("x_forward",)), ("y forward", ("y_forward", "y_kernel")),
            ("z x OTF", ("z_kernel",)), ("y inverse", ("y_inverse", "y_kernel")),
            ("x inverse", ("x_inverse",)))
HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch_ms(rows):
    """{launch: device ms} from (kernel name, ms, count) rows of one call's
    trace. The generic path's two y launches share one name (y_kernel): a
    name found twice a call stands for both."""
    out = {}
    for launch, names in LAUNCHES:
        hits = [(ms, n) for key, ms, n in rows if any(x in key for x in names)]
        out[launch] = hits[0][0] if len(hits) == 1 else None
    return out


def time_root(root, grids, reps):
    """One JSON line per grid for the package under ``root``; runs in this
    process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from microimagelib_tpu_torch.kernels import fft_ct as F

    if not os.path.abspath(F.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {F.__file__}, not the package under {root}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def events_ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for shape in grids:
        v = torch.rand(shape, device="cuda", generator=gen) * 100
        otf = torch.fft.rfftn(torch.rand(shape, device="cuda", generator=gen)).contiguous()
        plain = F.conv3_ct_torch(v, otf)
        err = float((F.conv3_ct(v, otf) - plain).abs().max() / plain.abs().max())
        del plain
        k_ms = events_ms(lambda: F.conv3_ct(v, otf))
        t_ms = events_ms(lambda: F.conv3_ct_torch(v, otf))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                F.conv3_ct(v, otf)
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / 1e3 / e.count, e.count)
                for e in prof.key_averages() if e.device_time_total > 0 and e.count]
        z = F.kernel_attrs(shape)[2]
        print(json.dumps({
            "root": root, "grid": list(shape), "k3_ms": k_ms, "torch_fft_ms": t_ms,
            "launch_ms": launch_ms(rows), "z_registers": z["registers"],
            "z_spill_bytes": z["spill_bytes"],
            "specialised": "".join(a for a, n in zip("zyx", shape) if F.radix_plan(n)),
            "max_rel_err": err}), flush=True)
        del v, otf
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=HERE)
    ap.add_argument("--grids", default=",".join("x".join(map(str, s)) for s in GRIDS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--one", help=argparse.SUPPRESS)   # the child: time this root
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k3_times: no CUDA device", file=sys.stderr)
        return 1
    grids = [tuple(int(n) for n in g.split("x")) for g in args.grids.split(",")]
    if args.one:
        time_root(args.one, grids, args.reps)
        return 0
    sys.path.insert(0, HERE)   # run by its path, a tool sees only its own directory
    from microimagelib_tpu_torch.tools import turns

    return turns.in_turns(__file__, args.roots, ["--grids", args.grids,
                                                 "--reps", str(args.reps)])[0]

if __name__ == "__main__":
    sys.exit(main())
