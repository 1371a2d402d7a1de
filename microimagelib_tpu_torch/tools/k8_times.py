"""Time the rotating MIP's kernel K8 per shape and axis on one CUDA device,
for one or more checkouts of the package in turns, and fingerprint its
frames.

    python microimagelib_tpu_torch/tools/k8_times.py [--roots DIR,DIR,...]
        [--shapes ZxYxX,...] [--frames N] [--reps N]

The first line is the card's name and power limit. For each root
(default: the checkout holding this file), shape and axis it prints one
JSON line: ms per ``kernels.mip_rot.mip_rot`` call back to back (CUDA
events; the call includes the wrapper's layout copy), the device time of
the kernel's one launch (``torch.profiler``), its registers and spilled
bytes a thread (``kernel_attrs``), and the sha256 of the frames' bytes.
The input is a uniform random volume from a torch seed on the card, the
matrices those of ``models.projections.mip3d_params`` on the factored
route. The last line gives, per shape and axis, whether every root gave
the same frames to the bit, and K8's bound from this checkout's
``samples_inside``: the larger of the volume read once and the frames
written once at 3.35 TB/s, and ``OPS_PER_SAMPLE`` fp32 operations for
every sample inside the validity box at 67 TFLOP/s.

The roots run in turns (``tools/turns.py``), e.g. ``--roots
build/parent,.,.,build/parent`` for a parent commit unpacked by ``git
archive`` beside the working tree.
"""

import argparse
import hashlib
import json
import os
import sys

SHAPES = ((128, 128, 128), (320, 320, 320), (320, 512, 320), (96, 100, 90))
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def key(shape, axis):
    return "x".join(map(str, shape)) + " about " + axis


def time_root(root, shapes, frames, reps):
    """One JSON line per shape and axis for the package under ``root``;
    runs in this process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from microimagelib_tpu_torch.kernels import mip_rot as MR
    from microimagelib_tpu_torch.models import projections as PP

    if not os.path.abspath(MR.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {MR.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    attrs = MR.kernel_attrs()
    for shape in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        img = torch.rand(shape, device=dev, generator=gen) * 100
        for r_axis in (1, 2):
            p = PP.mip3d_params(shape, r_axis, frames, "factored", device=dev)

            def call():
                return MR.mip_rot(img, p["mats"], p["out_shape"], r_axis)

            out = call()
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
            del out
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            end.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
            dev_ms = [e.device_time_total / 1e3 / e.count for e in prof.key_averages()
                      if "mip_rot_kernel" in e.key and e.count]
            print(json.dumps({
                "root": root, "shape": list(shape), "axis": "xy"[r_axis - 1],
                "frames": frames, "ms": start.elapsed_time(end) / reps,
                "device_ms": dev_ms[0] if len(dev_ms) == 1 else None,
                "registers": attrs["registers"], "spill_bytes": attrs["spill_bytes"],
                "threads": attrs["threads"], "blocks_per_sm": attrs["blocks_per_sm"],
                "sha256": digest}), flush=True)
        del img
        torch.cuda.empty_cache()


def bounds(shapes, frames):
    """{shape and axis: K8's bound} from this checkout's package: the
    bound depends on the shape and the matrices, not on the kernel."""
    from microimagelib_tpu_torch.kernels import mip_rot as MR
    from microimagelib_tpu_torch.models import projections as PP

    out = {}
    for shape in shapes:
        for r_axis in (1, 2):
            p = PP.mip3d_params(shape, r_axis, frames, "factored", device="cuda")
            rows, na, nb, zo, po = MR.extents(shape, p["out_shape"], r_axis)
            inside = rows * MR.samples_inside(MR.coefficients(p["mats"], r_axis),
                                              na, nb, zo, po)
            by_bytes = 4 * (rows * na * nb + frames * rows * po) / HBM_BYTES_PER_S * 1e3
            by_ops = MR.OPS_PER_SAMPLE * inside / FP32_OPS_PER_S * 1e3
            out[key(shape, "xy"[r_axis - 1])] = {
                "bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "inside": inside, "inside_share": inside / (frames * rows * zo * po)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=HERE)
    ap.add_argument("--shapes", default=",".join("x".join(map(str, s)) for s in SHAPES))
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one", help=argparse.SUPPRESS)   # the child: time this root
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k8_times: no CUDA device", file=sys.stderr)
        return 1
    shapes = [tuple(int(n) for n in s.split("x")) for s in args.shapes.split(",")]
    if args.one:
        time_root(args.one, shapes, args.frames, args.reps)
        return 0
    sys.path.insert(0, HERE)   # run by its path, a tool sees only its own directory
    from microimagelib_tpu_torch.tools import turns

    rc, outs = turns.in_turns(__file__, args.roots, ["--shapes", args.shapes, "--frames",
                                                     str(args.frames), "--reps", str(args.reps)])
    if rc:
        return rc
    digests = {}
    for line in "".join(outs).splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            digests.setdefault(key(d["shape"], d["axis"]), set()).add(d["sha256"])
    print(json.dumps({"same_bits": {k: len(v) == 1 for k, v in digests.items()},
                      "bounds": bounds(shapes, args.frames)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
