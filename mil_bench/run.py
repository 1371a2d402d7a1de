"""Run one cell of the port's benchmark once.

    python3 mil_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in BENCHMARK.json, makes its inputs from the seed on
the card, warms up (set-up, reported as ``setup_s``), measures a closed
loop of one caller for ``--seconds``, judges a sample of the answers
against the plain reference, and prints one JSON line last on standard
output. ``--trace 1`` runs the window under ``torch.profiler`` and reports
the per-layer metrics instead of the end-to-end ones. The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error, and under ``checks``, the result's last key.

Exits 2 without a result where CUDA has fewer cards than the cell asks
for, and 3 where the process holds JAX or the JAX package once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

from milbench import card  # noqa: E402


def _clean(v):
    return v if v is None or math.isfinite(v) else None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    card.cache_dirs(ROOT)
    from milbench import spec

    cell = spec.find_cell(args.workload)
    import torch

    t_torch = time.perf_counter()
    card.require(cell.chips)
    torch.zeros(1, device="cuda:0")
    from milbench import harness

    print(f"mil_bench: set-up to torch imported {t_torch - T_START:.3f} s, CUDA context "
          f"{time.perf_counter() - t_torch:.3f} s", file=sys.stderr)
    sampler = card.ClockSampler() if args.trace else None
    if sampler:
        sampler.start()
    try:
        result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                          "cuda:0", T_START)
    finally:
        samples = sampler.stop() if sampler else []
    print(f"mil_bench: {args.workload} seed {args.seed} on {torch.cuda.device_count()} x "
          f"{torch.cuda.get_device_name(0)}, power limit {card.smi('power.limit')}",
          file=sys.stderr)
    for line in samples:
        print(f"mil_bench: nvidia-smi {card.QUERY}: {line}", file=sys.stderr)
    found = card.forbidden_modules()
    if found:
        print(f"mil_bench: the process holds {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": _clean(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    print(f"correct {result['correct']}; the numbers compared, each beside its limit "
          "(None: printed, not compared):", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
