"""The readings a cell's correctness limits are set from, in one process
(set-up paid once):

* the program: for each of ``--seeds``, a run of the cell as run.py makes
  it (pool, warm-up, a ``--seconds`` window at the cell's load, the
  sample judged against the reference); one JSON line of its numbers;
* the control: for each of ``--control-seeds``, the reference in
  bfloat16 put in the program's place on the same number of pool items
  as a run judges, judged the same way; one JSON line of its numbers.

    python3 mil_bench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 4 [--out FILE]

Each line also goes to ``--out`` when given. Not run by the benchmark.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

from milbench import card  # noqa: E402


def control_readings(cell, seed, device):
    """The control's numbers on ``check_sample`` pool items drawn from the
    seed."""
    import numpy as np

    from milbench import entries, generate, judge

    entry = entries.make(cell.config, cell.traffic, device)
    pool = generate.make_pool(cell.config, cell.traffic, seed, device)
    rng = np.random.default_rng([int(seed), 4])
    k = min(int(cell.traffic["check_sample"]), len(pool))
    picks = rng.choice(len(pool), size=k, replace=False)
    readings = [entry.judge(entry.control(pool[int(i)]), pool[int(i)]) for i in picks]
    return judge.worst(readings)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    card.cache_dirs(ROOT)
    import torch

    from milbench import harness, spec

    cell = spec.find_cell(args.workload)
    if args.device.startswith("cuda"):
        card.require(cell.chips)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        result, checks = harness.run_cell(cell, seed, args.seconds, False, args.device,
                                          T_START if seed == seeds[0] else t)
        emit({"workload": cell.name, "side": "program", "seed": seed,
              "correct": result["correct"], "attempted": result["attempted"],
              "failed": result["failed"], "metrics": result["metrics"],
              "memory_peak_bytes": result["device"]["memory_peak_bytes"],
              "checks": {k: v["value"] for k, v in checks.items()},
              "seconds": time.perf_counter() - t})
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t = time.perf_counter()
        emit({"workload": cell.name, "side": "control", "seed": seed,
              "checks": control_readings(cell, seed, torch.device(args.device)),
              "seconds": time.perf_counter() - t})
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    if out:
        out.close()
    found = card.forbidden_modules()
    if found:
        print(f"calibrate: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
