"""What the port's spans cost the host (``microimagelib_tpu_torch/utils/trace.py``):

    python3 tools/span_cost.py [--calls N]

Prints one JSON line: ns per ``with span(...)`` with no profiler running
(N calls, 2 x 10^6 by default, in three rounds, the empty loop's own time
taken off), and microseconds per span under ``torch.profiler`` with CPU
and CUDA activities (CUDA initialised first, so each span also records
its two timing events), with the card's name and power limit."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from microimagelib_tpu_torch.utils import trace  # noqa: E402


def _spans(n):
    for _ in range(n):
        with trace.span("mil.rl.iter"):
            pass


def _empty(n):
    for _ in range(n):
        pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2_000_000)
    n = ap.parse_args(argv).calls
    off = []
    for _ in range(3):
        t = time.perf_counter()
        _empty(n)
        empty = time.perf_counter() - t
        t = time.perf_counter()
        _spans(n)
        off.append((time.perf_counter() - t - empty) / n * 1e9)
    out = {"off_ns": off, "calls": n}
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda:0")
        torch.cuda.synchronize()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        on = []
        for k in (2_000, 20_000):
            trace.reset()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                t = time.perf_counter()
                _spans(k)
                on.append(((time.perf_counter() - t) / k * 1e6, k))
        out.update(on_us=on, card=card.stdout.strip())
        trace.reset()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
