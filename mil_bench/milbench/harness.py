"""One run of one cell: make the pool from the seed, warm up, measure a
closed loop of one caller for ``seconds``, read the metrics, then judge a
sample of the window's answers against the plain reference.

The window: calls go back to back on the pool's items in turn; the loop
stops starting calls once ``seconds`` have passed, and the window ends
when the last call does, so every rate is the work of all completed calls
over all the time they took."""

from __future__ import annotations

import contextlib
import importlib
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from milbench import entries, generate, judge
from milbench.spans import Spans
from milbench.trace import CALL_SPAN, WINDOW_SPAN, TraceView


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: str
    config: dict
    traffic: dict
    units: dict
    setup_s: float
    window_s: float = 0.0
    calls: list = field(default_factory=list)        # (t0, t1, ok)
    counters: dict = field(default_factory=dict)     # (module, attribute) -> delta
    spans: Spans | None = None
    trace: TraceView | None = None

    def completed(self):
        return sum(1 for c in self.calls if c[2])

    def units_done(self, name):
        return self.units.get(name, 0) * self.completed()

    def latencies_s(self):
        return [t1 - t0 for t0, t1, ok in self.calls if ok]


class Reservoir:
    """A uniform sample of ``k`` completed calls, drawn from the seed."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 3])
        self.seen = 0
        self.kept = []

    def offer(self, item):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.kept[j] = item


def _counter(module, attribute):
    return getattr(importlib.import_module(module), attribute)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(entry, pool, seconds, sample, spans=None):
    """The closed loop. Returns (calls, failed, window_s)."""
    calls, failed = [], 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        idx = i % len(pool)
        t0 = time.perf_counter()
        try:
            with spans.open(CALL_SPAN) if spans is not None else contextlib.nullcontext():
                out = entry.call(pool[idx])
            ok = True
        except Exception:  # a call that fails is counted, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            failed += 1
            ok, out = False, None
        t1 = time.perf_counter()
        calls.append((t0, t1, ok))
        if ok:
            sample.offer((i, idx, out))
        del out
        i += 1
        if t1 >= deadline:
            return calls, failed, t1 - t_start


def _print_latencies(calls, n_items):
    """Each pool item's calls: count, median, largest (ms), on stderr."""
    for idx in range(n_items):
        lat = sorted(1e3 * (t1 - t0) for t0, t1, ok in calls[idx::n_items] if ok)
        if lat:
            print(f"mil_bench: item {idx}: {len(lat)} calls, median "
                  f"{lat[len(lat) // 2]:.3f} ms, largest {lat[-1]:.3f} ms", file=sys.stderr)


def run_cell(cell, seed, seconds, trace, device, t_start):
    """Returns (result, checks): the result line's keys but ``checks``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    entry = entries.make(cell.config, cell.traffic, device)
    parts = [("imports", time.perf_counter())]
    pool = generate.make_pool(cell.config, cell.traffic, seed, device)
    _sync(device)
    parts.append(("pool", time.perf_counter()))
    for k in range(int(cell.traffic["warmup"])):
        entry.call(pool[k % len(pool)])
        _sync(device)
        parts.append((f"warm-up call {k + 1}", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    starts = [t_start] + [p for _n, p in parts]
    print("mil_bench: set-up " + ", ".join(f"{name} {p - t0:.3f} s"
                                          for (name, p), t0 in zip(parts, starts)),
          file=sys.stderr)

    metrics = cell.per_layer if trace else cell.end_to_end
    readers = [cell.readers[m["name"]] for m in metrics]
    counters = sorted({tuple(c) for r in readers for c in getattr(r, "COUNTERS", ())})
    before = {c: _counter(*c) for c in counters}
    spans = Spans(cuda) if trace else None
    wrapped = sorted({tuple(s) for r in readers for s in getattr(r, "SPANS", ())})
    if cuda:
        for d in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(d)
    sample = Reservoir(int(cell.traffic["check_sample"]), seed)
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            for m, a, n in wrapped:
                spans.wrap(m, a, n)
            stack.callback(spans.unwrap)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(record_function(WINDOW_SPAN))
        calls, failed, window_s = window(entry, pool, seconds, sample, spans)
        _sync(device)
    peak = (max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))
            if cuda else 0)
    _print_latencies(calls, len(pool))
    run = Run(cell=cell.name, config=cell.config, traffic=cell.traffic, units=entry.units,
              setup_s=setup_s, window_s=window_s, calls=calls,
              counters={c: _counter(*c) - before[c] for c in counters}, spans=spans,
              trace=TraceView.from_profiler(prof, [w[2] for w in wrapped]) if trace else None)
    values = {}
    for m, r in zip(metrics, readers):
        v = r.read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": False, "attempted": len(calls), "failed": failed,
              "metrics": values,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if trace and run.trace is not None:
        tv = run.trace
        result["device"]["busy_s"] = tv.busy_s()
        result["device"]["window_s"] = tv.window_s
        result["breakdown"] = {"device_ops": tv.device_ops(),
                               "idle_gaps": tv.idle_gaps([w[2] for w in wrapped])}
    # the reference runs once the window's peak is read; the program keeps
    # no state between calls, and the pool's items are the sample's inputs
    t = time.perf_counter()
    readings = [entry.judge(out, pool[idx]) for _i, idx, out in sample.kept]
    print(f"mil_bench: judged {len(readings)} of {len(calls)} calls in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    correct, checks = judge.verdict(readings, cell.limits, len(calls), failed)
    result["correct"] = correct
    return result, checks
