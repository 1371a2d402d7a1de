"""The traced run's readings: ``torch.profiler`` over the measured window,
reduced to intervals on one clock (the profiler's, in ns).

* device activity: the kernels, copies and sets the profiler records on
  the device (not the device-side copies of the host's annotations);
* spans: the host ranges the benchmark opens with ``record_function``
  around the calls into the program's layers (``spans.py``), by name;
* busy time: the union of device activity inside the window; idle gaps:
  the rest of the window, each labelled by the innermost host range open
  at its middle (a benchmark span, a program op or a runtime call).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_kind(ev, annotations):
    """'kernel', 'gpu_memcpy' or 'gpu_memset' for a device event, None for
    the device's copies of the host's annotations (``annotations``, the
    benchmark's span names). Torch builds without ``activity_type`` tell
    copies and sets by name."""
    name = ev.name()
    if name in annotations:
        return None
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = kind()
        return kind if kind in DEVICE_KINDS else None
    if getattr(ev, "is_user_annotation", lambda: False)():
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def union_ns(intervals, lo, hi):
    """Length of the union of [s, e) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals, lo, hi):
    """The sub-intervals of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class TraceView:
    """The profiler's events of one traced window."""

    def __init__(self, device_events, host_events):
        # device: (name, start_ns, end_ns, kind); host: (name, start_ns, end_ns)
        self.device = device_events
        self.host = host_events
        spans = [h for h in host_events if h[0] == WINDOW_SPAN]
        if spans:
            self.lo, self.hi = spans[0][1], spans[0][2]
        else:
            ends = [d[2] for d in device_events + host_events]
            starts = [d[1] for d in device_events + host_events]
            self.lo, self.hi = (min(starts), max(ends)) if starts else (0, 0)

    @classmethod
    def from_profiler(cls, prof, annotations=()):
        annotations = set(annotations) | {WINDOW_SPAN, CALL_SPAN}
        dev, host = [], []
        for ev in prof.profiler.kineto_results.events():
            s = ev.start_ns()
            item = (ev.name(), s, s + ev.duration_ns())
            if not str(ev.device_type()).endswith("CUDA"):
                host.append(item)
            elif (kind := _device_kind(ev, annotations)) is not None:
                dev.append(item + (kind,))
        return cls(dev, host)

    @property
    def window_s(self):
        return (self.hi - self.lo) / 1e9

    def kernels(self):
        return [d[:3] for d in self.device if d[3] == "kernel"]

    def busy_s(self):
        return union_ns([d[1:3] for d in self.device], self.lo, self.hi) / 1e9

    def spans(self, name):
        return [(s, e) for n, s, e in self.host if n == name]

    def kernel_s_within(self, span_name, match=None):
        """Seconds of kernels (whose name contains ``match``, if given)
        that start inside any ``span_name`` range."""
        spans = sorted(self.spans(span_name))
        starts = [s for s, _e in spans]
        total = 0
        for name, s, e in self.kernels():
            if match is not None and match not in name:
                continue
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < spans[i][1]:
                total += e - s
        return total / 1e9

    def kernel_s(self, match):
        return sum(e - s for n, s, e in self.kernels() if match in n) / 1e9

    def device_ops(self, top=10):
        by = defaultdict(int)
        for n, s, e, _k in self.device:
            if e > self.lo and s < self.hi:
                by[n[:160]] += min(e, self.hi) - max(s, self.lo)
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, span_names=(), top=10):
        """Idle seconds summed by what the host was doing at each gap's
        middle: the innermost benchmark span open then (one of
        ``span_names``, or the call) and the innermost host range open
        inside it (``python`` where none was), the largest first."""
        hosts = sorted(self.host, key=lambda h: h[1])
        marks = set(span_names) | {CALL_SPAN}
        by = defaultdict(int)
        stack, i = [], 0
        for s, e in gaps_ns([d[1:3] for d in self.device], self.lo, self.hi):
            mid = (s + e) // 2
            while i < len(hosts) and hosts[i][1] <= mid:
                stack.append(hosts[i])
                i += 1
            stack = [h for h in stack if h[2] > mid]
            span = next((h[0] for h in reversed(stack) if h[0] in marks), "outside calls")
            inner = next((h[0] for h in reversed(stack)
                          if h[0] not in marks and h[0] != WINDOW_SPAN), "python")
            by[f"{span} > {inner}"[:160]] += e - s
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
