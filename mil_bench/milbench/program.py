"""The program's own spans, for the readers of the per-layer metrics that
read them: the per-name totals its trace module
(``microimagelib_tpu_torch.utils.trace``) keeps while the profiler runs,
which in a traced run is the window, and the device idle time inside its
host ranges on the profiler's clock. A program without that module, or a
window in which it recorded no span, gives None."""

from __future__ import annotations

import bisect

from milbench.trace import gaps_ns


def spans():
    """{name: {"calls", "host_s", "device_s", "bytes", ...}} of the
    program's spans after the window; None where there are none."""
    try:
        from microimagelib_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()["spans"] or None


def span(name):
    """The totals of one span, None where it never closed."""
    s = spans()
    return s.get(name) if s else None


def per_call(run, value):
    """``value`` over the window's completed calls; None without either."""
    n = run.completed()
    return value / n if value is not None and n else None


def idle_within_ns(tv, name):
    """Device-idle ns inside the host ranges named ``name`` (the ranges
    clipped to the window), None where there are none: the gaps between
    the device's kernels, copies and sets, summed where they overlap the
    ranges."""
    ranges = sorted(tv.spans(name))
    if not ranges:
        return None
    gaps = gaps_ns([d[1:3] for d in tv.device], tv.lo, tv.hi)
    starts = [g[0] for g in gaps]
    idle = 0
    for s, e in ranges:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(gaps) and gaps[i][0] < e:
            idle += max(0, min(e, gaps[i][1]) - max(s, gaps[i][0]))
            i += 1
    return idle
