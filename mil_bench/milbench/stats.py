"""Arithmetic the metric readers share: rates over the window, the tail,
the RL iterations' least time, the device's idle share, and the spread
that sets a bound."""

from __future__ import annotations

import statistics

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA data sheet
# bytes an RL iteration has to touch at least, per voxel of the FFT grid,
# each input and output counted once (float32): single view reads the
# estimate and the image and writes the estimate; dual view reads the
# estimate and both views and writes the estimate
RL_BYTES_PER_VOXEL = {"single": 3 * 4, "dual": 4 * 4}


def rate(run, unit, scale=1.0):
    """Units of all completed calls over the window, times ``scale``."""
    if not run.completed() or run.window_s <= 0:
        return None
    return run.units_done(unit) * scale / run.window_s


def percentile(values, q):
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def rl_least_s(voxels, n_iters, kind, calls):
    return calls * n_iters * RL_BYTES_PER_VOXEL[kind] * voxels / HBM_BYTES_PER_S


def roofline_pct(least_s, kernel_s):
    if not kernel_s or kernel_s <= 0:
        return None
    return 100.0 * least_s / kernel_s


def idle_pct(run):
    tv = run.trace
    if tv is None or tv.window_s <= 0:
        return None
    busy = tv.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / tv.window_s)


def mean_ms(seconds):
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def spread(values):
    """(q3 - q1) / median by statistics.quantiles(values, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
