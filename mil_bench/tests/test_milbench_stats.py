"""The readers' arithmetic: rates over the window, the 95th percentile,
the RL iterations' least bytes, the trace's busy time, gaps and kernel
sums, and the spread that sets a bound."""

import statistics

import numpy as np
import pytest

from milbench import spec, stats
from milbench.harness import Reservoir, Run
from milbench.trace import CALL_SPAN, WINDOW_SPAN, TraceView, gaps_ns, union_ns


def _run(calls, units, window_s, config=None, trace=None):
    return Run(cell="x", config=config or {}, traffic={}, units=units, setup_s=1.5,
               window_s=window_s, calls=calls, trace=trace)


def test_rates_count_completed_calls_over_the_window():
    calls = [(0.0, 1.0, True), (1.0, 2.5, False), (2.5, 3.0, True)]
    run = _run(calls, {"timepoints": 1}, 3.0)
    assert spec.load_reader("fusion_tp_per_min").read(run) == pytest.approx(60 * 2 / 3.0)
    run = _run(calls, {"voxel_iters": 512 ** 3 * 20}, 3.0)
    assert spec.load_reader("rl_gvoxit_per_s").read(run) == pytest.approx(
        2 * 512 ** 3 * 20 / 3.0 / 1e9)
    run = _run(calls, {"pairs": 1}, 4.0)
    assert spec.load_reader("reg_pairs_per_s").read(run) == pytest.approx(0.5)
    assert spec.load_reader("setup_s").read(run) == 1.5
    assert stats.rate(_run([], {"pairs": 1}, 1.0), "pairs") is None


def test_p95_is_numpys_linear_percentile_of_every_latency():
    lat = [0.001 * (k + 1) for k in range(100)]
    t, calls = 0.0, []
    for v in lat:
        calls.append((t, t + v, True))
        t += v
    run = _run(calls, {"pairs": 1}, t)
    assert spec.load_reader("reg_p95_ms").read(run) == pytest.approx(
        1e3 * np.percentile(lat, 95))
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)


def test_rl_least_bytes():
    n = 512 ** 3
    assert stats.rl_least_s(n, 20, "single", 3) == pytest.approx(3 * 20 * 12 * n / 3.35e12)
    assert stats.rl_least_s(n, 10, "dual", 1) == pytest.approx(10 * 16 * n / 3.35e12)
    assert stats.roofline_pct(1.0, 4.0) == 25.0
    assert stats.roofline_pct(1.0, 0.0) is None


def test_spread_is_the_interquartile_range_over_the_median():
    v = [10.0, 10.5, 9.8, 10.2, 10.1, 9.9]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (28, 29)]
    assert union_ns(iv, 0, 40) == 25
    assert union_ns(iv, 8, 25) == 12
    assert gaps_ns(iv, 0, 40) == [(15, 20), (30, 40)]
    assert gaps_ns([], 0, 5) == [(0, 5)]


def _trace():
    dev = [("k1", 100, 200, "kernel"), ("k1", 300, 350, "kernel"),
           ("Memcpy DtoH (Device -> Pageable)", 350, 500, "gpu_memcpy"),
           ("reg_stage_kernel<1>", 600, 700, "kernel")]
    host = [(WINDOW_SPAN, 0, 1000), (CALL_SPAN, 50, 520), ("decon.rl_loop", 60, 90),
            ("aten::copy_", 340, 510), (CALL_SPAN, 530, 990), ("cudaMemGetInfo", 540, 590)]
    return TraceView(dev, host)


def test_trace_busy_idle_and_kernel_sums():
    tv = _trace()
    assert tv.window_s == pytest.approx(1000e-9)
    assert tv.busy_s() == pytest.approx((100 + 200 + 100) * 1e-9)
    assert tv.kernel_s_within(CALL_SPAN) == pytest.approx(250e-9)
    assert tv.kernel_s("reg_stage_kernel") == pytest.approx(100e-9)
    ops = dict((n, v) for n, v in tv.device_ops())
    assert ops["k1"] == pytest.approx(150e-9)
    gaps = dict((n, v) for n, v in tv.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(600e-9)
    assert gaps["bench.call > cudaMemGetInfo"] == pytest.approx(100e-9)
    run = _run([(0, 1, True), (1, 2, True)], {"pairs": 1}, 2.0, trace=tv)
    assert spec.load_reader("device_idle_pct.reg").read(run) == pytest.approx(60.0)
    assert spec.load_reader("k9_ms_per_pair.reg").read(run) == pytest.approx(100e-9 * 1e3 / 2)


def test_roofline_reader_never_reads_above_its_least_time():
    tv = _trace()
    cfg = {"shape_zyx": [2, 2, 2], "n_iters": 1}
    run = _run([(0, 1, True), (1, 2, True)], {}, 2.0, config=cfg, trace=tv)
    least = stats.rl_least_s(8, 1, "single", 2)
    assert spec.load_reader("rl_roofline.decon").read(run) == pytest.approx(
        100 * least / 250e-9)


def test_reservoir_is_the_seeds_and_uniform():
    a, b = Reservoir(2, 7), Reservoir(2, 7)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.kept == b.kept and len(a.kept) == 2
    hits = np.zeros(10)
    for seed in range(2000):
        r = Reservoir(1, seed)
        for i in range(10):
            r.offer(i)
        hits[r.kept[0]] += 1
    assert hits.min() > 140 and hits.max() < 260
