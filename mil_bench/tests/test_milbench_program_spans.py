"""The readers of the metrics that read the program's own spans
(``milbench/program.py``): None on a run without the spans (a program
without its trace module, or a window in which it recorded none), and the
hand-computed value from a hand-set snapshot and a hand-made trace."""

import sys

import pytest

from milbench import program, spec
from milbench.harness import Run
from milbench.trace import TraceView

NEW = {"to_host_gbps.decon": ["decon.sv512.gauss", "decon.sv512.measured"],
       "to_host_gbps.fusion": ["fusion.dispim"],
       "rl_iter_ms.decon": ["decon.sv512.gauss", "decon.sv512.measured"],
       "rl_iter_ms.fusion": ["fusion.dispim"],
       "reg_final_ms.reg": ["reg.dispim"],
       "reg_level_idle_ms.reg": ["reg.dispim"],
       "mem_queries_per_call.reg": ["reg.dispim"],
       "mem_queries_per_call.fusion": ["fusion.dispim"]}

SPANS = {"mil.to_host": {"calls": 2, "host_s": 0.6, "device_s": 0.5, "bytes": 10 ** 9},
         "mil.rl.iter": {"calls": 40, "host_s": 0.01, "device_s": 0.1, "bytes": 0},
         "mil.reg.final_transform": {"calls": 4, "host_s": 0.001, "device_s": 0.02, "bytes": 0},
         "mil.mem_query": {"calls": 40, "host_s": 0.2, "device_s": 0.0, "bytes": 0},
         "mil.reg.level": {"calls": 2, "host_s": 4e-7, "device_s": 0.0, "bytes": 0}}
# per call, over 4 completed calls: 10^9 B / 0.5 s; 0.1 s / 40; 20 ms / 4;
# 40 / 4; the idle gaps [100, 150) and [300, 400) ns inside the levels
# [50, 200) and [250, 500): 150 ns / 4
WANT = {"to_host_gbps.decon": 2.0, "to_host_gbps.fusion": 2.0, "rl_iter_ms.decon": 2.5,
        "rl_iter_ms.fusion": 2.5, "reg_final_ms.reg": 5.0, "reg_level_idle_ms.reg": 150e-6 / 4,
        "mem_queries_per_call.reg": 10.0, "mem_queries_per_call.fusion": 10.0}


def _run(trace=None):
    return Run(cell="x", config={}, traffic={}, units={}, setup_s=0.0, window_s=1.0,
               calls=[(0.0, 0.1, True)] * 4 + [(0.0, 0.1, False)], trace=trace)


def _trace():
    device = [("k", 0, 100, "kernel"), ("k", 150, 300, "kernel"), ("c", 400, 1000, "gpu_memcpy")]
    host = [("bench.window", 0, 1000), ("mil.reg.level", 50, 200), ("mil.reg.level", 250, 500),
            ("aten::add", 120, 130)]
    return TraceView(device, host)


@pytest.fixture
def snapshot(monkeypatch):
    from microimagelib_tpu_torch.utils import trace

    def set_spans(spans):
        monkeypatch.setattr(trace, "snapshot", lambda: {"spans": spans, "counters": {}})
    return set_spans


def test_the_entries_list_the_cells_that_read_them():
    bench = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name, cells in NEW.items():
        assert bench[name]["workloads"] == cells
        assert bench[name]["source"] == "program_span"
        for cell in cells:
            assert name in spec.find_cell(cell).readers
    assert list(bench)[-len(NEW):] == list(NEW)


@pytest.mark.parametrize("name", sorted(NEW))
def test_hand_set_snapshot_gives_the_hand_computed_value(name, snapshot):
    snapshot(SPANS)
    got = spec.load_reader(name).read(_run(_trace()))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(NEW))
def test_no_spans_recorded_gives_none(name, snapshot):
    snapshot({})
    assert spec.load_reader(name).read(_run(TraceView([], []))) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_program_without_the_trace_module_gives_none(name, monkeypatch):
    """A checkout before the program had spans: the import fails."""
    from microimagelib_tpu_torch import utils

    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "microimagelib_tpu_torch.utils.trace", None)
    assert spec.load_reader(name).read(_run(TraceView([], []))) is None


def test_the_readers_take_no_counter_or_span_of_their_own():
    """The harness looks up a reader's COUNTERS and SPANS before the
    window; a name the parent lacks would break the parent's traced run."""
    for name in NEW:
        r = spec.load_reader(name)
        assert not hasattr(r, "COUNTERS") and not hasattr(r, "SPANS")


def test_the_snapshot_is_the_programs_after_a_traced_window():
    """A tiny traced decon cell on the CPU: the program's spans come back
    through the snapshot (no device, so no device seconds)."""
    import time

    import tiny
    from milbench import harness
    from microimagelib_tpu_torch.utils import trace

    trace.reset()
    res, _checks = harness.run_cell(tiny.cell("decon.sv512.gauss"), tiny.SEED, 0.2, True,
                                    "cpu", time.perf_counter())
    spans = program.spans()
    assert spans["mil.decon"]["calls"] == res["attempted"]
    assert spans["mil.rl.iter"]["calls"] == res["attempted"] * 20
    assert spans["mil.to_host"]["calls"] == res["attempted"]
    assert "to_host_gbps.decon" not in res["metrics"]
    assert "rl_iter_ms.decon" not in res["metrics"]
    trace.reset()
