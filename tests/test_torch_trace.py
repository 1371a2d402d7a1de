"""The port's spans and counters (``utils/trace.py``) on the CPU at small
shapes: off without a profiler, nested as the layers are under one, the
same outputs either way, every span name listed, the counters read from
their modules. One test needs the card (``-m cuda``; skips elsewhere):
the copies' bytes and the memory queries there. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -m cuda
"""

import ast
import importlib
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.models import deconvolution as D
from microimagelib_tpu_torch.models import fusion as FU
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.ops.matrix import identity_tmx
from microimagelib_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "microimagelib_tpu_torch"
LITERAL = re.compile(r"\bspan(?:ned)?\(\s*\"(mil\.[^\"]*)\"")


def _blobs(shape, n=8, seed=0):
    rng = np.random.default_rng(seed)
    grid = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape), indexing="ij")
    vol = np.full(shape, 10.0, np.float32)
    for _ in range(n):
        c = [rng.uniform(0.2 * s, 0.8 * s) for s in shape]
        r2 = sum((g - ci) ** 2 for g, ci in zip(grid, c))
        vol += 500.0 * np.exp(-r2 / (2 * rng.uniform(1.0, 2.5) ** 2)).astype(np.float32)
    return vol


def _gauss(shape, sigma):
    grid = np.meshgrid(*(np.arange(s) - s // 2 for s in shape), indexing="ij")
    k = np.exp(-sum(g.astype(np.float64) ** 2 for g in grid) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


@pytest.fixture
def fresh():
    trace.reset()
    yield
    trace.reset()


def _traced(fn, cuda=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof, trace.snapshot()["spans"]


def _ranges(prof, prefix="mil."):
    """(name, start, end) of the profiler's host ranges named ``prefix...``,
    by start."""
    evs = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(prefix) and e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(evs, key=lambda e: e[1])


def _decon(**kw):
    img = _blobs((12, 16, 20), seed=1)
    return D.decon_singleview(img, _gauss((5, 5, 5), 1.0), n_iters=3, mem_mode=0, **kw)


def test_off_without_a_profiler(fresh):
    assert trace.span("mil.decon") is trace.OFF
    assert trace.span("mil.to_host", 4) is trace.OFF
    _decon()
    assert trace.snapshot()["spans"] == {}


def test_decon_nests_loop_and_iterations(fresh):
    out, prof, spans = _traced(_decon)
    assert spans["mil.decon"]["calls"] == 1 and not spans["mil.decon"]["within"]
    assert spans["mil.rl.loop"]["within"] == {"mil.decon": 1}
    assert spans["mil.rl.iter"]["calls"] == 3
    assert spans["mil.rl.iter"]["within"] == {"mil.rl.loop": 3}
    assert spans["mil.to_host"]["within"] == {"mil.decon": 1}
    assert spans["mil.to_host"]["bytes"] == out.nbytes
    assert all(s["device_s"] == 0.0 for s in spans.values())
    # the profiler's host ranges nest the same way
    r = _ranges(prof)
    (dec,) = [x for x in r if x[0] == "mil.decon"]
    (loop,) = [x for x in r if x[0] == "mil.rl.loop"]
    iters = [x for x in r if x[0] == "mil.rl.iter"]
    assert len(iters) == 3
    assert dec[1] <= loop[1] and loop[2] <= dec[2]
    assert all(loop[1] <= i[1] and i[2] <= loop[2] for i in iters)


def _fusion():
    vol = _blobs((16, 16, 16), n=6, seed=3)
    return FU.fusion_dualview(vol, vol, _gauss((5, 5, 5), 1.0), _gauss((5, 5, 5), 1.0),
                              (1.0, 1.0, 1.0), (1.0, 1.0, 1.0), im_rotation=0,
                              aff_method=1, it_limit=100, n_iters=2, mem_mode=0)


def test_fusion_preprocess_reg_decon_in_order(fresh):
    out, prof, spans = _traced(_fusion)
    stages = ["mil.fusion.preprocess", "mil.fusion.reg", "mil.fusion.decon"]
    r = _ranges(prof, "mil.fusion")
    (fus,) = [x for x in r if x[0] == "mil.fusion"]
    got = [x for x in r if x[0] in stages]
    assert [x[0] for x in got] == stages
    assert all(fus[1] <= x[1] and x[2] <= fus[2] for x in got)
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))
    assert spans["mil.reg"]["within"] == {"mil.fusion.reg": 1}
    assert spans["mil.decon"]["within"] == {"mil.fusion.decon": 1}
    assert spans["mil.rl.iter"]["calls"] == 2
    # the joint decon's result and view A on the grid come back to the host
    assert spans["mil.to_host"]["calls"] == 2
    assert spans["mil.to_host"]["bytes"] == out[0].nbytes + out[3].nbytes


def _pyramid(levels):
    vol = _blobs((32, 32, 32), n=12, seed=23)
    m = identity_tmx()
    m[3], m[7], m[11] = 1.3, -1.8, 0.7
    moved = R.affine_transform_3d(torch.from_numpy(vol), m, vol.shape).numpy()
    return R.reg3d(vol, moved, 2, 2, ftol=1e-5, it_limit=3000, mem_mode=0, engine="grad",
                   pyramid=True, on_level=lambda *a: levels.append(a))


def test_pyramid_spans_each_level(fresh, monkeypatch):
    monkeypatch.setenv("MIL_REG_PYRAMID_BUDGET", "4000")
    levels = []
    _out, _prof, spans = _traced(lambda: _pyramid(levels))
    assert [lv[1] for lv in levels] == [(8, 8, 32), (16, 16, 32), (32, 32, 32)]
    assert spans["mil.reg.level"]["calls"] == len(levels)
    assert spans["mil.reg.level"]["within"] == {"mil.reg": len(levels)}
    assert spans["mil.reg.pool"]["calls"] == len(levels) - 1
    assert spans["mil.reg.final_transform"]["within"] == {"mil.reg.level": 1}
    assert spans["mil.to_host"]["within"] == {"mil.reg.level": 1}


def test_outputs_equal_with_the_profiler_on_and_off(fresh, monkeypatch):
    """The volumes and matrices (the records hold host times)."""
    monkeypatch.setenv("MIL_REG_PYRAMID_BUDGET", "4000")
    for run in (lambda: (_decon(),), _fusion, lambda: _pyramid([])[:2]):
        off = run()
        on, _prof, _spans = _traced(run)
        assert len(on) == len(off)
        for a, b in zip(off, on):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def _package_literals():
    found = {}
    for path in sorted(PKG.rglob("*.py")):
        for name in LITERAL.findall(path.read_text()):
            found.setdefault(name, path.relative_to(ROOT).as_posix())
    return found


LITERALS = _package_literals()


@pytest.mark.parametrize("name", sorted(LITERALS))
def test_every_span_in_the_package_is_listed(name):
    assert name in trace.SPANS, (name, LITERALS[name])


def test_every_listed_span_is_opened_somewhere():
    assert set(trace.SPANS) == set(LITERALS)
    assert all(n.startswith("mil.") and trace.SPANS[n] for n in trace.SPANS)


def _benchmark_span_names():
    """The names the benchmark gives its own spans: its window and call
    ranges and the third entry of each reader's ``SPANS``."""
    names = set()
    for path in [*(ROOT / "mil_bench" / "metrics").glob("*.py"),
                 *(ROOT / "mil_bench" / "milbench").glob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id in ("SPANS", "WINDOW_SPAN", "CALL_SPAN")
                    for t in node.targets):
                names |= {c.value for c in ast.walk(node.value)
                          if isinstance(c, ast.Constant) and isinstance(c.value, str)
                          and "." in c.value and not c.value.startswith("microimagelib")}
    return names


def test_no_span_is_named_as_a_benchmark_span():
    bench = _benchmark_span_names()
    assert {"bench.window", "bench.call", "fusion.reg3d", "fusion.decon_dualview",
            "decon.rl_loop"} <= bench
    assert not bench & set(trace.SPANS)


def test_snapshot_counters_are_the_module_attributes(monkeypatch):
    monkeypatch.setattr(C, "K5_LAUNCHES", C.K5_LAUNCHES + 7)
    got = trace.snapshot()["counters"]
    assert got["microimagelib_tpu_torch.kernels.corr.K5_LAUNCHES"] == C.K5_LAUNCHES
    n = 0
    for module, attribute in trace.COUNTERS:
        value = getattr(importlib.import_module(module), attribute)
        items = value.items() if isinstance(value, dict) else [(None, value)]
        for k, v in items:
            key = f"{module}.{attribute}" + ("" if k is None else f".{k}")
            assert got[key] == v, key
            n += 1
    assert len(got) == n


def test_threads_keep_their_own_stacks(fresh):
    seen = threading.Event()
    go = threading.Event()

    def worker():
        with trace.span("mil.to_host", 8):
            seen.set()
            go.wait(30)

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("mil.decon"):
            t = threading.Thread(target=worker)
            t.start()
            assert seen.wait(30)
            with trace.span("mil.rl.loop"):
                pass
            go.set()
            t.join(30)
    assert not t.is_alive()
    spans = trace.snapshot()["spans"]
    assert spans["mil.to_host"]["within"] == {} and spans["mil.to_host"]["bytes"] == 8
    assert spans["mil.rl.loop"]["within"] == {"mil.decon": 1}


def test_a_span_left_by_an_exception_closes(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with trace.span("mil.reg"):
                raise ValueError("x")
        with trace.span("mil.decon"):
            pass
    spans = trace.snapshot()["spans"]
    assert spans["mil.reg"]["calls"] == 1 and spans["mil.decon"]["within"] == {}


@pytest.mark.cuda
def test_copies_and_memory_queries_on_the_card(fresh, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the spans' events and the memory queries)")
    dev = torch.device("cuda", 0)
    queries = []
    for name in ("free_memory_mb", "hbm_budget_bytes"):
        real = getattr(D, name)

        def counted(*a, _real=real, _name=name, **k):
            queries.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(D, name, counted)
    img = _blobs((64, 96, 128), n=20, seed=5)
    psf = _gauss((9, 9, 9), 1.5)

    def run():
        rec = np.zeros(10)
        single = D.decon_singleview(img, psf, n_iters=4, device=dev, mem_mode=-1, records=rec)
        dual = D.decon_dualview(img, img, psf, psf, n_iters=2, device=dev, mem_mode=-1,
                                records=np.zeros(10))
        return single, dual

    off = run()
    n_off = len(queries)
    queries.clear()
    (single, dual), _prof, spans = _traced(run, cuda=True)
    assert np.array_equal(off[0], single) and np.array_equal(off[1], dual)
    assert len(queries) == n_off > 0
    assert spans["mil.mem_query"]["calls"] == len(queries)
    assert spans["mil.to_host"]["calls"] == 2
    assert spans["mil.to_host"]["bytes"] == single.nbytes + dual.nbytes
    assert spans["mil.to_host"]["device_s"] > 0
    it, loop = spans["mil.rl.iter"], spans["mil.rl.loop"]
    assert it["calls"] == 6 and 0 < it["device_s"] <= loop["device_s"]
