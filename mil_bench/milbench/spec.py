"""Finds a cell's parts by the names in ``BENCHMARK.json``:

* the configuration's file, as ``configs[].file`` names it;
* the traffic mix ``mil_bench/traffic/<traffic>.json``;
* the limits of its correctness numbers ``mil_bench/limits/<cell>.json``;
* each metric's reader ``mil_bench/metrics/<metric>.py``: a module with
  ``read(run)`` that returns the number or None where it finds nothing to
  read, and optionally ``SPANS`` [(module, attribute, span name)] that the
  traced run wraps and ``COUNTERS`` [(module, attribute)] of the program
  that the run reads before and after the window.

A cell reports the end-to-end metrics whose ``workloads`` list it (all,
without the key) and, in a traced run, the per-layer metrics whose
``workloads`` list it or, without the key, whose ``moves`` it reports.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict = field(default_factory=dict)


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _listed(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path):
    """A module of the benchmark's own loaded from its file (names may
    hold dots)."""
    path = Path(path)
    name = "milbench_" + path.parent.name + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name, bench_dir=BENCH_DIR):
    return load_module(Path(bench_dir) / "metrics" / f"{name}.py")


def find_cell(name, bench=None, root=ROOT):
    bench = load_benchmark(root) if bench is None else bench
    bench_dir = Path(root) / BENCH_DIR.name
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    cell = Cell(name=name, chips=int(wl["chips"]),
                config=_json(Path(root) / cfg_entry["file"]),
                traffic=_json(bench_dir / "traffic" / f"{wl['traffic']}.json"),
                limits=_json(bench_dir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)
    for m in e2e + per_layer:
        cell.readers[m["name"]] = load_reader(m["name"], bench_dir)
    return cell
