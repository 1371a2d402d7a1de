"""BENCHMARK.json against the rules a benchmark file keeps, and the harness
finding each cell's configuration, mix, limits and readers by name."""

import json
import re
import shutil

import numpy as np
import pytest

from milbench import entries, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert "mil_bench" in BENCH["paths"]
    assert BENCH["command"] == ["python3", "mil_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check of 24 cells fits 43200 s
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (BENCH["run_seconds"] + 60)


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("mil_bench/")
        assert c["reduced"] == [] or c["name"] not in ("dispim_320x512x320", "sv_512")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns)), group


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {"setup_s", "fusion_tp_per_min", "rl_gvoxit_per_s", "reg_pairs_per_s",
            "reg_p95_ms"} <= set(e2e)


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.find_cell(name)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], "moves a metric the cell reports")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.readers[m["name"]].read)
    assert cell.limits, "a cell compares at least one number"
    assert callable(entries.resolve(cell.traffic["entry"]))


def test_per_layer_lists_only_cells_that_report_what_it_moves():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        for w in m["workloads"]:
            e2e = [e["name"] for e in spec.find_cell(w).end_to_end]
            assert m["moves"] in e2e, (m["name"], w)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_cell_added_by_data_alone(tmp_path):
    """A later change adds a cell with a mix file, a limits file and an
    entry; no code changes."""
    root = tmp_path
    shutil.copytree(spec.BENCH_DIR, root / "mil_bench")
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((root / "mil_bench/traffic/sv_gauss9_pool4.json").read_text())
    traffic["pool"] = 2
    (root / "mil_bench/traffic/sv_gauss9_pool2.json").write_text(json.dumps(traffic))
    (root / "mil_bench/limits/decon.sv512.pool2.json").write_text('{"decon_rel_l2": 1e-4}')
    bench["workloads"].append({"name": "decon.sv512.pool2", "config": "sv_512",
                               "traffic": "sv_gauss9_pool2", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "decon.sv512.gauss" in m.get("workloads", ()):
            m["workloads"].append("decon.sv512.pool2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("decon.sv512.pool2", root=root)
    assert cell.traffic["pool"] == 2
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "rl_gvoxit_per_s"}
    assert "rl_roofline.decon" in cell.readers


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell("no.such.cell")


def test_a_new_entry_and_input_kind_are_new_files(tmp_path, monkeypatch):
    """An entry, a kind of input or a PSF the harness lacks comes as a file
    of its own under ``mil_bench/entries/``, ``inputs/`` or ``psfs/``."""
    from milbench import generate

    (tmp_path / "entries").mkdir()
    (tmp_path / "inputs").mkdir()
    (tmp_path / "entries" / "echo.py").write_text(
        "class Entry:\n    units = {}\n    def __init__(self, cfg, traffic, device):\n"
        "        self.cfg = cfg\n")
    (tmp_path / "inputs" / "ones.py").write_text(
        "def make_pool(cfg, traffic, seed, device):\n    return [{'x': 1}] * traffic['pool']\n")
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    assert entries.make({"a": 1}, {"entry": "echo", "psf": "gauss9"}, "cpu").cfg == {"a": 1}
    assert generate.make_pool({}, {"inputs": "ones", "resident": "host", "pool": 3}, 1,
                              "cpu") == [{"x": 1}] * 3
    from milbench import data

    (tmp_path / "psfs").mkdir()
    np.save(tmp_path / "psfs" / "flat.npy", np.ones((3, 3, 3)))
    monkeypatch.setattr(data, "PSF_DIR", tmp_path / "psfs")
    assert data.psf("flat").shape == (3, 3, 3) and data.psf("gauss9").shape == (9, 9, 9)
