"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or the JAX package (``microimagelib_tpu``, compared whole,
since the port's name begins with it), and a plain reference that imports
nothing of the program."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "microimagelib_tpu"}
# the yardstick: it may not lean on the program it measures
PLAIN = ["data.py", "reference.py", "generate.py", "judge.py", "stats.py", "trace.py"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("name", PLAIN)
def test_the_yardstick_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in _imports(BENCH / "milbench" / name)}
    assert "microimagelib_tpu_torch" not in tops


def _child(code, cwd, env_path):
    env = dict(os.environ, PYTHONPATH=env_path, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          capture_output=True, text=True, timeout=600, env=env)


def test_a_run_loads_no_jax():
    """A tiny decon cell driven end to end on the CPU, then the loaded
    modules' top-level names."""
    code = f"""
        import sys, time
        sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r}, {str(ROOT)!r}]
        import tiny
        from milbench import card, harness, spec
        res, _ = harness.run_cell(tiny.cell("decon.sv512.gauss"), 5, 0.2, False, "cpu",
                                  time.perf_counter())
        cell = spec.find_cell("fusion.dispim")
        print("correct", res["correct"])
        print("found", card.forbidden_modules())
        print("port", "microimagelib_tpu_torch" in sys.modules)
    """
    out = _child(code, ROOT, "")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "correct True" in out.stdout
    assert "found []" in out.stdout and "port True" in out.stdout


def test_without_the_program_there_is_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    the harness cannot load the program, fails, and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name)
    code = f"""
        import sys, time
        sys.path[:0] = [{str(tmp_path / BENCH.name)!r}, {str(tmp_path / BENCH.name / 'tests')!r}]
        import tiny
        from milbench import harness
        res, _ = harness.run_cell(tiny.cell("decon.sv512.gauss"), 5, 0.2, False, "cpu",
                                  time.perf_counter())
        print(res)
    """
    out = _child(code, tmp_path, "")
    assert out.returncode != 0
    assert "microimagelib_tpu_torch" in out.stderr and out.stdout == ""
