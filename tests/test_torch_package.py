"""Package hygiene of the PyTorch/CUDA port: it never imports JAX or the
JAX package, and its kernel build targets Hopper from csrc/ sources only
and happens at first use, never at import; so does the native TIFF
codec's host build, from its own copy of the source."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import microimagelib_tpu_torch
from microimagelib_tpu_torch.kernels import build

PKG = Path(microimagelib_tpu_torch.__file__).parent
ROOT = PKG.parent


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(ROOT), timeout=240)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"microimagelib_tpu_torch.models.deconvolution",
            "microimagelib_tpu_torch.models.registration",
            "microimagelib_tpu_torch.models.registration_grad",
            "microimagelib_tpu_torch.ops.corr",
            "microimagelib_tpu_torch.kernels.corr",
            "microimagelib_tpu_torch.cli.reg3d",
            "microimagelib_tpu_torch.models.fusion",
            "microimagelib_tpu_torch.ops.resample",
            "microimagelib_tpu_torch.kernels.rl_fused",
            "microimagelib_tpu_torch.cli.spim_fusion",
            "microimagelib_tpu_torch.kernels.pipe_copy",
            "microimagelib_tpu_torch.tools.conv_roofline",
            "microimagelib_tpu_torch.models.projections",
            "microimagelib_tpu_torch.models.batch",
            "microimagelib_tpu_torch.cli.spim_fusion_batch",
            "microimagelib_tpu_torch.tools.e2e_surrogate",
            "microimagelib_tpu_torch.models.decon_streamed",
            "microimagelib_tpu_torch.native.build",
            "microimagelib_tpu_torch.parallel",
            "microimagelib_tpu_torch.parallel.mesh",
            "microimagelib_tpu_torch.parallel.collectives",
            "microimagelib_tpu_torch.parallel.sharded",
            "microimagelib_tpu_torch.parallel.distributed",
            "microimagelib_tpu_torch.ops.fft_sharded"} <= set(mods)
    proc = _run(
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'microimagelib_tpu' or m.startswith('microimagelib_tpu.')]\n"
        "print('LEAKED', bad)\n")
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+microimagelib_tpu\b"
                     r"|from\s+microimagelib_tpu[\s.])", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert offenders == []
    chip_smoke = ROOT / "chip_smoke.py"
    assert not pat.search(chip_smoke.read_text())


def test_nvcc_command_targets_sm90a_and_csrc_only(tmp_path):
    compiles = build.compile_commands(tmp_path)
    srcs = []
    for cmd, obj in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--use_fast_math" not in cmd     # K3 needs accurate twiddles
        assert cmd[cmd.index("-o") + 1] == str(obj) and obj.parent == tmp_path
        src = [Path(c) for c in cmd if c.endswith((".cu", ".cpp", ".c"))]
        assert len(src) == 1                    # one nvcc per source
        srcs += src
    assert all(s.parent == build.CSRC_DIR for s in srcs)
    assert {build.CSRC_DIR / "conv_sep.cu", build.CSRC_DIR / "fft_ct.cu",
            build.CSRC_DIR / "corr.cu", build.CSRC_DIR / "pipe_copy.cu"} <= set(srcs)
    link = build.link_command([obj for _cmd, obj in compiles], tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert link[link.index("-o") + 1] == str(tmp_path / "lib.so")
    # the library links the CUDA runtime only: no cuFFT, cuBLAS or other
    # library of finished kernels
    assert not [c for c in link if c.startswith(("-l", "-L")) or "cufft" in c
                or "cublas" in c]
    for src in srcs:
        text = src.read_text()
        assert "cufft" not in text.lower() and "cublas" not in text.lower()
    # the library lands under build/<package>/<source hash>/
    lib = build.library_path()
    assert lib.parent.parent == ROOT / "build" / "microimagelib_tpu_torch"


def test_importing_kernels_builds_nothing():
    proc = _run(
        "import microimagelib_tpu_torch.kernels.build as b\n"
        "import microimagelib_tpu_torch.kernels.conv_sep as k\n"
        "import microimagelib_tpu_torch.kernels.fft_ct as f\n"
        "import microimagelib_tpu_torch.kernels.corr as c\n"
        "import microimagelib_tpu_torch.kernels.pipe_copy as p\n"
        "import microimagelib_tpu_torch.models.deconvolution\n"
        "import microimagelib_tpu_torch.models.registration\n"
        "import microimagelib_tpu_torch.tools.conv_roofline\n"
        "print('STATE', b._LIB is None, k._lib is None, k.LAUNCHES,\n"
        "      f._lib is None, f.LAUNCHES, c._lib is None, c.K4_LAUNCHES,\n"
        "      c.K5_LAUNCHES, c.PLAIN_CALLS, p._lib is None, p.LAUNCHES,\n"
        "      b.library_path().exists())\n")
    assert proc.returncode == 0, proc.stderr
    state = proc.stdout.split("STATE")[1].split()
    assert state[:11] == ["True", "True", "0", "True", "0", "True", "0", "0", "0",
                          "True", "0"]


def test_native_codec_builds_at_first_use_from_its_own_source():
    from microimagelib_tpu_torch.native import build as nb

    assert nb.SOURCE == PKG / "native" / "miltiff.cpp" and nb.SOURCE.is_file()
    assert nb.BUILD_ROOT == ROOT / "build" / "microimagelib_tpu_torch" / "native"
    assert not list(PKG.rglob("*.so"))      # nothing prebuilt in the package
    proc = _run(
        "import microimagelib_tpu_torch.io.tiff as t\n"
        "import microimagelib_tpu_torch.native.build as nb\n"
        "print('STATE', nb._MODULE is None, sum(t.COUNTS.values()))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("STATE")[1].split() == ["True", "0"]


def _all_names(init_py):
    """The names of ``__all__`` in an ``__init__.py``, read with ``ast``
    (nothing is imported); the empty set where the file has no ``__all__``."""
    import ast

    for node in ast.parse(init_py.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return set()


@pytest.mark.parametrize("sub", ["models", "ops", "io", "utils", "parallel", "cli"])
def test_every_jax_export_is_exported_by_the_port(sub):
    """The same surface: each name in the ``__all__`` of a JAX package
    ``__init__`` is in the port's counterpart's, and the port's module has
    it. The JAX ``__all__`` is parsed from its file, so no JAX module is
    imported here."""
    import importlib

    jax_names = _all_names(ROOT / "microimagelib_tpu" / sub / "__init__.py")
    port = importlib.import_module(f"microimagelib_tpu_torch.{sub}")
    port_names = set(getattr(port, "__all__", ()))
    assert port_names == _all_names(PKG / sub / "__init__.py")
    assert jax_names <= port_names, sorted(jax_names - port_names)
    assert all(hasattr(port, name) for name in port_names)


def test_times_tools_run_each_root_on_its_own_package(tmp_path, monkeypatch, capsys):
    """tools/turns.py runs a tool's file once per root, in turns, with that
    root's package first on the path, passes each child's output through
    after the card line, and stops at the first child that fails."""
    from microimagelib_tpu_torch.tools import turns

    script = tmp_path / "tool.py"
    script.write_text("import sys, microimagelib_tpu_torch as m\n"
                      "print(sys.argv[1:], m.WHICH)\n"
                      "sys.exit(3 if m.WHICH == 'bad' else 0)\n")
    roots = []
    for which in ("a", "b", "bad", "c"):
        pkg = tmp_path / which / "microimagelib_tpu_torch"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text(f"WHICH = {which!r}\n")
        roots.append(str(tmp_path / which))
    monkeypatch.setattr(turns, "card_line", lambda: "a card, 700.00 W")
    rc, outs = turns.in_turns(str(script), ",".join(roots[:2] + roots[:1]), ["--x", "1"])
    assert rc == 0
    assert outs == [f"['--one', '{roots[i]}', '--x', '1'] {w}\n"
                    for i, w in ((0, "a"), (1, "b"), (0, "a"))]
    assert capsys.readouterr().out == "a card, 700.00 W\n" + "".join(outs)
    rc, outs = turns.in_turns(str(script), ",".join(roots[1:]), [])
    assert rc == 3 and [o.split()[-1] for o in outs] == ["b", "bad"]
