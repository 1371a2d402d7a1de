"""Package hygiene of the PyTorch/CUDA port: it never imports JAX or the
JAX package, and its kernel build targets Hopper from csrc/ sources only
and happens at first use, never at import."""

import os
import re
import subprocess
import sys
from pathlib import Path

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
            "microimagelib_tpu_torch.cli.reg3d"} <= set(mods)
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
            build.CSRC_DIR / "corr.cu"} <= set(srcs)
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
        "import microimagelib_tpu_torch.models.deconvolution\n"
        "import microimagelib_tpu_torch.models.registration\n"
        "print('STATE', b._LIB is None, k._lib is None, k.LAUNCHES,\n"
        "      f._lib is None, f.LAUNCHES, c._lib is None, c.K4_LAUNCHES,\n"
        "      c.K5_LAUNCHES, c.PLAIN_CALLS, b.library_path().exists())\n")
    assert proc.returncode == 0, proc.stderr
    state = proc.stdout.split("STATE")[1].split()
    assert state[:9] == ["True", "True", "0", "True", "0", "True", "0", "0", "0"]
