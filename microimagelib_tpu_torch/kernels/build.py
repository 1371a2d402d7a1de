"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``microimagelib_tpu_torch/csrc/`` is compiled
by ``nvcc`` for Hopper (``sm_90a``) into an object, one ``nvcc`` process
per source, all started together; the objects are linked into one shared
library with a plain C interface (CUDA runtime only: no cuFFT, no
cuBLAS), loaded with ``ctypes``. The library goes into
``build/microimagelib_tpu_torch/<hash of the sources and flags>/`` at the
repository root, so an edit to a source rebuilds it and an unchanged tree
reuses it. Nothing is built or loaded when this module is imported: the
first :func:`load_library` call does it.

    python -m microimagelib_tpu_torch.kernels.build   # build now, print the path
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / PKG_DIR.name
LIB_NAME = "libmil_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_LIB = None


def sources():
    """The kernel sources: ``csrc/*.cu``, sorted."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path():
    return BUILD_ROOT / _source_hash() / LIB_NAME


def nvcc_path():
    """``nvcc`` on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def compile_commands(obj_dir):
    """One ``nvcc -c`` command per source: [(command, object path)]."""
    cmds = []
    for src in sources():
        obj = Path(obj_dir) / (src.stem + ".o")
        cmds.append(([nvcc_path(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                     obj))
    return cmds


def link_command(objects, out_path):
    return [nvcc_path(), *NVCC_FLAGS[:2], "-shared", "-o", str(out_path),
            *(str(o) for o in objects)]


def _run_all(cmds):
    """Run the commands in parallel; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    for cmd, text, rc in outs:
        if rc != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + text)


def build():
    """Compile the library unless this source hash is already built;
    return its path. Raises when ``nvcc`` is missing or fails."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = nvcc_path()
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found (looked for {nvcc}); the CUDA "
                           "kernels cannot be built")
    tmp_dir = out.parent / f"tmp.{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    try:
        compiles = compile_commands(tmp_dir)
        _run_all([cmd for cmd, _obj in compiles])
        tmp = tmp_dir / LIB_NAME
        _run_all([link_command([obj for _cmd, obj in compiles], tmp)])
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


def load_library():
    """Build if needed and load the kernel library (once per process)."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
        _LIB.mil_cuda_error_string.argtypes = [ctypes.c_int]
        _LIB.mil_cuda_error_string.restype = ctypes.c_char_p
    return _LIB


def check(lib, err, what):
    """Raise when a C entry returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.mil_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


if __name__ == "__main__":
    print(build())
