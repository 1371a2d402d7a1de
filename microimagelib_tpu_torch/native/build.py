"""Build and load the port's native TIFF codec (``native/miltiff.cpp``, the
JAX package's codec with every read bounded by the file's size:
page-parallel decode and encode with the u16 <-> f32 conversion fused
into the copy).

The source is compiled by the host C++ compiler (``g++``, or ``$CXX``)
against this interpreter's headers into
``build/microimagelib_tpu_torch/native/<hash>/`` at the repository root;
the hash covers the source, the flags, the compiler's version and the
interpreter's ABI, so a build made elsewhere is never loaded. Nothing is
built or loaded when this module is imported: the first :func:`load`
does it. A failed build raises.

    python -m microimagelib_tpu_torch.native.build   # build now, print the path
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "miltiff.cpp"
BUILD_ROOT = NATIVE_DIR.parents[1] / "build" / NATIVE_DIR.parent.name / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
CXX = os.environ.get("CXX", "g++")

_MODULE = None
_LOCK = threading.Lock()   # the batch's writer threads may load it at once


def _compiler_version(cxx):
    try:
        out = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             timeout=60)
    except OSError as e:
        raise RuntimeError(f"the C++ compiler {cxx!r} cannot run: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed:\n{out.stdout}{out.stderr}")
    return out.stdout


def module_path(cxx=None):
    """Where the extension of this source, compiler and interpreter lives."""
    cxx = cxx or CXX
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (" ".join(FLAGS), _compiler_version(cxx), sys.version,
                 sysconfig.get_config_var("EXT_SUFFIX") or ""):
        h.update(part.encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_ROOT / h.hexdigest()[:16] / ("miltiff" + suffix)


def build(cxx=None):
    """Compile the extension unless it is built already; return its path.
    Raises RuntimeError when the compiler is missing or fails."""
    cxx = cxx or CXX
    out = module_path(cxx)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [cxx, *FLAGS, f"-I{sysconfig.get_paths()['include']}", str(SOURCE),
           "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError("building the native TIFF codec failed:\n"
                               + " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load():
    """Build if needed and import the extension (once per process)."""
    global _MODULE
    with _LOCK:
        if _MODULE is None:
            _MODULE = _import(build())
    return _MODULE


def _import(path):
    """Import the extension at ``path`` as the module ``miltiff``."""
    loader = importlib.machinery.ExtensionFileLoader("miltiff", str(path))
    spec = importlib.util.spec_from_file_location("miltiff", str(path),
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


if __name__ == "__main__":
    print(build())
