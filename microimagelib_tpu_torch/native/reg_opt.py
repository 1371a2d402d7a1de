"""The host build of K9's optimizers (``csrc/reg_opt.cuh`` through
``native/reg_opt.cpp``): the L-BFGS and Powell stages (Powell with the
8-probe line search too), the matrix builders, the whole affMethod ladder
(with ``batch_ls``) and the hybrid engine's line stage as the card runs them
inside K9, compiled by
the host C++ compiler, with costs and sums from Python callbacks (ctypes).
The CPU tests use it to hold the card's optimizer source against the JAX
package; the port's own CPU path is the host loop
(``models/registration_grad.py::reg_ladder_grad_host``,
``models/registration_device.py::reg_ladder_device_host``).

The library is compiled by ``g++`` (or ``$CXX``) at first use into
``build/microimagelib_tpu_torch/native/reg_opt/<hash>/`` at the repository
root; the hash covers the sources, the flags and the compiler's version.
No ``-ffast-math`` and no ``-march``: float32 operations round one by one,
as the host loop's numpy scalars do. Nothing is built or loaded when this
module is imported. A failed build raises.

    python -m microimagelib_tpu_torch.native.reg_opt   # build now, print the path
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from microimagelib_tpu_torch.kernels.reg_ladder import LadderArgs, LadderState

NATIVE_DIR = Path(__file__).resolve().parent
SOURCES = (NATIVE_DIR / "reg_opt.cpp", NATIVE_DIR.parent / "csrc" / "reg_opt.cuh",
           NATIVE_DIR.parent / "csrc" / "torch_trig.cuh")
BUILD_ROOT = NATIVE_DIR.parents[1] / "build" / NATIVE_DIR.parent.name / "native" / "reg_opt"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
CXX = os.environ.get("CXX", "g++")
LIB_NAME = "libmil_reg_opt.so"

COST_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_void_p)
VG_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                         ctypes.POINTER(ctypes.c_float), ctypes.c_void_p)
SUMS_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                           ctypes.POINTER(ctypes.c_double), ctypes.c_void_p)
BATCH_FN = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_void_p)
PROBES_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                             ctypes.POINTER(ctypes.c_double), ctypes.c_void_p)
# the row pitch of a batched cost's points (reg_opt.cuh kMaxN)
MAX_N = 12

_LIB = None
_LOCK = threading.Lock()


def library_path(cxx=None):
    cxx = cxx or CXX
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed:\n{out.stdout}{out.stderr}")
    h.update(out.stdout.encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build(cxx=None):
    """Compile the library unless it is built already; return its path."""
    cxx = cxx or CXX
    out = library_path(cxx)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [cxx, *FLAGS, str(SOURCES[0]), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError("building the host optimizers failed:\n" + " ".join(cmd)
                               + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load():
    """Build if needed and load the library (once per process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.mil_reg_powell.argtypes = [i, p, f, i, i, i, COST_FN, BATCH_FN, p, p, p]
            lib.mil_reg_linmin_nprobe.argtypes = [i, p, p, p, BATCH_FN, p, p]
            lib.mil_reg_lbfgs.argtypes = [i, p, f, i, i, i, i, VG_FN, p, p, p]
            lib.mil_reg_stage_matrix.argtypes = [p, i, p, p]
            lib.mil_reg_stage_pullback.argtypes = [p, i, p, p, p]
            lib.mil_reg_ladder.argtypes = [p, SUMS_FN, PROBES_FN, p, p]
            lib.mil_reg_sizes.argtypes = [p]
            lib.mil_reg_stages.argtypes = [p, p]
            lib.mil_reg_torch_trig.argtypes = [p, i, p, p]
            lib.mil_reg_compose.argtypes = [p] * 6
            sizes = (ctypes.c_int * 2)()
            lib.mil_reg_sizes(sizes)
            if tuple(sizes) != (ctypes.sizeof(LadderArgs), ctypes.sizeof(LadderState)):
                raise RuntimeError("reg_opt.cuh's layouts differ from kernels/reg_ladder.py's")
            _LIB = lib
    return _LIB


def _f32(a, n=None):
    a = np.ascontiguousarray(np.asarray(a, np.float32).reshape(-1))
    if n is not None and a.size != n:
        raise ValueError(f"expected {n} values, got {a.size}")
    return a


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def torch_trig(x):
    """(sin, cos) of the float32 angles ``x`` as the matrix builders take
    them (``csrc/torch_trig.cuh``: torch's CPU float32 values)."""
    lib = load()
    x = _f32(x)
    sn, cs = np.empty_like(x), np.empty_like(x)
    lib.mil_reg_torch_trig(_ptr(x), x.size, _ptr(sn), _ptr(cs))
    return sn, cs


def compose(a, b, g):
    """``reg_opt.cuh``'s compose(a, b) of two row-major 3 x 4 float32
    matrices and its backward for the output gradient ``g``: (a o b,
    d/da (3, 4), d/db[:, :3] (3, 3))."""
    lib = load()
    a, b, g = _f32(a, 12), _f32(b, 12), _f32(g, 12)
    o, ga, gb = np.empty(12, np.float32), np.empty(12, np.float32), np.empty(12, np.float32)
    lib.mil_reg_compose(_ptr(a), _ptr(b), _ptr(g), _ptr(o), _ptr(ga), _ptr(gb))
    return o.reshape(3, 4), ga.reshape(3, 4), gb.reshape(3, 4)[:, :3]


def _batch_cb(cost_batch, n):
    """A BATCH_FN over ``cost_batch``: (P, n) float32 -> (P,) float32."""
    def cb(ps, k, f, _ctx):
        pts = np.ctypeslib.as_array(ps, (k, MAX_N))[:, :n].copy()
        np.ctypeslib.as_array(f, (k,))[:] = np.asarray(cost_batch(pts), np.float32)
    return BATCH_FN(cb)


def powell(cost, p0, ftol, it_limit, nev0=0, max_sweeps=None, cost_batch=None):
    """Powell over ``cost``: (n,) float32 numpy -> float32; as
    ``ops/powell_device.py::powell_device``, whose line searches are the
    8-probe search over ``cost_batch`` ((P, n) float32 -> (P,) float32)
    where one is given. Returns (p, f, evaluations)."""
    lib = load()
    p = _f32(p0).copy()
    n = p.size

    def cb(x, _ctx):
        return float(cost(np.ctypeslib.as_array(x, (n,)).copy()))

    fret, nev = ctypes.c_float(), ctypes.c_int()
    err = lib.mil_reg_powell(n, _ptr(p), float(np.float32(ftol)), int(it_limit), int(nev0),
                             0 if max_sweeps is None else int(max_sweeps), COST_FN(cb),
                             BATCH_FN() if cost_batch is None else _batch_cb(cost_batch, n), None,
                             ctypes.byref(fret), ctypes.byref(nev))
    if err:
        raise ValueError(f"Powell takes 1 to 12 parameters, got {n}")
    return p, np.float32(fret.value), nev.value


def linmin_nprobe(cost_batch, p, xi, fret):
    """The 8-probe line search along ``xi`` from ``p`` (cost ``fret``); as
    ``ops/powell_device.py::_linmin_nprobe``. Returns (p', xi', f',
    evaluations)."""
    lib = load()
    p, xi = _f32(p).copy(), _f32(xi).copy()
    if p.size != xi.size:
        raise ValueError(f"p has {p.size} entries, xi {xi.size}")
    f, nev = ctypes.c_float(float(np.float32(fret))), ctypes.c_int()
    if lib.mil_reg_linmin_nprobe(p.size, _ptr(p), _ptr(xi), ctypes.byref(f),
                                 _batch_cb(cost_batch, p.size), None, ctypes.byref(nev)):
        raise ValueError(f"the line search takes 1 to 12 parameters, got {p.size}")
    return p, xi, np.float32(f.value), nev.value


def lbfgs(value_and_grad, p0, ftol, it_limit, nev0=0, max_iters=200, patience=3):
    """L-BFGS over ``value_and_grad``: (n,) float32 -> (f, (n,) g); as
    ``ops/lbfgs.py::lbfgs_minimize``. Returns (p, f, evaluations)."""
    lib = load()
    p = _f32(p0).copy()
    n = p.size

    def cb(x, g, _ctx):
        f, grad = value_and_grad(np.ctypeslib.as_array(x, (n,)).copy())
        np.ctypeslib.as_array(g, (n,))[:] = np.asarray(grad, np.float32)
        return float(f)

    f, nev = ctypes.c_float(), ctypes.c_int()
    err = lib.mil_reg_lbfgs(n, _ptr(p), float(np.float32(ftol)), int(it_limit), int(nev0),
                            int(max_iters), int(patience), VG_FN(cb), None, ctypes.byref(f),
                            ctypes.byref(nev))
    if err:
        raise ValueError(f"L-BFGS takes 1 to 12 parameters, got {n}")
    return p, np.float32(f.value), nev.value


def stage_matrix(p, ndof):
    """(the 12-vector matrix, its (12, ndof) Jacobian) of a stage's
    parameters: a DOF vector (ndof 3, 6, 7, 9) or the matrix parameters
    (12)."""
    lib = load()
    p = _f32(p, ndof)
    m = np.zeros(12, np.float32)
    jac = np.zeros((12, ndof), np.float32)
    if lib.mil_reg_stage_matrix(_ptr(p), int(ndof), _ptr(m), _ptr(jac)):
        raise ValueError(f"unsupported ndof {ndof}")
    return m, jac


def stage_pullback(p, ndof, gm):
    """(the 12-vector matrix, the pullback of the matrix gradient ``gm``)
    of a stage's parameters, as the ladder's L-BFGS stages take them."""
    lib = load()
    p, gm = _f32(p, ndof), _f32(gm, 12)
    m = np.zeros(12, np.float32)
    gp = np.zeros(ndof, np.float32)
    if lib.mil_reg_stage_pullback(_ptr(p), int(ndof), _ptr(gm), _ptr(m), _ptr(gp)):
        raise ValueError(f"unsupported ndof {ndof}")
    return m, gp


def stages(args):
    """The ladder's stages as (body, ndof, slot, max_sweeps, ftol x 1e6,
    line) tuples (``reg_opt.cuh::ladder_stages``; body 0 = Powell over K5's
    sums, 1 = L-BFGS over K4's, 2 = Powell with the probe line search over
    K6's; line 1 = the single line stage)."""
    lib = load()
    out = (ctypes.c_int * 30)()
    n = lib.mil_reg_stages(ctypes.byref(args), out)
    return [tuple(out[6 * i:6 * i + 6]) for i in range(n)]


def ladder(args, sums, probes=None):
    """The whole ladder of ``args`` (a :class:`LadderArgs`; engine 2: the
    line stage) with ``sums``: (12,) float32 matrix, grad flag -> float64
    sums (2 or 26 values, K5's or K4's packed result), and ``probes``: (n,
    12) float32 matrices -> (n, 2) float64 sums (K6's; None: ``sums`` of
    each). Returns the final :class:`LadderState`."""
    lib = load()
    state = LadderState()
    failure = []
    if probes is None:
        def probes(ms):
            return np.stack([np.asarray(sums(m, False), np.float64)[:2] for m in ms])

    def cb(m, grad, out, _ctx):
        try:
            v = np.asarray(sums(np.ctypeslib.as_array(m, (12,)).copy(), bool(grad)),
                           np.float64).reshape(-1)
            np.ctypeslib.as_array(out, (26,))[:v.size] = v
            return 0
        except Exception as e:   # raised below, after the ladder stops
            failure.append(e)
            return 100

    def cb_probes(ms, n, out, _ctx):
        try:
            v = np.asarray(probes(np.ctypeslib.as_array(ms, (n, 12)).copy()),
                           np.float64).reshape(-1)
            if v.size != 2 * n:
                raise ValueError(f"{n} probes gave {v.size} sums")
            np.ctypeslib.as_array(out, (2 * n,))[:] = v
            return 0
        except Exception as e:
            failure.append(e)
            return 100

    lib.mil_reg_ladder(ctypes.byref(args), SUMS_FN(cb), PROBES_FN(cb_probes), None,
                       ctypes.byref(state))
    if failure:
        raise failure[0]
    if state.error:
        raise RuntimeError(f"ladder error {state.error}")
    return state


if __name__ == "__main__":
    print(build())
