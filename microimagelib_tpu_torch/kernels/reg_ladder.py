"""K9: the registration ladder's optimizer stages on the card — wrapper
and counters.

:func:`reg_ladder` runs the affMethod 1-7 ladder of the ``grad`` engine
(L-BFGS stages over K4's sums, then the optional Powell finisher over K5's)
or of the ``device`` engine (Powell stages over K5's) on a pair of
mean-subtracted (z, y, x) float32 volumes and returns (aff 12-vector, fret,
stage costs (4,), evaluations), the contract of
``models/registration_grad.py::reg_ladder_grad`` and
``models/registration_device.py::reg_ladder_device``. With ``batch_ls``
its Powell stages (the grad engine's finisher alone) take the 8-probe line
search over K6's sums, as ``MIL_REG_BATCH_LS=1`` asks. :func:`reg_line`
runs the hybrid engine's one line minimization (mnbrak + brent over K5's
sums) and returns (p', xi', f', evaluations), the contract of
``models/registration_device.py::linmin_reg_device``.

A CUDA pair runs the hand-written kernel ``csrc/reg_ladder.cu`` (which
replaces the JAX package's jitted ladders,
``microimagelib_tpu/models/registration_grad.py:111`` and
``microimagelib_tpu/models/registration_device.py:126`` and the jitted
line minimization ``:243``): one cooperative launch per optimizer stage
(or per line) on the caller's stream, every evaluation inside it, and one
sync at the end; a failed build or launch raises. The plain version is the
host loop (``ops/lbfgs.py``, ``ops/powell_device.py`` and the ladder
bodies, one K4/K5/K6 call and one sync per evaluation or batch of probes):
``models/registration_grad.py::reg_ladder_grad_host``,
``models/registration_device.py::reg_ladder_device_host`` and the host
``_linmin``, which the models run for a CPU pair. The optimizers' source,
``csrc/reg_opt.cuh``, also builds for the host (``native/reg_opt.py``),
where the CPU tests hold it against the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.utils.trace import spanned

__all__ = ["reg_ladder", "reg_line", "launch", "ladder_args", "line_args", "kernel_attrs",
           "LadderArgs", "LadderState", "K9_LAUNCHES", "K9_EVALS_K4", "K9_EVALS_K5",
           "K9_EVALS_K6", "K9_LINES", "ENGINES", "BODIES", "LINE_MODES", "TRACE_WORDS",
           "STAMP_AT", "STAMPS", "MATS_AT", "INSTANTIATIONS", "stage_count", "trace_split",
           "split_medians", "trace_matrices", "record_ladders", "args_of"]

# stage launches of K9 (one per optimizer stage or line), and the
# evaluations those launches made on K4's body (L-BFGS stages), on K5's
# (Powell stages and lines) and on K6's (the probe stages: each a pass over
# up to 8 matrices); the line launches among K9_LAUNCHES
K9_LAUNCHES = 0
K9_EVALS_K4 = 0
K9_EVALS_K5 = 0
K9_EVALS_K6 = 0
K9_LINES = 0
ENGINES = {"grad": 0, "device": 1, "line": 2}
# a stage's body (reg_opt.cuh kBodyK5, kBodyK4, kBodyK6)
BODIES = {"K5": 0, "K4": 1, "K6": 2}
# linmin_reg_device's modes and their parameters
LINE_MODES = {"dof3": 3, "dof6": 6, "dof7": 7, "dof9": 9, "p12": 12}
# doubles a trace record: kind (the body: 0 K5, 1 K4, 2 K6), the matrix
# (12), the sums (26: K5's 2, K4's 26, K6's ss, st of each matrix), the
# matrices of the pass (1; K6: up to 8), K6's matrices 1.. from word
# MATS_AT, then the %globaltimer stamps (ns, int64 bits in the float64
# slots) named in STAMPS, from word STAMP_AT
STAMPS = ("publish", "start", "arrive", "row0", "seen", "summed", "next")
MATS_AT = 40
STAMP_AT = MATS_AT + 12 * (C.MAX_PROBES - 1)
TRACE_WORDS = STAMP_AT + len(STAMPS)
# the stage kernels (body, vx, wide), in the order of csrc/reg_ladder.cu's
# MIL_K9_STAGE_KINDS: one a (BODY, VX, IDX) of K4/K5's plan (K6 on K5's)
INSTANTIATIONS = tuple((body, vx, wide) for body in (1, 0, 2) for wide in (0, 1)
                       for vx in (4, 2, 1))
# LadderState.error codes
ERRORS = {1: "unknown method, engine or line", 2: "a block's wait ran past its bound",
          3: "an evaluation of the wrong kind"}

_lib = None
_work = {}


class LadderArgs(ctypes.Structure):
    """csrc/reg_opt.cuh::LadderArgs."""
    _fields_ = [("p_init", ctypes.c_float * 12), ("xi", ctypes.c_float * 12),
                ("ftol", ctypes.c_float), ("s_lin", ctypes.c_float),
                ("sd_t", ctypes.c_double), ("aff_method", ctypes.c_int),
                ("engine", ctypes.c_int), ("finish", ctypes.c_int),
                ("finish_sweeps", ctypes.c_int), ("it_limit", ctypes.c_int),
                ("ls_max_iters", ctypes.c_int), ("ls_patience", ctypes.c_int),
                ("batch_ls", ctypes.c_int), ("line_ndof", ctypes.c_int),
                ("pad", ctypes.c_int)]


class LadderState(ctypes.Structure):
    """csrc/reg_opt.cuh::LadderState."""
    _fields_ = [("p", ctypes.c_float * 12), ("aff", ctypes.c_float * 12),
                ("xi", ctypes.c_float * 12), ("stage_costs", ctypes.c_float * 4),
                ("fret", ctypes.c_float), ("ndof", ctypes.c_int), ("nev", ctypes.c_int),
                ("stage", ctypes.c_int), ("evals", ctypes.c_int * 3), ("error", ctypes.c_int)]


def ladder_args(engine, aff_method, p_init12, ftol, it_limit, sd_t, shape, finish=True,
                finish_sweeps=None, ls_max_iters=None, ls_patience=None, batch_ls=False):
    """The :class:`LadderArgs` of a ladder: ``engine`` 'grad' or 'device';
    ``finish_sweeps`` None (or <= 0) runs the finisher to Powell's ftol;
    ``ls_max_iters``/``ls_patience`` None read the MIL_LBFGS_* knobs
    (``ops/lbfgs.py::lbfgs_env``); ``batch_ls``: the Powell stages' line
    searches take 8 probes a pass over K6's sums. ``shape`` gives the
    preconditioning of linear entries, 2 / (mean extent), as the host loop
    takes it."""
    from microimagelib_tpu_torch.ops.lbfgs import lbfgs_env

    if engine not in ENGINES or engine == "line":
        raise ValueError(f"unknown ladder engine {engine!r}")
    env_mi, env_pa = lbfgs_env()
    a = LadderArgs()
    a.p_init[:] = [float(v) for v in np.asarray(p_init12, np.float32).reshape(12)]
    a.ftol = float(np.float32(ftol))
    a.s_lin = float(np.float32(2.0 / (float(sum(shape)) / 3.0)))
    a.sd_t = float(sd_t)
    a.aff_method = int(aff_method)
    a.engine = ENGINES[engine]
    a.finish = int(bool(finish))
    a.finish_sweeps = 0 if finish_sweeps is None else max(0, int(finish_sweeps))
    a.it_limit = int(it_limit)
    a.ls_max_iters = env_mi if ls_max_iters is None else int(ls_max_iters)
    a.ls_patience = env_pa if ls_patience is None else int(ls_patience)
    a.batch_ls = int(bool(batch_ls))
    return a


def line_args(p, xi, mode, sd_t):
    """The :class:`LadderArgs` of the line stage: one line minimization of
    the cost of ``mode`` ('dof3', 'dof6', 'dof7', 'dof9' or 'p12') along
    ``xi`` from ``p`` (float32, the mode's parameters)."""
    if mode not in LINE_MODES:
        raise ValueError(f"unknown cost mode {mode!r}")
    n = LINE_MODES[mode]
    p = np.asarray(p, np.float32).reshape(-1)
    xi = np.asarray(xi, np.float32).reshape(-1)
    if p.size != n or xi.size != n:
        raise ValueError(f"mode {mode} takes {n} parameters, got p {p.size}, xi {xi.size}")
    a = LadderArgs()
    a.p_init[:n] = [float(v) for v in p]
    a.xi[:n] = [float(v) for v in xi]
    a.sd_t = float(sd_t)
    a.engine = ENGINES["line"]
    a.line_ndof = n
    return a


def _library():
    global _lib
    if _lib is None:
        lib = build.load_library()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mil_reg_ladder.argtypes = [p, p, i, i, i, p, p, ll, p, i, p, p]
        lib.mil_reg_ladder.restype = i
        lib.mil_reg_ladder_work.argtypes = [i, i, i, p]
        lib.mil_reg_ladder_work.restype = i
        lib.mil_reg_ladder_sizes.argtypes = [p]
        lib.mil_reg_ladder_sizes.restype = i
        lib.mil_reg_ladder_attrs.argtypes = [i] * 3 + [p]
        lib.mil_reg_ladder_attrs.restype = i
        lib.mil_reg_ladder_kinds.argtypes = [p]
        lib.mil_reg_ladder_kinds.restype = i
        sizes = (ctypes.c_int * 6)()
        lib.mil_reg_ladder_sizes(sizes)
        kinds = (ctypes.c_int * (3 * max(1, sizes[4])))()
        lib.mil_reg_ladder_kinds(kinds)
        got = (tuple(sizes), tuple(tuple(kinds[3 * k:3 * k + 3]) for k in range(sizes[4])))
        want = ((ctypes.sizeof(LadderArgs), ctypes.sizeof(LadderState), TRACE_WORDS, STAMP_AT,
                 len(INSTANTIATIONS), MATS_AT), INSTANTIATIONS)
        if got != want:
            raise RuntimeError(f"csrc/reg_ladder.cu's layouts {got} differ from "
                               f"kernels/reg_ladder.py's {want}")
        _lib = lib
    return _lib


def kernel_attrs(body, vx, wide=0, device=None):
    """What a stage kernel compiled to on the current (or the given) CUDA
    device: ``body`` 1 (or True) for the L-BFGS stage (K4's body and launch
    bounds), 0 (False) for the Powell stage and the line (K5's), 2 for the
    probe stage (K6's body, K5's bounds); ``vx`` and ``wide`` as
    ``kernels/corr.py::launch_plan`` gives them. A dict of registers and
    spilled (local) bytes a thread, static shared bytes and resident blocks
    per SM."""
    lib = _library()
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.mil_reg_ladder_attrs(int(body), int(vx), int(wide), vals)
    build.check(lib, err, "reg_ladder kernel attributes")
    return dict(zip(("registers", "spill_bytes", "static_smem", "blocks_per_sm"), vals))


def _on(device):
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _workspace(lib, device, stream, shape):
    """(workspace, the state's offset): doubles on the device, kept per
    (device, stream) and grown to what a ladder on ``shape`` needs."""
    out = (ctypes.c_longlong * 2)()
    with _on(device):
        err = lib.mil_reg_ladder_work(*shape, out)
    build.check(lib, err, "reg_ladder workspace")
    key = (device.index, stream)
    w = _work.get(key)
    if w is None or w.numel() < out[0]:
        w = _work[key] = torch.zeros(int(out[0]), dtype=torch.float64, device=device)
    return w, int(out[1])


@spanned("mil.reg.ladder")
def launch(src, tgt, args, trace_cap=0):
    """K9 on a CUDA pair: one cooperative launch per stage of ``args`` (a
    :class:`LadderArgs`), then one sync. Returns the final
    :class:`LadderState` and, with ``trace_cap`` > 0, the (n, TRACE_WORDS)
    float64 trace of the first n <= trace_cap evaluations (the test hook:
    kind, matrices and sums of each, and the stamps :func:`trace_split`
    reads). Raises on a refused launch or an error
    the kernel reports."""
    global K9_LAUNCHES, K9_EVALS_K4, K9_EVALS_K5, K9_EVALS_K6, K9_LINES
    C._check(src, tgt)
    if not src.is_cuda:
        raise ValueError(f"K9 runs on CUDA tensors, not {src.device}")
    lib = _library()
    dev = src.device
    shape = tuple(int(n) for n in src.shape)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work, state_at = _workspace(lib, dev, stream, shape)
    trace = (torch.zeros((int(trace_cap), TRACE_WORDS), dtype=torch.float64, device=dev)
             if trace_cap > 0 else None)
    n_launched = ctypes.c_int(0)
    with _on(dev):
        err = lib.mil_reg_ladder(src.data_ptr(), tgt.data_ptr(), *shape, ctypes.byref(args),
                                 work.data_ptr(), work.numel(),
                                 trace.data_ptr() if trace is not None else None,
                                 int(trace_cap), stream, ctypes.byref(n_launched))
    K9_LAUNCHES += n_launched.value
    if args.engine == ENGINES["line"]:
        K9_LINES += n_launched.value
    build.check(lib, err, "reg_ladder kernel launch")
    raw = work[state_at:state_at + -(-ctypes.sizeof(LadderState) // 8)].cpu()
    state = LadderState.from_buffer_copy(raw.numpy().tobytes()[:ctypes.sizeof(LadderState)])
    K9_EVALS_K5 += state.evals[0]
    K9_EVALS_K4 += state.evals[1]
    K9_EVALS_K6 += state.evals[2]
    if state.error:
        raise RuntimeError(f"reg_ladder kernel: error {state.error} "
                           f"({ERRORS.get(state.error, 'unknown')})")
    if trace is None:
        return state, None
    n = min(int(trace_cap), sum(state.evals))
    return state, trace[:n].cpu().numpy()


def trace_matrices(record):
    """The (n, 12) float32 matrices of one trace record's pass (n = 1 for
    K4's and K5's body, up to 8 for K6's) and its (n, 2) or (26,) float64
    sums."""
    n = max(1, int(record[39]))
    mats = np.concatenate([record[1:13], record[MATS_AT:MATS_AT + 12 * (n - 1)]])
    sums = record[13:13 + 2 * n] if int(record[0]) == BODIES["K6"] else \
        record[13:13 + (26 if int(record[0]) == BODIES["K4"] else 2)]
    return mats.reshape(n, 12).astype(np.float32), sums


def trace_split(trace):
    """Each traced evaluation's time, part by part, in microseconds, from
    the stamps of a ``launch(..., trace_cap=n)`` trace: ``rows`` (publish to
    the last row done, block 0's or another block's), ``handover`` (then
    until block 0 sees the count), ``colsum`` (the column sum), ``step``
    (then until the next publish: the optimizer's step), ``evaluation``
    (publish to next publish, their sum); inside ``rows``, ``release``
    (publish to the latest start among the other blocks; 0 on a one-block
    grid), ``rows_others`` (publish to their last arrival) and
    ``rows_block0`` (publish to block 0's row done). A dict of float64
    arrays."""
    t = np.ascontiguousarray(trace[:, STAMP_AT:STAMP_AT + len(STAMPS)]).view(np.int64)
    p, s, a, r0, w, c, n = (t[:, k] for k in range(len(STAMPS)))
    done = np.maximum(a, r0)

    def us(d):
        return d.astype(np.float64) / 1e3

    return {"rows": us(done - p), "handover": us(w - done), "colsum": us(c - w),
            "step": us(n - c), "evaluation": us(n - p), "release": us(np.where(s > 0, s - p, 0)),
            "rows_others": us(np.where(a > 0, a - p, 0)), "rows_block0": us(r0 - p)}


def split_medians(trace, kind=None):
    """The medians of :func:`trace_split` over the trace's evaluations (or
    those of ``kind``: 1 for K4's body, 0 for K5's, 2 for K6's), and their
    count under ``n``."""
    if kind is not None:
        trace = trace[trace[:, 0] == kind]
    out = {k: float(np.median(v)) if len(v) else float("nan")
           for k, v in trace_split(trace).items()}
    out["n"] = int(len(trace))
    return out


@contextlib.contextmanager
def record_ladders():
    """While entered, record the arguments of every ladder :func:`reg_ladder`
    runs (the models call it through this module): a list of dicts of its
    bound arguments, one a call, for :func:`args_of` and :func:`launch`."""
    calls, orig = [], globals()["reg_ladder"]
    sig = inspect.signature(orig)

    def recorded(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        calls.append(dict(bound.arguments))
        return orig(*args, **kw)

    globals()["reg_ladder"] = recorded
    try:
        yield calls
    finally:
        globals()["reg_ladder"] = orig


def args_of(call, **change):
    """The :class:`LadderArgs` of a call :func:`record_ladders` recorded
    (with the arguments in ``change`` replaced, e.g. ``engine``,
    ``batch_ls``)."""
    c = {**call, **change}
    return ladder_args(c["engine"], c["aff_method"], c["p_init12"], c["ftol"], c["it_limit"],
                       c["sd_t"], tuple(c["src"].shape), c["finish"], c["finish_sweeps"],
                       c["ls_max_iters"], c["ls_patience"], c["batch_ls"])


def _result(state):
    return (np.array(state.aff, np.float32), np.float32(state.fret),
            np.array(state.stage_costs, np.float32), int(state.nev))


def reg_ladder(src, tgt, sd_t, p_init12, aff_method, ftol, it_limit, engine="grad",
               finish=True, finish_sweeps=None, ls_max_iters=None, ls_patience=None,
               batch_ls=False):
    """The ladder in K9 on a CUDA pair. Returns (aff float32 12-vector,
    fret, stage costs (4,), evaluations). A CPU pair raises: its ladder is
    the host loop, which ``models/registration_grad.py::reg_ladder_grad``
    and ``models/registration_device.py::reg_ladder_device`` run."""
    C._check(src, tgt)
    if aff_method not in (1, 2, 3, 4, 5, 6, 7):
        raise ValueError("Wrong affine registration method")
    args = ladder_args(engine, aff_method, p_init12, ftol, it_limit, sd_t, src.shape,
                       finish, finish_sweeps, ls_max_iters, ls_patience, batch_ls)
    return _result(launch(src, tgt, args)[0])


def reg_line(src, tgt, sd_t, p, xi, mode):
    """One line minimization in K9 on a CUDA pair (one launch, one sync):
    mnbrak + brent of the registration cost of ``mode`` along ``xi`` from
    ``p``. Returns (p' float32, xi scaled by the step, f', evaluations), as
    the host loop's ``ops/powell_device.py::_linmin``. A CPU pair raises:
    its line is that host loop."""
    C._check(src, tgt)
    args = line_args(p, xi, mode, sd_t)
    state = launch(src, tgt, args)[0]
    n = args.line_ndof
    return (np.array(state.p[:n], np.float32), np.array(state.xi[:n], np.float32),
            np.float32(state.fret), int(state.nev))


def stage_count(args):
    """Stages (launches) of a ladder or a line: the host mirror of
    ``reg_opt.cuh::ladder_stages``."""
    if args.engine == ENGINES["line"]:
        return 1
    per = {1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 6: 2, 7: 4}[args.aff_method]
    return per + int(args.engine == 0 and bool(args.finish))

