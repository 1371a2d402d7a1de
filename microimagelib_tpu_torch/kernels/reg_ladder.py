"""K9: the registration ladder's optimizer stages on the card — wrapper
and counters.

:func:`reg_ladder` runs the affMethod 1-7 ladder of the ``grad`` engine
(L-BFGS stages over K4's sums, then the optional Powell finisher over K5's)
or of the ``device`` engine (Powell stages over K5's) on a pair of
mean-subtracted (z, y, x) float32 volumes and returns (aff 12-vector, fret,
stage costs (4,), evaluations), the contract of
``models/registration_grad.py::reg_ladder_grad`` and
``models/registration_device.py::reg_ladder_device``.

A CUDA pair runs the hand-written kernel ``csrc/reg_ladder.cu`` (which
replaces the JAX package's jitted ladders,
``microimagelib_tpu/models/registration_grad.py:111`` and
``microimagelib_tpu/models/registration_device.py:126``): one cooperative
launch per optimizer stage on the caller's stream, every evaluation inside
it, and one sync at the end; a failed build or launch raises. The plain
version is the host loop (``ops/lbfgs.py``, ``ops/powell_device.py`` and
the ladder bodies, one K4/K5 call and one sync per evaluation):
``models/registration_grad.py::reg_ladder_grad_host`` and
``models/registration_device.py::reg_ladder_device_host``, which
``reg_ladder_grad`` / ``reg_ladder_device`` run for a CPU pair. The
optimizers' source,
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

__all__ = ["reg_ladder", "launch", "ladder_args", "kernel_attrs", "LadderArgs",
           "LadderState", "K9_LAUNCHES", "K9_EVALS_K4", "K9_EVALS_K5", "ENGINES",
           "TRACE_WORDS", "STAMP_AT", "STAMPS", "INSTANTIATIONS", "stage_count",
           "trace_split", "split_medians", "record_ladders", "args_of"]

# stage launches of K9 (one per optimizer stage), and the evaluations those
# launches made on K4's body (L-BFGS stages) and on K5's (Powell stages)
K9_LAUNCHES = 0
K9_EVALS_K4 = 0
K9_EVALS_K5 = 0
ENGINES = {"grad": 0, "device": 1}
# doubles a trace record: kind (1 = K4), the matrix (12), the sums (26), pad,
# then the %globaltimer stamps (ns, int64 bits in the float64 slots) named
# in STAMPS, from word STAMP_AT
STAMPS = ("publish", "start", "arrive", "row0", "seen", "summed", "next")
STAMP_AT = 40
TRACE_WORDS = STAMP_AT + len(STAMPS)
# the stage kernels (grad, vx, wide), in the order of csrc/reg_ladder.cu's
# MIL_K9_STAGE_KINDS: one a (GRAD, VX, IDX) of K4/K5's plan
INSTANTIATIONS = tuple((grad, vx, wide) for grad in (1, 0) for wide in (0, 1)
                       for vx in (4, 2, 1))
# LadderState.error codes
ERRORS = {1: "unknown method or engine", 2: "a block's wait ran past its bound",
          3: "an evaluation of the wrong kind"}

_lib = None
_work = {}


class LadderArgs(ctypes.Structure):
    """csrc/reg_opt.cuh::LadderArgs."""
    _fields_ = [("p_init", ctypes.c_float * 12), ("ftol", ctypes.c_float),
                ("s_lin", ctypes.c_float), ("sd_t", ctypes.c_double),
                ("aff_method", ctypes.c_int), ("engine", ctypes.c_int),
                ("finish", ctypes.c_int), ("finish_sweeps", ctypes.c_int),
                ("it_limit", ctypes.c_int), ("ls_max_iters", ctypes.c_int),
                ("ls_patience", ctypes.c_int), ("pad", ctypes.c_int)]


class LadderState(ctypes.Structure):
    """csrc/reg_opt.cuh::LadderState."""
    _fields_ = [("p", ctypes.c_float * 12), ("aff", ctypes.c_float * 12),
                ("stage_costs", ctypes.c_float * 4), ("fret", ctypes.c_float),
                ("ndof", ctypes.c_int), ("nev", ctypes.c_int), ("stage", ctypes.c_int),
                ("evals", ctypes.c_int * 2), ("error", ctypes.c_int), ("pad", ctypes.c_int)]


def ladder_args(engine, aff_method, p_init12, ftol, it_limit, sd_t, shape, finish=True,
                finish_sweeps=None, ls_max_iters=None, ls_patience=None):
    """The :class:`LadderArgs` of a ladder: ``engine`` 'grad' or 'device';
    ``finish_sweeps`` None (or <= 0) runs the finisher to Powell's ftol;
    ``ls_max_iters``/``ls_patience`` None read the MIL_LBFGS_* knobs
    (``ops/lbfgs.py::lbfgs_env``). ``shape`` gives the preconditioning of
    linear entries, 2 / (mean extent), as the host loop takes it."""
    from microimagelib_tpu_torch.ops.lbfgs import lbfgs_env

    if engine not in ENGINES:
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
        sizes = (ctypes.c_int * 5)()
        lib.mil_reg_ladder_sizes(sizes)
        kinds = (ctypes.c_int * (3 * max(1, sizes[4])))()
        lib.mil_reg_ladder_kinds(kinds)
        got = (tuple(sizes), tuple(tuple(kinds[3 * k:3 * k + 3]) for k in range(sizes[4])))
        want = ((ctypes.sizeof(LadderArgs), ctypes.sizeof(LadderState), TRACE_WORDS, STAMP_AT,
                 len(INSTANTIATIONS)), INSTANTIATIONS)
        if got != want:
            raise RuntimeError(f"csrc/reg_ladder.cu's layouts {got} differ from "
                               f"kernels/reg_ladder.py's {want}")
        _lib = lib
    return _lib


def kernel_attrs(grad, vx, wide=0, device=None):
    """What a stage kernel compiled to on the current (or the given) CUDA
    device: ``grad`` True for the L-BFGS stage (K4's body and launch
    bounds), False for the Powell stage (K5's); ``vx`` and ``wide`` as
    ``kernels/corr.py::launch_plan`` gives them. A dict of registers and
    spilled (local) bytes a thread, static shared bytes and resident blocks
    per SM."""
    lib = _library()
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.mil_reg_ladder_attrs(int(bool(grad)), int(vx), int(wide), vals)
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


def launch(src, tgt, args, trace_cap=0):
    """K9 on a CUDA pair: one cooperative launch per stage of ``args`` (a
    :class:`LadderArgs`), then one sync. Returns the final
    :class:`LadderState` and, with ``trace_cap`` > 0, the (n, TRACE_WORDS)
    float64 trace of the first n <= trace_cap evaluations (the test hook:
    kind, matrix and sums of each, and the stamps :func:`trace_split`
    reads). Raises on a refused launch or an error
    the kernel reports."""
    global K9_LAUNCHES, K9_EVALS_K4, K9_EVALS_K5
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
    build.check(lib, err, "reg_ladder kernel launch")
    raw = work[state_at:state_at + -(-ctypes.sizeof(LadderState) // 8)].cpu()
    state = LadderState.from_buffer_copy(raw.numpy().tobytes()[:ctypes.sizeof(LadderState)])
    K9_EVALS_K5 += state.evals[0]
    K9_EVALS_K4 += state.evals[1]
    if state.error:
        raise RuntimeError(f"reg_ladder kernel: error {state.error} "
                           f"({ERRORS.get(state.error, 'unknown')})")
    if trace is None:
        return state, None
    n = min(int(trace_cap), state.evals[0] + state.evals[1])
    return state, trace[:n].cpu().numpy()


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
    those of ``kind``: 1 for K4's body, 0 for K5's), and their count under
    ``n``."""
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


def args_of(call):
    """The :class:`LadderArgs` of a call :func:`record_ladders` recorded."""
    return ladder_args(call["engine"], call["aff_method"], call["p_init12"], call["ftol"],
                       call["it_limit"], call["sd_t"], tuple(call["src"].shape), call["finish"],
                       call["finish_sweeps"], call["ls_max_iters"], call["ls_patience"])


def _result(state):
    return (np.array(state.aff, np.float32), np.float32(state.fret),
            np.array(state.stage_costs, np.float32), int(state.nev))


def reg_ladder(src, tgt, sd_t, p_init12, aff_method, ftol, it_limit, engine="grad",
               finish=True, finish_sweeps=None, ls_max_iters=None, ls_patience=None):
    """The ladder in K9 on a CUDA pair. Returns (aff float32 12-vector,
    fret, stage costs (4,), evaluations). A CPU pair raises: its ladder is
    the host loop, which ``models/registration_grad.py::reg_ladder_grad``
    and ``models/registration_device.py::reg_ladder_device`` run."""
    C._check(src, tgt)
    if aff_method not in (1, 2, 3, 4, 5, 6, 7):
        raise ValueError("Wrong affine registration method")
    args = ladder_args(engine, aff_method, p_init12, ftol, it_limit, sd_t, src.shape,
                       finish, finish_sweeps, ls_max_iters, ls_patience)
    return _result(launch(src, tgt, args)[0])


def stage_count(args):
    """Stages (launches) of a ladder: the host mirror of
    ``reg_opt.cuh::ladder_stages``."""
    per = {1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 6: 2, 7: 4}[args.aff_method]
    return per + int(args.engine == 0 and bool(args.finish))

