"""Spans and counters inside the port, on the profiler's clock.

``span(name, nbytes=0)`` marks a layer boundary of the main path, in a
``with`` statement; :func:`spanned` is its decorator form. While no
``torch.profiler`` session runs, ``span`` returns :data:`OFF`, one shared
no-op object: one attribute read, no allocation. While one runs, it opens
``torch.profiler.record_function(name)`` (a host range on the profiler's
own clock, the clock of the device trace) and, once CUDA is initialised,
records a timing event on the current stream at entry and at exit, with
no synchronisation.

Spans are kept in memory as per-name totals: calls, host seconds, device
seconds (between each span's two events, read once the device has passed
them), the bytes named at the span, and how often each enclosing span
held it (``within``). Spans nest as the host ranges do; each thread keeps
its own stack, so the batch's reader and writer threads stay apart.
:func:`snapshot` resolves the event pairs still pending (it waits for the
device) and returns the totals beside every counter of the package
(:data:`COUNTERS`), by qualified name. :func:`reset` clears the totals.

Every span name starts with ``mil.`` and is listed in :data:`SPANS`.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

__all__ = ["SPANS", "COUNTERS", "OFF", "span", "spanned", "to_host", "snapshot",
           "counters", "reset"]

SPANS = {
    "mil.fusion": "fusion_dualview: one timepoint, from the raw views to the host copies",
    "mil.fusion.preprocess": "fusion_dualview: view A resampled, view B turned and resampled",
    "mil.fusion.reg": "fusion_dualview: reg3d, with the plain-affine retry checkmatrix asks for",
    "mil.fusion.decon": "fusion_dualview: decon_dualview, its host copy included",
    "mil.decon": "decon_singleview, decon_dualview: one call",
    "mil.rl.loop": "_rl_loop: the RL iterations of one call",
    "mil.rl.iter": "_rl_loop: one RL iteration (one call of its step)",
    "mil.to_host": "to_host: a result's copy to host numpy (into a pinned block on CUDA), "
                   "the allocation and the wait included; bytes: the result's",
    "mil.reg": "reg3d: one call",
    "mil.reg.pool": "reg3d_affine_pyramid: the pair mean-pooled for one level",
    "mil.reg.level": "reg3d_affine_pyramid: one level's reg3d_affine",
    "mil.reg.final_transform": "_final_transform: the source resampled by the found matrix",
    "mil.reg.ladder": "kernels/reg_ladder.py::launch: K9's stage launches, the sync, the state back",
    "mil.mem_query": "free_memory_mb, hbm_budget_bytes: one free-memory query of the device",
}

_PKG = "microimagelib_tpu_torch."
COUNTERS = tuple((_PKG + m, a) for m, a in (
    ("kernels.conv_sep", "LAUNCHES"),
    ("kernels.corr", "K4_LAUNCHES"), ("kernels.corr", "K5_LAUNCHES"),
    ("kernels.corr", "K6_LAUNCHES"), ("kernels.corr", "PLAIN_CALLS"),
    ("kernels.fft_ct", "LAUNCHES"), ("kernels.fft_ct", "LAUNCHES_SPECIALISED"),
    ("kernels.mip_rot", "LAUNCHES"),
    ("kernels.pipe_copy", "LAUNCHES"),
    ("kernels.rl_fused", "LAUNCHES"),
    ("kernels.reg_ladder", "K9_LAUNCHES"), ("kernels.reg_ladder", "K9_EVALS_K4"),
    ("kernels.reg_ladder", "K9_EVALS_K5"), ("kernels.reg_ladder", "K9_EVALS_K6"),
    ("kernels.reg_ladder", "K9_LINES"),
    ("models.registration_grad", "HOST_LADDERS"),
    ("models.registration_device", "HOST_LADDERS"),
    ("models.registration_device", "HOST_LINES"),
    ("io.tiff", "COUNTS"),
    ("utils.trace", "TO_HOST_PINNED"), ("utils.trace", "TO_HOST_PLAIN"),
))

TO_HOST_PINNED = 0   # to_host: CUDA tensors copied into a pinned block
TO_HOST_PLAIN = 0    # to_host: CPU tensors

_lock = threading.Lock()
_local = threading.local()
_totals = {}
_pending = deque()   # (name, entry event, exit event), in the order the spans closed


class _Off:
    """The span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name, nbytes=0):
    """The span ``name`` (a key of :data:`SPANS`) for a ``with`` statement;
    ``nbytes``: the bytes the span moves. :data:`OFF` while no profiler
    runs."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, nbytes)


def spanned(name):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def to_host(t):
    """A result's copy to host numpy, inside a ``mil.to_host`` span that
    names its bytes.

    A CUDA tensor is copied into a block of pinned host memory from
    torch's caching host allocator (``torch.empty(..., pin_memory=True)``)
    on the current stream, which is then waited for: the copy runs at
    the link's pinned rate, and a block that a dropped result gave back
    is taken again without new pinning or page faults. The array returned
    is C-ordered, owns its block (no later call writes into it) and
    gives it back to the allocator when dropped; the allocator rounds a
    block up to a power of two of bytes, so each live result holds up to
    twice its bytes of pinned memory. A CPU tensor gives ``t.numpy()``,
    a view of the tensor's memory. Counters: :data:`TO_HOST_PINNED`,
    :data:`TO_HOST_PLAIN`."""
    global TO_HOST_PINNED, TO_HOST_PLAIN
    with span("mil.to_host", t.numel() * t.element_size()):
        if not t.is_cuda:
            TO_HOST_PLAIN += 1
            return t.numpy()
        dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dst.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        TO_HOST_PINNED += 1
        return dst.numpy()


def _timing_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _total(name):
    t = _totals.get(name)
    if t is None:
        t = _totals[name] = {"calls": 0, "host_s": 0.0, "device_s": 0.0, "bytes": 0,
                             "within": {}}
    return t


def _resolve(wait):
    """Adds the device seconds of the pending pairs the device has passed
    (all of them with ``wait``); call with the lock held."""
    while _pending:
        name, ev0, ev1 = _pending[0]
        if wait:
            ev1.synchronize()
        elif not ev1.query():
            return
        _totals[name]["device_s"] += ev0.elapsed_time(ev1) / 1e3
        _pending.popleft()


class _Span:
    __slots__ = ("name", "nbytes", "rf", "ev0", "t0", "parent")

    def __init__(self, name, nbytes):
        self.name = name
        self.nbytes = nbytes

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev0 = _timing_event() if torch.cuda.is_initialized() else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        ev1 = _timing_event() if self.ev0 is not None else None
        self.rf.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            t = _total(self.name)
            t["calls"] += 1
            t["host_s"] += t1 - self.t0
            t["bytes"] += self.nbytes
            if self.parent is not None:
                t["within"][self.parent] = t["within"].get(self.parent, 0) + 1
            if ev1 is not None:
                _pending.append((self.name, self.ev0, ev1))
            _resolve(wait=False)
        return False


def counters():
    """Every counter of :data:`COUNTERS` by qualified name
    (``module.ATTRIBUTE``; a dict counter's entries as
    ``module.ATTRIBUTE.key``)."""
    out = {}
    for module, attribute in COUNTERS:
        value = getattr(importlib.import_module(module), attribute)
        if isinstance(value, dict):
            out.update((f"{module}.{attribute}.{k}", v) for k, v in value.items())
        else:
            out[f"{module}.{attribute}"] = value
    return out


def snapshot():
    """{"spans": {name: {"calls", "host_s", "device_s", "bytes", "within"}},
    "counters": :func:`counters`}: a copy, after the device has passed
    every span closed so far."""
    with _lock:
        _resolve(wait=True)
        spans = {n: dict(t, within=dict(t["within"])) for n, t in _totals.items()}
    return {"spans": spans, "counters": counters()}


def reset():
    """Clears the span totals (the counters stay the modules')."""
    with _lock:
        _resolve(wait=True)
        _totals.clear()
