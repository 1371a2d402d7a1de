"""Spans the benchmark puts around calls into the program's layers, in the
traced run only: a module attribute (``module``, ``attribute``) is
replaced for the window by a wrapper that opens a
``torch.profiler.record_function`` range of the span's name, notes the
host clock, and on a CUDA device records an event on the current stream
before and after (no synchronisation). The program's files are not
edited: the program looks the attribute up when it calls it."""

from __future__ import annotations

import importlib
import time
from collections import defaultdict

import torch
from torch.profiler import record_function


class Spans:
    def __init__(self, cuda):
        self.cuda = cuda
        self.records = defaultdict(list)   # name -> [(t0, t1, ev0, ev1)]
        self._restore = []

    def open(self, name):
        """Context manager of one span."""
        return _Span(self, name)

    def wrap(self, module, attribute, name):
        mod = importlib.import_module(module)
        orig = getattr(mod, attribute)

        def wrapper(*args, **kwargs):
            with self.open(name):
                return orig(*args, **kwargs)

        setattr(mod, attribute, wrapper)
        self._restore.append((mod, attribute, orig))

    def unwrap(self):
        for mod, attribute, orig in reversed(self._restore):
            setattr(mod, attribute, orig)
        self._restore.clear()

    def host_s(self, name):
        return [t1 - t0 for t0, t1, _a, _b in self.records.get(name, ())]

    def device_s(self, name):
        """Seconds between each span's two events (after the device has
        passed them); empty off CUDA."""
        out = []
        for _t0, _t1, a, b in self.records.get(name, ()):
            if a is not None:
                b.synchronize()
                out.append(a.elapsed_time(b) / 1e3)
        return out


class _Span:
    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.ev0 = None
        if self.owner.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        ev1 = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        self.owner.records[self.name].append((self.t0, t1, self.ev0, ev1))
        self.rf.__exit__(*exc)
        return False
