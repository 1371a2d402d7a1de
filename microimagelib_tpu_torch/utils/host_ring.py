"""Reused host buffers for the batch's transfers, and the copy stream they
go through: the port's counterpart of the JAX package's
``copy_to_host_async`` fetch of a timepoint's outputs and of its
asynchronous ``jnp.asarray`` upload of the raw views.

A :class:`HostRing` keeps at most ``n_slots`` slots per shape set (the
names, shapes and dtypes of one timepoint's arrays). A slot is one host
tensor per name, allocated once and reused: pinned for a CUDA device,
plain for the CPU. On CUDA every copy into or out of a slot runs on the
ring's own stream and ends with an event (:class:`Transfer`); the
compute stream never waits on it unless it needs the data. On the CPU
the copies are plain and done when the call returns.

A slot is held by whoever acquired it and by every job that still reads
it (:meth:`HostSlot.hold`); it returns to the ring when the last of them
releases it, whether or not that job failed. :meth:`HostRing.acquire`
blocks while every slot of a shape set is held, so the host memory is
bounded by ``n_slots`` times one timepoint's arrays.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

__all__ = ["HostRing", "HostSlot", "Transfer", "fill"]


class Transfer:
    """One copy into or out of a slot: on CUDA its start and end events on
    the ring's stream (the start only when the ring times its copies),
    on the CPU the seconds it took."""

    def __init__(self, end=None, start=None, seconds=0.0):
        self.end, self.start, self._seconds = end, start, seconds

    def wait(self):
        """Block the calling thread until the copy is done."""
        if self.end is not None:
            self.end.synchronize()

    def seconds(self):
        """The copy's own seconds: device time between its events on CUDA
        (it waits for the copy first), host time on the CPU."""
        if self.end is None:
            return self._seconds
        if self.start is None:
            raise ValueError("the ring does not time its copies (timed=False)")
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


class HostSlot:
    """The host tensors of one timepoint's arrays (``host``, by name)."""

    def __init__(self, ring, key, host):
        # a weak reference: the ring holds its slots, and without a cycle
        # the pinned memory goes back to torch's host allocator as soon as
        # the ring is dropped, for the next ring of the process to reuse
        self._ring = weakref.ref(ring)
        self.key, self.host = key, host
        self.transfer = Transfer()   # the last copy into or out of it
        self.holds = 0

    @property
    def nbytes(self):
        return sum(v.numel() * v.element_size() for v in self.host.values())

    def arrays(self):
        """Numpy views of the host tensors, by name."""
        return {k: v.numpy() for k, v in self.host.items()}

    def hold(self):
        """One more reader of the slot; each hold needs one :meth:`release`."""
        with self._ring()._cond:
            if self.holds < 1:
                raise RuntimeError("hold() on a slot that is back in its ring")
            self.holds += 1

    def release(self):
        """Drop one hold; the last returns the slot to its ring."""
        self._ring()._release(self)


class HostRing:
    """At most ``n_slots`` (>= 2) reused host slots per shape set for
    copies to and from ``device``; ``timed`` records start events, so that
    :meth:`Transfer.seconds` gives each copy's device time."""

    def __init__(self, device, n_slots, timed=False):
        if n_slots < 2:
            raise ValueError(f"a host ring needs at least 2 slots, got {n_slots}")
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.timed = timed
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._cond = threading.Condition()
        self._slots = {}   # shape-set key -> every slot allocated for it
        self._free = {}    # shape-set key -> the slots back in the ring

    def slots_allocated(self):
        """The number of slots allocated per shape-set key."""
        with self._cond:
            return {k: len(v) for k, v in self._slots.items()}

    def slots_free(self):
        """The number of slots back in the ring per shape-set key."""
        with self._cond:
            return {k: len(v) for k, v in self._free.items()}

    @property
    def bytes_held(self):
        """Host bytes of every slot allocated so far (pinned on CUDA)."""
        with self._cond:
            return sum(s.nbytes for slots in self._slots.values() for s in slots)

    def acquire(self, specs):
        """A slot for ``specs`` ({name: (shape, torch dtype)}), held once by
        the caller. Reuses a slot back in the ring, else allocates one while
        fewer than ``n_slots`` exist, else blocks until one is released.
        The slot's last copy is done when it is returned."""
        key = tuple((name, tuple(int(n) for n in shape), dtype)
                    for name, (shape, dtype) in specs.items())
        with self._cond:
            while True:
                free = self._free.setdefault(key, [])
                slots = self._slots.setdefault(key, [])
                if free:
                    slot = free.pop()
                    break
                if len(slots) < self.n_slots:
                    slot = HostSlot(self, key, {
                        name: torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                        for name, shape, dtype in key})
                    slots.append(slot)
                    break
                self._cond.wait()
            slot.holds = 1
        slot.transfer.wait()   # an upload slot is released before its copy ends
        return slot

    def _release(self, slot):
        with self._cond:
            if slot.holds < 1:
                raise RuntimeError("release() of a slot that is back in its ring")
            slot.holds -= 1
            if slot.holds == 0:
                self._free[slot.key].append(slot)
                self._cond.notify_all()

    def _events(self):
        end = torch.cuda.Event(enable_timing=self.timed)
        start = torch.cuda.Event(enable_timing=True) if self.timed else None
        return end, start

    def fetch(self, slot, outs):
        """Start copying the device tensors ``outs`` ({name: tensor}, the
        slot's names and shapes) into ``slot``, after the work queued so
        far on the current stream; returns the :class:`Transfer`, also kept
        as ``slot.transfer``. The sources are marked as used by the copy
        stream, so the caching allocator does not hand their memory to a
        new tensor before the copy has read it."""
        if not self.cuda:
            t = time.perf_counter()
            for name, v in outs.items():
                slot.host[name].copy_(v)
            slot.transfer = Transfer(seconds=time.perf_counter() - t)
            return slot.transfer
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        end, start = self._events()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            if start is not None:
                start.record(self.stream)
            for name, v in outs.items():
                slot.host[name].copy_(v, non_blocking=True)
                v.record_stream(self.stream)
            end.record(self.stream)
        slot.transfer = Transfer(end, start)
        return slot.transfer

    def upload(self, slot):
        """Copy ``slot``'s tensors to new tensors on the device and release
        the caller's hold on the slot (its next :meth:`acquire` waits for
        this copy). The current stream waits for the copy before its next
        work. Returns ({name: device tensor}, the :class:`Transfer`)."""
        if not self.cuda:
            t = time.perf_counter()
            outs = {name: v.clone() for name, v in slot.host.items()}
            slot.transfer = Transfer(seconds=time.perf_counter() - t)
            slot.release()
            return outs, slot.transfer
        compute = torch.cuda.current_stream(self.device)
        end, start = self._events()
        with torch.cuda.stream(self.stream):
            # allocated on the copy stream, so that no pending work of the
            # compute stream can still own this memory
            outs = {name: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                    for name, v in slot.host.items()}
            if start is not None:
                start.record(self.stream)
            for name, v in slot.host.items():
                outs[name].copy_(v, non_blocking=True)
            end.record(self.stream)
        compute.wait_event(end)
        for v in outs.values():
            v.record_stream(compute)
        slot.transfer = Transfer(end, start)
        slot.release()
        return outs, slot.transfer


def fill(slot, arrays):
    """Copy numpy ``arrays`` ({name: array}) into ``slot``'s host tensors."""
    for name, arr in arrays.items():
        np.copyto(slot.host[name].numpy(), arr)
