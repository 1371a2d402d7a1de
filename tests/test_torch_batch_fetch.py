"""The batch's transfers through reused host slots (``utils/host_ring.py``,
``models/batch.py``), at tests/test_torch_batch.py's small size: raw (8,
16, 16) views made anisotropic (2 um z steps), view B turned -90 degrees
about y and drifting in y per timepoint, 3 decon iterations.

The port is held against itself: a run whose TIFF writes are slowed (so
that every output slot is busy and the main thread waits for one) writes
the same files bit for bit and the same log lines (times masked) as a run
that is not. The rings are also held to their bounds, a failed write to
its slot's release, and on the card (tests marked ``cuda``) the copies to
their stream, their pinned memory and the caching allocator's reuse.
This file imports no JAX, so that its card tests run on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_batch_fetch.py -m cuda
"""

import os
import re
import threading
import weakref

import numpy as np
import pytest
import torch

from microimagelib_tpu_torch.io.tiff import readtifstack, writetifstack
from microimagelib_tpu_torch.io.tmx import read_tmx, write_tmx
from microimagelib_tpu_torch.models import batch as PB
from microimagelib_tpu_torch.ops.matrix import dof_to_matrix
from microimagelib_tpu_torch.utils.host_ring import HostRing, fill

torch.set_num_threads(1)

N_T = 5
WRITE_DELAY = 0.05   # seconds a slowed TIFF write sleeps first
TIMED = ("upload", "upload_copy", "slot_wait", "fetch", "fetch_copy", "write")
TIME = re.compile(r"([Tt]ime cost[^:]*: *|is )[-+]?\d+(\.\d+)?")


def _gaussian_psf(shape, sigma):
    zz, yy, xx = np.meshgrid(*[np.arange(s) - s // 2 for s in shape], indexing="ij")
    g = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blobs(shape, n, seed):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, dtype=np.float32)
    for _ in range(n):
        z, y, x = (rng.integers(s // 4, 3 * s // 4) for s in shape)
        vol[z, y, x] = rng.uniform(80, 200)
    zz, yy, xx = np.meshgrid(*[np.arange(s) - s // 2 for s in shape], indexing="ij")
    g = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 4.0)
    g = np.roll(g / g.sum(), [-s // 2 for s in shape], axis=(0, 1, 2))
    return np.fft.irfftn(np.fft.rfftn(vol) * np.fft.rfftn(g), s=shape,
                         axes=(0, 1, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """N_T timepoints of blob views, view B turned and rolled by t in y."""
    root = tmp_path_factory.mktemp("fetch_in")
    for view in ("SPIMA", "SPIMB"):
        os.makedirs(root / view)
    for t in range(N_T):
        vol = _blobs((8, 16, 16), 6, 30 + t)
        writetifstack(str(root / "SPIMA" / f"SPIMA_{t}.tif"), vol, 32)
        b = np.roll(np.transpose(vol, (2, 1, 0)), t, axis=1).copy()
        writetifstack(str(root / "SPIMB" / f"SPIMB_{t}.tif"), b, 32)
    writetifstack(str(root / "psf.tif"), _gaussian_psf((5, 5, 5), 1.0), 32)
    write_tmx(str(root / "init.tmx"),
              np.asarray(dof_to_matrix([1.0, -0.5, 0.4, 0.3, 0.0, 0.0, 1, 1, 1], 6),
                         np.float32))
    return root


def _cfg(root, out, **kw):
    base = dict(
        out_dir=str(out), in_dir1=str(root / "SPIMA"), in_dir2=str(root / "SPIMB"),
        name1="SPIMA_", name2="SPIMB_", img_start=0, img_end=2, img_interval=1,
        img_test=1, pixel1=(1.0, 1.0, 2.0), pixel2=(1.0, 1.0, 2.0), reg_mode=0,
        im_rotation=-1, flag_initial_tmx=1, tmx_file=str(root / "init.tmx"), ftol=1e-3,
        it_limit=200, save_reg_a=True, save_reg_b=True, psf1_file=str(root / "psf.tif"),
        psf2_file=str(root / "psf.tif"), it_num_decon=3, save_mp_z=True, save_mp_y=True,
        save_mp_x=True, save_3d_x=True, save_3d_y=True, bit_per_sample=32,
        query_device=False, device_num=0, verbose=False)
    base.update(kw)
    return PB.BatchConfig(**base)


class Rings:
    """Records every HostRing spim_fusion_batch makes (the upload ring
    first, then the output ring)."""

    def __init__(self, monkeypatch):
        self.made = []
        real = PB.HostRing

        def make(*args, **kw):
            ring = real(*args, **kw)
            self.made.append(ring)
            return ring

        monkeypatch.setattr(PB, "HostRing", make)

    def all_free(self):
        return all(ring.slots_free() == ring.slots_allocated() for ring in self.made)


def _slow_writes(monkeypatch, fail_on=None):
    """Slow every TIFF write by WRITE_DELAY; a write whose file name is
    ``fail_on`` raises OSError instead."""
    real = PB.writetifstack

    def slowed(path, arr, bits):
        threading.Event().wait(WRITE_DELAY)
        if os.path.basename(path) == fail_on:
            raise OSError(f"disk full: {path}")
        return real(path, arr, bits)

    monkeypatch.setattr(PB, "writetifstack", slowed)


def _files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs)


def _log(out):
    lines = (out / "ProcessingLog.txt").read_text().replace(str(out), "<out>")
    return [TIME.sub(r"\1#", ln) for ln in lines.splitlines()[1:]]


def _same_outputs(got, ref):
    """Every TIFF and .tmx file of ``got`` equals ``ref``'s bit for bit,
    and the log lines equal with their times masked."""
    assert _files(got) == _files(ref)
    for rel in _files(ref):
        if rel.endswith(".tif"):
            np.testing.assert_array_equal(readtifstack(str(got / rel))[0],
                                          readtifstack(str(ref / rel))[0], err_msg=rel)
        elif rel.endswith(".tmx"):
            np.testing.assert_array_equal(read_tmx(str(got / rel)), read_tmx(str(ref / rel)))
    assert _log(got) == _log(ref)


@pytest.mark.parametrize("kw", [dict(reg_mode=2, flag_initial_tmx=0),
                                dict(reg_mode=0, flag_initial_tmx=0)],
                         ids=["regmode2_chained", "regmode0_identity"])
def test_slowed_writer_writes_the_same_files(inputs, tmp_path, monkeypatch, kw):
    """Two output slots and writes slowed by WRITE_DELAY: the main thread
    waits for slots, and every file and log line is the unslowed run's."""
    monkeypatch.setenv("MIL_REG_FINISH_LEVEL", "mid")
    ref = tmp_path / "ref"
    assert PB.spim_fusion_batch(_cfg(inputs, ref, **kw), device="cpu") == [0, 1, 2]
    rings = Rings(monkeypatch)
    monkeypatch.setattr(PB, "OUTPUT_SLOTS", 2)
    _slow_writes(monkeypatch)
    got = tmp_path / "slowed"
    timings = {}
    assert PB.spim_fusion_batch(_cfg(inputs, got, **kw), device="cpu",
                                timings=timings) == [0, 1, 2]
    _same_outputs(got, ref)
    assert rings.all_free()
    for t in range(3):
        assert set(TIMED) <= set(timings[t]), timings[t]


def test_output_slots_bounded_over_five_timepoints(inputs, tmp_path, monkeypatch):
    """A chained 5-timepoint run (regMode 0, input matrix) with slowed
    writes allocates exactly OUTPUT_SLOTS slots for the outputs and at
    most UPLOAD_SLOTS for the views, and they hold that many timepoints'
    bytes; every slot is back in its ring at the end."""
    rings = Rings(monkeypatch)
    monkeypatch.setattr(PB, "OUTPUT_SLOTS", 2)
    _slow_writes(monkeypatch)
    out = tmp_path / "out"
    assert PB.spim_fusion_batch(_cfg(inputs, out, img_end=N_T - 1), device="cpu") \
        == list(range(N_T))
    in_ring, out_ring = rings.made
    assert list(out_ring.slots_allocated().values()) == [2]
    per_tp = sum(readtifstack(str(out / rel))[0].nbytes for rel in _files(out)
                 if rel.endswith("_0.tif"))
    assert out_ring.bytes_held == 2 * per_tp
    (n_in,) = in_ring.slots_allocated().values()
    assert 1 <= n_in <= PB.UPLOAD_SLOTS
    assert in_ring.bytes_held == n_in * 2 * 8 * 16 * 16 * 4
    assert rings.all_free()
    assert "...Time cost for current image" in (out / "ProcessingLog.txt").read_text()


@pytest.mark.parametrize("overlap_io", [True, False], ids=["writer_pool", "main_thread"])
def test_failed_write_raises_and_frees_its_slot(inputs, tmp_path, monkeypatch,
                                                overlap_io):
    """A write that raises makes spim_fusion_batch raise it (at the end
    with the writer pool, at once on the main thread, as before), and its
    slot still returns to the ring: with two slots the run does not hang
    (it is held to 120 s on a thread of its own)."""
    rings = Rings(monkeypatch)
    monkeypatch.setattr(PB, "OUTPUT_SLOTS", 2)
    _slow_writes(monkeypatch, fail_on="MP_XY_1.tif")
    raised = []

    def run():
        try:
            PB.spim_fusion_batch(_cfg(inputs, tmp_path / "out", img_end=N_T - 1,
                                      overlap_io=overlap_io), device="cpu")
        except OSError as e:
            raised.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "the batch hung on a slot the failed write held"
    assert len(raised) == 1 and "MP_XY_1.tif" in str(raised[0])
    last = tmp_path / "out" / "Decon" / "MP_ZProj" / f"MP_XY_{N_T - 1}.tif"
    if overlap_io:   # the writer pool went on with the later timepoints
        assert last.exists() and rings.all_free()
    else:            # the write raised on the main thread and ended the run,
        # leaving only the next timepoint's slot, fetched and not collected
        in_ring, out_ring = rings.made
        assert not last.exists() and in_ring.slots_free() == in_ring.slots_allocated()
        (n,), (free,) = out_ring.slots_allocated().values(), out_ring.slots_free().values()
        assert free == n - 1


def test_ring_blocks_while_every_slot_is_held():
    """A third acquire of a two-slot ring waits until a slot is released,
    then gets that slot back; holds count readers; shape sets are apart."""
    ring = HostRing("cpu", 2)
    spec = {"v": ((4, 5), torch.float32)}
    a, b = ring.acquire(spec), ring.acquire(spec)
    got = []
    th = threading.Thread(target=lambda: got.append(ring.acquire(spec)), daemon=True)
    th.start()
    th.join(timeout=0.3)
    assert th.is_alive() and not got
    other = ring.acquire({"v": ((4, 6), torch.float32)})   # another shape set
    a.hold()
    a.release()
    th.join(timeout=0.3)
    assert th.is_alive()                       # one hold left on a
    a.release()
    th.join(timeout=30)
    assert not th.is_alive() and got == [a]
    assert sorted(ring.slots_allocated().values()) == [1, 2]
    assert ring.bytes_held == 2 * 4 * 5 * 4 + 4 * 6 * 4
    for s in (b, got[0], other):
        s.release()
    with pytest.raises(RuntimeError):
        b.release()
    with pytest.raises(RuntimeError):
        b.hold()
    with pytest.raises(ValueError):
        HostRing("cpu", 1)


def test_ring_copies_on_the_cpu():
    """On the CPU a fetch copies at once into the slot and an upload hands
    back copies and frees the slot; the transfers' seconds are host time.
    A dropped ring is freed at once (no reference cycle holds its slots)."""
    ring = HostRing("cpu", 2, timed=True)
    src = {"x": torch.arange(12.0).reshape(3, 4), "y": torch.ones(5)}
    slot = ring.acquire({k: (v.shape, v.dtype) for k, v in src.items()})
    tr = ring.fetch(slot, src)
    assert tr is slot.transfer and tr.seconds() >= 0.0
    for k, v in slot.arrays().items():
        np.testing.assert_array_equal(v, src[k].numpy())
    fill(slot, {"x": np.full((3, 4), 7.0, np.float32), "y": np.zeros(5, np.float32)})
    outs, tr = ring.upload(slot)
    assert ring.slots_free() == ring.slots_allocated()
    slot.host["x"].zero_()                     # the upload is a copy
    np.testing.assert_array_equal(outs["x"].numpy(), np.full((3, 4), 7.0, np.float32))
    gone = weakref.ref(slot.host["x"])
    del ring, slot, tr
    assert gone() is None


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the copy streams and pinned memory)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_outputs_go_through_the_copy_stream(inputs, tmp_path, monkeypatch, cuda):
    """On the card every output reaches the host by a non-blocking copy
    into pinned memory on a stream other than the compute stream, the
    views go up the same way, and no output is fetched with .cpu()."""
    rings = Rings(monkeypatch)
    copies, cpu_shapes = [], []
    real_copy, real_cpu = torch.Tensor.copy_, torch.Tensor.cpu

    def copy_(dst, src, non_blocking=False):
        if dst.device.type != src.device.type:
            copies.append((dst.device.type, dst.is_pinned() or src.is_pinned(),
                           non_blocking, torch.cuda.current_stream(cuda),
                           tuple(src.shape)))
        return real_copy(dst, src, non_blocking)

    def cpu(t, *a, **kw):
        if t.is_cuda:
            cpu_shapes.append(tuple(t.shape))
        return real_cpu(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    compute = torch.cuda.current_stream(cuda)
    assert PB.spim_fusion_batch(_cfg(inputs, tmp_path / "out"), device=cuda) == [0, 1, 2]
    in_ring, out_ring = rings.made
    down = [c for c in copies if c[0] == "cpu"]
    up = [c for c in copies if c[3] == in_ring.stream]
    # per timepoint: the decon, the MPs, two MIPs, two registered views
    assert len(down) == 3 * 6 and len(up) == 3 * 2
    for _, pinned, non_blocking, stream, _ in down:
        assert pinned and non_blocking and stream == out_ring.stream != compute
    for kind, pinned, non_blocking, stream, _ in up:
        assert kind == "cuda" and pinned and non_blocking and in_ring.stream != compute
    assert not {c[4] for c in down} & set(cpu_shapes)
    for ring in rings.made:
        assert all(v.is_pinned() for slots in ring._slots.values() for s in slots
                   for v in s.host.values())


@pytest.mark.cuda
def test_card_copy_survives_the_allocator_reusing_its_source(cuda):
    """The copy stream is held back (torch.cuda._sleep) while the compute
    stream drops the source and fills fresh tensors of its size with a
    sentinel: the slot still receives the source's values."""
    ring = HostRing(cuda, 2)
    n = 1 << 22
    src = torch.arange(n, device=cuda, dtype=torch.float32)
    want = src.cpu().numpy().copy()
    slot = ring.acquire({"v": ((n,), torch.float32)})
    with torch.cuda.stream(ring.stream):
        torch.cuda._sleep(200_000_000)           # ~0.1 s of the copy stream
    tr = ring.fetch(slot, {"v": src})
    del src
    fresh = [torch.empty(n, device=cuda).fill_(-1.0) for _ in range(4)]
    tr.wait()
    np.testing.assert_array_equal(slot.arrays()["v"], want)
    del fresh


@pytest.mark.cuda
def test_card_upload_survives_the_allocator_reusing_it(cuda):
    """An uploaded tensor dropped while the compute stream still reads it
    (held back by torch.cuda._sleep) is not handed to the next upload
    before that read: the compute stream's result is the first upload's."""
    ring = HostRing(cuda, 2)
    n = 1 << 22
    slot = ring.acquire({"v": ((n,), torch.float32)})
    fill(slot, {"v": np.ones(n, np.float32)})
    outs, _ = ring.upload(slot)
    torch.cuda._sleep(200_000_000)               # ~0.1 s of the compute stream
    total = outs["v"].sum()
    del outs
    slot = ring.acquire({"v": ((n,), torch.float32)})
    fill(slot, {"v": np.full(n, 5.0, np.float32)})
    outs2, tr = ring.upload(slot)
    assert float(total) == n
    assert float(outs2["v"][0]) == 5.0


@pytest.mark.cuda
def test_card_slowed_writer_writes_the_same_files(inputs, tmp_path, monkeypatch, cuda):
    """On the card, two output slots and slowed writes give the unslowed
    run's files and log lines (chained regMode 0 with an input matrix)."""
    ref = tmp_path / "ref"
    assert PB.spim_fusion_batch(_cfg(inputs, ref), device=cuda) == [0, 1, 2]
    rings = Rings(monkeypatch)
    monkeypatch.setattr(PB, "OUTPUT_SLOTS", 2)
    _slow_writes(monkeypatch)
    got = tmp_path / "slowed"
    assert PB.spim_fusion_batch(_cfg(inputs, got), device=cuda) == [0, 1, 2]
    _same_outputs(got, ref)
    assert rings.all_free()
