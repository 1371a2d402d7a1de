"""Truncated and corrupt TIFF stacks on the port's codecs: each raises
``TiffError`` and none crashes the process.

A (4, 64, 64) float32 stack written by the port at 32 and at 16 bits, and
a hand-made little-endian BigTIFF of it, are cut at 12 points between
1/1.01 and 1/8 of their bytes, at 1/2 and 1/4, and inside each of the four
IFDs: halfway through its entries and inside its pointer to the next IFD
(where a parse that checks only the IFD's first bytes reads past the end
of the file). Each cut is read in a process of its own,
so that a crash fails its test instead of ending the run: there the
native codec alone must refuse the file (``ValueError``, the "not
decoded" that hands a file to the NumPy codec), and ``readtifstack`` must
raise ``TiffError`` from the NumPy codec, with no native read counted. An
IFD chain that returns to its first IFD must raise within the child's
timeout, and an untruncated stack of each kind must still decode on the
native codec, bit for bit.

The child imports ``microimagelib_tpu_torch.io.tiff`` under a bare package
module, without the package's ``__init__`` (which imports torch), so that
a cut costs a fraction of a second; the codec modules themselves import
only numpy.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from microimagelib_tpu_torch.io import tiff as T
from microimagelib_tpu_torch.native import build as NB

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "microimagelib_tpu_torch"
SHAPE = (4, 64, 64)
FRACTIONS = (*np.geomspace(1 / 1.01, 1 / 8, 12), 1 / 2, 1 / 4)
CUTS = ([f"1/{1 / f:.2f}" for f in FRACTIONS]
        + [f"ifd{i}-{where}" for i in range(SHAPE[0]) for where in ("entries", "next")])
KINDS = ("f32", "u16", "bigtiff")

CHILD = """
import json, sys, types
pkg = types.ModuleType("microimagelib_tpu_torch")
pkg.__path__ = [{pkg!r}]
sys.modules["microimagelib_tpu_torch"] = pkg
from microimagelib_tpu_torch.io import tiff
path = {path!r}
res = {{}}
try:
    tiff._native().read_stack_f32(path)
    res["native"] = "decoded"
except Exception as e:
    res["native"] = type(e).__name__
try:
    tiff.readtifstack(path)
    res["read"] = "decoded"
except Exception as e:
    res["read"] = type(e).__name__
res["counts"] = tiff.COUNTS
print(json.dumps(res))
"""


def _stack():
    return (np.random.default_rng(16).random(SHAPE, dtype=np.float32) * 1000).astype(np.float32)


def _bigtiff(stack):
    """A little-endian BigTIFF of the float32 stack: one strip a page, each
    page's data followed by its IFD, offsets and counts as LONG8."""
    n, h, w = stack.shape
    entries = lambda off, nbytes: [                                    # noqa: E731
        (256, 4, w), (257, 4, h), (258, 3, 32), (259, 3, 1), (262, 3, 1),
        (273, 16, off), (277, 3, 1), (278, 4, h), (279, 16, nbytes), (339, 3, 3)]
    out = bytearray(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 0))
    ifd_ptr = 8                         # where the pointer to the next IFD goes
    for page in stack:
        data = page.astype("<f4").tobytes()
        off = len(out)
        out += data
        ifd = len(out)
        struct.pack_into("<Q", out, ifd_ptr, ifd)
        ents = entries(off, len(data))
        out += struct.pack("<Q", len(ents))
        for tag, typ, val in ents:
            out += struct.pack("<HHQQ", tag, typ, 1, val)
        ifd_ptr = len(out)
        out += struct.pack("<Q", 0)
    return bytes(out)


def _write(kind, path):
    """The stack of ``kind`` at ``path``; returns what it must decode to."""
    stack = _stack()
    if kind == "bigtiff":
        path.write_bytes(_bigtiff(stack))
        return stack
    T.writetifstack(str(path), stack, 32 if kind == "f32" else 16)
    return stack if kind == "f32" else np.trunc(stack)


def _cut_at(data, name):
    """The byte count a cut named in CUTS keeps."""
    if name.startswith("1/"):
        return int(len(data) * FRACTIONS[CUTS.index(name)])
    big = struct.unpack_from("<H", data, 2)[0] == 43
    head, entry, ptr = (8, 20, 8) if big else (2, 12, 4)
    off = struct.unpack_from("<Q" if big else "<I", data, 8 if big else 4)[0]
    i, where = int(name[3]), name.split("-")[1]
    for _ in range(i):
        count = struct.unpack_from("<Q" if big else "<H", data, off)[0]
        off = struct.unpack_from("<Q" if big else "<I", data, off + head + count * entry)[0]
    count = struct.unpack_from("<Q" if big else "<H", data, off)[0]
    if where == "entries":
        return off + head + entry * (count // 2) + 3
    return off + head + entry * count + ptr // 2


@pytest.fixture(scope="module")
def native():
    """The native codec, built once here so that every child loads it."""
    return NB.load()


def _read_in_child(path):
    env = {k: v for k, v in os.environ.items() if k != "MIL_NO_NATIVE_TIFF"}
    code = CHILD.format(pkg=str(PKG), path=str(path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, (f"the child ended with {proc.returncode} "
                                  f"(a negative code is a signal):\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("kind", KINDS)
def test_every_cut_raises_in_its_own_process(native, tmp_path, kind, cut):
    whole = tmp_path / "whole.tif"
    _write(kind, whole)
    data = whole.read_bytes()
    keep = _cut_at(data, cut)
    assert 0 < keep < len(data)
    part = tmp_path / "cut.tif"
    part.write_bytes(data[:keep])
    res = _read_in_child(part)
    assert res["native"] == "ValueError"           # refused: "not decoded"
    assert res["read"] == "TiffError"
    assert res["counts"]["native_read"] == 0 and res["counts"]["numpy_read"] == 1


def test_a_cyclic_ifd_chain_raises(native, tmp_path):
    """The last IFD's next pointer set back to the first IFD: the native
    codec stops at the IFD it has seen and refuses the file, the NumPy
    codec raises, both well inside the child's timeout."""
    p = tmp_path / "loop.tif"
    T.writetifstack(str(p), _stack(), 32)
    data = bytearray(p.read_bytes())
    first = struct.unpack_from("<I", data, 4)[0]
    off = first
    while True:
        ptr = off + 2 + struct.unpack_from("<H", data, off)[0] * 12
        nxt = struct.unpack_from("<I", data, ptr)[0]
        if nxt == 0:
            break
        off = nxt
    struct.pack_into("<I", data, ptr, first)
    p.write_bytes(bytes(data))
    res = _read_in_child(p)
    assert res["native"] == "ValueError" and res["read"] == "TiffError"
    with pytest.raises(T.TiffError, match="loops"):
        T.gettifinfo(str(p))


@pytest.mark.parametrize("kind", KINDS)
def test_an_untruncated_stack_reads_bit_for_bit_on_the_native_codec(native, tmp_path,
                                                                     monkeypatch, kind):
    monkeypatch.delenv("MIL_NO_NATIVE_TIFF", raising=False)
    monkeypatch.setattr(T, "COUNTS", dict.fromkeys(T.COUNTS, 0))
    p = tmp_path / "whole.tif"
    want = _write(kind, p)
    back, size = T.readtifstack(str(p))
    assert T.COUNTS["native_read"] == 1 and T.COUNTS["numpy_read"] == 0
    assert size == (SHAPE[2], SHAPE[1], SHAPE[0])
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back.view(np.int32), want.view(np.int32))


def test_only_the_files_reads_are_reported_as_corrupt(tmp_path, monkeypatch):
    """A ValueError raised outside the reads of the file (here by a caller's
    stacking of the intact pages) passes through as it is; a read past the
    end of the file is the TiffError that names the file."""
    monkeypatch.setenv("MIL_NO_NATIVE_TIFF", "1")
    p = tmp_path / "whole.tif"
    _write("f32", p)

    def refuse(*args, **kwargs):
        raise ValueError("the caller's own error")

    with monkeypatch.context() as m:
        m.setattr(T.np, "stack", refuse)
        with pytest.raises(ValueError, match="the caller's own error") as e:
            T.readtifstack(str(p))
        assert not isinstance(e.value, T.TiffError)
    data = p.read_bytes()
    p.write_bytes(data[: len(data) // 2])
    with pytest.raises(T.TiffError, match="Truncated or corrupt TIFF .*whole.tif"):
        T.readtifstack(str(p))
