"""The port's native TIFF codec (``native/miltiff.cpp``, built here with the
host C++ compiler at first use) against its NumPy codec and the JAX
package's I/O: exact round trips, the same decoded stacks, the same file
bytes where the JAX package's two codecs write the same bytes, the NumPy
path for a layout the native codec does not decode, and a build that
raises instead of falling back."""

import os
import stat
from pathlib import Path

import numpy as np
import pytest

import microimagelib_tpu.io.tiff as JT
from microimagelib_tpu_torch.io import tiff as T
from microimagelib_tpu_torch.native import build as NB


@pytest.fixture
def codec(monkeypatch):
    """The native codec on, counts from zero."""
    monkeypatch.delenv("MIL_NO_NATIVE_TIFF", raising=False)
    monkeypatch.setattr(T, "COUNTS", dict.fromkeys(T.COUNTS, 0))
    return T.COUNTS


def _numpy_codec(monkeypatch):
    monkeypatch.setenv("MIL_NO_NATIVE_TIFF", "1")


def test_module_lives_under_build():
    path = Path(NB.load().__file__).resolve()
    root = Path(T.__file__).resolve().parents[2]
    assert path.parent.parent == root / "build" / "microimagelib_tpu_torch" / "native"
    assert path == NB.module_path().resolve()


@pytest.mark.parametrize("bits", [16, 32])
def test_round_trip_and_codecs_agree(tmp_path, codec, monkeypatch, bits):
    rng = np.random.default_rng(bits)
    if bits == 16:
        stack = rng.integers(0, 65535, size=(5, 17, 23)).astype(np.float32)
    else:
        stack = rng.normal(size=(4, 9, 11)).astype(np.float32) * 100
    p_nat, p_np = str(tmp_path / "n.tif"), str(tmp_path / "p.tif")
    T.writetifstack(p_nat, stack, bits)
    back, size = T.readtifstack(p_nat)
    assert codec == {"native_read": 1, "native_write": 1, "numpy_read": 0,
                     "numpy_write": 0}
    assert size == (stack.shape[2], stack.shape[1], stack.shape[0])
    np.testing.assert_array_equal(back, stack)
    assert T.gettifinfo(p_nat) == (size, bits)
    np.testing.assert_array_equal(JT.readtifstack(p_nat)[0], stack)
    _numpy_codec(monkeypatch)
    T.writetifstack(p_np, stack, bits)
    np.testing.assert_array_equal(T.readtifstack(p_nat)[0], back)
    assert codec["numpy_read"] == 1 and codec["numpy_write"] == 1
    # the bytes: the port's two codecs, and the JAX package's where its
    # native and NumPy writers agree
    nat, num = Path(p_nat).read_bytes(), Path(p_np).read_bytes()
    assert nat == num
    p_jn, p_jp = str(tmp_path / "jn.tif"), str(tmp_path / "jp.tif")
    JT.writetifstack(p_jn, stack, bits)
    monkeypatch.setattr(JT, "_NATIVE", None)
    JT.writetifstack(p_jp, stack, bits)
    if Path(p_jn).read_bytes() == Path(p_jp).read_bytes():
        assert nat == Path(p_jn).read_bytes()


def test_u16_journey_and_c_cast(tmp_path, codec):
    rng = np.random.default_rng(3)
    u16 = rng.integers(0, 65535, size=(3, 8, 6)).astype(np.uint16)
    p = str(tmp_path / "u.tif")
    T.writetifstack_16to16(p, u16)
    back, size = T.readtifstack_16to16(p)
    assert back.dtype == np.uint16 and size == (6, 8, 3)
    np.testing.assert_array_equal(back, u16)
    np.testing.assert_array_equal(JT.readtifstack_16to16(p)[0], u16)
    assert codec["native_read"] == 1 and codec["native_write"] == 1
    # the float -> u16 write truncates like C, as the NumPy codec does
    f = np.array([[[0.9, 1.5, 65535.7, 100.2, -0.5, 7.0]]], np.float32)
    T.writetifstack(p, f, 16)
    np.testing.assert_array_equal(T.readtifstack_16to16(p)[0],
                                  T._float_to_u16_c_cast(f))


def test_layout_the_native_codec_does_not_decode(tmp_path, codec):
    """8-bit pages: the native codec declines and NumPy decodes them."""
    rng = np.random.default_rng(4)
    pages = rng.integers(0, 255, size=(3, 5, 7)).astype(np.uint8)
    blob = T._build_classic_tiff_pages([pg.tobytes() for pg in pages], 7, 5, 8, 1)
    p = tmp_path / "u8.tif"
    p.write_bytes(blob)
    back, size = T.readtifstack(str(p))
    assert codec["numpy_read"] == 1 and codec["native_read"] == 0
    np.testing.assert_array_equal(back, pages.astype(np.float32))
    np.testing.assert_array_equal(back, JT.readtifstack(str(p))[0])
    with pytest.raises(T.TiffError):
        T.readtifstack(str(tmp_path / "missing.tif"))


def test_a_broken_compiler_raises(tmp_path, monkeypatch, codec):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\n[ \"$1\" = --version ] && echo broken 1.0 && exit 0\n"
                   "echo 'error: cannot compile' >&2\nexit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(NB, "CXX", str(cxx))
    monkeypatch.setattr(NB, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(NB, "_MODULE", None)
    with pytest.raises(RuntimeError, match="cannot compile"):
        NB.build()
    stack = np.ones((2, 3, 4), np.float32)
    with pytest.raises(RuntimeError, match="native TIFF codec failed"):
        T.writetifstack(str(tmp_path / "x.tif"), stack, 16)
    assert codec["numpy_write"] == 0 and not os.path.exists(tmp_path / "x.tif")
    monkeypatch.setattr(NB, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        NB.build()
    assert not list((tmp_path / "build").rglob("*.so"))
