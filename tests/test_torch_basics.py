"""The port's volume ops, TIFF/.tmx codec and device utilities against the
JAX package on the same numpy inputs (exact: these ops only move or copy
values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.io import tiff as jtiff
from microimagelib_tpu.io import tmx as jtmx
from microimagelib_tpu.ops import basics as J
from microimagelib_tpu_torch.io import tiff as ptiff
from microimagelib_tpu_torch.io import tmx as ptmx
from microimagelib_tpu_torch.ops import basics as P
from microimagelib_tpu_torch.utils import device as pdev

torch.set_num_threads(1)


def test_fft_size_policy_matches_jax():
    for n in list(range(1, 300)) + [320, 500, 512, 700, 1000, 1025, 2000]:
        assert P.snap_transform_size(n) == J.snap_transform_size(n), n
        for friendly in (True, False):
            assert P.snap_fft_size(n, friendly) == J.snap_fft_size(n, friendly)


@pytest.mark.parametrize("psf_shape,grid", [
    ((5, 5, 5), (16, 16, 16)),
    ((8, 7, 6), (16, 12, 20)),
    ((9, 9, 9), (9, 9, 9)),
])
def test_pad_psf_to_origin_and_flip(rng, psf_shape, grid):
    psf = rng.random(psf_shape).astype(np.float32)
    out = P.pad_psf_to_origin(torch.from_numpy(psf), grid).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(J.pad_psf_to_origin(jnp.asarray(psf), grid)))
    np.testing.assert_array_equal(
        P.flip3(torch.from_numpy(psf)).numpy(),
        np.asarray(J.flip3(jnp.asarray(psf))))


@pytest.mark.parametrize("shape,out_shape", [
    ((20, 30, 40), (32, 32, 64)),
    ((5, 7, 9), (16, 16, 16)),
    ((8, 8, 8), (8, 8, 8)),
])
def test_pad_stack_edge_and_crop_center(rng, shape, out_shape):
    img = rng.random(shape).astype(np.float32)
    pad = P.pad_stack_edge(torch.from_numpy(img), out_shape).numpy()
    np.testing.assert_array_equal(
        pad, np.asarray(J.pad_stack_edge(jnp.asarray(img), out_shape)))
    back = P.crop_center(torch.from_numpy(pad), shape).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(J.crop_center(jnp.asarray(pad), shape)))
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("shape,out_shape", [
    ((9, 21, 7), (16, 16, 16)),    # crop y, pad z and x
    ((17, 5, 6), (8, 8, 8)),       # odd crop
    ((4, 4, 4), (9, 10, 11)),
])
def test_align_size_3d(rng, shape, out_shape):
    img = rng.random(shape).astype(np.float32)
    out = P.align_size_3d(torch.from_numpy(img), out_shape).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(J.align_size_3d(jnp.asarray(img), out_shape)))


@pytest.mark.parametrize("bits", [16, 32])
def test_tiff_codec_interoperates_with_jax(tmp_path, rng, bits):
    stack = (rng.random((4, 9, 11)) * 60000).astype(np.float32)
    p_port, p_jax = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    ptiff.writetifstack(p_port, stack, bits)
    jtiff.writetifstack(p_jax, stack, bits)
    for path in (p_port, p_jax):
        assert ptiff.gettifinfo(path) == jtiff.gettifinfo(path)
        a, size_a = ptiff.readtifstack(path)
        b, size_b = jtiff.readtifstack(path)
        assert size_a == size_b == (11, 9, 4)
        np.testing.assert_array_equal(a, b)
    expect = stack if bits == 32 else np.trunc(stack)
    np.testing.assert_array_equal(ptiff.readtifstack(p_port)[0], expect)


def test_tmx_roundtrip_with_jax(tmp_path):
    m = np.arange(12, dtype=np.float32) * 0.5 + 1
    ptmx.write_tmx(str(tmp_path / "p.tmx"), m)
    jtmx.write_tmx(str(tmp_path / "j.tmx"), m)
    assert (tmp_path / "p.tmx").read_text() == (tmp_path / "j.tmx").read_text()
    np.testing.assert_array_equal(ptmx.read_tmx(str(tmp_path / "j.tmx")), m)


def test_device_utils_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pdev.get_device(1) == torch.device("cuda", 1)
    with pytest.raises(ValueError):
        pdev.get_device(-1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdev.require_cuda(torch.device("cuda", 0))
    with pytest.raises(ValueError):
        pdev.require_cuda(torch.device("cpu"))
    assert pdev.free_memory_mb(torch.device("cpu")) == -1.0
    assert pdev.free_memory_mb(torch.device("cuda", 0)) == -1.0
    assert pdev.query_device(verbose=False) == []
