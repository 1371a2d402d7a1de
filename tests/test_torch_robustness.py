"""Failure-path robustness of the port on its CPU path: clean errors instead
of crashes or NaNs on degenerate inputs, the six cases of
tests/test_robustness.py with the same asserts (SURVEY §5: the reference
aborts through cudaCheckErrors and exits on a zero SD; the port raises
Python exceptions), each also held to the JAX package on the same inputs:
the same exception and message, deconvolutions within the port's CPU bound
(rtol = atol/max = 2e-4, tests/test_torch_deconvolution.py), registrations
within its registration bound (final NCC within 1e-3, translations within
0.35 voxel, tests/test_torch_registration.py).
tests/test_torch_tiff_truncated.py reads truncated stacks at many cut
points, each in a process of its own."""

import numpy as np
import pytest

from microimagelib_tpu.io import tiff as JT
from microimagelib_tpu.models import deconvolution as JD
from microimagelib_tpu.models import registration as JR
from microimagelib_tpu_torch.io.tiff import TiffError, readtifstack, writetifstack
from microimagelib_tpu_torch.models.deconvolution import decon_singleview
from microimagelib_tpu_torch.models.registration import reg3d_affine

PSF = np.ones((5, 5, 5), np.float32) / 125


def _close(out, ref, tol=2e-4):
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * np.abs(ref).max())


def test_truncated_tiff_raises(tmp_path):
    p = tmp_path / "t.tif"
    writetifstack(str(p), np.ones((4, 8, 8), np.float32), 32)
    data = p.read_bytes()
    (tmp_path / "trunc.tif").write_bytes(data[: len(data) // 3])
    with pytest.raises(Exception):  # TiffError, never a segfault/hang
        readtifstack(str(tmp_path / "trunc.tif"))
    with pytest.raises(Exception):  # the JAX package refuses the same cut
        JT.readtifstack(str(tmp_path / "trunc.tif"))


def test_garbage_file_raises(tmp_path):
    p = tmp_path / "g.tif"
    p.write_bytes(b"not a tiff at all, just text" * 10)
    with pytest.raises(TiffError) as got:
        readtifstack(str(p))
    with pytest.raises(JT.TiffError) as ref:
        JT.readtifstack(str(p))
    assert str(got.value) == str(ref.value)


def test_empty_image_registration_raises():
    z = np.zeros((16, 16, 16), np.float32)
    r = np.random.default_rng(0).random((16, 16, 16)).astype(np.float32)
    for a, b in ((z, z + 1.0), (r, z)):
        with pytest.raises(ValueError, match="SD of image") as got:
            reg3d_affine(a, b, aff_method=1, device="cpu")
        with pytest.raises(ValueError, match="SD of image") as ref:
            JR.reg3d_affine(a, b, aff_method=1)
        assert str(got.value) == str(ref.value)


def test_zero_image_decon_no_nan():
    z = np.zeros((16, 16, 16), np.float32)
    out = decon_singleview(z, PSF, n_iters=3, device="cpu")
    assert np.all(np.isfinite(out))
    # clamped observed image (SMALLVALUE) deconvolves to a flat field
    assert out.std() < 1e-3
    _close(out, np.asarray(JD.decon_singleview(z, PSF, n_iters=3)))


def test_constant_image_decon_stable():
    c = np.full((16, 16, 16), 7.0, np.float32)
    out = decon_singleview(c, PSF, n_iters=5, device="cpu")
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, 7.0, rtol=0.05)
    _close(out, np.asarray(JD.decon_singleview(c, PSF, n_iters=5)))


def test_registration_identical_images():
    vol = np.random.default_rng(1).random((16, 16, 16)).astype(np.float32) + 1
    reg, tmx, rec = reg3d_affine(vol, vol.copy(), aff_method=1, ftol=1e-5, it_limit=500,
                                 device="cpu")
    # identity is the optimum; NCC ~ 1, translation ~ 0
    assert rec[3] > 0.999
    assert max(abs(tmx[3]), abs(tmx[7]), abs(tmx[11])) < 0.2
    _jreg, jtmx, jrec = JR.reg3d_affine(vol, vol.copy(), aff_method=1, ftol=1e-5,
                                        it_limit=500)
    assert abs(rec[3] - jrec[3]) <= 1e-3, (rec[3], jrec[3])
    np.testing.assert_allclose(np.asarray(tmx)[[3, 7, 11]], np.asarray(jtmx)[[3, 7, 11]],
                               atol=0.35)
