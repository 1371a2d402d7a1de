"""The port's MIP outputs against the JAX package's on the CPU: the 2-D
MPs and the packed buffer bit for bit (maxima), the rotating MIPs within
1e-5 x max of JAX's gather route (tests/test_fusion_batch.py's bound
between its routes), with the same rotation matrices and grid."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.models import projections as JP
from microimagelib_tpu_torch.models import projections as PP
from test_fusion_batch import blobs

torch.set_num_threads(1)


@pytest.mark.parametrize("flags", [(True, True, True), (True, False, True),
                                   (False, True, False)])
def test_mp2d_and_packed_match_jax(rng, flags):
    vol = (rng.random((4, 5, 6)) - 0.3).astype(np.float32)
    ref = JP.mp2d(vol, *flags)
    out = PP.mp2d(torch.from_numpy(vol), *flags)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]))
    buf, size = PP.mp2d_packed(vol, *flags, device="cpu")
    jbuf, jsize = JP.mp2d_packed(vol, *flags)
    np.testing.assert_array_equal(buf, jbuf)
    np.testing.assert_array_equal(size, jsize)


def test_mip3d_matches_jax_gather(rng, monkeypatch):
    monkeypatch.setenv("MIL_MIP_IMPL", "gather")
    vol = (blobs((18, 13, 15), n=8, seed=7)
           + rng.normal(0, 0.05, (18, 13, 15))).astype(np.float32)
    for r_axis in (1, 2):
        p, jp = PP.mip3d_params(vol.shape, r_axis, 7), JP.mip3d_params(vol.shape, r_axis, 7)
        assert p["impl"] == jp["impl"] == "gather" and p["out_shape"] == jp["out_shape"]
        np.testing.assert_array_equal(p["mats"], jp["mats"])
        ref = JP.mip3d(vol, r_axis, project_num=7)
        out = PP.mip3d(vol, r_axis, project_num=7, device="cpu")
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())
    both = PP.mp3d(torch.from_numpy(vol), project_num=5)
    jboth = JP.mp3d(vol, project_num=5)
    for k in ("x", "y"):
        np.testing.assert_allclose(both[k], jboth[k], atol=1e-5 * np.abs(jboth[k]).max())
    with pytest.raises(ValueError):
        PP.mip3d_params(vol.shape, 3)
