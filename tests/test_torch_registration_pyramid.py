"""The port's registration pyramid and ``reg3d`` dispatcher against the
JAX package's on the CPU, on the fixtures of tests/test_registration.py:
the pyramid with MIL_REG_FINISH_LEVEL pinned to 'mid' and to 'full' on
both sides ((32, 32, 32), factor (4, 4, 1), grad engine) and with factor
(2, 2, 2) ((24, 32, 32), method 1); ``reg3d`` choices 0 and 2.

Bounds: the final NCC within 1e-3 of JAX's, the translations within 0.35
voxel of JAX's, and the plausibility gate holds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.models import registration as JR
from microimagelib_tpu.ops.affine import affine_transform_3d as jax_affine
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.ops.matrix import identity_tmx
from test_registration import smooth_blobs

torch.set_num_threads(1)


def _moved(shape, seed, shift):
    vol = smooth_blobs(shape, n=12 if shape != (24, 24, 24) else 10, seed=seed)
    m = identity_tmx()
    m[3], m[7], m[11] = shift
    return vol, np.asarray(jax_affine(jnp.asarray(vol), m, vol.shape))


def _check(got, ref, shape):
    (reg, tmx, rec), (_jreg, jtmx, jrec) = got, ref
    assert abs(rec[3] - jrec[3]) <= 1e-3, (rec[3], jrec[3])
    np.testing.assert_allclose(tmx[[3, 7, 11]], jtmx[[3, 7, 11]], atol=0.35)
    sz, sy, sx = shape
    assert R.checkmatrix(tmx, sx, sy, sz)
    assert reg.shape == tuple(shape)
    assert 0 < rec[5] <= 3000
    assert abs(rec[2] - jrec[2]) <= 1e-3      # the coarse level's NCC


@pytest.mark.parametrize("level", ["mid", "full"])
def test_pyramid_finish_level_matches_jax(level, monkeypatch):
    """tests/test_registration.py::test_pyramid_finish_level_mid's case:
    a coarse level at (8, 8, 32), a mid level at (2, 2, 1), full size."""
    vol, moved = _moved((32, 32, 32), 23, (1.3, -1.8, 0.7))
    monkeypatch.setenv("MIL_REG_FINISH_LEVEL", level)
    kw = dict(aff_method=2, ftol=1e-5, it_limit=3000, factor=(4, 4, 1),
              engine="grad")
    ref = JR.reg3d_affine_pyramid(vol, moved, **kw)
    levels = []
    got = R.reg3d_affine_pyramid(vol, moved, mem_mode=0, **kw,
                                 on_level=lambda *a: levels.append(a[:2]))
    _check(got, ref, vol.shape)
    assert [lv[1] for lv in levels] == [(8, 8, 32), (16, 16, 32), (32, 32, 32)]


def test_pyramid_factor_222_keeps_translation_model():
    """Method 1 through the pyramid stays a pure translation
    (tests/test_registration.py::test_pyramid_preserves_requested_dof_model)."""
    vol, moved = _moved((24, 32, 32), 13, (2.4, -1.6, 1.1))
    kw = dict(aff_method=1, ftol=1e-5, it_limit=3000, factor=(2, 2, 2))
    ref = JR.reg3d_affine_pyramid(vol, moved, **kw)
    got = R.reg3d_affine_pyramid(vol, moved, mem_mode=0, **kw)
    _check(got, ref, vol.shape)
    a = np.asarray(got[1], np.float64).reshape(3, 4)[:, :3]
    np.testing.assert_allclose(a, np.eye(3), atol=1e-6)


def test_reg3d_choice_2_with_input_matrix():
    """tests/test_registration.py::test_reg3d_input_matrix_compose: the
    input matrix pre-transforms the source and composes into the answer."""
    vol, moved = _moved((24, 24, 24), 8, (2.5, 0.0, 0.0))
    near = identity_tmx()
    near[3] = -2.0
    kw = dict(reg_choice=2, aff_method=1, flag_tmx=True, tmx=near, ftol=1e-5,
              it_limit=2000)
    ref = JR.reg3d(vol, moved, **kw)
    got = R.reg3d(vol, moved, mem_mode=0, **kw)
    assert abs(got[2][3] - ref[2][3]) <= 1e-3
    np.testing.assert_allclose(got[1][[3, 7, 11]], ref[1][[3, 7, 11]], atol=0.35)
    np.testing.assert_allclose(got[1][3], -2.5, atol=0.15)
    assert got[2][0] == 1 and got[2][7] > 0 and got[2][8] == -1.0


def test_reg3d_choice_0_and_size_harmonization():
    """Choice 0 applies the input matrix (or passes the source through)
    after centering a smaller source on the target's grid."""
    vol = smooth_blobs((24, 24, 24), n=8, seed=7)
    small = vol[2:-2, 2:-2, 3:-1]
    m = identity_tmx()
    m[3], m[7] = 1.25, -0.5
    for flag in (False, True):
        reg, tmx, _ = R.reg3d(vol, small, reg_choice=0, flag_tmx=flag, tmx=m,
                              mem_mode=0)
        jreg, jtmx, _ = JR.reg3d(vol, small, reg_choice=0, flag_tmx=flag, tmx=m)
        assert reg.shape == vol.shape
        np.testing.assert_array_equal(tmx, jtmx)
        np.testing.assert_allclose(reg, np.asarray(jreg), atol=1e-6 * vol.max())
    dev_reg, _, _ = R.reg3d(vol, small, reg_choice=0, mem_mode=0, as_device=True)
    assert isinstance(dev_reg, torch.Tensor)
    none_reg, _, _ = R.reg3d(vol, small, reg_choice=0, mem_mode=0, want_reg=False)
    assert none_reg is None


def test_pyramid_helpers_match_jax(monkeypatch):
    for shape in [(256, 512, 512), (128, 256, 256), (2, 2048, 2048),
                  (128, 128, 128), (4, 4, 4), (100, 300, 700)]:
        assert R._auto_pool_factors(shape) == JR._auto_pool_factors(shape)
    assert R._auto_pool_factors((256, 512, 512)) == (16, 16, 4)
    assert R.pyramid_levels((16, 16, 4)) == [(16, 16, 4), (8, 8, 2), (4, 4, 1),
                                             (2, 2, 1)]
    monkeypatch.setenv("MIL_REG_PYRAMID_MID", "0")
    assert R.pyramid_levels((16, 16, 4)) == [(16, 16, 4)]
    rng = np.random.default_rng(1)
    m = (identity_tmx() + rng.normal(size=12) * 0.05).astype(np.float32)
    for k in [(2, 2, 2), (4, 4, 1), (16, 16, 4), 3]:
        np.testing.assert_array_equal(R._tmx_coarse_to_full(m, k),
                                      JR._tmx_coarse_to_full(m, k))
        np.testing.assert_array_equal(R._tmx_full_to_coarse(m, k),
                                      JR._tmx_full_to_coarse(m, k))
    vol = rng.random((9, 10, 11)).astype(np.float32)
    np.testing.assert_allclose(R._mean_pool(torch.from_numpy(vol), (2, 3, 4)).numpy(),
                               np.asarray(JR._mean_pool(jnp.asarray(vol), (2, 3, 4))),
                               rtol=1e-6)
