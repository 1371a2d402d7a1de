"""The port's affine transform, matrix algebra, plausibility gate, 16-bit
transform and ZNCC against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.models import registration as JR
from microimagelib_tpu.ops import affine as JA
from microimagelib_tpu.ops import matrix as JM
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.models import registration_device as RD
from microimagelib_tpu_torch.ops import affine as A
from microimagelib_tpu_torch.ops import matrix as M
from test_registration import smooth_blobs

torch.set_num_threads(1)


@pytest.mark.parametrize("case", [
    ((16, 16, 16), (16, 16, 16), JM.dof_to_matrix([1.0, 0.5, -0.5, 3.0, 0, 0, 1, 1, 1], 6)),
    ((12, 20, 28), (10, 22, 30), JM.dof_to_matrix([-2.0, 1.5, 0.7, 7.0, -4.0, 3.0,
                                                   1.05, 0.97, 1.02], 9)),
    ((8, 12, 16), (8, 12, 16), JM.dof_to_matrix([5.0, -4.0, 3.0, 0, 0, 0, 1, 1, 1], 3)),
], ids=["test_registration-case", "resized-9dof", "partly-outside"])
def test_affine_transform_matches_jax(case):
    """atol 1e-6 as tests/test_registration.py::test_atrans3dgpu_matches_direct."""
    in_shape, out_shape, m = case
    vol = smooth_blobs(in_shape, n=6, seed=10)
    ref = np.asarray(JA.affine_transform_3d(jnp.asarray(vol), m, out_shape))
    out = A.affine_transform_3d(torch.from_numpy(vol), m, out_shape).numpy()
    assert out.shape == tuple(out_shape)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_masks_at_minus_half():
    """The transform keeps c = -0.5 (c >= -0.5); the correlation drops it
    (c > -0.5): with x shifted by exactly -0.5 the x = 0 plane is in the
    transform and out of the NCC sums, in both packages."""
    shape = (4, 5, 6)
    ones = np.ones(shape, np.float32)
    m = M.identity_tmx()
    m[3] = -0.5
    out = A.affine_transform_3d(torch.from_numpy(ones), m, shape).numpy()
    ref = np.asarray(JA.affine_transform_3d(jnp.asarray(ones), m, shape))
    np.testing.assert_array_equal(out, ref)
    assert (out[:, :, 0] == 1).all()
    ss, st = A.corr3d_partials(torch.from_numpy(ones), torch.from_numpy(ones), m)
    jss, jst = JA.corr3d_partials(jnp.asarray(ones), jnp.asarray(ones), m)
    n_in = ones.size - shape[0] * shape[1]
    assert float(ss) == float(st) == n_in == float(jss) == float(jst)
    # just inside the other edge: c = sx - 0.5 is out for both
    m[3] = 0.5
    out = A.affine_transform_3d(torch.from_numpy(ones), m, shape).numpy()
    assert (out[:, :, -1] == 0).all() and (out[:, :, :-1] == 1).all()


def test_matrix_module_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        dof = rng.normal(size=9) * [3, 3, 3, 10, 10, 10, 0.05, 0.05, 0.05]
        dof[6:] += 1.0
        for n in (3, 6, 7, 9):
            np.testing.assert_array_equal(M.dof_to_matrix(dof, n),
                                          JM.dof_to_matrix(dof, n))
        p = rng.normal(size=12).astype(np.float32)
        np.testing.assert_array_equal(M.params_to_matrix(p), JM.params_to_matrix(p))
        np.testing.assert_array_equal(M.matrix_to_params(p), JM.matrix_to_params(p))
        a, b = rng.normal(size=12), rng.normal(size=12)
        np.testing.assert_array_equal(M.compose_affine(a, b), JM.compose_affine(a, b))
    for axis in (1, 2, 3):
        np.testing.assert_array_equal(M.rot_to_matrix(0.3, 40, 30, 20, axis),
                                      JM.rot_to_matrix(0.3, 40, 30, 20, axis))
    np.testing.assert_array_equal(M.scale_tmx(1.5, 0.5, 2.0), JM.scale_tmx(1.5, 0.5, 2.0))
    np.testing.assert_array_equal(M.identity_tmx(), JM.identity_tmx())
    with pytest.raises(ValueError):
        M.dof_to_matrix(np.zeros(9), 4)


def test_torch_matrix_twins_match_numpy():
    """The differentiable twins the ladders use agree with ops/matrix.py
    to float32 rounding."""
    rng = np.random.default_rng(4)
    ident = np.array([0.0] * 6 + [1.0] * 3, np.float32)
    for _ in range(10):
        dof = (rng.normal(size=9) * [3, 3, 3, 10, 10, 10, 0.05, 0.05, 0.05]
               + ident).astype(np.float32)
        for n in (3, 6, 7, 9):
            t = RD.dof_to_matrix_t(RD._full_dof(torch.from_numpy(dof[:n]), n), n)
            full = np.concatenate([dof[:n], ident[n:]])
            np.testing.assert_allclose(t.numpy(), M.dof_to_matrix(full, n),
                                       rtol=1e-5, atol=1e-5)
        p = torch.from_numpy(rng.normal(size=12).astype(np.float32))
        np.testing.assert_array_equal(RD.params_to_matrix_t(p).numpy(),
                                      M.params_to_matrix(p.numpy()))
        np.testing.assert_array_equal(RD.matrix_to_params_t(p).numpy(),
                                      M.matrix_to_params(p.numpy()))


def test_checkmatrix_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        m = M.identity_tmx() + rng.normal(size=12).astype(np.float32) * 0.3
        m[[3, 7, 11]] = rng.normal(size=3) * 40
        assert R.checkmatrix(m, 64, 48, 32) == JR.checkmatrix(m, 64, 48, 32)
    assert R.checkmatrix(M.identity_tmx(), 64, 64, 64)


def test_atrans3dgpu_16bit_matches_jax():
    vol = (smooth_blobs((12, 16, 20), n=8, seed=11) * 40).astype(np.uint16)
    m = JM.dof_to_matrix([1.5, -0.7, 0.3, 4.0, 2.0, -1.0, 1, 1, 1], 6)
    out = R.atrans3dgpu_16bit(vol, m, (12, 16, 20), mem_mode=0)
    ref = JR.atrans3dgpu_16bit(vol, m, (12, 16, 20))
    assert out.dtype == np.uint16 and out.shape == ref.shape
    # float trilinear then truncation: equal, or one apart where the two
    # float32 samples straddle an integer
    assert np.abs(out.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    assert np.mean(out == ref) > 0.99
    f32 = R.atrans3dgpu(vol, m, (10, 16, 20), mem_mode=0)
    np.testing.assert_allclose(f32, JR.atrans3dgpu(vol, m, (10, 16, 20)),
                               atol=1e-6 * vol.max())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        R.atrans3dgpu(vol, m, (12, 16, 20), mem_mode=2)


def test_zncc_matches_jax(rng):
    a = rng.normal(size=(8, 9, 10)).astype(np.float32)
    b = a * 0.5 + rng.normal(size=a.shape).astype(np.float32)
    np.testing.assert_allclose(R.zncc(a, b), JR.zncc(a, b), rtol=1e-5)
    assert abs(R.zncc(a, a) - 1.0) < 1e-6
    assert R.zncc(np.zeros((4, 4, 4)), np.zeros((4, 4, 4))) == -2.0
