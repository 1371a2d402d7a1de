"""The port's 2-D affine transform and NCC partials, and the batched 2-D
and 3-D partials, against the JAX package's on the CPU, at the bounds of
tests/test_affine.py: the resample within 1e-6 x max, ss and st within
rtol 1e-5 and 1e-4 (the port sums in float64, JAX in blocked float32),
a batch against single calls within rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.ops import affine as JA
from microimagelib_tpu.ops.matrix import dof_to_matrix, identity_tmx
from microimagelib_tpu_torch.ops import affine as PA

MATS2 = [
    [1, 0, 0, 0, 1, 0],
    [1, 0, 2.5, 0, 1, -1.25],          # shifts a half texel past the edge
    [0.97, 0.1, -0.4, -0.08, 1.03, 0.6],
    [1, 0, -0.5, 0, 1, -0.5],          # c = -0.5 exactly: strict bound drops it
]


@pytest.mark.parametrize("k", range(len(MATS2)))
def test_affine_2d_and_corr2d_match_jax(rng, k):
    src = rng.normal(size=(13, 17)).astype(np.float32)
    tgt = rng.normal(size=(13, 17)).astype(np.float32)
    m = np.asarray(MATS2[k], np.float32)
    ref = np.asarray(JA.affine_transform_2d(jnp.asarray(src), m, (11, 19)))
    out = PA.affine_transform_2d(torch.from_numpy(src), m, (11, 19)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6 * np.abs(ref).max())
    ss, st = PA.corr2d_partials(torch.from_numpy(src), torch.from_numpy(tgt), m)
    jss, jst = JA.corr2d_partials(jnp.asarray(src), jnp.asarray(tgt), m)
    assert ss.dtype == torch.float64
    np.testing.assert_allclose(float(ss), float(jss), rtol=1e-5)
    np.testing.assert_allclose(float(st), float(jst), rtol=1e-4)


def test_corr2d_batch_matches_single_and_jax(rng, monkeypatch):
    src = rng.normal(size=(12, 15)).astype(np.float32)
    tgt = rng.normal(size=(12, 15)).astype(np.float32)
    mats = np.asarray(MATS2 * 3, np.float32)
    mats[4:, 2] += np.linspace(-3, 3, len(mats) - 4)
    # a small chunk so the batch crosses chunk boundaries
    monkeypatch.setattr(PA, "CHUNK_VOXELS", 3 * 12 * 15)
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    ss_b, st_b = PA.corr2d_partials_batch(s, t, mats)
    jss_b, jst_b = JA.corr2d_partials_batch(jnp.asarray(src), jnp.asarray(tgt),
                                            jnp.asarray(mats))
    assert ss_b.shape == st_b.shape == (len(mats),)
    for i, m in enumerate(mats):
        ss, st = PA.corr2d_partials(s, t, m)
        np.testing.assert_allclose(float(ss_b[i]), float(ss), rtol=1e-6)
        np.testing.assert_allclose(float(st_b[i]), float(st), rtol=1e-6)
    np.testing.assert_allclose(ss_b.numpy(), np.asarray(jss_b), rtol=1e-5)
    np.testing.assert_allclose(st_b.numpy(), np.asarray(jst_b), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jst_b)).max())


def test_corr3d_batch_matches_single_and_jax(rng):
    src = rng.normal(size=(6, 7, 8)).astype(np.float32)
    tgt = rng.normal(size=(6, 7, 8)).astype(np.float32)
    mats = np.stack([identity_tmx(),
                     dof_to_matrix([0.5, 0, 0, 0, 0, 0, 1, 1, 1], 9),
                     dof_to_matrix([0.3, -1.2, 0.7, 4, 2, -3, 1.02, 0.98, 1], 9)])
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    ss_b, st_b = PA.corr3d_partials_batch(s, t, mats)
    jss_b, jst_b = JA.corr3d_partials_batch(jnp.asarray(src), jnp.asarray(tgt),
                                            jnp.asarray(mats))
    for i in range(len(mats)):
        ss, st = PA.corr3d_partials(s, t, mats[i])
        np.testing.assert_allclose(float(ss_b[i]), float(ss), rtol=1e-6)
        np.testing.assert_allclose(float(st_b[i]), float(st), rtol=1e-6)
        np.testing.assert_allclose(float(ss_b[i]), float(jss_b[i]), rtol=1e-5)
        np.testing.assert_allclose(float(st_b[i]), float(jst_b[i]), rtol=1e-4)
