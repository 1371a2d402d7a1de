"""The rest of the port's ``ops/basics.py`` against the JAX package's on
the CPU: shifts, crops, projections, the storage-order transpose, the
first-maximum search, the float64 sum and the FFT size snap. All bit for
bit: each is an index permutation, a max or a copy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.ops import basics as JB
from microimagelib_tpu_torch.ops import basics as PB


def _vol(rng, shape=(5, 6, 7)):
    return (rng.random(shape) * 100 - 20).astype(np.float32)


@pytest.mark.parametrize("shift", [(0, 0, 0), (2, -1, 3), (-7, 6, -5), (9, -8, 1)])
def test_shifts_match_jax(rng, shift):
    a = _vol(rng)
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(PB.circshift(t, *shift).numpy(),
                                  np.asarray(JB.circshift(jnp.asarray(a), *shift)))
    np.testing.assert_array_equal(PB.imshift(t, *shift).numpy(),
                                  np.asarray(JB.imshift(jnp.asarray(a), *shift)))


@pytest.mark.parametrize("direction", [1, 2, 3])
def test_max_projection_matches_jax(rng, direction):
    a = _vol(rng)
    a[:, 0, :] = -5.0          # an all-negative line floors at 0
    out = PB.max_projection(torch.from_numpy(a), direction).numpy()
    np.testing.assert_array_equal(out, np.asarray(JB.max_projection(jnp.asarray(a),
                                                                    direction)))
    with pytest.raises(ValueError):
        PB.max_projection(torch.from_numpy(a), 4)


def test_crop_storage_order_sums_and_snap_match_jax(rng):
    a = _vol(rng, (6, 8, 9))
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(PB.crop_at(t, (3, 4, 5), (2, 1, 3)).numpy(),
                                  np.asarray(JB.crop_at(jnp.asarray(a), (3, 4, 5), (2, 1, 3))))
    for mode in (1, -1):
        np.testing.assert_array_equal(PB.change_storage_order(t, mode).numpy(),
                                      np.asarray(JB.change_storage_order(jnp.asarray(a), mode)))
    with pytest.raises(ValueError):
        PB.change_storage_order(t, 0)
    assert PB.sum_dbl(t) == JB.sum_dbl(a) == PB.sum_dbl(a)
    for shape in ((7, 100, 130), (33, 200, 513)):
        for tf in (True, False):
            assert PB.np_snap_sizes(shape, tf) == JB.np_snap_sizes(shape, tf)


@pytest.mark.parametrize("tie", [False, True])
def test_max3d_with_coords_matches_jax(rng, tie):
    a = _vol(rng, (4, 6, 5))
    if tie:
        # three equal maxima: the first in C-order scan wins
        a[1, 4, 2] = a[3, 0, 1] = a[2, 5, 4] = 1000.0
    v, (x, y, z) = PB.max3d_with_coords(torch.from_numpy(a))
    jv, (jx, jy, jz) = JB.max3d_with_coords(jnp.asarray(a))
    assert (int(x), int(y), int(z)) == (int(jx), int(jy), int(jz))
    assert float(v) == float(jv)
    if tie:
        assert (int(x), int(y), int(z)) == (2, 4, 1)
