"""The port's 2-D registration against the JAX package's on the CPU:
``reg2d`` choices 0-3 on the images of tests/test_registration.py. The
shift grid (choice 1, and ``reg2d_shiftalign`` with ``x_only``) and the
phasor (3) give the same matrix; Powell (2) a final NCC within 1e-3 and a
matrix within 0.35 pixel over the central half of the image; choice 0
the same resample within 1e-6 x max."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.models import registration as JR
from microimagelib_tpu_torch.models import registration as R
from test_registration import smooth_blobs

torch.set_num_threads(1)


def _img(seed=11):
    return smooth_blobs((1, 40, 40), n=12, seed=seed)[0]


def _box_error_2d(m, ref, shape):
    sy, sx = shape
    pts = np.array([[x, y, 1.0] for x in (sx / 4, 3 * sx / 4)
                    for y in (sy / 4, 3 * sy / 4)])
    a = np.asarray(m, np.float64).reshape(2, 3)
    b = np.asarray(ref, np.float64).reshape(2, 3)
    return float(np.abs(pts @ a.T - pts @ b.T).max())


@pytest.mark.parametrize("choice", [0, 1, 3])
def test_reg2d_exact_choices_match_jax(choice):
    img = _img()
    # the shift grid steps 0.4 pixel here, so (4, -4) lies on it
    moved = np.roll(img, (4, -4), axis=(0, 1))
    tmx = np.array([1, 0.05, -2.5, 0.02, 1, 1.5], np.float32)
    jrec, rec = np.zeros(11), np.zeros(11)
    jreg, jtmx, _ = JR.reg2d(img, moved, reg_choice=choice, flag_tmx=True,
                             tmx=tmx if choice == 0 else None, records=jrec)
    reg, out, _ = R.reg2d(img, moved, reg_choice=choice, flag_tmx=True,
                          tmx=tmx if choice == 0 else None, records=rec,
                          device="cpu")
    np.testing.assert_array_equal(out, jtmx)
    np.testing.assert_allclose(reg, np.asarray(jreg),
                               atol=1e-6 * np.abs(np.asarray(jreg)).max())
    if choice == 1:
        assert out[2] == -4 and out[5] == 4
        np.testing.assert_allclose(rec[[4, 5]], jrec[[4, 5]], atol=1e-5)
        assert rec[8] == jrec[8] == 80 ** 2


def test_shiftalign_half_step_tie():
    """A 3-pixel shift lies halfway between the candidates 2.8 and 3.2,
    whose NCCs on this periodic image are equal to float rounding: each
    package's sums (JAX: blocked float32, the port: float64) decide the
    tie, so the pick may differ. Both pick one of the two, at the same
    NCC within 1e-5."""
    img = _img()
    moved = np.roll(img, (3, -4), axis=(0, 1))
    jrec, rec = np.zeros(11), np.zeros(11)
    _, jtmx = JR.reg2d_shiftalign(img, moved, None, 0.4, 40, records=jrec)
    _, tmx = R.reg2d_shiftalign(img, moved, None, 0.4, 40, records=rec,
                                device="cpu")
    assert tmx[2] == jtmx[2] == -4
    assert {round(float(tmx[5]), 4), round(float(jtmx[5]), 4)} <= {2.8, 3.2}
    assert abs(rec[5] - jrec[5]) <= 1e-5


def test_shiftalign_x_only_and_negative_grid_match_jax():
    img = _img(13)
    moved = np.roll(img, 5, axis=1)
    init = np.array([1, 0, 0, 0, 1, 2.0], np.float32)
    _, jtmx = JR.reg2d_shiftalign(img, moved, init, 0.3, 30, x_only=True)
    _, tmx = R.reg2d_shiftalign(img, moved, init, 0.3, 30, x_only=True, device="cpu")
    np.testing.assert_array_equal(tmx, jtmx)
    assert tmx[5] == 2.0
    # an anti-correlated pair: every candidate's NCC is <= 0, so the shift
    # stays (0, 0) as in the reference
    _, jtmx = JR.reg2d_shiftalign(img, -img, None, 0.1, 4)
    _, tmx = R.reg2d_shiftalign(img, -img, None, 0.1, 4, device="cpu")
    np.testing.assert_array_equal(tmx, jtmx)
    assert tmx[2] == tmx[5] == 0


def test_reg2d_affine_matches_jax():
    img = _img(12)
    moved = np.roll(img, (0, -2), axis=(0, 1))
    init = np.array([1, 0, -1.0, 0, 1, 0], np.float32)
    jrec, rec = np.zeros(11), np.zeros(11)
    _, jtmx, _ = JR.reg2d(img, moved, reg_choice=2, flag_tmx=True, tmx=init,
                          ftol=1e-5, it_limit=3000, records=jrec)
    reg, tmx, _ = R.reg2d(img, moved, reg_choice=2, flag_tmx=True, tmx=init,
                          ftol=1e-5, it_limit=3000, records=rec, device="cpu")
    assert abs(rec[3] - jrec[3]) <= 1e-3 and rec[3] > 0.97
    assert abs(rec[1] - jrec[1]) <= 1e-5
    assert _box_error_2d(tmx, jtmx, img.shape) <= 0.35
    assert reg.shape == img.shape and 0 < rec[5] <= 3000
