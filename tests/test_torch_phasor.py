"""The port's phase-correlation registration against the JAX package's on
the CPU: ``reg3d_phasor`` and ``reg2d_phasor`` give the same integer
shifts, on the inputs of tests/test_registration.py (a plain roll, the
wraparound case past size/4 where the box ZNCC decides, and 2-D), on a
shift past size/4 on two axes, and through ``reg3d`` choice 1."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.models import registration as JR
from microimagelib_tpu_torch.models import registration as R
from test_registration import smooth_blobs

torch.set_num_threads(1)


def _wrap_cases():
    vol = smooth_blobs((32, 32, 32), n=12, seed=1)
    yield "roll", vol, np.roll(vol, (7, -3, 5), axis=(0, 1, 2)), (5, -3, 7)
    vol = smooth_blobs((32, 32, 32), n=12, seed=2)
    moved = np.zeros_like(vol)
    moved[:, :, 12:] = vol[:, :, :20]
    yield "wrap x", vol, moved, (12, 0, 0)
    vol = smooth_blobs((24, 32, 28), n=12, seed=5)
    moved = np.zeros_like(vol)
    moved[:-10, 9:, :] = vol[10:, :-9, :]
    yield "wrap y and z", vol, moved, (0, 9, -10)


@pytest.mark.parametrize("case", range(3))
def test_reg3d_phasor_matches_jax(case):
    _name, vol, moved, truth = list(_wrap_cases())[case]
    ref = JR.reg3d_phasor(vol, moved)
    out = R.reg3d_phasor(vol, moved, device="cpu")
    assert out == list(ref) and tuple(out) == truth
    # a CPU tensor stays on the CPU without a device argument
    assert R.reg3d_phasor(torch.from_numpy(vol), torch.from_numpy(moved)) == out


def test_reg2d_phasor_matches_jax():
    img = smooth_blobs((1, 48, 48), n=14, seed=3)[0]
    for moved in (np.roll(img, (4, -6), axis=(0, 1)),
                  np.roll(img, (15, 2), axis=(0, 1))):
        ref = JR.reg2d_phasor(img, moved)
        out = R.reg2d_phasor(img, moved, device="cpu")
        assert out == list(ref)
    wrapped = np.zeros_like(img)
    wrapped[:, 14:] = img[:, :-14]
    assert R.reg2d_phasor(img, wrapped, device="cpu") == list(
        JR.reg2d_phasor(img, wrapped)) == [14, 0]


def test_reg3d_choice_1_matches_jax():
    vol = smooth_blobs((24, 24, 24), n=10, seed=6)
    moved = np.roll(vol, (2, 0, -3), axis=(0, 1, 2))
    jreg, jtmx, _ = JR.reg3d(vol, moved, reg_choice=1)
    reg, tmx, _ = R.reg3d(vol, moved, reg_choice=1, mem_mode=0)
    np.testing.assert_array_equal(tmx, jtmx)
    np.testing.assert_array_equal(reg, np.asarray(jreg))
    assert (tmx[3], tmx[11]) == (-3, 2)
    _, tmx2, _ = R.reg3d(vol, moved, reg_choice=1, mem_mode=0, want_reg=False)
    np.testing.assert_array_equal(tmx2, jtmx)
