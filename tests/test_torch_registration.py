"""The port's 3D affine registration against the JAX package's on the CPU,
engine for engine: ``reg3d_affine`` with methods 1 and 7 on the ``grad``
(L-BFGS + Powell finisher) and ``device`` (Powell ladder) engines, on the
(16, 24, 20) pair of tests/test_registration_grad.py.

Bounds: the final NCC (records[3]) within 1e-3 of JAX's, the translations
within 0.35 voxel of JAX's (tests/test_registration.py's bound on the
truth), and the plausibility gate holds."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.models.registration import reg3d_affine as jax_reg3d_affine
from microimagelib_tpu_torch.kernels import corr as K
from microimagelib_tpu_torch.models import registration as R
from test_registration_grad import _pair

torch.set_num_threads(1)

SHAPE = (16, 24, 20)


@pytest.fixture(scope="module")
def pair():
    return _pair(shape=SHAPE)


def _check_against_jax(got, ref, shape):
    (reg, tmx, rec), (_jreg, jtmx, jrec) = got, ref
    assert abs(rec[3] - jrec[3]) <= 1e-3, (rec[3], jrec[3])
    np.testing.assert_allclose(tmx[[3, 7, 11]], jtmx[[3, 7, 11]], atol=0.35)
    sz, sy, sx = shape
    assert R.checkmatrix(tmx, sx, sy, sz)
    assert reg.shape == tuple(shape) and reg.dtype == np.float32
    # records: initial NCC, final NCC >= initial, per-eval ms, evals, times
    assert abs(rec[1] - jrec[1]) <= 1e-5
    assert rec[3] >= rec[1] and rec[4] > 0 and rec[6] > 0 and rec[7] >= rec[6]


@pytest.mark.parametrize("engine", ["grad", "device"])
@pytest.mark.parametrize("method", [1, 7])
def test_reg3d_affine_matches_jax(pair, method, engine):
    vol, moved = pair
    ref = jax_reg3d_affine(vol, moved, aff_method=method, ftol=1e-4,
                           it_limit=3000, engine=engine)
    plain = K.PLAIN_CALLS
    got = R.reg3d_affine(vol, moved, aff_method=method, ftol=1e-4,
                         it_limit=3000, engine=engine, mem_mode=0)
    _check_against_jax(got, ref, SHAPE)
    rec = got[2]
    # every evaluation is one call of a plain version on the CPU (plus the
    # initial cost); the count stays under the cap and near JAX's
    assert 0 < rec[5] <= 3000
    assert K.PLAIN_CALLS - plain == rec[5] + 1
    assert rec[5] <= 1.25 * ref[2][5] + 10
    if method == 1:
        a = np.asarray(got[1], np.float64).reshape(3, 4)[:, :3]
        np.testing.assert_allclose(a, np.eye(3), atol=1e-6)


def test_host_engine_and_it_limit(pair):
    """engine='host' (NR Powell in float64, one cost call per evaluation)
    registers as well as JAX's; a small it_limit caps the evaluations."""
    vol, moved = pair
    _, jtmx, jrec = jax_reg3d_affine(vol, moved, aff_method=1, ftol=1e-4,
                                     it_limit=3000, engine="host")
    _, tmx, rec = R.reg3d_affine(vol, moved, aff_method=1, ftol=1e-4,
                                 it_limit=3000, engine="host", mem_mode=0)
    assert abs(rec[3] - jrec[3]) <= 1e-3
    np.testing.assert_allclose(tmx[[3, 7, 11]], jtmx[[3, 7, 11]], atol=0.35)
    for engine in ("grad", "device", "host"):
        _, _, rec = R.reg3d_affine(vol, moved, aff_method=7, it_limit=40,
                                   engine=engine, mem_mode=0)
        # the shared cap is checked between line searches, and each of the
        # four ladder stages starts with one, as in the JAX package
        assert 0 < rec[5] <= 40 + 4 * 60, engine


def test_engine_auto_and_env(pair, monkeypatch):
    """'auto' on CPU tensors is the Powell ladder, as in JAX;
    MIL_REG_ENGINE=grad routes 'auto' to the gradient ladder."""
    vol, moved = pair
    _, _, rec_auto = R.reg3d_affine(vol, moved, aff_method=1, mem_mode=0)
    _, _, rec_dev = R.reg3d_affine(vol, moved, aff_method=1, mem_mode=0,
                                   engine="device")
    assert rec_auto[5] == rec_dev[5] and rec_auto[3] == rec_dev[3]
    monkeypatch.setenv("MIL_REG_ENGINE", "grad")
    _, _, rec = R.reg3d_affine(vol, moved, aff_method=1, mem_mode=0, it_limit=500)
    _, _, rec_g = R.reg3d_affine(vol, moved, aff_method=1, mem_mode=0,
                                 it_limit=500, engine="grad")
    assert rec[5] == rec_g[5] and rec[3] == rec_g[3] and rec[5] <= 500


def test_not_ported_raise(pair):
    vol, moved = pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        R.reg3d_affine(vol, moved, aff_method=1, mem_mode=0, engine="hybrid")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        R.reg3d_affine(vol, moved, aff_method=1, mem_mode=2)
    for choice in (1, 3, 4):
        with pytest.raises(NotImplementedError, match="queue 3"):
            R.reg3d(vol, moved, reg_choice=choice, mem_mode=0)


def test_needs_cuda_outside_mode_0(pair, monkeypatch):
    vol, moved = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.reg3d(vol, moved, reg_choice=2, aff_method=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.reg3d_affine(vol, moved, aff_method=1, mem_mode=1)
