"""The ``hybrid`` registration engine against the JAX package's on the CPU:
Powell's ``linmin_fn`` hook, the device line minimization
(``linmin_reg_device``) and ``reg3d_affine(engine="hybrid")``.

Bounds: on analytic float32 costs the hooked Powell gives JAX's point
within 1e-4, its f within 1e-6 and no more than 10% more evaluations
(tests/test_torch_optim.py's bounds for the float32 optimizers); on the
registration pair the final NCC within 1e-3 of JAX's and the translations
within 0.35 voxel (tests/test_torch_registration.py's bounds: the port's
cost takes K5's coordinate order, the JAX one on the CPU the gather's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.models import registration as JR
from microimagelib_tpu.models import registration_device as JRD
from microimagelib_tpu.ops import powell_device as JPD
from microimagelib_tpu.ops.powell import powell as jax_powell
from microimagelib_tpu_torch.kernels import corr as K
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.models import registration_device as PRD
from microimagelib_tpu_torch.ops.powell_device import BRENT_ITMAX, MNBRAK_MAX, _linmin
from microimagelib_tpu_torch.ops.powell import EvalCounter, powell
from test_registration_grad import _pair
from test_torch_optim import _C3, COSTS

torch.set_num_threads(1)

SHAPE = (16, 24, 20)


@pytest.fixture(scope="module")
def pair():
    return _pair(shape=SHAPE)


def _hooked(f_np):
    def linmin_fn(p, xi):
        return _linmin(f_np, np.asarray(p, np.float32), np.asarray(xi, np.float32))
    return linmin_fn


@pytest.mark.parametrize("name", list(COSTS))
def test_powell_linmin_fn_matches_jax(name):
    make, p0 = COSTS[name]
    if name == "bowl":   # start under the 1.001 abort
        p0 = _C3 - np.float32(0.5)
    ftol, it_limit = 1e-6, 3000
    fj = make(jnp)
    jlin = jax.jit(lambda p, xi: JPD._linmin(fj, p, xi))
    jp, jf, jit, jc = jax_powell(
        p0, lambda p: float(fj(jnp.asarray(p, jnp.float32))), ftol, it_limit,
        linmin_fn=lambda p, xi: jlin(jnp.asarray(p, jnp.float32),
                                     jnp.asarray(xi, jnp.float32)))
    fn = make(np)
    calls = [0]

    def counted(p):
        calls[0] += 1
        return float(fn(np.asarray(p, np.float32)))

    def linmin_fn(p, xi):
        out = _hooked(fn)(p, xi)
        calls[0] += out[3]
        return out

    p, f, it, counter = powell(p0, counted, ftol, it_limit, linmin_fn=linmin_fn)
    assert counter.count == calls[0]        # the hook's evaluations count
    assert it == jit                        # the same direction-set sweeps
    np.testing.assert_allclose(p, jp, atol=1e-4)
    assert abs(f - jf) <= 1e-6
    assert counter.count <= jc.count * 1.1 and jc.count > 1


def test_linmin_fn_evaluations_count_toward_it_limit():
    make, p0 = COSTS["well"]
    fn = make(np)
    counter = EvalCounter(lambda p: float(fn(np.asarray(p, np.float32))))
    _, _, _, counter = powell(p0, None, 1e-12, 40, counter=counter,
                              linmin_fn=_hooked(fn))
    # the cap is checked between line minimizations, as without the hook
    assert 40 <= counter.count < 40 + MNBRAK_MAX * 3 + BRENT_ITMAX


def test_linmin_reg_device_matches_jax(pair):
    vol, moved = pair
    src_ms = moved - moved.mean()
    tgt_ms = vol - vol.mean()
    sd_t = float(np.sqrt((tgt_ms.astype(np.float64) ** 2).sum()))
    s_t, t_t = torch.from_numpy(src_ms), torch.from_numpy(tgt_ms)
    for mode, p, xi in (("dof6", np.zeros(6), np.eye(6)[4]),
                        ("p12", np.array([0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1.0]),
                         np.eye(12)[1])):
        got = PRD.linmin_reg_device(s_t, t_t, sd_t, p, xi, mode)
        ref = JRD.linmin_reg_device(jnp.asarray(src_ms), jnp.asarray(tgt_ms),
                                    jnp.float32(sd_t), jnp.asarray(p, jnp.float32),
                                    jnp.asarray(xi, jnp.float32), mode)
        np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=1e-3)
        assert abs(float(got[2]) - float(ref[2])) <= 1e-5
        f0 = PRD.cost_eval_reg_device(s_t, t_t, sd_t, p, mode)
        assert abs(float(f0) - float(JRD.cost_eval_reg_device(
            jnp.asarray(src_ms), jnp.asarray(tgt_ms), jnp.float32(sd_t),
            jnp.asarray(p, jnp.float32), mode))) <= 1e-5
        assert float(got[2]) <= float(f0)


@pytest.mark.parametrize("method", [1, 5])
def test_reg3d_affine_hybrid_matches_jax(pair, method):
    vol, moved = pair
    ref = JR.reg3d_affine(vol, moved, aff_method=method, ftol=1e-4, it_limit=3000,
                          engine="hybrid")
    plain = K.PLAIN_CALLS
    reg, tmx, rec = R.reg3d_affine(vol, moved, aff_method=method, ftol=1e-4,
                                   it_limit=3000, engine="hybrid", mem_mode=0)
    _jreg, jtmx, jrec = ref
    assert abs(rec[3] - jrec[3]) <= 1e-3, (rec[3], jrec[3])
    np.testing.assert_allclose(tmx[[3, 7, 11]], jtmx[[3, 7, 11]], atol=0.35)
    assert R.checkmatrix(tmx, SHAPE[2], SHAPE[1], SHAPE[0])
    assert reg.shape == SHAPE and rec[3] >= rec[1]
    # every evaluation is one K5 call (its plain version here), the initial
    # cost included; the count near JAX's
    assert K.PLAIN_CALLS - plain == rec[5] + 1
    assert rec[5] <= 1.25 * jrec[5] + 10
    if method == 1:
        np.testing.assert_allclose(np.asarray(tmx, np.float64).reshape(3, 4)[:, :3],
                                   np.eye(3), atol=1e-6)


def test_hybrid_from_the_environment(pair, monkeypatch):
    vol, moved = pair
    monkeypatch.setenv("MIL_REG_ENGINE", "hybrid")
    _, tmx, rec = R.reg3d_affine(vol, moved, aff_method=1, mem_mode=0)
    monkeypatch.delenv("MIL_REG_ENGINE")
    _, tmx2, rec2 = R.reg3d_affine(vol, moved, aff_method=1, mem_mode=0,
                                   engine="hybrid")
    np.testing.assert_array_equal(tmx, tmx2)
    assert rec[5] == rec2[5]
