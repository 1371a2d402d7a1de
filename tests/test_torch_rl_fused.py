"""K2's plain version and the fused RL route against the JAX package on the
CPU: ``rl_iter_fused_torch`` against the JAX ``rl_iter_fused`` (its Pallas
kernel in interpret mode) at the shapes of tests/test_conv_sep.py, the
``MIL_CONV_SEP_FUSED=1`` single- and dual-view loops end to end, the mixed
fused/pair coercion, and what ``plan_rl_fused`` accepts and refuses.

Tolerances: one iteration 2e-5 x max (tests/test_conv_sep.py: same taps,
the z/xy rounding order differs); after a few iterations rtol = atol/max =
2e-4, 5e-4 with a tilted PSF (its 1e-4 planning tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.models import deconvolution as JD
from microimagelib_tpu.ops.conv_sep import plan_rl_fused as jax_plan_rl_fused
from microimagelib_tpu.ops.conv_sep import rl_iter_fused as jax_rl_iter_fused
from microimagelib_tpu_torch.kernels import rl_fused as KF
from microimagelib_tpu_torch.models import deconvolution as PD
from microimagelib_tpu_torch.ops.conv_sep import (
    RLFusedPlan,
    conv3_sep_torch,
    plan_rl_fused,
    plan_sep_pair,
    rl_iter_fused,
    rl_iter_fused_torch,
)
from test_conv_sep import gauss3, tilted_gauss

torch.set_num_threads(1)

SHAPE = (16, 16, 128)
PSF = gauss3((9, 9, 9), (1.5, 1.2, 1.8))


def flip(p):
    return np.ascontiguousarray(p[::-1, ::-1, ::-1])


def _img(rng, shape=SHAPE):
    return (rng.random(shape) * 100 + 1).astype(np.float32)


def _close(out, ref, tol):
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(16, 16, 128), (32, 16, 128), (64, 8, 128)])
def test_rl_iter_fused_matches_jax(rng, shape):
    est, img = _img(rng, shape), _img(rng, shape)
    ref = np.asarray(jax_rl_iter_fused(jnp.asarray(est), jnp.asarray(img),
                                       jax_plan_rl_fused(PSF, flip(PSF), shape)))
    plan = plan_rl_fused(PSF, flip(PSF), shape)
    before = KF.LAUNCHES
    out = rl_iter_fused(torch.from_numpy(est), torch.from_numpy(img), plan)
    assert KF.LAUNCHES == before     # CPU: the plain version, no launch
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5 * np.abs(ref).max())
    # the plain version is K1's plain version in ratio, then update mode
    ratio = conv3_sep_torch(torch.from_numpy(est), plan.fwd,
                            aux=torch.from_numpy(img), mode="ratio")
    upd = conv3_sep_torch(ratio, plan.bp, aux=torch.from_numpy(est),
                          mode="update")
    np.testing.assert_array_equal(out.numpy(), upd.numpy())


def test_rl_iter_fused_checks_inputs(rng):
    plan = plan_rl_fused(PSF, flip(PSF), SHAPE)
    est = torch.from_numpy(_img(rng))
    with pytest.raises(ValueError, match="shape"):
        rl_iter_fused(est[:8].contiguous(), est[:8].contiguous(), plan)
    with pytest.raises(TypeError):
        rl_iter_fused(est.double(), est, plan)
    with pytest.raises(ValueError, match="contiguous"):
        rl_iter_fused(est, est.repeat(1, 1, 2)[:, :, ::2], plan)
    np.testing.assert_array_equal(
        rl_iter_fused_torch(est, est, plan, 0.5).numpy(),
        rl_iter_fused(est, est, plan, 0.5).numpy())


def test_plan_rl_fused_takes_the_fusion_psfs_and_refuses_rolls():
    """The fusion PSFs' z reach of 12 (25 z taps), which the TPU planner
    refuses, plans here; so does a rank-4 pair. A pick with per-tap rolls
    (the recentered tilted form) is refused, as in the JAX package."""
    pa = gauss3((25, 25, 25), (3.5, 1.2, 1.2))
    pb = gauss3((25, 25, 25), (1.2, 1.2, 3.5))
    shape = (32, 32, 64)
    fa = plan_rl_fused(pa, flip(pa), shape)
    assert isinstance(fa, RLFusedPlan) and fa.shape == shape
    assert (fa.fwd.a, fa.fwd.b, fa.fwd.nsteps) == (12, 12, 25)
    assert fa.fwd.rolls is None and fa.bp.rolls is None
    assert jax_plan_rl_fused(pa, flip(pa), shape) is None
    fb = plan_rl_fused(pb, flip(pb), shape)
    assert fb is not None and fb.fwd.tx.shape[1] == 25
    r4 = gauss3((7, 9, 11), (1.0, 1.5, 2.0)) + 0.3 * gauss3((7, 9, 11), (2.0, 1.0, 0.8))
    f4 = plan_rl_fused(r4, flip(r4), SHAPE)
    assert f4 is not None and f4.fwd.rank >= 2
    tilted = tilted_gauss((17, 9, 25))
    pair = plan_sep_pair(tilted, flip(tilted), (32, 32, 128), tol=1e-4)
    assert pair[0].rolls is not None
    assert plan_rl_fused(tilted, flip(tilted), (32, 32, 128), tol=1e-4) is None


def _route_counter(monkeypatch):
    """Count K2 calls on the decon path; K1 must not be reached."""
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return rl_iter_fused(*args, **kw)

    monkeypatch.setattr(PD, "rl_iter_fused", counted)
    monkeypatch.setattr(PD, "conv3_sep", None)
    return calls


@pytest.mark.parametrize("const_initial", [False, True])
def test_single_view_fused_route_matches_jax(rng, monkeypatch, const_initial):
    img = _img(rng)
    monkeypatch.setenv("MIL_CONV_SEP", "1")        # JAX: separable, interpret
    monkeypatch.setenv("MIL_CONV_SEP_FUSED", "1")
    ref = np.asarray(JD.rl_decon_single(jnp.asarray(img), None, None, 3,
                                        const_initial, psf=PSF))
    assert PD._sep_plans(PSF, flip(PSF), SHAPE)[0] == "fused"
    calls = _route_counter(monkeypatch)
    out = PD.rl_decon_single(img, None, None, 3, const_initial, psf=PSF).numpy()
    assert len(calls) == 3
    _close(out, ref, 2e-4)


def test_dual_view_fused_route_matches_jax(rng, monkeypatch):
    img_a, img_b = _img(rng), _img(rng)
    psf_b = gauss3((9, 9, 9), (1.0, 1.8, 1.2))
    monkeypatch.setenv("MIL_CONV_SEP", "1")
    monkeypatch.setenv("MIL_CONV_SEP_FUSED", "1")
    ref = np.asarray(JD.rl_decon_dual(jnp.asarray(img_a), jnp.asarray(img_b),
                                      None, None, None, None, 3,
                                      psf_a=PSF, psf_b=psf_b))
    calls = _route_counter(monkeypatch)
    out = PD.rl_decon_dual(img_a, img_b, None, None, None, None, 3,
                           psf_a=PSF, psf_b=psf_b).numpy()
    assert len(calls) == 6                         # two per iteration
    _close(out, ref, 2e-4)
    # decon_dualview takes the same route
    calls.clear()
    PD.decon_dualview(img_a, img_b, PSF, psf_b, n_iters=2, mem_mode=0)
    assert len(calls) == 4


def test_fused_off_by_default(rng, monkeypatch):
    monkeypatch.delenv("MIL_CONV_SEP_FUSED", raising=False)
    assert PD._sep_plans(PSF, flip(PSF), SHAPE)[0] == "pair"
    monkeypatch.setattr(PD, "rl_iter_fused", None)   # must not be reached
    PD.rl_decon_single(_img(rng), None, None, 2, psf=PSF)


def test_mixed_fused_and_pair_run_as_pairs(rng, monkeypatch):
    """View A plans fused, view B (tilted: its pick carries rolls) as a
    pair: both views run as K1 pairs, and the result matches JAX's."""
    shape = (32, 32, 128)
    img_a, img_b = _img(rng, shape), _img(rng, shape)
    psf_b = tilted_gauss((17, 9, 25))
    monkeypatch.setenv("MIL_CONV_SEP_FUSED", "1")
    assert PD._sep_plans(PSF, flip(PSF), shape)[0] == "fused"
    assert PD._sep_plans(psf_b, flip(psf_b), shape)[0] == "pair"
    ref = np.asarray(JD.rl_decon_dual(
        jnp.asarray(img_a), jnp.asarray(img_b),
        *(JD.gen_otf(jnp.asarray(p), shape)
          for p in (PSF, psf_b, flip(PSF), flip(psf_b))), 3))
    monkeypatch.setattr(PD, "rl_iter_fused", None)   # must not be reached
    launches = []
    real = PD.conv3_sep

    def counted(*args, **kw):
        launches.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(PD, "conv3_sep", counted)
    out = PD.rl_decon_dual(img_a, img_b, None, None, None, None, 3,
                           psf_a=PSF, psf_b=psf_b).numpy()
    assert len(launches) == 12                     # 2 views x 2 x 3 iterations
    _close(out, ref, 5e-4)
    assert PD._as_pair(PD._sep_plans(PSF, flip(PSF), shape))[0].rank == 1
