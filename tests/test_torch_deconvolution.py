"""The port's single-view RL deconvolution against the JAX package on the
same numpy inputs: OTFs, both routes of rl_decon_single, the three
_rl_loop modes, and decon_singleview in memory mode 0.

The JAX separable route runs as its own tests run it (MIL_CONV_SEP=1:
the Pallas kernel in interpret mode); on the CPU the port's separable
route runs conv3_sep's plain version. Tolerances after a few iterations
are tests/test_conv_sep.py's: rtol = atol/max = 2e-4, 5e-4 for the
tilted PSF (its 1e-4 planning tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.models import deconvolution as JD
from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.models import deconvolution as PD
from test_conv_sep import gauss3, tilted_gauss

torch.set_num_threads(1)

SHAPE = (16, 16, 128)
PSF = gauss3((9, 9, 9), (1.5, 1.2, 1.8))


def _img(rng, shape=SHAPE):
    return (rng.random(shape) * 100 + 1).astype(np.float32)


def _close(out, ref, tol=2e-4):
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("psf,grid", [
    (PSF, SHAPE),
    (gauss3((8, 8, 8), (1.2, 1.2, 1.2)), (16, 16, 32)),
    (gauss3((5, 21, 9), (1.0, 3.0, 1.5)), (16, 16, 32)),   # oversized in y
])
def test_gen_otf_matches_jax(psf, grid):
    out = PD.gen_otf(psf, grid, device="cpu").numpy()
    ref = np.asarray(JD.gen_otf(jnp.asarray(psf), grid))
    np.testing.assert_allclose(out, ref, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("const_initial", [False, True])
def test_rl_sep_route_matches_jax_sep(rng, monkeypatch, const_initial):
    img = _img(rng)
    monkeypatch.setenv("MIL_CONV_SEP", "1")   # JAX: separable, interpret
    monkeypatch.setenv("MIL_CONV_SEP_FUSED", "0")
    ref = np.asarray(JD.rl_decon_single(jnp.asarray(img), None, None, 5,
                                        const_initial, psf=PSF))
    before = K.LAUNCHES
    out = PD.rl_decon_single(torch.from_numpy(img), None, None, 5,
                             const_initial, psf=PSF).numpy()
    assert K.LAUNCHES == before   # CPU: plain version, no kernel launch
    _close(out, ref)


def test_rl_fft_route_with_jax_otfs(rng, monkeypatch):
    """MIL_CONV_SEP=0 forces the FFT route; OTFs built by the JAX package
    are accepted as numpy arrays, so both packages use one operator."""
    img = _img(rng)
    otf = JD.gen_otf(jnp.asarray(PSF), SHAPE)
    otf_bp = JD.gen_otf(jnp.asarray(PSF[::-1, ::-1, ::-1]), SHAPE)
    ref = np.asarray(JD.rl_decon_single(jnp.asarray(img), otf, otf_bp, 5))
    monkeypatch.setenv("MIL_CONV_SEP", "0")
    out = PD.rl_decon_single(img, np.asarray(otf), np.asarray(otf_bp), 5,
                             psf=PSF, device="cpu").numpy()
    _close(out, ref)
    # a refused/forced-off plan with no OTFs builds them from the PSFs
    out2 = PD.rl_decon_single(img, None, None, 5, psf=PSF, device="cpu").numpy()
    _close(out2, ref)


@pytest.mark.parametrize("loop", ["accel", "stop", "accel+stop"])
def test_rl_loop_modes_match_jax(rng, monkeypatch, loop):
    """Biggs-Andrews acceleration (MIL_RL_ACCEL) and the early stop
    (stop_tol) give the JAX loop's result, through both routes."""
    img = _img(rng)
    stop = 2e-3 if "stop" in loop else None
    monkeypatch.setenv("MIL_RL_ACCEL", "1" if "accel" in loop else "0")
    otf = JD.gen_otf(jnp.asarray(PSF), SHAPE)
    otf_bp = JD.gen_otf(jnp.asarray(PSF[::-1, ::-1, ::-1]), SHAPE)
    ref = np.asarray(JD.rl_decon_single(jnp.asarray(img), otf, otf_bp, 12,
                                        stop_tol=stop))
    sep = PD.rl_decon_single(img, None, None, 12, psf=PSF,
                             stop_tol=stop, device="cpu").numpy()
    _close(sep, ref)
    monkeypatch.setenv("MIL_CONV_SEP", "0")
    fft = PD.rl_decon_single(img, None, None, 12, psf=PSF,
                             stop_tol=stop, device="cpu").numpy()
    _close(fft, ref)


def test_rl_loop_stop_tol_stops_early():
    calls = []

    def step(x):
        calls.append(1)
        return x * 0.5 + 1.0    # converges to 2: updates shrink by half

    est0 = torch.full((4,), 10.0)
    PD._rl_loop(step, est0, 100, accel=False, stop_tol=1e-3)
    assert 5 < len(calls) < 100
    calls.clear()
    PD._rl_loop(step, est0, 7, accel=False, stop_tol=None)
    assert len(calls) == 7


def test_rl_unmatched_bp_matches_jax(rng, monkeypatch):
    img = _img(rng)
    bp = gauss3((7, 7, 7), (1.0, 1.0, 1.0))
    monkeypatch.setenv("MIL_CONV_SEP", "1")
    ref = np.asarray(JD.rl_decon_single(jnp.asarray(img), None, None, 4,
                                        psf=PSF, psf_bp=bp))
    out = PD.rl_decon_single(img, None, None, 4, psf=PSF, psf_bp=bp,
                             device="cpu").numpy()
    _close(out, ref)


def test_rl_tilted_psf_takes_rolled_sep_route(rng):
    """The tilted measured-PSF class plans at rank > 1 with per-tap rolls
    on the default tolerance cascade, and its RL result matches the JAX
    FFT-route RL."""
    shape = (32, 32, 128)
    img = _img(rng, shape)
    psf = tilted_gauss((17, 9, 25))
    bp = np.ascontiguousarray(psf[::-1, ::-1, ::-1])
    kind, (fwd, bpp) = PD._sep_plans(psf, bp, shape)
    assert kind == "pair"
    assert fwd.rank > 1 and fwd.rolls is not None and bpp.rolls is not None
    ref = np.asarray(JD.rl_decon_single(
        jnp.asarray(img), JD.gen_otf(jnp.asarray(psf), shape),
        JD.gen_otf(jnp.asarray(bp), shape), 4))
    out = PD.rl_decon_single(img, None, None, 4, psf=psf, device="cpu").numpy()
    _close(out, ref, 5e-4)


@pytest.mark.parametrize("const_initial", [False, True])
def test_decon_singleview_cpu_matches_jax(rng, const_initial):
    img = (rng.random((20, 30, 40)) * 100 + 5).astype(np.float32)
    psf = gauss3((7, 7, 7), (1.2, 1.0, 1.5))
    rec_p, rec_j = np.zeros(10), np.zeros(10)
    out = PD.decon_singleview(img, psf, n_iters=5, const_initial=const_initial,
                              mem_mode=0, records=rec_p)
    ref = JD.decon_singleview(img, psf, n_iters=5, const_initial=const_initial,
                              mem_mode=0, records=rec_j)
    assert out.shape == ref.shape == img.shape and out.dtype == np.float32
    _close(out, ref)
    assert PD._fft_grid(img.shape) == (32, 32, 64)
    assert rec_p[0] == rec_j[0] == 0
    assert (rec_p[1:6] == -1).all()          # no device memory on the CPU
    assert (rec_p[6:] >= 0).all() and rec_p[9] >= rec_p[8]


def test_mem_modes_without_cuda(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _img(rng, (8, 8, 16))
    psf = gauss3((3, 3, 3), (1.0, 1.0, 1.0))
    # every mode but 0 defaults to the card and raises without one; none
    # falls back to the CPU (mode 2 streams through the card)
    for mode in (1, -1, 2):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PD.decon_singleview(img, psf, n_iters=1, mem_mode=mode)
    with pytest.raises(ValueError):
        PD.decon_singleview(img, psf, n_iters=1, mem_mode=3)


# --------------------------------------------------------------------------
# joint dual view
# --------------------------------------------------------------------------

PSF_B = gauss3((9, 9, 9), (1.2, 1.8, 1.2))


def _otfs(psf_a, psf_b, shape, bp_a=None, bp_b=None):
    """The four OTFs built by the JAX package (A, B, back A, back B)."""
    bp_a = psf_a[::-1, ::-1, ::-1] if bp_a is None else bp_a
    bp_b = psf_b[::-1, ::-1, ::-1] if bp_b is None else bp_b
    return [JD.gen_otf(jnp.asarray(np.ascontiguousarray(p)), shape)
            for p in (psf_a, psf_b, bp_a, bp_b)]


@pytest.mark.parametrize("const_initial", [False, True])
def test_rl_dual_fft_route_with_jax_otfs(rng, const_initial):
    a, b = _img(rng), _img(rng)
    otfs = _otfs(PSF, PSF_B, SHAPE)
    ref = np.asarray(JD.rl_decon_dual(jnp.asarray(a), jnp.asarray(b), *otfs,
                                      4, const_initial))
    out = PD.rl_decon_dual(a, b, *(np.asarray(o) for o in otfs), 4,
                           const_initial, device="cpu").numpy()
    _close(out, ref)


@pytest.mark.parametrize("const_initial", [False, True])
def test_rl_dual_sep_route_matches_jax_sep(rng, monkeypatch, const_initial):
    """Both views separable: two K1 calls per view and iteration (the plain
    version on the CPU); JAX runs its separable kernel in interpret mode."""
    a, b = _img(rng), _img(rng)
    monkeypatch.setenv("MIL_CONV_SEP", "1")
    monkeypatch.setenv("MIL_CONV_SEP_FUSED", "0")
    ref = np.asarray(JD.rl_decon_dual(jnp.asarray(a), jnp.asarray(b), None,
                                      None, None, None, 3, const_initial,
                                      psf_a=PSF, psf_b=PSF_B))
    calls = []
    monkeypatch.setattr(PD, "conv3_sep",
                        lambda *args, **kw: calls.append(1) or K.conv3_sep(*args, **kw))
    out = PD.rl_decon_dual(torch.from_numpy(a), torch.from_numpy(b), None,
                           None, None, None, 3, const_initial, psf_a=PSF,
                           psf_b=PSF_B).numpy()
    assert len(calls) == 2 * 2 * 3
    _close(out, ref)


def test_rl_dual_wb_back_projectors_take_fft_route(rng, monkeypatch):
    """Wiener-Butterworth back projectors are refused by the separable
    planner, so the loop builds all four OTFs and runs the FFT route."""
    from microimagelib_tpu.models.backprojector import gen_backprojector

    a, b = _img(rng), _img(rng)
    bp_a, bp_b = gen_backprojector(PSF), gen_backprojector(PSF_B)
    assert PD._sep_plans(PSF, bp_a, SHAPE) is None
    ref = np.asarray(JD.rl_decon_dual(jnp.asarray(a), jnp.asarray(b), None,
                                      None, None, None, 2, psf_a=PSF,
                                      psf_b=PSF_B, psf_bp_a=bp_a,
                                      psf_bp_b=bp_b))
    monkeypatch.setattr(PD, "conv3_sep", None)     # must not be reached
    out = PD.rl_decon_dual(a, b, None, None, None, None, 2, psf_a=PSF,
                           psf_b=PSF_B, psf_bp_a=bp_a, psf_bp_b=bp_b,
                           device="cpu").numpy()
    _close(out, ref)


def test_rl_dual_ct_route_matches_jax_pallas(monkeypatch):
    """MIL_FFT_IMPL=pallas on both sides: JAX's Pallas CT convolution in
    interpret mode, the port's conv3_ct (its plain version on the CPU).
    Tolerance 2e-3, tests/test_fft_pallas.py's pallas-vs-xla RL bound."""
    shape = (32, 32, 128)
    rng = np.random.default_rng(4)
    a, b = _img(rng, shape), _img(rng, shape)
    psf_b = gauss3((7, 7, 7), (1.0, 1.0, 2.0))
    otfs = _otfs(gauss3((7, 7, 7), (1.5, 1.0, 1.0)), psf_b, shape)
    monkeypatch.setenv("MIL_FFT_IMPL", "pallas")
    ref = np.asarray(JD.rl_decon_dual(jnp.asarray(a), jnp.asarray(b), *otfs, 2))
    out = PD.rl_decon_dual(a, b, *(np.asarray(o) for o in otfs), 2,
                           device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("wb", [False, True], ids=["matched", "wb"])
def test_decon_dualview_cpu_matches_jax(rng, wb):
    """(20, 30, 40) pads to the (32, 32, 64) grid and is cropped back."""
    from microimagelib_tpu_torch.models import gen_backprojector

    shape = (20, 30, 40)
    a = (rng.random(shape) * 100 + 5).astype(np.float32)
    b = (rng.random(shape) * 100 + 5).astype(np.float32)
    psf_a = gauss3((7, 7, 7), (1.2, 1.0, 1.5))
    psf_b = gauss3((7, 7, 7), (1.5, 1.0, 1.2))
    bps = ((gen_backprojector(psf_a), gen_backprojector(psf_b)) if wb
           else (None, None))
    rec_p, rec_j = np.zeros(10), np.zeros(10)
    out = PD.decon_dualview(a, b, psf_a, psf_b, n_iters=3, psf_bp_a=bps[0],
                            psf_bp_b=bps[1], mem_mode=0, records=rec_p)
    ref = JD.decon_dualview(a, b, psf_a, psf_b, n_iters=3, psf_bp_a=bps[0],
                            psf_bp_b=bps[1], mem_mode=0, records=rec_j)
    assert out.shape == ref.shape == shape and out.dtype == np.float32
    _close(out, ref)
    assert rec_p[0] == rec_j[0] == 0 and (rec_p[1:6] == -1).all()
    assert (rec_p[6:] >= 0).all() and rec_p[9] >= rec_p[8]


def test_decon_dualview_one_bp_is_matched(rng):
    """Unmatched back projectors apply only when both are given."""
    shape = (16, 16, 32)
    a, b = _img(rng, shape), _img(rng, shape)
    psf = gauss3((5, 5, 5), (1.0, 1.0, 1.0))
    bp = gauss3((3, 3, 3), (0.8, 0.8, 0.8))
    one = PD.decon_dualview(a, b, psf, psf, 2, psf_bp_a=bp, mem_mode=0)
    none = PD.decon_dualview(a, b, psf, psf, 2, mem_mode=0)
    np.testing.assert_array_equal(one, none)


def test_decon_dualview_size_mismatch_and_modes(rng, monkeypatch):
    psf = gauss3((3, 3, 3), (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="must match in size"):
        PD.decon_dualview(_img(rng, (8, 8, 16)), _img(rng, (8, 8, 17)), psf,
                          psf, 1, mem_mode=0)
    a = _img(rng, (8, 8, 16))
    # mode 2 (the streamed RL) runs where it is asked to, here the CPU,
    # and agrees with mode 0 (tests/test_decon_streamed.py's 2e-3)
    rec = np.zeros(10)
    streamed = PD.decon_dualview(a, a, psf, psf, 2, mem_mode=2, device="cpu",
                                 records=rec)
    assert rec[0] == 2
    _close(streamed, PD.decon_dualview(a, a, psf, psf, 2, mem_mode=0), 2e-3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in (-1, 2):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PD.decon_dualview(a, a, psf, psf, 1, mem_mode=mode)


def test_workingset_tiers():
    assert PD._workingset_bytes((64, 64, 64), True) == 9 * 64 ** 3 * 4
    assert PD._workingset_bytes((64, 64, 64), False) == 6 * 64 ** 3 * 4


def test_decon_dualview_prepared_and_batch_match_jax(rng):
    grid, out_shape = (16, 32, 64), (12, 30, 50)
    pads_a = np.stack([_img(rng, grid) for _ in range(2)])
    pads_b = np.stack([_img(rng, grid) for _ in range(2)])
    otfs = _otfs(PSF, PSF_B, grid)
    otfs_np = [np.asarray(o) for o in otfs]
    ref = np.asarray(JD.decon_dualview_prepared(
        jnp.asarray(pads_a[0]), jnp.asarray(pads_b[0]), *otfs, 3, False,
        out_shape))
    out = PD.decon_dualview_prepared(torch.from_numpy(pads_a[0]),
                                     torch.from_numpy(pads_b[0]), *otfs_np, 3,
                                     False, out_shape).numpy()
    assert out.shape == out_shape
    _close(out, ref)
    for const_initial in (False, True):
        ref_b = np.asarray(JD.decon_dualview_prepared_batch(
            jnp.asarray(pads_a), jnp.asarray(pads_b), *otfs, 3,
            const_initial, out_shape))
        out_b = PD.decon_dualview_prepared_batch(
            torch.from_numpy(pads_a), torch.from_numpy(pads_b), *otfs_np, 3,
            const_initial, out_shape).numpy()
        assert out_b.shape == (2, *out_shape)
        _close(out_b, ref_b)
