"""The port's beyond-HBM RL tier (models/decon_streamed.py and memory mode
2 of the decon entries) against the JAX package's on the CPU.

The numpy helpers and the chunk plan are copies: equal. The streamed RL
runs its chunks here on the CPU (``device="cpu"``); against the JAX
package's streamed RL and the port's resident RL the bound is
tests/test_decon_streamed.py's rtol = atol/max = 2e-3, with budgets that
split both streamed axes and axes that are not powers of two. The OTF the
port builds on the device matches ``np_gen_otf`` at that file's rtol 1e-4,
atol 1e-7."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.models import decon_streamed as JS
from microimagelib_tpu.models import deconvolution as JD
from microimagelib_tpu_torch.models import decon_streamed as PS
from microimagelib_tpu_torch.models import deconvolution as PD

torch.set_num_threads(1)


def _gauss(r=2, sigma=1.2):
    z, y, x = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    g = np.exp(-(x * x + y * y + z * z) / (2 * sigma ** 2)).astype(np.float32)
    return g / g.sum()


def _img(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 100 + 1).astype(np.float32)


def _close(out, ref, tol=2e-3):
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("shape,out", [((10, 12, 14), (16, 16, 16)),
                                       ((7, 9, 30), (16, 16, 32)),
                                       ((16, 16, 16), (16, 16, 16))])
def test_np_helpers_equal_jax(shape, out):
    img = _img(shape, 1)
    np.testing.assert_array_equal(PS.np_pad_stack_edge(img, out),
                                  JS.np_pad_stack_edge(img, out))
    np.testing.assert_array_equal(PS.np_align_size_3d(img, out),
                                  JS.np_align_size_3d(img, out))
    np.testing.assert_array_equal(PS.np_align_size_3d(img, (5, 20, 8)),
                                  JS.np_align_size_3d(img, (5, 20, 8)))
    np.testing.assert_array_equal(PS.np_crop_center(PS.np_pad_stack_edge(img, out), shape),
                                  JS.np_crop_center(JS.np_pad_stack_edge(img, out), shape))
    for psf in (_gauss(), _gauss(9, 3.0)):   # the second exceeds the grid
        np.testing.assert_array_equal(PS.np_gen_otf(psf, out), JS.np_gen_otf(psf, out))


@pytest.mark.parametrize("shape", [(64, 64, 64), (40, 24, 20), (8, 8, 8),
                                   (704, 1024, 1024), (320, 512, 512)])
@pytest.mark.parametrize("budget", [None, 0, 16, 64 * 1024, 256 * 1024, 1 << 24,
                                    16 * 2 ** 30, 1 << 40])
def test_chunk_counts_equal_jax(shape, budget):
    assert PS._chunk_counts(shape, budget) == JS._chunk_counts(shape, budget)


@pytest.mark.parametrize("shape,budget", [((32, 16, 16), 64 * 1024),
                                          ((40, 24, 20), 24 * 20 * 4 * 40)])
def test_otf_built_on_the_device_matches_np(shape, budget):
    nz, ny = PS._chunk_counts(shape, budget)
    assert nz > 1 and ny > 1
    mover = PS._Mover(torch.device("cpu"))
    for psf in (_gauss(), _gauss(9, 3.0)):
        np.testing.assert_allclose(
            PS._otf_streamed(mover, psf, shape, nz, ny).numpy(),
            PS.np_gen_otf(psf, shape), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("const_initial", [False, True])
@pytest.mark.parametrize("shape,budget", [((40, 24, 20), 24 * 20 * 4 * 40),
                                          ((16, 16, 16), 64 * 1024)])
def test_streamed_single_matches_jax_and_resident(const_initial, shape, budget):
    img = _img(shape, 2)
    psf = _gauss()
    otf = PS.np_gen_otf(psf, shape)
    otf_bp = PS.np_gen_otf(psf[::-1, ::-1, ::-1], shape)
    nz, ny = PS._chunk_counts(shape, budget)
    assert nz > 1 and ny > 1
    stats = {}
    got = PS.rl_decon_single_streamed(img, otf, otf_bp, 3, const_initial,
                                      budget_bytes=budget, device="cpu", stats=stats)
    ref = JS.rl_decon_single_streamed(img, otf, otf_bp, 3, const_initial,
                                      budget_bytes=budget)
    _close(got, ref)
    resident = PD.rl_decon_single(img, otf, otf_bp, 3, const_initial, device="cpu")
    _close(got, resident.numpy())
    # the same RL with the OTFs built from the PSFs on the device
    _close(PS.rl_decon_single_streamed(img, psf, psf[::-1, ::-1, ::-1], 3,
                                       const_initial, budget_bytes=budget,
                                       device="cpu"), ref)
    assert len(stats["iter_s"]) == 3
    # every iteration moves the same bytes: each of 2 convolutions reads the
    # volume, the spectrum 3 times, the OTF and the other operand, and
    # writes the spectrum twice and the result
    n, nh = np.prod(shape), shape[0] * shape[1] * (shape[2] // 2 + 1)
    per_iter = 2 * (4 * n + 8 * nh * 3 + 4 * n)
    assert stats["h2d_bytes"] - stats["setup_h2d_bytes"] == 3 * per_iter


def test_streamed_dual_matches_jax_and_resident():
    shape = (24, 20, 36)
    a, b = _img(shape, 3), _img(shape, 4)
    pa, pb = _gauss(sigma=1.0), _gauss(sigma=1.5)
    otfs = [PS.np_gen_otf(p, shape) for p in (pa, pb, pa[::-1, ::-1, ::-1],
                                              pb[::-1, ::-1, ::-1])]
    budget = 128 * 1024
    assert min(PS._chunk_counts(shape, budget)) > 1
    for const_initial in (False, True):
        got = PS.rl_decon_dual_streamed(a, b, *otfs, 4, const_initial,
                                        budget_bytes=budget, device="cpu")
        _close(got, JS.rl_decon_dual_streamed(a, b, *otfs, 4, const_initial,
                                              budget_bytes=budget))
        _close(got, PD.rl_decon_dual(a, b, *otfs, 4, const_initial,
                                     device="cpu").numpy())


def test_hbm_budget_and_mem_mode(monkeypatch):
    monkeypatch.delenv("MIL_HBM_BUDGET_MB", raising=False)
    assert PD.hbm_budget_bytes("cpu") is None
    cpu = torch.device("cpu")
    # explicit modes pass; auto without a budget is mode 1 (the CPU here)
    for m in (1, 2, -1):
        assert PD._resolve_mem_mode(m, (64, 64, 64), False, "cpu") == (abs(m), cpu)
    assert PD._resolve_mem_mode(0, (64, 64, 64), False, None) == (0, cpu)
    with pytest.raises(ValueError):
        PD._resolve_mem_mode(3, (64, 64, 64), False, "cpu")
    # the JAX package's tiers under the same budgets
    for mb, dual in (("100000", False), ("1", False), ("6", False), ("6", True),
                     ("0.25", False)):
        monkeypatch.setenv("MIL_HBM_BUDGET_MB", mb)
        assert PD.hbm_budget_bytes("cpu") == JD.hbm_budget_bytes(None)
        want = JD._resolve_mem_mode(-1, (64, 64, 64), dual, None)
        assert PD._resolve_mem_mode(-1, (64, 64, 64), dual, "cpu") == (want, cpu)


def test_decon_entries_take_the_streamed_tier_like_jax(monkeypatch):
    img = _img((24, 24, 24), 5)
    psf = _gauss(3, 1.2)
    # cap the budget below the 6-volume working set of the 24^3 -> 32^3 grid
    monkeypatch.setenv("MIL_HBM_BUDGET_MB", "0.25")
    rec_p, rec_j = np.zeros(10), np.zeros(10)
    got = PD.decon_singleview(img, psf, n_iters=5, mem_mode=-1, device="cpu",
                              records=rec_p, verbose=True)
    ref = JD.decon_singleview(img, psf, n_iters=5, mem_mode=-1, records=rec_j)
    assert rec_p[0] == rec_j[0] == 2
    assert got.shape == img.shape and got.flags.writeable
    _close(got, ref)
    monkeypatch.delenv("MIL_HBM_BUDGET_MB")
    _close(got, PD.decon_singleview(img, psf, n_iters=5, mem_mode=0))
    a, b = _img((16, 16, 16), 6), _img((16, 16, 16), 7)
    pa, pb = _gauss(3, 1.0), _gauss(3, 1.4)
    monkeypatch.setenv("MIL_HBM_BUDGET_MB", "0.05")
    got = PD.decon_dualview(a, b, pa, pb, n_iters=4, mem_mode=-1, device="cpu",
                            records=rec_p)
    ref = JD.decon_dualview(a, b, pa, pb, n_iters=4, mem_mode=-1, records=rec_j)
    assert rec_p[0] == rec_j[0] == 2
    _close(got, ref)
    # unmatched back projectors go through the streamed tier as well
    got = PD.decon_dualview(a, b, pa, pb, 2, psf_bp_a=pa, psf_bp_b=pb, mem_mode=2,
                            device="cpu")
    ref = JD.decon_dualview(a, b, pa, pb, 2, psf_bp_a=pa, psf_bp_b=pb, mem_mode=2)
    _close(got, ref)
