"""The port's memory-saving registration tier against the JAX package's on
the CPU: the z-window bounds, the streamed transform and NCC sums, the
host-staged phasor, ``_reg3d_affine_lowmem`` and the mode-2 branches of
``reg3d``.

Bounds: ``_zspan_for_rows`` and ``zslab_footprint_hops`` equal JAX's; the
streamed transform equals the port's resident one bit for bit (the JAX
package's claim for its own); the streamed NCC sums are within rtol 1e-5
of JAX's (tests/test_registration.py); the phasor's shifts are exact; the
low-memory registration meets the JAX package's own gates
(tests/test_registration.py's beyond-HBM tests: translations within 0.35
voxel of the truth, 0.1 with the uncapped polish, the affine part the
identity to 1e-6, final NCC > 0.9, the default polish no worse than the
coarse matrix and within 0.02 of mode 1, at most 180 evaluations), and
the port's matrix lies within 0.1 voxel of JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.models import registration as JR
from microimagelib_tpu.ops import affine as JA
from microimagelib_tpu.ops.matrix import dof_to_matrix, identity_tmx
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.ops import affine as PA
from test_registration import smooth_blobs

torch.set_num_threads(1)

MATRICES = [
    identity_tmx(),
    dof_to_matrix([1.5, -2.0, 0.8, 0, 0, 0, 1, 1, 1], 3),
    dof_to_matrix([1.5, -0.7, 2.3, 4.0, 2.0, -1.0, 1, 1, 1], 6),
    dof_to_matrix([3.0, 1.0, -5.0, 20.0, 10.0, -15.0, 1.1, 0.9, 1.05], 9),
    dof_to_matrix([0.0, 0.0, 0.0, 0.0, 35.0, 0.0, 1, 1, 1], 6),
]


def _sheared():
    m = identity_tmx()
    m[3], m[7], m[11] = 1.5, -2.0, 0.8
    m[1] = 0.05
    return m


@pytest.mark.parametrize("mi", range(len(MATRICES)))
def test_zspan_and_footprint_hops_equal_jax(mi):
    m = np.asarray(MATRICES[mi], np.float64).reshape(3, 4)
    for zlo, zhi, oy, ox, sz in ((0, 3, 20, 16, 24), (5, 17, 64, 48, 40),
                                 (30, 39, 8, 8, 40), (0, 0, 1, 1, 1)):
        assert PA._zspan_for_rows(m, zlo, zhi, oy, ox, sz) == \
            JA._zspan_for_rows(m, zlo, zhi, oy, ox, sz)
    for shape in ((32, 20, 16), (64, 48, 40), (96, 64, 64)):
        for n_shards in (1, 2, 4, 8):
            assert PA.zslab_footprint_hops(MATRICES[mi], shape, n_shards) == \
                JA.zslab_footprint_hops(MATRICES[mi], shape, n_shards)


@pytest.mark.parametrize("mi", range(len(MATRICES)))
def test_streamed_transform_is_bit_equal(mi):
    src = smooth_blobs((30, 24, 28), n=10, seed=mi)
    m = MATRICES[mi]
    for out_shape in ((30, 24, 28), (17, 20, 31)):
        ref = PA.affine_transform_3d(torch.from_numpy(src), m, out_shape).numpy()
        for n_blocks in (None, 1, 3, 7, out_shape[0]):
            got = PA.affine_transform_3d_streamed(src, m, out_shape, n_blocks=n_blocks,
                                                  device="cpu")
            np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
        # a budget that forces blocks, and the JAX package's streamed result
        got = PA.affine_transform_3d_streamed(src, m, out_shape,
                                              budget_bytes=src.nbytes, device="cpu")
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(
            got, JA.affine_transform_3d_streamed(src, m, out_shape,
                                                 budget_bytes=src.nbytes),
            atol=1e-5 * np.abs(ref).max())


def test_stream_blocks_cover_the_rows_within_the_budget():
    sz, sy, sx = 96, 64, 64
    for m in MATRICES:
        for budget in (1 << 20, 1 << 23, 1 << 30, None):
            blocks = PA._stream_blocks(m, sz, sz, sy, sx, sy, sx, budget)
            rows = [z for z0, n, _lo, _hi in blocks for z in range(z0, z0 + n)]
            assert rows == list(range(sz))
            mm = np.asarray(m, np.float64).reshape(3, 4)
            for z0, n, lo, hi in blocks:
                assert (lo, hi) == PA._zspan_for_rows(mm, z0, z0 + n - 1, sy, sx, sz)
                fits = (PA.STREAM_PEAK_FACTOR * PA._block_bytes(n, lo, hi, sy * sx,
                                                                sy * sx)
                        <= budget * PA.STREAM_BUDGET_SHARE) if budget else True
                assert fits or len(blocks) == sz


def test_streamed_ncc_sums_match_jax_and_resident():
    vol = smooth_blobs((24, 20, 16), n=12, seed=21)
    tgt = smooth_blobs((24, 20, 16), n=12, seed=22)
    for m in [_sheared()] + MATRICES[1:4]:
        ss0, st0 = PA.corr3d_partials(torch.from_numpy(vol), torch.from_numpy(tgt), m)
        for budget in (24 * 20 * 16 * 4 * 4, 24 * 20 * 16 * 100):
            ss, st = PA.corr3d_partials_streamed(vol, tgt, m, budget_bytes=budget,
                                                 device="cpu")
            np.testing.assert_allclose(ss, float(ss0), rtol=1e-12)
            np.testing.assert_allclose(st, float(st0), rtol=1e-12)
            jss, jst = JA.corr3d_partials_streamed(vol, tgt, m, budget_bytes=budget)
            np.testing.assert_allclose(ss, jss, rtol=1e-5)
            np.testing.assert_allclose(st, jst, rtol=1e-5)


def _sparse_beads(shape, seed, n=30):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    for _ in range(n):
        vol[tuple(rng.integers(2, s - 2) for s in shape)] = rng.uniform(100, 900)
    return vol


@pytest.mark.parametrize("shift", [(3, -2, 4), (3, -2, 12), (-9, 5, -2), (0, 0, 0)])
def test_phasor_lowmem_shifts_exact(shift):
    """(z, y, x) circular shifts; |x| = 12 > 28 / 4 and |z| = 9 > 24 / 4 go
    through the wraparound check."""
    vol = _sparse_beads((24, 20, 28), 8)
    moved = np.roll(vol, shift, axis=(0, 1, 2))
    want = [shift[2], shift[1], shift[0]]
    for budget in (16 * 1024, None):
        got = R.reg3d_phasor_lowmem(vol, moved, budget_bytes=budget, device="cpu")
        assert got == want
        assert got == JR.reg3d_phasor_lowmem(vol, moved, budget_bytes=budget)
    assert got == R.reg3d_phasor(vol, moved, device="cpu")


def _moved(vol, true_m):
    return np.asarray(JA.affine_transform_3d(jnp.asarray(vol), true_m, vol.shape))


def test_reg3d_affine_lowmem_matches_jax(monkeypatch):
    vol = smooth_blobs((32, 32, 32), n=14, seed=23)
    true_m = identity_tmx()
    true_m[3], true_m[7], true_m[11] = 2.0, -1.0, 1.0
    moved = _moved(vol, true_m)
    monkeypatch.setenv("MIL_HBM_BUDGET_MB", "0.3")
    assert R._beyond_budget(2, vol.shape, torch.device("cpu"))
    reg, tmx, rec = R.reg3d(vol, moved, reg_choice=2, aff_method=1, it_limit=2000,
                            device="cpu")
    jreg, jtmx, jrec = JR.reg3d(vol, moved, reg_choice=2, aff_method=1, it_limit=2000)
    for t, r in ((tmx, rec), (jtmx, jrec)):
        np.testing.assert_allclose(np.asarray(t).reshape(3, 4)[:, :3], np.eye(3),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(t)[[3, 7, 11]], -true_m[[3, 7, 11]],
                                   atol=0.35)
        assert r[3] > 0.9
    np.testing.assert_allclose(tmx[[3, 7, 11]], jtmx[[3, 7, 11]], atol=0.1)
    assert abs(rec[2] - jrec[2]) < 1e-3 and abs(rec[3] - jrec[3]) < 1e-3
    # the registered volume comes from the streamed final transform
    np.testing.assert_array_equal(
        reg, PA.affine_transform_3d(torch.from_numpy(moved), tmx, vol.shape).numpy())


def test_reg3d_affine_lowmem_default_polish(monkeypatch):
    vol = smooth_blobs((32, 32, 32), n=14, seed=29)
    true_m = identity_tmx()
    true_m[3], true_m[7], true_m[11] = 1.3, -0.7, 0.9
    moved = _moved(vol, true_m)
    _, _, rec_full = R.reg3d(vol, moved, reg_choice=2, aff_method=1, it_limit=2000,
                             mem_mode=0)
    monkeypatch.setenv("MIL_HBM_BUDGET_MB", "0.3")
    monkeypatch.setenv("MIL_REG_STREAM_POLISH", "0")
    _, _, rec0 = R.reg3d(vol, moved, reg_choice=2, aff_method=1, it_limit=2000,
                         device="cpu")
    assert rec0[5] == 1   # the coarse matrix's NCC alone
    monkeypatch.delenv("MIL_REG_STREAM_POLISH")
    _, tmx, rec = R.reg3d(vol, moved, reg_choice=2, aff_method=1, it_limit=2000,
                          device="cpu")
    assert rec[3] >= rec0[3] - 1e-6, (rec[3], rec0[3])
    assert rec[3] >= rec_full[3] - 0.02, (rec[3], rec_full[3])
    assert rec[5] <= 180
    monkeypatch.setenv("MIL_REG_STREAM_POLISH", "1")
    vol = smooth_blobs((32, 32, 32), n=14, seed=24)
    true_m = identity_tmx()
    true_m[3], true_m[7] = 1.5, -0.8
    _, tmx, _ = R.reg3d(vol, _moved(vol, true_m), reg_choice=2, aff_method=1,
                        it_limit=2000, device="cpu")
    np.testing.assert_allclose(tmx.reshape(3, 4)[:, :3], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(tmx[[3, 7, 11]], -true_m[[3, 7, 11]], atol=0.1)


def test_lowmem_twelve_parameter_polish_and_apply_only(monkeypatch):
    """Method 5 polishes the 12 parameters on the streamed cost; choice 0
    and an applied matrix stream the transform, as in the JAX package."""
    vol = smooth_blobs((32, 32, 32), n=14, seed=31)
    true_m = dof_to_matrix([1.0, -0.5, 0.7, 2.0, 0, 0, 1, 1, 1], 6)
    moved = _moved(vol, true_m)
    monkeypatch.setenv("MIL_HBM_BUDGET_MB", "0.3")
    monkeypatch.setenv("MIL_REG_STREAM_BUDGET", "40")
    _, tmx, rec = R.reg3d_affine(vol, moved, aff_method=5, device="cpu", mem_mode=-1,
                                 want_reg=False)
    _, jtmx, jrec = JR.reg3d_affine(vol, moved, aff_method=5, mem_mode=-1,
                                    want_reg=False)
    assert abs(rec[3] - jrec[3]) < 2e-3 and rec[3] > 0.9
    np.testing.assert_allclose(tmx[[3, 7, 11]], jtmx[[3, 7, 11]], atol=0.35)
    reg, out_tmx, _ = R.reg3d(vol, moved, reg_choice=0, flag_tmx=True, tmx=true_m,
                              device="cpu", mem_mode=2)
    np.testing.assert_array_equal(out_tmx, true_m)
    np.testing.assert_array_equal(
        reg, PA.affine_transform_3d(torch.from_numpy(moved), true_m, vol.shape).numpy())
    np.testing.assert_array_equal(
        R.atrans3dgpu(moved, true_m, vol.shape, device="cpu", mem_mode=-1), reg)


def test_reg3d_phasor_choices_in_mode_2(monkeypatch):
    """Choices 1 and 3 take the host-staged phasor in mode 2 (and in auto
    beyond the budget); choice 1's registered volume is the streamed
    transform by the shift."""
    vol = _sparse_beads((24, 20, 28), 9, n=60)
    vol = np.asarray(JA.affine_transform_3d(jnp.asarray(vol), identity_tmx(), vol.shape))
    moved = np.roll(vol, (2, -3, 4), axis=(0, 1, 2))
    reg, tmx, _ = R.reg3d(vol, moved, reg_choice=1, device="cpu", mem_mode=2)
    jreg, jtmx, _ = JR.reg3d(vol, moved, reg_choice=1, mem_mode=2)
    np.testing.assert_array_equal(tmx, jtmx)
    assert list(tmx[[3, 7, 11]]) == [4, -3, 2]
    np.testing.assert_allclose(reg, jreg, atol=1e-4 * vol.max())
    monkeypatch.setenv("MIL_HBM_BUDGET_MB", "0.05")
    _, tmx3, _ = R.reg3d(vol, moved, reg_choice=1, device="cpu", mem_mode=-1)
    np.testing.assert_array_equal(tmx3, tmx)
