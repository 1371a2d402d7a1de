"""``reg3d`` choices 1, 3 and 4 and ``reg_3dgpu`` of the port against the
JAX package's on the CPU, on (24, 24, 24) volumes moved by a translation
(choice 3, from the phasor's integer start) and by a small rigid motion
(choice 4, from the 2-D MIP shift search). Choice 1 is held equal
(tests/test_torch_phasor.py); 3 and 4 and ``reg_3dgpu`` to a final NCC
within 1e-3 of JAX's and a matrix within 0.35 voxel over the central
half-box (the port's registration bound), and the 2-D shift search that
seeds choice 4 to JAX's matrix exactly."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.models import registration as JR
from microimagelib_tpu.ops.affine import affine_transform_3d as jax_affine
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.ops.matrix import dof_to_matrix
from test_registration import smooth_blobs
from test_torch_fusion import _box_error

torch.set_num_threads(1)

SHAPE = (24, 24, 24)


def _pair(kind):
    vol = smooth_blobs(SHAPE, n=10, seed=4)
    if kind == "roll":
        return vol, np.roll(vol, (2, -1, 3), axis=(0, 1, 2))
    m = dof_to_matrix([1.5, -1.0, 2.0, 1.7, -1.2, 0.8, 1, 1, 1], 6)
    return vol, np.array(jax_affine(vol, m, SHAPE))


@pytest.mark.parametrize("choice,kind,method", [(3, "roll", 1), (4, "rigid", 2)])
def test_reg3d_choices_3_4_match_jax(choice, kind, method):
    vol, moved = _pair(kind)
    jrec, rec = np.zeros(11), np.zeros(11)
    _, jtmx, _ = JR.reg3d(vol, moved, reg_choice=choice, aff_method=method,
                          records=jrec)
    reg, tmx, _ = R.reg3d(vol, moved, reg_choice=choice, aff_method=method,
                          mem_mode=0, records=rec)
    assert abs(rec[3] - jrec[3]) <= 1e-3, (rec[3], jrec[3])
    assert _box_error(tmx, jtmx, SHAPE) <= 0.35
    assert rec[3] > 0.95
    assert reg.shape == SHAPE and R.checkmatrix(tmx, 24, 24, 24)


def test_mip_shift_search_seed_matches_jax():
    """Choice 4's seed: the XY and ZX MIP shift searches, with the x shift
    carried into the x-only search's second component."""
    from microimagelib_tpu.ops.basics import max_projection as jmp
    from microimagelib_tpu_torch.ops.basics import max_projection

    vol, moved = _pair("rigid")
    out = []
    for mod, proj, kw in ((JR, lambda v, d: np.asarray(jmp(v, d)), {}),
                          (R, lambda v, d: max_projection(torch.from_numpy(v), d),
                           {"device": "cpu"})):
        _, t1 = mod.reg2d_shiftalign(proj(vol, 1), proj(moved, 1), None, 0.3, 30, **kw)
        init = np.array([1, 0, 0, 0, 1, t1[2]], np.float32)
        _, t2 = mod.reg2d_shiftalign(proj(vol, 2), proj(moved, 2), init, 0.3, 30,
                                     x_only=True, **kw)
        out.append(np.concatenate([t1, t2]))
    np.testing.assert_array_equal(out[1], out[0])


def test_reg_3dgpu_matches_jax():
    vol = smooth_blobs(SHAPE, n=10, seed=9)
    moved = np.roll(vol, 2, axis=2)
    _, jtmx, jrec = JR.reg_3dgpu(vol, moved, aff_method=1, ftol=1e-5, it_limit=2000)
    reg, tmx, rec = R.reg_3dgpu(vol, moved, aff_method=1, ftol=1e-5, it_limit=2000,
                                mem_mode=0)
    assert abs(rec[3] - jrec[3]) <= 1e-3
    assert _box_error(tmx, jtmx, SHAPE) <= 0.35
    assert R.checkmatrix(tmx, 24, 24, 24) and R.zncc(reg, vol) > 0.97


@pytest.mark.parametrize("regc", [1, 3, 4])
def test_reg3d_cli_takes_choices_1_3_4(tmp_path, capsys, regc):
    """The reg3D CLI runs choices 1, 3 and 4 (-gm 0): its .tmx and image are
    the library call's on the same TIFFs, and the phasor finds the +2 x
    roll."""
    from microimagelib_tpu_torch.cli import reg3d as preg
    from microimagelib_tpu_torch.io.tiff import readtifstack, writetifstack
    from microimagelib_tpu_torch.io.tmx import read_tmx
    from test_fusion_batch import blobs

    vol = blobs((16, 20, 24), n=6, seed=1) * 50 + 100
    writetifstack(str(tmp_path / "t.tif"), vol, 32)
    writetifstack(str(tmp_path / "s.tif"), np.roll(vol, 2, axis=2), 32)
    assert preg.main(["-t", str(tmp_path / "t.tif"), "-s", str(tmp_path / "s.tif"),
                      "-o", str(tmp_path / "r.tif"), "-regc", str(regc), "-affm", "1",
                      "-bit", "32", "-otmx", str(tmp_path / "m.tmx"), "-gm", "0",
                      "-verbOFF"]) == 0
    assert "Registration choice" in capsys.readouterr().out
    img1, _ = readtifstack(str(tmp_path / "t.tif"))
    img2, _ = readtifstack(str(tmp_path / "s.tif"))
    reg, tmx, _ = R.reg3d(img1, img2, regc, 1, mem_mode=0)
    np.testing.assert_allclose(read_tmx(str(tmp_path / "m.tmx")), tmx, atol=1e-6)
    np.testing.assert_array_equal(readtifstack(str(tmp_path / "r.tif"))[0], reg)
    if regc == 1:
        np.testing.assert_array_equal(tmx[[3, 7, 11]], [2, 0, 0])
