"""The port's diSPIM fusion against the JAX package's on the CPU: the
view-B rotation, the separable resample, the grid sizes, the view
preprocessing, ``fusion_dualview`` on the 20^3 case of
tests/test_fusion_batch.py and on chip_smoke.py's Phase 14 views at a
reduced diSPIM geometry (where both land from the true matrix), and the
spimFusion CLI on 16-bit TIFFs.

Bounds: the rotation is a permutation, so bit for bit; the resample 1e-5
x max (three fp32 products, summed in another order); the registration's
final NCC within 1e-3 and its matrix within 0.35 voxel of JAX's
(tests/test_torch_registration.py); the deconvolution of the same
registered view rtol = atol/max = 2e-4 (tests/test_conv_sep.py)."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.cli import spim_fusion as jcli
from microimagelib_tpu.models import fusion as JF
from microimagelib_tpu.models.deconvolution import decon_dualview as jax_decon_dualview
from microimagelib_tpu.ops.basics import rot_by_y_axis as jax_rot
from microimagelib_tpu_torch.cli import spim_fusion as pcli
from microimagelib_tpu_torch.io.tiff import gettifinfo, readtifstack, writetifstack
from microimagelib_tpu_torch.io.tmx import read_tmx
from microimagelib_tpu_torch.models import deconvolution as PD
from microimagelib_tpu_torch.models import fusion as PF
from microimagelib_tpu_torch.ops.basics import rot_by_y_axis
from microimagelib_tpu_torch.ops.resample import is_diagonal_tmx, resize3d_separable
from test_fusion_batch import blobs, gaussian_psf

import chip_smoke as CS

torch.set_num_threads(1)


def _close(out, ref, tol):
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * np.abs(ref).max())


def _box_error(m, ref, shape):
    """Max distance (voxels) between where ``m`` and ``ref`` map the
    corners of the central half-box of ``shape`` (z, y, x)."""
    sz, sy, sx = shape
    pts = np.array([[x, y, z, 1.0] for x in (sx / 4, 3 * sx / 4)
                    for y in (sy / 4, 3 * sy / 4) for z in (sz / 4, 3 * sz / 4)])
    a = np.asarray(m, np.float64).reshape(3, 4)
    b = np.asarray(ref, np.float64).reshape(3, 4)
    return float(np.abs(pts @ a.T - pts @ b.T).max())


@pytest.mark.parametrize("direction", [1, -1])
def test_rot_by_y_axis_matches_jax(rng, direction):
    import jax.numpy as jnp

    a = rng.random((5, 6, 7)).astype(np.float32)
    out = rot_by_y_axis(torch.from_numpy(a), direction)
    assert out.is_contiguous() and tuple(out.shape) == (7, 6, 5)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jax_rot(jnp.asarray(a), direction)))
    with pytest.raises(ValueError):
        rot_by_y_axis(torch.from_numpy(a), 0)


@pytest.mark.parametrize("out_shape", [(20, 12, 9), (7, 6, 14), (26, 6, 7)])
def test_resize_matches_jax(rng, out_shape):
    a = (rng.random((6, 8, 10)) * 100).astype(np.float32)
    ref = JF.imresize3d(a, out_shape)
    _close(PF.imresize3d(a, out_shape), ref, 1e-5)
    # a diagonal matrix with a translation column, as the JAX package takes it
    from microimagelib_tpu.ops.resample import resize3d_separable as jax_resize

    m = np.array([0.8, 0, 0, 0.5, 0, 1.1, 0, -0.3, 0, 0, 0.5, 1.0], np.float32)
    ref = np.asarray(jax_resize(a, out_shape, m))
    out = resize3d_separable(torch.from_numpy(a), out_shape, m).numpy()
    _close(out, ref, 1e-5)
    assert is_diagonal_tmx(m) and not is_diagonal_tmx(np.arange(12))
    with pytest.raises(ValueError):
        resize3d_separable(torch.from_numpy(a), out_shape, np.arange(12.0))


def test_resize_ignores_tf32(rng, monkeypatch):
    """The products run in full fp32 whatever the global TF32 switch says."""
    a = (rng.random((6, 8, 10)) * 100).astype(np.float32)
    ref = PF.imresize3d(a, (12, 9, 20))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    np.testing.assert_array_equal(PF.imresize3d(a, (12, 9, 20)), ref)
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("op", [0, 1, 2])
def test_imoperation3d_matches_jax(rng, op):
    a = rng.random((4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(PF.imoperation3d(a, op), JF.imoperation3d(a, op))


@pytest.mark.parametrize("rot", [-1, 0, 1])
def test_fusion_sizes_match_jax(rot):
    args = ((128, 96, 50), (120, 96, 48), (0.1625, 0.1625, 1.0),
            (0.1625, 0.1625, 0.9), rot)
    assert PF.fusion_sizes(*args) == JF.fusion_sizes(*args)


@pytest.mark.parametrize("rot", [-1, 1])
def test_preprocess_views_host_and_device_forms(rng, rot):
    """numpy and tensor forms agree bit for bit, and match JAX's."""
    a = (rng.random((6, 24, 24)) * 100).astype(np.float32)
    b = (rng.random((8, 24, 24)) * 100).astype(np.float32)
    px = (0.1625, 0.1625, 0.65)
    host = PF.preprocess_views(a, b, px, px, rot)
    dev = PF.preprocess_views(a, b, px, px, rot, as_device=True)
    ref = JF.preprocess_views(a, b, px, px, rot)
    for h, d, r in zip(host, dev, ref):
        assert isinstance(h, np.ndarray) and isinstance(d, torch.Tensor)
        assert d.is_contiguous()
        np.testing.assert_array_equal(h, d.numpy())
        _close(h, r, 1e-5)


@pytest.fixture(scope="module")
def fused_20():
    """The 20^3 case of tests/test_fusion_batch.py through both packages."""
    vol = blobs((20, 20, 20), n=8, seed=2)
    psf = gaussian_psf((5, 5, 5), 1.0)
    shifted = np.roll(vol, 1, axis=2)
    kw = dict(pixel_a=(1.0, 1.0, 1.0), pixel_b=(1.0, 1.0, 1.0), im_rotation=0,
              reg_choice=2, aff_method=1, ftol=1e-4, it_limit=500, n_iters=4)
    jrec = np.zeros(22)
    ref = JF.fusion_dualview(vol, shifted, psf, psf, records=jrec, **kw)
    rec = np.zeros(22)
    saved = []
    out = PF.fusion_dualview(vol, shifted, psf, psf, mem_mode=0, records=rec,
                             save_reg_callback=lambda a, b: saved.append((a, b)),
                             **kw)
    return vol, psf, (out, rec, saved), (ref, jrec)


def test_fusion_dualview_matches_jax(fused_20):
    vol, psf, (out, rec, saved), (ref, jrec) = fused_20
    decon, tmx, reg_b, a_iso = out
    jdecon, jtmx, jreg_b, ja_iso = ref
    assert decon.shape == vol.shape and np.isfinite(decon).all()
    assert isinstance(reg_b, torch.Tensor) and isinstance(a_iso, np.ndarray)
    np.testing.assert_array_equal(a_iso, np.asarray(ja_iso))
    assert abs(rec[3] - jrec[3]) <= 1e-3, (rec[3], jrec[3])
    assert _box_error(tmx, jtmx, vol.shape) <= 0.35
    assert abs(tmx[3] - 1.0) < 0.5          # the +1 x roll
    # records: the reg3d block, the decon block, the total
    assert rec[7] > 0 and rec[19] > 0 and rec[21] >= rec[7]
    # the callback saw both registered views, as numpy
    (sa, sb), = saved
    np.testing.assert_array_equal(sa, a_iso)
    np.testing.assert_array_equal(sb, reg_b.numpy())
    # the decon of the port's own registered view is the pipeline's output
    again = PD.decon_dualview(a_iso, reg_b, psf, psf, n_iters=4, mem_mode=0)
    np.testing.assert_array_equal(decon, again)


def test_fusion_decon_of_same_view_matches_jax(fused_20):
    """Given JAX's registered view, the port's joint decon gives JAX's."""
    _vol, psf, _out, (ref, _jrec) = fused_20
    jdecon, _jtmx, jreg_b, ja_iso = ref
    out = PD.decon_dualview(np.asarray(ja_iso), np.asarray(jreg_b), psf, psf,
                            n_iters=4, mem_mode=0)
    _close(out, np.asarray(jdecon), 2e-4)
    # and the JAX package agrees with itself on the same inputs
    _close(np.asarray(jax_decon_dualview(np.asarray(ja_iso), np.asarray(jreg_b),
                                         psf, psf, n_iters=4)),
           np.asarray(jdecon), 1e-6)


# chip_smoke.py's Phase 14 geometry reduced: raw views of 13 steps of
# 1.0 um at 0.1625 um pixels (13 steps = 80 isotropic planes), 64 rows,
# on the isotropic (80, 64, 80) grid (full: raw (52, 512, 320), grid
# (320, 512, 320))
TRUTH_SHAPE, TRUTH_RAW = (80, 64, 80), (13, 64, 80)


def test_fusion_truth_on_dispim_views_matches_jax(monkeypatch):
    """Both packages' fusion_dualview on Phase 14's synthetic views (beads
    from a numpy seed; view B moved by the reg128 matrix; anisotropic
    blur; diSPIM sampling) with the registration engine Phase 14 runs on
    the card (grad). They agree (NCC within 1e-3, matrices within 0.35
    voxel), and both land the same distance from the true matrix, within
    the gate Phase 14 holds its runs to. Neither lands on the truth
    because the truth is not the optimum of these views: on the
    registration's own NCC both matrices score above it."""
    monkeypatch.setenv("MIL_REG_ENGINE", "grad")
    monkeypatch.setattr(CS, "FUSION_SHAPE", TRUTH_SHAPE)
    monkeypatch.setattr(CS, "FUSION_RAW", TRUTH_RAW)
    a, b = CS.fusion_views(torch.device("cpu"))
    pa, pb = CS.fusion_psfs()
    args = (a, b, pa, pb, CS.FUSION_PIXEL, CS.FUSION_PIXEL, -1, 2, 7)
    rec, jrec = np.zeros(22), np.zeros(22)
    _, tmx, _, _ = PF.fusion_dualview(*args, n_iters=1, mem_mode=0, records=rec)
    _, jtmx, _, _ = JF.fusion_dualview(*args, n_iters=1, records=jrec)
    jtmx = np.asarray(jtmx)
    assert abs(rec[3] - jrec[3]) <= 1e-3, (rec[3], jrec[3])
    assert _box_error(tmx, jtmx, TRUTH_SHAPE) <= 0.35
    truth = CS.inverse12(CS.dof_to_matrix(CS.REG_DOF, 6))
    dist = [_box_error(m, truth, TRUTH_SHAPE) for m in (tmx, jtmx)]
    assert max(dist) <= CS.FUSION_TRUTH_VOXELS, dist
    assert abs(dist[0] - dist[1]) <= 0.35, dist
    views = PF.preprocess_views(a, b, CS.FUSION_PIXEL, CS.FUSION_PIXEL, -1,
                                as_device=True)
    ncc = [CS.reg_ncc(*views, m) for m in (truth, tmx, jtmx)]
    print(f"port / JAX: {dist[0]:.4f} / {dist[1]:.4f} voxel from the truth, "
          f"{_box_error(tmx, jtmx, TRUTH_SHAPE):.4f} apart, final NCC {rec[3]:.6f} / "
          f"{jrec[3]:.6f}; registration NCC at the truth {ncc[0]:.6f}, at their "
          f"matrices {ncc[1]:.6f} / {ncc[2]:.6f}")
    assert ncc[1] > ncc[0] and ncc[2] > ncc[0], ncc


def test_fusion_checkmatrix_retry_and_mode_2(rng, monkeypatch):
    """A result the plausibility gate rejects is registered again with
    plain choice 2; memory mode 2 raises as the other entries do."""
    vol = blobs((16, 16, 16), n=6, seed=3)
    psf = gaussian_psf((5, 5, 5), 1.0)
    calls = []
    real = PF.reg3d

    def counting(*args, **kw):
        calls.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(PF, "reg3d", counting)
    monkeypatch.setattr(PF, "checkmatrix", lambda *a: len(calls) > 1)
    PF.fusion_dualview(vol, vol, psf, psf, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0),
                       im_rotation=0, aff_method=1, it_limit=100, n_iters=1,
                       mem_mode=0)
    assert calls == [2, 2]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PF.fusion_dualview(vol, vol, psf, psf, mem_mode=2)


@pytest.fixture
def views(tmp_path, monkeypatch):
    monkeypatch.setenv("MIL_TPU_CACHE", str(tmp_path / "jax_cache"))
    vol = blobs((14, 14, 14), n=6, seed=4) * 50 + 100
    writetifstack(str(tmp_path / "a.tif"), vol, 16)
    writetifstack(str(tmp_path / "b.tif"), np.roll(vol, 1, axis=2), 16)
    writetifstack(str(tmp_path / "p.tif"), gaussian_psf((5, 5, 5), 1.0), 32)
    return tmp_path


def _banner(text, out_name):
    return [ln.replace(out_name, "OUT") for ln in text.splitlines()
            if "time cost" not in ln.lower()]


def test_spim_fusion_cli_matches_jax(views, capsys):
    """16-bit views, -gm 0: the banner line for line, the matrix within
    0.35 voxel and the fused volume as the library call gives it."""
    common = ["-i1", str(views / "a.tif"), "-i2", str(views / "b.tif"),
              "-fp1", str(views / "p.tif"), "-fp2", str(views / "p.tif"),
              "-pxx1", "1", "-pxy1", "1", "-pxz1", "1",
              "-pxx2", "1", "-pxy2", "1", "-pxz2", "1",
              "-imgrot", "0", "-regc", "2", "-affm", "1", "-it", "2",
              "-itreg", "200", "-gm", "0", "-verbOFF"]
    assert pcli.main(common + ["-o", str(views / "port.tif"), "-bit", "32",
                               "-otmx", str(views / "port.tmx")]) == 0
    port_out = capsys.readouterr().out
    assert "reading/writing" in port_out
    assert jcli.main(common + ["-o", str(views / "jax.tif"), "-bit", "32",
                               "-otmx", str(views / "jax.tmx")]) == 0
    jax_out = capsys.readouterr().out
    banner = [ln.replace("jax.t", "port.t") for ln in _banner(jax_out, "jax.tif")]
    assert _banner(port_out, "port.tif") == banner
    out, size = readtifstack(str(views / "port.tif"))
    assert size == (14, 14, 14) and np.isfinite(out).all()
    m, jm = read_tmx(str(views / "port.tmx")), read_tmx(str(views / "jax.tmx"))
    assert _box_error(m, jm, out.shape) <= 0.35
    a, _ = readtifstack(str(views / "a.tif"))
    b, _ = readtifstack(str(views / "b.tif"))
    psf, _ = readtifstack(str(views / "p.tif"))
    lib, tmx, _, _ = PF.fusion_dualview(a, b, psf, psf, (1.0, 1.0, 1.0),
                                        (1.0, 1.0, 1.0), 0, 2, 1, it_limit=200,
                                        n_iters=2, mem_mode=0)
    np.testing.assert_array_equal(out, lib)
    np.testing.assert_allclose(m, tmx, atol=1e-6)   # the .tmx text format
    # -bit 16 writes 16-bit, the input's width by default
    assert pcli.main(common + ["-o", str(views / "u16.tif")]) == 0
    _, bits = gettifinfo(str(views / "u16.tif"))
    assert int(bits) == 16


def test_spim_fusion_cli_usage(capsys):
    assert pcli.HELP == jcli.HELP
    assert pcli.main([]) == 0
    assert pcli.main(["-h"]) == 0 and "-imgrot" in capsys.readouterr().out
    assert pcli.main(["-i1", "x.tif"]) == 1
    assert "mandatory" in capsys.readouterr().out
