"""The port's time-lapse batch driver against the JAX package's on the
CPU, at a small size: raw (8, 16, 16) views made anisotropic (2 um z
steps), view B turned -90 degrees about y and drifting in y per
timepoint (tests/test_fusion_batch.py's registering-regMode workload), 3
decon iterations.

Bounds: with a fixed input matrix (regModes 0 and 1) the decon, the 2-D
MPs and the rotating MIPs at the JAX batch bound (rtol 2e-4, atol 2e-4 x
max; tests/test_fusion_batch.py); with registration (regModes 2 and 3)
the matrices within 0.35 voxel over the central half-box (the port's
registration bound). In every mode the output tree is the JAX package's
and ProcessingLog.txt matches it line for line with numbers masked. Both
sides pin MIL_REG_FINISH_LEVEL."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from microimagelib_tpu.io.tmx import write_tmx as jwrite_tmx
from microimagelib_tpu.models import batch as JB
from microimagelib_tpu.ops.matrix import dof_to_matrix
from microimagelib_tpu_torch.io.tiff import readtifstack, writetifstack, writetifstack_16to16
from microimagelib_tpu_torch.io.tmx import read_tmx
from microimagelib_tpu_torch.models import batch as PB
from microimagelib_tpu_torch.models import deconvolution as PD
from microimagelib_tpu_torch.models import fusion as PF
from microimagelib_tpu_torch.parallel.mesh import make_mesh
from test_fusion_batch import _write_drift_inputs, gaussian_psf

torch.set_num_threads(1)

N_T = 3
RELS = [("Decon", "Decon_{t}.tif"), ("RegA", "SPIMA_reg_{t}.tif"),
        ("RegB", "SPIMB_reg_{t}.tif"), ("Decon/MP_ZProj", "MP_XY_{t}.tif"),
        ("Decon/MP_XProj", "MP_YZ_{t}.tif"), ("Decon/MP_YProj", "MP_ZX_{t}.tif"),
        ("Decon/MP_3D_Xaxis", "MP_3D_Xaxis_{t}.tif"),
        ("Decon/MP_3D_Yaxis", "MP_3D_Yaxis_{t}.tif")]
NUM = re.compile(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch_in")
    _write_drift_inputs(root, n_t=N_T)
    jwrite_tmx(str(root / "init.tmx"),
               np.asarray(dof_to_matrix([1.0, -0.5, 0.4, 0.3, 0.0, 0.0, 1, 1, 1], 6),
                          np.float32))
    return root


def _cfg(root, out, **kw):
    base = dict(
        out_dir=str(out), in_dir1=str(root / "SPIMA"), in_dir2=str(root / "SPIMB"),
        name1="SPIMA_", name2="SPIMB_", img_start=0, img_end=N_T - 1,
        img_interval=1, img_test=1, pixel1=(1.0, 1.0, 2.0), pixel2=(1.0, 1.0, 2.0),
        reg_mode=0, im_rotation=-1, flag_initial_tmx=1,
        tmx_file=str(root / "init.tmx"), ftol=1e-3, it_limit=200,
        save_reg_a=True, save_reg_b=True, psf1_file=str(root / "psf.tif"),
        psf2_file=str(root / "psf.tif"), it_num_decon=3, save_mp_z=True,
        save_mp_y=True, save_mp_x=True, save_3d_x=True, save_3d_y=True,
        bit_per_sample=32, query_device=False, device_num=0, verbose=False)
    base.update(kw)
    return base


def _tree(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs)


def _log_lines(out):
    lines = (out / "ProcessingLog.txt").read_text().replace(str(out), "<out>").splitlines()
    return lines[0], [NUM.sub("#", ln) for ln in lines[1:]]


def _run_both(inputs, tmp_path, monkeypatch, **kw):
    monkeypatch.setenv("MIL_REG_FINISH_LEVEL", "mid")
    jout, pout = tmp_path / "jax", tmp_path / "port"
    assert JB.spim_fusion_batch(JB.BatchConfig(**_cfg(inputs, jout, **kw))) == list(range(N_T))
    assert PB.spim_fusion_batch(PB.BatchConfig(**_cfg(inputs, pout, **kw)),
                                device="cpu") == list(range(N_T))
    assert _tree(pout) == _tree(jout)
    (jfirst, jlog), (pfirst, plog) = _log_lines(jout), _log_lines(pout)
    assert jfirst.startswith("microimagelib_tpu spimFusionBatch:")
    assert pfirst.startswith("microimagelib_tpu_torch spimFusionBatch:")
    assert plog == jlog
    return jout, pout


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4 * np.abs(b).max())


def _outputs_close(pout, jout):
    for t in range(N_T):
        for d, name in RELS:
            f = name.format(t=t)
            _close(readtifstack(str(pout / d / f))[0], readtifstack(str(jout / d / f))[0])


def test_batch_regmode0_matches_jax(inputs, tmp_path, monkeypatch):
    jout, pout = _run_both(inputs, tmp_path, monkeypatch, reg_mode=0)
    for t in range(N_T):
        m, jm = (read_tmx(str(o / "TMX" / f"Matrix_{t}.tmx")) for o in (pout, jout))
        np.testing.assert_array_equal(m, jm)
    _outputs_close(pout, jout)


def test_batch_regmode1_matches_jax(inputs, tmp_path, monkeypatch):
    """regMode 1 registers the test timepoint from the input matrix and
    applies the result to all: the matrices within 0.35 voxel of JAX's;
    the outputs at the batch bound against JAX's regMode 0 applying the
    port's matrix (two registrations land a few hundredths of a voxel
    apart, which moves the decon by more than the bound)."""
    from test_torch_fusion import _box_error

    jout, pout = _run_both(inputs, tmp_path, monkeypatch, reg_mode=1)
    a, _ = readtifstack(str(pout / "RegA" / "SPIMA_reg_0.tif"))
    m = read_tmx(str(pout / "TMX" / "Matrix_1.tmx"))
    for t in range(N_T):
        jm = read_tmx(str(jout / "TMX" / f"Matrix_{t}.tmx"))
        np.testing.assert_array_equal(read_tmx(str(pout / "TMX" / f"Matrix_{t}.tmx")), m)
        assert _box_error(m, jm, a.shape) <= 0.35
    jwrite_tmx(str(tmp_path / "port.tmx"), m)
    japply = tmp_path / "jax_apply"
    JB.spim_fusion_batch(JB.BatchConfig(**_cfg(inputs, japply, reg_mode=0,
                                                tmx_file=str(tmp_path / "port.tmx"))))
    _outputs_close(pout, japply)


@pytest.mark.parametrize("reg_mode,flag_tmx", [(2, 0), (3, 3)])
def test_batch_registering_modes_match_jax(inputs, tmp_path, monkeypatch, reg_mode,
                                           flag_tmx):
    from test_torch_fusion import _box_error

    jout, pout = _run_both(inputs, tmp_path, monkeypatch, reg_mode=reg_mode,
                           flag_initial_tmx=flag_tmx, save_3d_x=False)
    a, _ = readtifstack(str(pout / "RegA" / "SPIMA_reg_0.tif"))
    for t in range(N_T):
        m, jm = (read_tmx(str(o / "TMX" / f"Matrix_{t}.tmx")) for o in (pout, jout))
        assert _box_error(m, jm, a.shape) <= 0.35, t


def test_batch_synchronous_io_matches_jax(inputs, tmp_path, monkeypatch):
    """regMode 2 with overlap_io=False (the read and the writes on the
    main thread): the output tree and the masked log equal, the matrices
    within 0.35 voxel."""
    from test_torch_fusion import _box_error

    jout, pout = _run_both(inputs, tmp_path, monkeypatch, reg_mode=2, flag_initial_tmx=0,
                           save_3d_x=False, overlap_io=False)
    a, _ = readtifstack(str(pout / "RegA" / "SPIMA_reg_0.tif"))
    for t in range(N_T):
        m, jm = (read_tmx(str(o / "TMX" / f"Matrix_{t}.tmx")) for o in (pout, jout))
        assert _box_error(m, jm, a.shape) <= 0.35, t


@pytest.mark.parametrize("env", [
    {"MIL_BATCH_WARM_METHOD": "collapse"},
    {"MIL_BATCH_WARM_METHOD": "1"},
    {"MIL_BATCH_WARM_FINISH": "1"},
    {"MIL_BATCH_WARM_PYRAMID": "1"},
], ids=["warm_method_collapse", "warm_method_1", "warm_finish", "warm_pyramid"])
def test_batch_warm_switches_match_jax(inputs, tmp_path, monkeypatch, env):
    """regMode 2 under each warm-timepoint switch: every registration
    gets the JAX package's choice, method, pyramid and finisher, the
    output tree and the masked log equal, and the cold first matrix is
    within 0.35 voxel. On the CPU at this size the pyramid (> 96^3
    voxels) and the finisher (the card's grad engine) do not engage, so
    the arguments are what holds those two switches to JAX. The warm
    matrices are not compared: under collapse the one 12-DOF stage starts
    at NCC 0.28 here and is ill-conditioned (JAX itself lands 1.1 voxel
    away when its start moves by 1e-6 relative)."""
    from test_torch_fusion import _box_error

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert PB._warm_method(6) == JB._warm_method(6)
    assert PB._warm_finish() == JB._warm_finish()
    calls = {}
    for side, mod in (("jax", JB), ("port", PB)):
        real, log = mod.reg3d, calls.setdefault(side, [])

        def recording(*args, _real=real, _log=log, **kw):
            _log.append((args[2], args[3], kw.get("pyramid", "auto"), kw.get("grad_finish")))
            return _real(*args, **kw)

        monkeypatch.setattr(mod, "reg3d", recording)
    jout, pout = _run_both(inputs, tmp_path, monkeypatch, reg_mode=2, flag_initial_tmx=0,
                           save_3d_x=False)
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == N_T
    m, jm = (read_tmx(str(o / "TMX" / "Matrix_0.tmx")) for o in (pout, jout))
    assert _box_error(m, jm, readtifstack(str(pout / "RegA" / "SPIMA_reg_0.tif"))[0].shape) \
        <= 0.35


def test_batch_group_equals_per_timepoint(inputs, tmp_path, monkeypatch):
    """MIL_BATCH_GROUP=2 (one batched decon per group, a partial last
    group) gives the per-timepoint outputs at the batch bound."""
    outs = {}
    for group in ("1", "2"):
        monkeypatch.setenv("MIL_BATCH_GROUP", group)
        out = tmp_path / group
        assert PB.spim_fusion_batch(PB.BatchConfig(**_cfg(inputs, out, save_3d_x=False)),
                                    device="cpu") == list(range(N_T))
        outs[group] = out
    assert _tree(outs["1"]) == _tree(outs["2"])
    log = (outs["2"] / "ProcessingLog.txt").read_text()
    assert log.count("Deconvolution (group of 2)") == 1
    assert log.count("Deconvolution (group of 1)") == 1
    for t in range(N_T):
        for d, name in RELS:
            if "Xaxis" in d:
                continue
            f = name.format(t=t)
            _close(readtifstack(str(outs["2"] / d / f))[0],
                   readtifstack(str(outs["1"] / d / f))[0])


def test_batch_multicolor_and_background(tmp_path, monkeypatch):
    """Two colors run as two single-color batches; bg1/bg2 on u16 inputs
    (where v + 100 - 100 is exact in float32) give the outputs of the
    background-free inputs bit for bit."""
    psf = gaussian_psf((5, 5, 5), 1.0)
    rng = np.random.default_rng(3)
    main = tmp_path / "main"
    for color, seed in (("488", 1), ("561", 2)):
        for view in ("SPIMA", "SPIMB"):
            os.makedirs(main / color / view)
            for t in range(2):
                v = np.round(rng.random((8, 16, 16)) * 200).astype(np.uint16)
                writetifstack_16to16(str(main / color / view / f"{view}_{t}.tif"), v)
                writetifstack_16to16(str(main / color / view / f"{view}_bg{t}.tif"),
                                     v + 100)
    writetifstack(str(tmp_path / "psf.tif"), psf, 32)
    kw = dict(img_end=1, reg_mode=0, flag_initial_tmx=0, tmx_file="",
              save_reg_a=False, save_reg_b=False, save_3d_x=False, save_3d_y=False,
              save_mp_x=False, save_mp_y=False, it_num_decon=2)
    tmpl = PB.BatchConfig(**_cfg(tmp_path, tmp_path / "unused", **kw))
    tmpl = dataclasses.replace(tmpl, psf1_file=str(tmp_path / "psf.tif"),
                               psf2_file=str(tmp_path / "psf.tif"))
    res = PB.spim_fusion_batch_multicolor(str(main), str(tmp_path / "mc"), tmpl,
                                          device="cpu")
    assert res == {"488": [0, 1], "561": [0, 1]}
    assert PB.find_color_folders(str(main)) == ["488", "561"]
    bg = dataclasses.replace(tmpl, out_dir=str(tmp_path / "bg"),
                             in_dir1=str(main / "561" / "SPIMA"),
                             in_dir2=str(main / "561" / "SPIMB"),
                             name1="SPIMA_bg", name2="SPIMB_bg", bg1=100.0, bg2=100.0)
    assert PB.spim_fusion_batch(bg, device="cpu") == [0, 1]
    for t in range(2):
        ref, _ = readtifstack(str(tmp_path / "mc" / "561" / "Decon" / f"Decon_{t}.tif"))
        got, _ = readtifstack(str(tmp_path / "bg" / "Decon" / f"Decon_{t}.tif"))
        np.testing.assert_array_equal(got, ref)
        assert (tmp_path / "mc" / "488" / "Decon" / "MP_ZProj" / f"MP_XY_{t}.tif").exists()


def test_not_ported_and_no_cuda_raise(inputs, tmp_path, monkeypatch):
    """The mesh-sharded decon (mesh=) and MIL_MULTIHOST, which raised
    before they were ported, now run and match the JAX package's
    MIL_MULTIHOST=1 run with no coordinator (one process, every
    timepoint): a (1, 2) CPU mesh and the port's MIL_MULTIHOST=1 run give
    its tree and its outputs at the batch bound; MIL_MULTIHOST=1 refuses
    regMode 2 before any set-up."""
    cfg = PB.BatchConfig(**_cfg(inputs, tmp_path / "o", save_3d_x=False))
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    assert PB.spim_fusion_batch(cfg, mesh=mesh, device="cpu") == list(range(N_T))
    assert "Device mesh (dp 1, sp 2): cpu, cpu" in (tmp_path / "o" / "ProcessingLog.txt").read_text()
    monkeypatch.setenv("MIL_MULTIHOST", "1")
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    one = dataclasses.replace(cfg, out_dir=str(tmp_path / "one"))
    assert PB.spim_fusion_batch(one, device="cpu") == list(range(N_T))
    assert JB.spim_fusion_batch(JB.BatchConfig(**_cfg(inputs, tmp_path / "ref",
                                                      save_3d_x=False))) == list(range(N_T))
    for out in (tmp_path / "o", tmp_path / "one"):
        assert _tree(out) == _tree(tmp_path / "ref")
        for t in range(N_T):
            for d, name in RELS:
                if "Xaxis" not in d:
                    f = name.format(t=t)
                    _close(readtifstack(str(out / d / f))[0],
                           readtifstack(str(tmp_path / "ref" / d / f))[0])
    with pytest.raises(ValueError, match="regMode 2"):
        PB.spim_fusion_batch(dataclasses.replace(cfg, reg_mode=2,
                                                 out_dir=str(tmp_path / "r2")),
                             device="cpu")
    assert not (tmp_path / "r2").exists()
    monkeypatch.delenv("MIL_MULTIHOST")
    # without CUDA every entry that defaults to the card raises; none falls
    # back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = np.ones((4, 6, 6), np.float32)
    psf = np.ones((3, 3, 3), np.float32)
    for call in (lambda: PB.spim_fusion_batch(cfg),
                 lambda: PF.preprocess_views(v, v, (1, 1, 1), (1, 1, 1), 0),
                 lambda: PF.imresize3d(v, (4, 6, 6)),
                 lambda: PF.imoperation3d(v, 1),
                 lambda: PD.gen_otf(psf, (4, 6, 6)),
                 lambda: PD.rl_decon_single(v, None, None, 1, psf=psf),
                 lambda: PD.rl_decon_dual(v, v, None, None, None, None, 1,
                                          psf_a=psf, psf_b=psf)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
