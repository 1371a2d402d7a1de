"""The port's batch driver on a device mesh against the JAX package's on
its 8-device virtual CPU mesh, at tests/test_fusion_batch.py's mesh bound
(rtol 2e-4, atol 2e-3): ``spim_fusion_batch(cfg, mesh=...)`` on 3
timepoints with n_dp = 2 (the final group is padded with its last
timepoint), and ``MIL_MESH=2,2`` through the CLI under
``MIL_PLATFORM=cpu``. The port's mesh is of CPU places
(``devices=["cpu"] * 4``). Against the JAX package the matrix is fixed
(regMode 0 with an input matrix), so both sides deconvolve the same
registered views (the registration's own parity is test_torch_batch's);
against the port's run without a mesh, regMode 1 registers as well."""

import numpy as np
import torch

from microimagelib_tpu.cli import spim_fusion_batch as jcli
from microimagelib_tpu.io.tmx import write_tmx as jwrite_tmx
from microimagelib_tpu.models import batch as JB
from microimagelib_tpu.ops.matrix import dof_to_matrix
from microimagelib_tpu.parallel.mesh import make_mesh as j_make_mesh
from microimagelib_tpu_torch.cli import spim_fusion_batch as pcli
from microimagelib_tpu_torch.io.tiff import readtifstack
from microimagelib_tpu_torch.models import batch as PB
from microimagelib_tpu_torch.parallel.mesh import make_mesh
from test_fusion_batch import _write_batch_inputs
from test_torch_batch import _tree

torch.set_num_threads(1)


def _write_inputs(tmp_path):
    _write_batch_inputs(tmp_path, n_t=3)
    jwrite_tmx(str(tmp_path / "init.tmx"),
               np.asarray(dof_to_matrix([1.0, -0.5, 0.4, 0, 0, 0, 1, 1, 1], 6), np.float32))


def _cfg(tmp_path, out, cls, **kw):
    kw = dict(dict(reg_mode=1, flag_initial_tmx=0, tmx_file=""), **kw)
    return cls(
        out_dir=str(out), in_dir1=str(tmp_path / "SPIMA"), in_dir2=str(tmp_path / "SPIMB"),
        name1="SPIMA_", name2="SPIMB_", img_start=0, img_end=2, img_interval=1,
        img_test=0, pixel1=(1.0, 1.0, 1.0), pixel2=(1.0, 1.0, 1.0),
        im_rotation=0, ftol=1e-4, it_limit=300,
        save_reg_a=False, save_reg_b=False, psf1_file=str(tmp_path / "psf1.tif"),
        psf2_file=str(tmp_path / "psf2.tif"), it_num_decon=3, save_mp_z=True,
        save_mp_y=False, save_mp_x=False, save_3d_x=False, save_3d_y=False,
        bit_per_sample=32, query_device=False, device_num=0, verbose=False,
        overlap_io=False, **kw)


def _decon_close(got_dir, ref_dir, n_t=3):
    for t in range(n_t):
        for rel in (f"Decon/Decon_{t}.tif", f"Decon/MP_ZProj/MP_XY_{t}.tif"):
            got, _ = readtifstack(str(got_dir / rel))
            ref, _ = readtifstack(str(ref_dir / rel))
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)


def test_batch_on_mesh_matches_jax_and_no_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("MIL_REG_FINISH_LEVEL", "mid")
    _write_inputs(tmp_path)
    fixed = dict(reg_mode=0, flag_initial_tmx=1, tmx_file=str(tmp_path / "init.tmx"))
    mesh = make_mesh(n_sp=2, n_dp=2, devices=["cpu"] * 4)
    outs = {}
    for name, kw in (("fixed", fixed), ("registered", {})):
        pout, ref = tmp_path / f"port_{name}", tmp_path / f"ref_{name}"
        assert PB.spim_fusion_batch(_cfg(tmp_path, pout, PB.BatchConfig, **kw), mesh,
                                    device="cpu") == [0, 1, 2]
        assert PB.spim_fusion_batch(_cfg(tmp_path, ref, PB.BatchConfig, **kw),
                                    device="cpu") == [0, 1, 2]
        assert _tree(pout) == _tree(ref)
        log = (pout / "ProcessingLog.txt").read_text()
        # two groups: the full one and the padded final one
        assert log.count("Deconvolution (group of 2)") == 1
        assert log.count("Deconvolution (group of 1)") == 1
        assert "fused apply+decon+MIP program" not in log
        _decon_close(pout, ref)
        outs[name] = pout
    jout = tmp_path / "jax"
    assert JB.spim_fusion_batch(_cfg(tmp_path, jout, JB.BatchConfig, **fixed),
                                mesh=j_make_mesh(n_sp=2, n_dp=2)) == [0, 1, 2]
    assert _tree(outs["fixed"]) == _tree(jout)
    _decon_close(outs["fixed"], jout)


def test_batch_cli_mil_mesh_matches_jax(tmp_path, monkeypatch):
    _write_inputs(tmp_path)
    monkeypatch.setenv("MIL_PLATFORM", "cpu")
    monkeypatch.setenv("MIL_MESH", "2,2")
    monkeypatch.setenv("MIL_REG_FINISH_LEVEL", "mid")
    monkeypatch.setenv("MIL_TPU_CACHE", str(tmp_path / "jax_cache"))
    cfg = _cfg(tmp_path, "x", PB.BatchConfig)

    def argv(out):
        a = [str(out), cfg.in_dir1, cfg.in_dir2, "SPIMA_", "SPIMB_", "0", "2", "1", "0",
             "1.0", "1.0", "1.0", "1.0", "1.0", "1.0", "0", "0", "1", str(tmp_path / "init.tmx"), "0.0001",
             "300", "0", "0", cfg.psf1_file, cfg.psf2_file, "3", "0", "0", "1", "0", "0",
             "32", "0", "0"]
        assert len(a) == 34
        return a

    pout, jout = tmp_path / "port", tmp_path / "jax"
    assert pcli.main(argv(pout)) == 0
    assert jcli.main(argv(jout)) == 0
    assert "Device mesh (dp 2, sp 2): cpu, cpu, cpu, cpu" in (
        pout / "ProcessingLog.txt").read_text()
    assert _tree(pout) == _tree(jout)
    _decon_close(pout, jout)
    # the same CLI without the mesh
    monkeypatch.delenv("MIL_MESH")
    ref = tmp_path / "ref"
    assert pcli.main(argv(ref)) == 0
    _decon_close(pout, ref)
