"""The port's spimFusionBatch CLI against the JAX package's on the same
TIFFs, on the CPU (MIL_PLATFORM=cpu, the JAX CLIs' own switch): the 34-
and 36-argument forms (the latter with unmatched back projectors), the
output tree, ProcessingLog.txt with numbers masked, and the 16-bit decon
and MPs at the JAX batch bound."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.cli import spim_fusion_batch as jcli
from microimagelib_tpu.io.tmx import write_tmx as jwrite_tmx
from microimagelib_tpu.ops.matrix import dof_to_matrix
from microimagelib_tpu_torch.cli import spim_fusion_batch as pcli
from microimagelib_tpu_torch.io.tiff import gettifinfo, readtifstack, writetifstack
from test_fusion_batch import _write_drift_inputs, gaussian_psf
from test_torch_batch import _log_lines, _tree

torch.set_num_threads(1)


def _argv(root, out, n_args):
    a = [str(out), str(root / "SPIMA"), str(root / "SPIMB"), "SPIMA_", "SPIMB_",
         "0", "1", "1", "0", "1.0", "1.0", "2.0", "1.0", "1.0", "2.0",
         "0", "-1", "1", str(root / "init.tmx"), "0.001", "200", "1", "0",
         str(root / "psf.tif"), str(root / "psf.tif"), "3", "1", "0", "1", "0", "1",
         "16", "0", "0"]
    if n_args == 36:
        a += [str(root / "bp.tif"), str(root / "bp.tif")]
    return a


@pytest.mark.parametrize("n_args", [34, 36])
def test_batch_cli_matches_jax(tmp_path, monkeypatch, n_args):
    _write_drift_inputs(tmp_path, n_t=2)
    writetifstack(str(tmp_path / "bp.tif"), gaussian_psf((5, 5, 5), 0.8), 32)
    jwrite_tmx(str(tmp_path / "init.tmx"),
               np.asarray(dof_to_matrix([0.5, 0, 0, 0.4, -0.3, 0, 1, 1, 1], 6),
                          np.float32))
    monkeypatch.setenv("MIL_PLATFORM", "cpu")
    monkeypatch.setenv("MIL_TPU_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("MIL_REG_FINISH_LEVEL", "mid")
    jout, pout = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(_argv(tmp_path, jout, n_args)) == 0
    assert pcli.main(_argv(tmp_path, pout, n_args)) == 0
    assert _tree(pout) == _tree(jout)
    assert _log_lines(pout)[1] == _log_lines(jout)[1]
    unmatched = "joint deconvolution: yes" in (pout / "ProcessingLog.txt").read_text()
    assert unmatched == (n_args == 36)
    for t in range(2):
        for rel in (f"Decon/Decon_{t}.tif", f"Decon/MP_ZProj/MP_XY_{t}.tif",
                    f"Decon/MP_XProj/MP_YZ_{t}.tif", f"RegA/SPIMA_reg_{t}.tif",
                    f"Decon/MP_3D_Yaxis/MP_3D_Yaxis_{t}.tif"):
            got, _ = readtifstack(str(pout / rel))
            ref, _ = readtifstack(str(jout / rel))
            assert gettifinfo(str(pout / rel))[1] == 16
            # u16 outputs: the float bound plus one count of truncation
            np.testing.assert_allclose(got, ref, rtol=2e-4,
                                       atol=2e-4 * np.abs(ref).max() + 1)


def test_batch_cli_usage_and_mesh(tmp_path, monkeypatch, capsys):
    """Usage and argument count; MIL_MESH (which raised before the mesh was
    ported) runs the decon over a (2, 1) CPU mesh under MIL_PLATFORM=cpu,
    with the outputs of the run without it at the batch bound."""
    assert pcli.main([]) == 0
    assert pcli.main(["-h"]) == 0
    assert "34 or 36" in capsys.readouterr().out
    assert pcli.main(["a"] * 35) == 1
    _write_drift_inputs(tmp_path, n_t=2)
    jwrite_tmx(str(tmp_path / "init.tmx"),
               np.asarray(dof_to_matrix([0.5, 0, 0, 0.4, -0.3, 0, 1, 1, 1], 6),
                          np.float32))
    monkeypatch.setenv("MIL_PLATFORM", "cpu")
    assert pcli.main(_argv(tmp_path, tmp_path / "ref", 34)) == 0
    monkeypatch.setenv("MIL_MESH", "2,1")
    assert pcli.main(_argv(tmp_path, tmp_path / "o", 34)) == 0
    assert "Device mesh (dp 2, sp 1): cpu, cpu" in (tmp_path / "o" / "ProcessingLog.txt").read_text()
    assert _tree(tmp_path / "o") == _tree(tmp_path / "ref")
    for t in range(2):
        for rel in (f"Decon/Decon_{t}.tif", f"Decon/MP_ZProj/MP_XY_{t}.tif"):
            got, _ = readtifstack(str(tmp_path / "o" / rel))
            ref, _ = readtifstack(str(tmp_path / "ref" / rel))
            np.testing.assert_allclose(got, ref, rtol=2e-4,
                                       atol=2e-4 * np.abs(ref).max() + 1)
