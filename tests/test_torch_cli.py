"""The port's CLIs against the JAX package's on the same TIFFs."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.cli import decon_dv as jdv
from microimagelib_tpu.cli import decon_sv as jcli
from microimagelib_tpu.cli import gen_bp as jbp
from microimagelib_tpu_torch.cli import check_device as pcheck
from microimagelib_tpu_torch.cli import decon_dv as pdv
from microimagelib_tpu_torch.cli import decon_sv as pcli
from microimagelib_tpu_torch.cli import gen_bp as pbp
from microimagelib_tpu_torch.io.tiff import readtifstack, writetifstack
from test_cli import blobs, gaussian_psf

torch.set_num_threads(1)


@pytest.fixture
def tiffs(tmp_path, monkeypatch):
    # keep the JAX CLI's compilation cache inside the test's directory
    monkeypatch.setenv("MIL_TPU_CACHE", str(tmp_path / "jax_cache"))
    img = blobs((20, 24, 40), n=6, seed=3) * 50 + 3
    writetifstack(str(tmp_path / "i.tif"), img, 16)
    writetifstack(str(tmp_path / "p.tif"), gaussian_psf((7, 7, 7), 1.3), 32)
    writetifstack(str(tmp_path / "bp.tif"), gaussian_psf((5, 5, 5), 1.0), 32)
    writetifstack(str(tmp_path / "i2.tif"), np.roll(img, 1, axis=2), 16)
    writetifstack(str(tmp_path / "p2.tif"), gaussian_psf((7, 7, 7), 1.6), 32)
    return tmp_path


def _banner(text, out_name):
    """The settings banner, line for line, up to the timings."""
    return [ln.replace(out_name, "OUT") for ln in text.splitlines()
            if "Time cost" not in ln]


@pytest.mark.parametrize("extra", [[], ["-bp", "bp.tif", "-cON"]],
                         ids=["matched", "unmatched-const"])
def test_decon_sv_cli_matches_jax(tiffs, capsys, extra):
    extra = [str(tiffs / a) if a.endswith(".tif") else a for a in extra]
    common = ["-i", str(tiffs / "i.tif"), "-fp", str(tiffs / "p.tif"),
              "-it", "5", "-bit", "32", "-gm", "0"] + extra
    assert pcli.main(common + ["-o", str(tiffs / "port.tif")]) == 0
    port_out = capsys.readouterr().out
    assert jcli.main(common + ["-o", str(tiffs / "jax.tif")]) == 0
    jax_out = capsys.readouterr().out
    out, size = readtifstack(str(tiffs / "port.tif"))
    ref, _ = readtifstack(str(tiffs / "jax.tif"))
    assert size == (40, 24, 20)
    np.testing.assert_allclose(out, ref, rtol=2e-4,
                               atol=2e-4 * np.abs(ref).max())

    assert _banner(port_out, "port.tif") == _banner(jax_out, "jax.tif")


def test_decon_sv_cli_help_and_usage(capsys):
    assert pcli.HELP == jcli.HELP
    assert pcli.main(["-h"]) == 0
    assert "-gm <int>" in capsys.readouterr().out
    assert pcli.main([]) == 0
    assert pcli.main(["-i", "x.tif"]) == 1
    assert "mandatory" in capsys.readouterr().out


def test_decon_sv_cli_needs_cuda_outside_mode_0(tiffs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.main(["-i", str(tiffs / "i.tif"), "-fp", str(tiffs / "p.tif"),
                   "-o", str(tiffs / "o.tif"), "-it", "1", "-dev", "0"])


def test_check_device_cli(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pcheck.main([]) == 0
    assert "Detected 0 CUDA device(s)" in capsys.readouterr().out


def test_gen_bp_cli_matches_jax(tiffs, capsys):
    for method in ("wiener-butterworth", "wiener"):
        args = ["-fp", str(tiffs / "p.tif"), "-method", method, "-alpha",
                "0.01", "-beta", "0.1", "-n", "8"]
        assert pbp.main(args + ["-o", str(tiffs / "bp_port.tif")]) == 0
        assert jbp.main(args + ["-o", str(tiffs / "bp_jax.tif")]) == 0
        out, size = readtifstack(str(tiffs / "bp_port.tif"))
        ref, _ = readtifstack(str(tiffs / "bp_jax.tif"))
        assert size == (7, 7, 7)
        np.testing.assert_array_equal(out, ref)
    text = capsys.readouterr().out
    assert "Back projector written to" in text
    assert pbp.HELP == jbp.HELP
    assert pbp.main(["-fp", "x.tif"]) == 1


@pytest.mark.parametrize("extra", [[], ["-bp1", "wb1.tif", "-bp2", "wb2.tif", "-cON"]],
                         ids=["matched", "wb-const"])
def test_decon_dv_cli_matches_jax(tiffs, capsys, extra):
    """Two views with different PSFs; with -bp1/-bp2 the back projectors
    are the Wiener-Butterworth ones genBackProjector writes."""
    for n in ("1", "2"):
        fp_name = "p.tif" if n == "1" else "p2.tif"
        assert pbp.main(["-fp", str(tiffs / fp_name), "-o",
                         str(tiffs / f"wb{n}.tif")]) == 0
    capsys.readouterr()
    extra = [str(tiffs / a) if a.endswith(".tif") else a for a in extra]
    common = ["-i1", str(tiffs / "i.tif"), "-i2", str(tiffs / "i2.tif"),
              "-fp1", str(tiffs / "p.tif"), "-fp2", str(tiffs / "p2.tif"),
              "-it", "3", "-bit", "32", "-gm", "0"] + extra
    assert pdv.main(common + ["-o", str(tiffs / "port.tif")]) == 0
    port_out = capsys.readouterr().out
    assert jdv.main(common + ["-o", str(tiffs / "jax.tif")]) == 0
    jax_out = capsys.readouterr().out
    out, size = readtifstack(str(tiffs / "port.tif"))
    ref, _ = readtifstack(str(tiffs / "jax.tif"))
    assert size == (40, 24, 20)
    np.testing.assert_allclose(out, ref, rtol=2e-4,
                               atol=2e-4 * np.abs(ref).max())
    assert _banner(port_out, "port.tif") == _banner(jax_out, "jax.tif")


def test_decon_dv_cli_size_mismatch_and_usage(tmp_path, capsys):
    psf = gaussian_psf((5, 5, 5), 1.0)
    writetifstack(str(tmp_path / "a.tif"), np.ones((8, 8, 8), np.float32), 32)
    writetifstack(str(tmp_path / "b.tif"), np.ones((8, 8, 9), np.float32), 32)
    writetifstack(str(tmp_path / "p.tif"), psf, 32)
    writetifstack(str(tmp_path / "q.tif"), gaussian_psf((5, 5, 7), 1.0), 32)
    args = ["-i1", str(tmp_path / "a.tif"), "-fp1", str(tmp_path / "p.tif"),
            "-o", str(tmp_path / "o.tif"), "-gm", "0"]
    assert pdv.main(args + ["-i2", str(tmp_path / "b.tif"),
                            "-fp2", str(tmp_path / "p.tif")]) == 1
    assert "same image size" in capsys.readouterr().out
    assert pdv.main(args + ["-i2", str(tmp_path / "a.tif"),
                            "-fp2", str(tmp_path / "q.tif")]) == 1
    assert "forward projectors" in capsys.readouterr().out
    assert pdv.HELP == jdv.HELP
    assert pdv.main(["-i1", "x.tif"]) == 1
    assert "mandatory" in capsys.readouterr().out
