"""The port's CLIs against the JAX package's on the same TIFFs."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.cli import decon_sv as jcli
from microimagelib_tpu_torch.cli import check_device as pcheck
from microimagelib_tpu_torch.cli import decon_sv as pcli
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
    return tmp_path


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

    # same settings banner, line for line, up to the timings
    def banner(text, out_name):
        return [ln.replace(out_name, "OUT") for ln in text.splitlines()
                if "Time cost" not in ln]

    assert banner(port_out, "port.tif") == banner(jax_out, "jax.tif")


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
