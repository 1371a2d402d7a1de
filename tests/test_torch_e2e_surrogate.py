"""The port's end-to-end surrogate: its inputs are the JAX tool's
(tools/e2e_surrogate.py) for the same seed, and a small run on the CPU
(2 timepoints, --xy 32, regMode 2, bg 100, 10 iterations) passes the
tool's own checks: the output tree, 16-bit outputs, every final NCC
above 0.5."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import torch

from microimagelib_tpu_torch.io.tiff import readtifstack, readtifstack_16to16
from microimagelib_tpu_torch.tools import e2e_surrogate as PE

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_e2e_surrogate",
                                                  ROOT / "tools" / "e2e_surrogate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inputs_match_the_jax_tool(tmp_path):
    jt = _jax_tool()
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jt.build_inputs(str(tmp_path / "j"), 2, xy=32)
    PE.build_inputs(str(tmp_path / "p"), 2, xy=32, device="cpu")
    np.testing.assert_array_equal(PE.curved_tilted_psf(), jt.curved_tilted_psf())
    for rel in ("SPIMA/SPIMA_0.tif", "SPIMA/SPIMA_1.tif", "SPIMB/SPIMB_0.tif",
                "SPIMB/SPIMB_1.tif"):
        got = readtifstack_16to16(str(tmp_path / "p" / rel))[0]
        ref = readtifstack_16to16(str(tmp_path / "j" / rel))[0]
        assert got.shape == ref.shape == (6, 32, 32)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(readtifstack(str(tmp_path / "p" / "psf.tif"))[0],
                                  readtifstack(str(tmp_path / "j" / "psf.tif"))[0])


def test_surrogate_runs_on_the_cpu():
    timings = {}
    res = PE.run(2, 32, device="cpu", timings=timings)
    assert len(res["nccs"]) == 2 and min(res["nccs"]) > 0.5
    assert res["tp_per_min"] > 0 and sorted(timings) == [0, 1]
    for t in (0, 1):
        assert {"read", "preprocess", "registration", "decon", "mp", "fetch",
                "write"} <= set(timings[t])
    assert os.environ.get("MIL_BATCH_BG1") is None
