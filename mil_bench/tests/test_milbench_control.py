"""The control (the plain reference in bfloat16 put in the program's
place) comes out not correct against each cell's limits, at test size;
the program comes out correct on the same items."""

import pytest
import torch

import calibrate
import tiny
from milbench import judge

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", sorted(tiny.SIZES))
def test_control_is_not_correct(name):
    cell = tiny.cell(name)
    readings = calibrate.control_readings(cell, tiny.SEED, CPU)
    ok, checks = judge.verdict([readings], cell.limits, 1, 0)
    assert not ok, checks
    failed = [k for k, v in checks.items() if v["limit"] is not None and v["value"] > v["limit"]]
    assert failed


@pytest.mark.parametrize("name", ["decon.sv512.measured", "fusion.dispim"])
def test_program_is_correct_at_test_size(name):
    import time

    from milbench import harness

    res, checks = harness.run_cell(tiny.cell(name), tiny.SEED, 0.2, False, "cpu",
                                   time.perf_counter())
    assert res["correct"], checks
