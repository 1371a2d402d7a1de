"""A run on the CPU at test size with the timed path broken underneath
(everything of a run but the look for a card): ``correct`` comes out
false for each fault the cells can have. The cells run on one card, so
there is no exchange between cards to leave out."""

import time

import numpy as np
import pytest

import tiny
from milbench import harness
from microimagelib_tpu_torch.models import deconvolution as D
from microimagelib_tpu_torch.models import fusion as FU
from microimagelib_tpu_torch.models import registration as R


def _run(name):
    res, checks = harness.run_cell(tiny.cell(name), tiny.SEED, 0.2, False, "cpu",
                                   time.perf_counter())
    return res, checks


def _frozen_loop(step, est0, n_iters, accel, stop_tol=None):
    """An RL loop whose steps return their state unchanged."""
    return est0


@pytest.mark.parametrize("name", ["decon.sv512.gauss", "decon.sv512.measured",
                                  "fusion.dispim"])
def test_rl_step_returning_its_state(monkeypatch, name):
    monkeypatch.setattr(D, "_rl_loop", _frozen_loop)
    res, checks = _run(name)
    assert not res["correct"], checks
    assert checks["decon_rel_l2"]["value"] > checks["decon_rel_l2"]["limit"]


def test_decon_answer_altered_where_produced(monkeypatch):
    orig = D.decon_singleview

    def altered(*a, **k):
        out = orig(*a, **k)
        out[: out.shape[0] // 4] *= 1.01
        return out

    monkeypatch.setattr(D, "decon_singleview", altered)
    res, checks = _run("decon.sv512.gauss")
    assert not res["correct"], checks


def test_one_view_left_out_of_the_joint_decon(monkeypatch):
    """Half of the fusion's views left out: view A alone stands for both."""
    orig = FU.decon_dualview

    def one_view(img_a, img_b, psf_a, psf_b, **k):
        return orig(img_a, img_a, psf_a, psf_a, **k)

    monkeypatch.setattr(FU, "decon_dualview", one_view)
    res, checks = _run("fusion.dispim")
    assert not res["correct"], checks
    assert checks["decon_rel_l2"]["value"] > checks["decon_rel_l2"]["limit"]


@pytest.mark.parametrize("name", ["reg.dispim", "fusion.dispim"])
def test_registration_returning_its_start(monkeypatch, name):
    """The optimizer's state left unchanged: the starting matrix comes back
    and the source is moved by it."""

    def unmoved(img1, img2, aff_method=7, flag_tmx=False, tmx=None, *a, want_reg=True, **k):
        m = np.asarray(tmx if flag_tmx and tmx is not None else
                       [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float32)
        rec = np.zeros(11)
        reg = R._final_transform(img2, m, tuple(img1.shape), 1) if want_reg else None
        return reg, m, rec

    monkeypatch.setattr(R, "reg3d_affine", unmoved)
    res, checks = _run(name)
    assert not res["correct"], checks
    assert checks["tmx_truth_vox"]["value"] > checks["tmx_truth_vox"]["limit"]


def test_matrix_altered_where_produced(monkeypatch):
    orig = R.reg3d

    def altered(*a, **k):
        reg, tmx, rec = orig(*a, **k)
        tmx = np.array(tmx, np.float32)
        tmx[3] += 0.5
        return reg, tmx, rec

    monkeypatch.setattr(R, "reg3d", altered)
    res, checks = _run("reg.dispim")
    assert not res["correct"], checks
