"""The plain reference against the port's CPU path at small sizes: the
resample and turn, the affine transform and the registration's NCC, RL
single and dual view, and the truth matrix the generator's geometry
implies against what the port's registration finds."""

import numpy as np
import pytest
import torch

import tiny
from milbench import data, generate, reference
from milbench.judge import rel_l2
from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.models import deconvolution as D
from microimagelib_tpu_torch.models import fusion as FU
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.ops.affine import affine_transform_3d

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def views():
    c = tiny.cell("fusion.dispim")
    return c.config, generate.make_pool(c.config, c.traffic, tiny.SEED, CPU)


def test_isotropize_matches_preprocess_views(views):
    cfg, pool = views
    it = pool[2]
    a, b = FU.preprocess_views(it["a"], it["b"], tuple(cfg["pixel_a"]),
                               tuple(cfg["pixel_b"]), cfg["im_rotation"], "cpu")
    ar, br = reference.isotropize(torch.from_numpy(it["a"]), torch.from_numpy(it["b"]), cfg)
    assert rel_l2(a, ar) < 1e-6 and rel_l2(b, br) < 1e-6


def test_affine_and_ncc_match_the_port(views):
    cfg, pool = views
    it = pool[1]
    a, b = (v.float() for v in reference.isotropize(
        torch.from_numpy(it["a"]), torch.from_numpy(it["b"]), cfg))
    m = it["truth"]
    port = affine_transform_3d(b, np.asarray(m, np.float32), tuple(b.shape))
    assert rel_l2(port, reference.affine(b.double(), m, tuple(b.shape))) < 1e-5
    src_ms, tgt_ms, _se2, st2 = R._reg_stats(b, a)
    ss, st = (float(v) for v in C.corr3d(src_ms, tgt_ms, np.asarray(m, np.float32)))
    port_ncc = st / np.sqrt(ss) / np.sqrt(st2)
    assert abs(port_ncc - reference.ncc(a, b, m)) < 1e-6


@pytest.mark.parametrize("psf", ["gauss9", "curved_tilted"])
def test_rl_single_matches_decon_singleview(psf):
    gen = torch.Generator().manual_seed(3)
    img = torch.rand((20, 24, 36), generator=gen) * 100
    k = data.psf(psf)
    port = D.decon_singleview(img.numpy(), k, n_iters=5, mem_mode=0)
    assert rel_l2(port, reference.rl_single(img, k, 5)) < 1e-5


def test_rl_dual_matches_decon_dualview():
    gen = torch.Generator().manual_seed(4)
    a = torch.rand((20, 24, 36), generator=gen) * 100
    b = torch.rand((20, 24, 36), generator=gen) * 100
    k = data.psf("curved_tilted")
    port = D.decon_dualview(a.numpy(), b.numpy(), k, k, n_iters=4, mem_mode=0)
    assert rel_l2(port, reference.rl_dual(a, b, k, k, 4)) < 1e-5


def test_padding_grid_follows_the_size_policy():
    from microimagelib_tpu_torch.ops.basics import snap_fft_size

    for n in (1, 17, 52, 100, 130, 320, 500, 512, 700, 1000):
        assert reference.snap_fft_size(n) == snap_fft_size(n)


def test_truth_matrix_is_what_registration_finds(views):
    """The port's registration on the tiny views lands near the truth the
    generator's geometry implies, at every timepoint's drift; the
    identity does not."""
    cfg, pool = views
    grid = data.iso_shape(cfg)
    for it in pool:
        a, b = FU.preprocess_views(it["a"], it["b"], tuple(cfg["pixel_a"]),
                                   tuple(cfg["pixel_b"]), cfg["im_rotation"], "cpu",
                                   as_device=True)
        _reg, tmx, _rec = R.reg3d(a, b, 2, 7, mem_mode=0, device="cpu")
        assert data.box_error(tmx, it["truth"], grid) < 2.0
        ident = [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]
        assert data.box_error(ident, it["truth"], grid) > 3.0
