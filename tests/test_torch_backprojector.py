"""The port's back-projector generator (a numpy copy) against the JAX
package's, and the Guo 2020 acceleration through the port's RL.

Equality is to float32 rounding: both run the same float64 numpy and
round once, so they agree to one float32 ulp of the largest tap."""

import numpy as np
import pytest
import torch

from microimagelib_tpu.models.backprojector import gen_backprojector as jgen
from microimagelib_tpu_torch.models import gen_backprojector
from microimagelib_tpu_torch.models.deconvolution import decon_singleview
from test_backprojector import beads, blur, corr, gaussian_psf
from test_conv_sep import gauss3

torch.set_num_threads(1)


@pytest.mark.parametrize("method,kw", [
    ("wiener", {}),
    ("butterworth", {}),
    ("wiener-butterworth", {}),
    ("wiener-butterworth", dict(alpha=0.05, beta=0.2, n=8)),
    ("wiener-butterworth", dict(kc=0.12)),     # explicit cutoff
    ("butterworth", dict(kc=0.3, n=4)),
])
@pytest.mark.parametrize("psf", [
    gaussian_psf((9, 9, 9), 1.5),
    gauss3((25, 25, 25), (3.5, 1.2, 1.2)),     # the anisotropic light-sheet class
], ids=["gauss9", "aniso25"])
def test_gen_backprojector_matches_jax(psf, method, kw):
    out = gen_backprojector(psf, method=method, **kw)
    ref = jgen(psf, method=method, **kw)
    assert out.dtype == ref.dtype == np.float32 and out.shape == psf.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=np.spacing(np.abs(ref).max()))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown back-projector"):
        gen_backprojector(gaussian_psf((5, 5, 5), 1.0), method="nope")


def test_wb_accelerates_port_rl():
    """Each WB iteration through the port's RL is worth more than a
    traditional one (tests/test_backprojector.py's claim)."""
    shape = (32, 32, 32)
    truth = beads(shape, n=8, seed=1)
    psf = gaussian_psf((11, 11, 11), 1.8)
    img = blur(truth, psf)
    bp = gen_backprojector(psf, method="wiener-butterworth", alpha=0.05,
                           beta=0.2, n=8)
    for it in (1, 2):
        trad = decon_singleview(img, psf, n_iters=it, mem_mode=0)
        wb = decon_singleview(img, psf, n_iters=it, psf_bp=bp, mem_mode=0)
        assert corr(wb, truth) > corr(trad, truth) + 0.005, it
