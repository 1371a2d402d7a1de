"""The port's separable-conv planner and conv3_sep (K1) against the JAX
package's ``plan_sep`` / ``conv3_sep`` (Pallas kernel in interpret mode)
and against the port's own FFT convolution, on the same numpy inputs.

On the CPU, conv3_sep runs its plain PyTorch version; the CUDA kernel
itself is compared with that plain version in test_torch_kernels.py.
Tolerances are tests/test_conv_sep.py's: 2e-5 x max for Gaussian PSFs,
2e-4 x max for the tilted one (the JAX kernel's bf16x3 circulant
matmuls are the looser side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.ops import conv_sep as J
from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.models.deconvolution import _conv_spec, gen_otf
from microimagelib_tpu_torch.ops import conv_sep as P
from test_conv_sep import gauss3, tilted_gauss

torch.set_num_threads(1)

SHAPE = (16, 16, 128)

# (psf, grid, plan kwargs, tolerance x max)
CASES = {
    "odd-gauss": (gauss3((9, 9, 9), (1.5, 2.0, 1.0)), SHAPE, {}, 2e-5),
    "even-gauss": (gauss3((8, 8, 8), (1.2, 1.2, 1.2)), SHAPE, {}, 2e-5),
    "rank2": (gauss3((7, 9, 11), (1.0, 1.5, 2.0))
              + 0.3 * gauss3((7, 9, 11), (2.0, 1.0, 0.8)), SHAPE, {}, 2e-5),
    "long-z": (gauss3((17, 5, 5), (2.5, 1.0, 1.0)), (24, 16, 128), {}, 2e-5),
    "oversized": (gauss3((5, 21, 9), (1.0, 3.0, 1.5)), SHAPE, {}, 2e-5),
    "tilted-rolls": (tilted_gauss((17, 9, 25)), (32, 32, 128),
                     dict(align=True, tol=1e-4), 2e-4),
}


def _jax_circulant(cs, left):
    """Dense f32 circulant of a JAX plan (hi + lo bf16 parts); the y
    circulant is stored transposed for its left multiply."""
    c = (np.asarray(cs[0], np.float32) + np.asarray(cs[1], np.float32))
    return np.swapaxes(c, 1, 2) if left else c


def _circulant(taps, off0, n):
    c = np.zeros((n, n), np.float64)
    w = np.arange(n)
    for j, t in enumerate(taps):
        c[(w - (off0 + j)) % n, w] += t
    return c


@pytest.mark.parametrize("case", list(CASES))
def test_plan_matches_jax(case):
    psf, shape, kw, _ = CASES[case]
    jp = J.plan_sep(psf, shape, **kw)
    pp = P.plan_from_numpy(psf, shape, **kw)
    assert jp is not None and pp is not None
    _zb, a, b, rank, nsteps = jp.meta[:5]
    assert (pp.rank, pp.a, pp.b, pp.nsteps) == (rank, a, b, nsteps)
    np.testing.assert_array_equal(pp.tz, np.asarray(jp.tz))
    rolls = jp.meta[10]
    if rolls is None:
        assert pp.rolls is None
    else:
        np.testing.assert_array_equal(pp.rolls, np.asarray(rolls))
    # x/y taps rebuild the JAX dense circulants within bf16-pair precision
    # (hi + lo keeps ~16 mantissa bits: 2^-16 relative to the largest tap)
    nz, ny, nx = shape
    cx = _jax_circulant((jp.cxh, jp.cxl), left=False)
    cy = _jax_circulant((jp.cyh, jp.cyl), left=True)
    for r in range(rank):
        for theirs, taps, off0, n in ((cx[r], pp.tx[r], pp.ox, nx),
                                      (cy[r], pp.ty[r], pp.oy, ny)):
            ref = _circulant(taps, off0, n)
            np.testing.assert_allclose(theirs, ref,
                                       atol=2 ** -15 * np.abs(ref).max())


@pytest.mark.parametrize("case", list(CASES))
def test_conv_matches_jax_and_fft(rng, case):
    psf, shape, kw, tol = CASES[case]
    v = (rng.random(shape) * 100).astype(np.float32)
    pp = P.plan_sep(psf, shape, **kw)
    out = P.conv3_sep(torch.from_numpy(v), pp).numpy()
    ref = np.asarray(J.conv3_sep(jnp.asarray(v), J.plan_sep(psf, shape, **kw),
                                 interpret=True))
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max())
    fft = _conv_spec(torch.from_numpy(v), gen_otf(psf, shape, device="cpu"), shape).numpy()
    np.testing.assert_allclose(out, fft, atol=tol * np.abs(fft).max())


@pytest.mark.parametrize("mode", ["plain", "ratio", "update"])
def test_modes_match_jax(rng, mode):
    psf = gauss3((9, 9, 9), (1.5, 1.5, 1.5))
    v = (rng.random(SHAPE) * 100).astype(np.float32)
    aux = (rng.random(SHAPE) + 0.5).astype(np.float32)
    out = P.conv3_sep(torch.from_numpy(v), P.plan_sep(psf, SHAPE),
                      aux=torch.from_numpy(aux), mode=mode,
                      smallvalue=20.0).numpy()
    ref = np.asarray(J.conv3_sep(jnp.asarray(v), J.plan_sep(psf, SHAPE),
                                 aux=jnp.asarray(aux), mode=mode,
                                 smallvalue=20.0, interpret=True))
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max())


def test_pair_prefers_aligned_rank_for_tilted_psf():
    """Like the JAX planner, the pair planner keeps the lower-rank
    candidate: the slab-aligned one (rolls present) for a tilted PSF,
    the raw one for a straight Gaussian."""
    psf = tilted_gauss((17, 9, 25))
    fwd, bp = P.plan_sep_pair(psf, psf[::-1, ::-1, ::-1], (32, 32, 256),
                              tol=1e-4)
    jf, jb = J.plan_sep_pair(psf, np.ascontiguousarray(psf[::-1, ::-1, ::-1]),
                             (32, 32, 256), tol=1e-4)
    assert fwd.rolls is not None and bp.rolls is not None
    assert (fwd.rank, bp.rank) == (jf.meta[3], jb.meta[3])
    g = gauss3((9, 9, 9), (1.5, 1.2, 1.8))
    fwd, bp = P.plan_sep_pair(g, g[::-1, ::-1, ::-1], SHAPE)
    assert fwd.rolls is None and (fwd.rank, bp.rank) == (1, 1)


def test_planner_refusals(rng):
    g9 = gauss3((9, 9, 9), (1.5, 1.5, 1.5))
    assert P.plan_sep(rng.random((9, 9, 9)), SHAPE) is None       # full rank
    assert P.plan_sep(np.zeros((5, 5, 5)), SHAPE) is None
    wide = gauss3((3, 3, 301), (0.8, 0.8, 60.0))
    assert P.plan_sep(wide, (16, 16, 512)) is None                # > 128 x taps
    # the TPU grid rules are gone: any nx, any nz
    assert P.plan_sep(g9, (12, 20, 100)) is not None


def test_wrapper_checks(rng):
    plan = P.plan_sep(gauss3((5, 5, 5), (1.0, 1.0, 1.0)), (8, 8, 16))
    v = torch.from_numpy((rng.random((8, 8, 16)) + 1).astype(np.float32))
    with pytest.raises(ValueError, match="aux is required"):
        P.conv3_sep(v, plan, mode="ratio")
    with pytest.raises(ValueError, match="unknown mode"):
        P.conv3_sep(v, plan, aux=v, mode="divide")
    with pytest.raises(TypeError):
        P.conv3_sep(v.double(), plan)
    with pytest.raises(ValueError, match="shape"):
        P.conv3_sep(v[:4], plan)
    with pytest.raises(ValueError, match="contiguous"):
        P.conv3_sep(v.transpose(1, 2).contiguous().transpose(1, 2), plan)
    # neither CPU nor CUDA: no silent plain path
    with pytest.raises(ValueError, match="CPU or CUDA"):
        P.conv3_sep(v.to("meta"), plan)
    before = K.LAUNCHES
    P.conv3_sep(v, plan)
    assert K.LAUNCHES == before   # the CPU runs the plain version, no launch
