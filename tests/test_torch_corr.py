"""K5 and K4 (resample + NCC partials, without and with the gradient in
the matrix): the port's plain versions against the JAX package's Pallas
kernels (interpret mode), ``grad_fallback_xla`` and the gather path; a
numpy transliteration of the CUDA kernel's arithmetic against the plain
version; ``NCCPartials``; and the route dispatch.

Tolerances are the JAX package's own (tests/test_registration_grad.py):
ss and st within rtol 1e-5, gs and gt within 2e-4 x max|ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.ops.affine import corr3d_partials as jax_gather
from microimagelib_tpu.ops.matrix import dof_to_matrix as jax_dof_to_matrix
from microimagelib_tpu.ops.pallas_corr import (
    corr3d_grad_pallas as jax_grad_pallas,
)
from microimagelib_tpu.ops.pallas_corr import (
    corr3d_partials_pallas as jax_partials_pallas,
)
from microimagelib_tpu.ops.pallas_corr import grad_fallback_xla
from microimagelib_tpu_torch.kernels import corr as K
from microimagelib_tpu_torch.ops import corr as C
from microimagelib_tpu_torch.ops.affine import corr3d_grad_torch, corr3d_partials

torch.set_num_threads(1)

MATRICES = {
    "shift": np.array([1, 0, 0, 0.6, 0, 1, 0, -0.8, 0, 0, 1, 0.3], np.float32),
    "shear-scale": np.array([0.99, 0.05, 0, 0.2, -0.05, 0.99, 0, 0.1,
                             0, 0.02, 1.01, -0.4], np.float32),
    "rot10": jax_dof_to_matrix([0.5, -0.3, 0.2, 10.0, 0, 0, 1, 1, 1], 6),
    "partly-outside": jax_dof_to_matrix([6.0, -3.0, 2.0, 4.0, 0, 0, 1, 1, 1], 6),
}


def _volumes(shape):
    rng = np.random.default_rng(0)
    return (rng.random(shape).astype(np.float32),
            rng.random(shape).astype(np.float32))


def _close_sums(ss, st, ss_ref, st_ref):
    np.testing.assert_allclose(float(ss), float(ss_ref), rtol=1e-5)
    np.testing.assert_allclose(float(st), float(st_ref), rtol=1e-5)


def _close_grads(g, g_ref):
    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    scale = max(np.abs(g_ref).max(), 1e-6)
    np.testing.assert_allclose(g, g_ref, atol=2e-4 * scale)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("shape", [(8, 16, 32), (8, 16, 256)],
                         ids=["x32", "x256"])
def test_plain_versions_match_jax_kernels(shape):
    """The port's plain K5/K4 against the Pallas kernels in interpret mode,
    and against XLA autodiff through the gather path (grad_fallback_xla)
    and the gather sums; x = 256 is beyond the one-lane-tile envelope the
    JAX package kept its kernel in.

    The port computes coordinates in the Pallas kernels' order and is held
    to them at the stated tolerances. The gather path rounds coordinates in
    another order; where one lands on a lattice point, its floor (and the
    one-sided derivative) or its validity flips. With the shear/scale
    matrix at x = 256 that makes the JAX package's own kernel and fallback
    differ by ~1e-4 in ss and 1-3% of max in the gradients (ROADMAP.md §3),
    so against the gather path the port is held to the stated tolerance
    plus the JAX kernel's own distance from it."""
    src, tgt = _volumes(shape)
    js, jt = jnp.asarray(src), jnp.asarray(tgt)
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    for name, m in MATRICES.items():
        ss, st = corr3d_partials(ts, tt, m)
        ssp, stp = jax_partials_pallas(js, jt, m, interpret=True)
        _close_sums(ss, st, ssp, stp)
        for mine, kern, ref in zip((ss, st), (ssp, stp), jax_gather(js, jt, m)):
            assert _gap(mine, ref) <= _gap(kern, ref) + 1e-5 * abs(float(ref))
        ss2, st2, gs, gt = corr3d_grad_torch(ts, tt, m)
        _close_sums(ss2, st2, ss, st)
        ssp, stp, gsp, gtp = jax_grad_pallas(js, jt, m, interpret=True)
        _close_sums(ss2, st2, ssp, stp)
        _ssx, _stx, gsx, gtx = grad_fallback_xla(js, jt, m)
        for mine, kern, ref in ((gs, gsp, gsx), (gt, gtp, gtx)):
            _close_grads(mine, kern)
            scale = max(np.abs(np.asarray(ref)).max(), 1e-6)
            assert _gap(mine, ref) <= _gap(kern, ref) + 2e-4 * scale, name
        if name == "partly-outside":
            # the matrix maps part of the grid outside the source: an
            # all-ones source samples 1 inside the box and 0 outside
            n_in, _ = corr3d_partials(torch.ones(shape), tt, m)
            assert 0 < float(n_in) < 0.8 * np.prod(shape)


# --------------------------------------------------------------------------
# numpy transliteration of csrc/corr.cu
# --------------------------------------------------------------------------

def _lerp(a, b, f):
    return a + (b - a) * f


def kernel_numpy(src, tgt, m, grad):
    """csrc/corr.cu's per-voxel arithmetic in float32 numpy, each operation
    rounded on its own as the kernel's __f*_rn intrinsics are: coordinates
    m00*x + ((m01*y + m02*z) + m03), the strict box, per-corner clamps, the
    lerps, the derivative lerps and the per-row x / 1 sums scaled by y and
    z; sums over blocks of rows_per_block rows in float64."""
    f32 = np.float32
    sz, sy, sx = src.shape
    m = np.asarray(m, f32)
    xf = np.arange(sx, dtype=f32)[None, None, :]
    yf = np.arange(sy, dtype=f32)[None, :, None]
    zf = np.arange(sz, dtype=f32)[:, None, None]
    c = [m[4 * a] * xf + ((m[4 * a + 1] * yf + m[4 * a + 2] * zf) + m[4 * a + 3])
         for a in range(3)]
    cx, cy, cz = c
    valid = ((cx > f32(-0.5)) & (cy > f32(-0.5)) & (cz > f32(-0.5))
             & (cx < f32(sx - 0.5)) & (cy < f32(sy - 0.5)) & (cz < f32(sz - 0.5)))
    fl = [np.floor(v) for v in c]
    fx, fy, fz = (v - f for v, f in zip(c, fl))
    idx = []
    for f, n in zip(fl, (sx, sy, sz)):
        r = np.where(valid, f, 0).astype(np.int64)
        idx.append((np.maximum(r, 0), np.minimum(r + 1, n - 1)))
    (x0, x1), (y0, y1), (z0, z1) = idx
    flat = src.reshape(-1)

    def at(zz, yy, xx):
        return flat[(zz * sy + yy) * sx + xx]

    v000, v001 = at(z0, y0, x0), at(z0, y0, x1)
    v010, v011 = at(z0, y1, x0), at(z0, y1, x1)
    v100, v101 = at(z1, y0, x0), at(z1, y0, x1)
    v110, v111 = at(z1, y1, x0), at(z1, y1, x1)
    c00, c01 = _lerp(v000, v001, fx), _lerp(v010, v011, fx)
    c10, c11 = _lerp(v100, v101, fx), _lerp(v110, v111, fx)
    c0, c1 = _lerp(c00, c01, fy), _lerp(c10, c11, fy)
    s = np.where(valid, _lerp(c0, c1, fz), f32(0))
    t = tgt
    out = [np.sum((s * s).astype(np.float64)), np.sum((s * t).astype(np.float64))]
    if not grad:
        return np.array(out)
    ds = [_lerp(_lerp(v001 - v000, v011 - v010, fy),
                _lerp(v101 - v100, v111 - v110, fy), fz),
          _lerp(c01 - c00, c11 - c10, fz),
          c1 - c0]
    rows_y = yf[..., 0].astype(np.float64)
    rows_z = zf[..., 0].astype(np.float64)
    gs, gt = np.zeros(12), np.zeros(12)
    for a in range(3):
        for g, w in ((gs, s), (gt, t)):
            u = np.where(valid, w * ds[a], f32(0)).astype(np.float64)
            a1 = np.sum(u * xf, axis=2)   # per row: sum u*x
            a0 = np.sum(u, axis=2)        # per row: sum u
            g[4 * a + 0] = a1.sum()
            g[4 * a + 1] = (rows_y * a0).sum()
            g[4 * a + 2] = (rows_z * a0).sum()
            g[4 * a + 3] = a0.sum()
    return np.concatenate([out, gs, gt])


@pytest.mark.parametrize("shape", [(8, 16, 32), (9, 7, 300)])
@pytest.mark.parametrize("name", list(MATRICES))
def test_kernel_transliteration_matches_plain(shape, name):
    """The CUDA kernel's index, clamp, lerp and derivative arithmetic
    (transliterated) against the plain versions, at an x not a multiple of
    the 128-thread stride and odd row counts."""
    src, tgt = _volumes(shape)
    m = MATRICES[name]
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    ref = K.corr3d_torch(ts, tt, m, grad=True).numpy()
    got = kernel_numpy(src, tgt, m, grad=True)
    _close_sums(got[0], got[1], ref[0], ref[1])
    _close_grads(got[2:14], ref[2:14])
    _close_grads(got[14:], ref[14:])
    np.testing.assert_array_equal(kernel_numpy(src, tgt, m, grad=False), got[:2])


def test_clamped_corners_give_zero_derivative():
    """At -0.5 < c < 0 both x corners clamp to texel 0: the sample is that
    texel and ds/dcx is 0 in the kernel arithmetic and in autograd."""
    src, tgt = _volumes((4, 6, 8))
    m = np.array([1, 0, 0, -0.25, 0, 1, 0, 0, 0, 0, 1, 0], np.float32)
    m[0] = 1e-4  # every voxel samples x in (-0.25, -0.2492): the clamped band
    ref = K.corr3d_torch(torch.from_numpy(src), torch.from_numpy(tgt), m,
                         grad=True).numpy()
    got = kernel_numpy(src, tgt, m, grad=True)
    np.testing.assert_allclose(ref[2:6], 0.0, atol=1e-12)
    np.testing.assert_allclose(got[2:6], 0.0, atol=1e-12)
    np.testing.assert_allclose(ref[:2], got[:2], rtol=1e-6)


def test_blocks_cover_every_row():
    for shape in [(256, 512, 512), (64, 128, 512), (16, 32, 128), (9, 7, 300),
                  (1, 1, 5000)]:
        sz, sy, sx = shape
        rows = K.rows_per_block(sx)
        blocks = -(-(sz * sy) // rows)
        assert rows >= 1 and (blocks - 1) * rows < sz * sy <= blocks * rows
        assert rows * sx <= K.VOXELS_PER_BLOCK or rows == 1


# --------------------------------------------------------------------------
# NCCPartials and the dispatch
# --------------------------------------------------------------------------

def test_ncc_partials_backward_matches_grad_torch():
    src, tgt = _volumes((8, 12, 20))
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    m0 = MATRICES["shear-scale"]
    m = torch.tensor(m0, requires_grad=True)
    ss, st = C.NCCPartials.apply(m, ts, tt, None)
    ss_r, st_r, gs_r, gt_r = corr3d_grad_torch(ts, tt, m0)
    assert float(ss.detach()) == float(ss_r) and float(st.detach()) == float(st_r)
    g_ss, g_st = 0.7, -1.3
    (g_ss * ss + g_st * st).backward()
    ref = (2 * g_ss * gs_r + g_st * gt_r).float().numpy()
    np.testing.assert_allclose(m.grad.numpy(), ref, rtol=1e-6, atol=1e-6)
    # without a gradient the forward is the sums alone (K5's plain version)
    before = K.PLAIN_CALLS
    with torch.no_grad():
        ss3, st3 = C.NCCPartials.apply(torch.tensor(m0), ts, tt, None)
    assert K.PLAIN_CALLS == before + 1
    _close_sums(ss3, st3, ss_r, st_r)


def test_resolve_ncc_impl_reads_the_array(monkeypatch):
    """A CPU tensor never selects the kernel; a CUDA tensor selects the
    plain version only when MIL_NCC_IMPL asks for it (an object with a
    CUDA ``device`` stands in for a card tensor here)."""
    cpu = torch.zeros((2, 2, 2))

    class FakeCuda:
        device = torch.device("cuda", 0)

    for env, on_cpu, on_cuda in (("auto", "gather", "pallas"),
                                 ("pallas", "gather", "pallas"),
                                 ("gather", "gather", "gather"),
                                 ("mxu", "gather", "gather")):
        monkeypatch.setenv("MIL_NCC_IMPL", env)
        assert C.resolve_ncc_impl(cpu) == on_cpu
        assert C.resolve_ncc_impl(FakeCuda()) == on_cuda
    monkeypatch.delenv("MIL_NCC_IMPL")
    assert C.resolve_ncc_impl(cpu) == "gather"
    assert C.resolve_ncc_impl(FakeCuda()) == "pallas"
    monkeypatch.setenv("MIL_NCC_IMPL", "bogus")
    with pytest.raises(ValueError, match="MIL_NCC_IMPL"):
        C.resolve_ncc_impl(cpu)


def test_cpu_dispatch_runs_plain_and_counts(monkeypatch):
    src, tgt = _volumes((4, 8, 16))
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    m = MATRICES["rot10"]
    k4, k5, plain = K.K4_LAUNCHES, K.K5_LAUNCHES, K.PLAIN_CALLS
    ss, st = C.corr3d_partials_pallas(ts, tt, m)
    ss2, st2, gs, gt = C.corr3d_grad_pallas(ts, tt, m)
    monkeypatch.setenv("MIL_NCC_IMPL", "gather")
    ss3, st3 = C.corr3d_auto(ts, tt, m)
    assert (K.K4_LAUNCHES, K.K5_LAUNCHES) == (k4, k5)
    assert K.PLAIN_CALLS == plain + 3
    assert ss.device.type == "cpu" and ss.dtype == torch.float64
    assert gs.shape == (12,) and gt.shape == (12,)
    _close_sums(ss, st, ss2, st2)
    _close_sums(ss3, st3, ss, st)


def test_wrapper_checks_inputs():
    src, tgt = _volumes((4, 8, 16))
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    m = MATRICES["shift"]
    with pytest.raises(TypeError):
        K.corr3d(ts.double(), tt, m)
    with pytest.raises(ValueError, match="shape"):
        K.corr3d(ts, tt[:, :, :8].contiguous(), m)
    with pytest.raises(ValueError, match="contiguous"):
        K.corr3d(ts.transpose(0, 2), tt.transpose(0, 2), m)
    with pytest.raises(ValueError, match="12 entries"):
        K.corr3d(ts, tt, m[:6])
