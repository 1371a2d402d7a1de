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
from test_torch_kernels import _fma32, kernel_numpy

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
# the numpy transliteration of csrc/corr.cu and the launch plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 16, 32), (9, 7, 300)])
@pytest.mark.parametrize("name", list(MATRICES))
def test_kernel_transliteration_matches_plain(shape, name):
    """The CUDA kernel's index, clamp, lerp and derivative arithmetic and
    its summation order (transliterated) against the plain versions, at an
    x not a multiple of the warp, odd row counts, and on the H100's plan
    (one step a warp here) and a one-SM card's (several steps a warp,
    rows advanced across z). K4's ss and st are K5's bits wherever their
    plans agree."""
    src, tgt = _volumes(shape)
    m = MATRICES[name]
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    ref = K.corr3d_torch(ts, tt, m, grad=True).numpy()
    for sms in (K.H100_SMS, 1):
        got = kernel_numpy(src, tgt, m, True, sms)
        _close_sums(got[0], got[1], ref[0], ref[1])
        _close_grads(got[2:14], ref[2:14])
        _close_grads(got[14:], ref[14:])
        sums = kernel_numpy(src, tgt, m, False, sms)
        _close_sums(sums[0], sums[1], ref[0], ref[1])
        if K.launch_plan(shape, False, sms) == K.launch_plan(shape, True, sms):
            np.testing.assert_array_equal(sums, got[:2])


def test_fma32_rounds_once():
    """The transliteration's __fmaf_rn: (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24
    lies halfway between two float32 values; plus +-2^-60, lost in the
    float64 sum, the one rounding goes up or down, where rounding twice
    would go to even both times."""
    a = np.float32(1 + 2 ** -12)
    lo, hi = np.float32(1 + 2 ** -11), np.float32(1 + 2 ** -11 + 2 ** -23)
    assert _fma32(a, a, np.float32(0)) == lo                     # a tie: to even
    assert _fma32(a, a, np.float32(2 ** -60)) == hi
    assert _fma32(a, a, np.float32(-2 ** -60)) == lo
    assert _fma32(np.float32(3), np.float32(0.5), np.float32(0.25)) == np.float32(1.75)


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


# chip_smoke.py's REG_LEVELS (Phase 10's pyramid) and fusion_levels()
# (Phase 14's), the odd shapes, and grids on both sides of 2^31 voxels
PLAN_SHAPES = ([(16, 32, 128), (32, 64, 256), (64, 128, 512), (128, 256, 512),
                (256, 512, 512)]
               + [(10, 16, 320), (20, 32, 320), (40, 64, 320), (80, 128, 320),
                  (160, 256, 320), (320, 512, 320)]
               + [(9, 7, 300), (1, 1, 5000), (1023, 1024, 2048), (1024, 1024, 2048)])


def test_plan_shapes_are_the_fusion_pyramid():
    from microimagelib_tpu_torch.models import registration as R

    full = (320, 512, 320)
    levels = [tuple(s // k for s, k in zip(full, f))
              for f in R.pyramid_levels(R._auto_pool_factors(full))] + [full]
    assert levels == PLAN_SHAPES[5:11]


def _walk(plan, shape, sm_count):
    """The task of every (block, warp, step) as csrc/corr.cu walks them:
    decoded once (first_task), then advanced by WARPS tasks a step without
    division (next_task); checked against the direct decode. Returns the
    task ids the walk visits."""
    _sz, sy, _sx = shape
    wsegs, tasks, steps = plan["wsegs"], plan["tasks"], plan["steps"]
    task = (np.arange(plan["blocks"])[:, None] * steps) * K.WARPS + np.arange(K.WARPS)
    row, seg = np.divmod(task, wsegs)
    z, y = np.divmod(row, sy)
    dseg, drow = K.WARPS % wsegs, K.WARPS // wsegs
    dy, dz = drow % sy, drow // sy
    seen = []
    for _k in range(steps):
        live = task < tasks
        row_d, seg_d = np.divmod(task[live], wsegs)
        assert np.array_equal(seg[live], seg_d)
        assert np.array_equal(z[live] * sy + y[live], row_d)
        seen.append(task[live])
        seg = seg + dseg
        carry = seg >= wsegs
        seg = np.where(carry, seg - wsegs, seg)
        y = y + dy + carry
        z = z + dz
        wrap = y >= sy
        y, z = np.where(wrap, y - sy, y), np.where(wrap, z + 1, z)
        task = task + K.WARPS
    return np.concatenate(seen)


@pytest.mark.parametrize("grad", [False, True], ids=["K5", "K4"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_plan_covers_fills_and_indexes(shape, grad):
    """launch_plan on an H100 (132 SMs): every voxel is in exactly one
    task of one warp of one block (the walk the kernel does, checked
    against a direct decode); the grid fills MIN_BLOCKS_PER_SM blocks an
    SM wherever one voxel a thread allows it, and stays within one wave of
    resident blocks; 64-bit offsets exactly where the grid has 2^31 voxels
    or more."""
    sz, sy, sx = shape
    sms = K.H100_SMS
    p = K.launch_plan(shape, grad, sms)
    span = 32 * p["vx"]
    assert p["vx"] in K.VX_CHOICES
    assert (p["wsegs"] - 1) * span < sx <= p["wsegs"] * span   # each x in one task
    assert p["tasks"] == sz * sy * p["wsegs"]
    per_block = K.WARPS * p["steps"]
    assert (p["blocks"] - 1) * per_block < p["tasks"] <= p["blocks"] * per_block
    if p["tasks"] <= 1 << 22:
        hits = np.bincount(_walk(p, shape, sms), minlength=p["tasks"])
        assert hits.shape == (p["tasks"],) and (hits == 1).all()
    one_voxel_a_thread = -(-(sz * sy * -(-sx // 32)) // K.WARPS)
    want = K.MIN_BLOCKS_PER_SM * sms
    assert p["blocks"] >= min(want, one_voxel_a_thread)
    assert p["blocks"] <= K.RESIDENT[grad] * sms
    assert p["wide"] == int(sz * sy * sx >= 2 ** 31)
    if shape == (16, 32, 128):       # was 16 blocks of 32 voxels a thread
        assert p["blocks"] == 512 and p["vx"] == 1


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
