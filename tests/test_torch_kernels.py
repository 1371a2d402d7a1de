"""The hand-written CUDA kernels against their plain PyTorch versions on
the card. Needs a CUDA device and nvcc; skips elsewhere. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances: K1 max|diff| <= 1e-5 x max|ref| — both sides are fp32 FMAs
over the same taps; only the summation order may differ — and bit for bit
from one launch to the next and on the generic and ring-less paths its
switches force (every path keeps the arithmetic order). K3 1e-4 x
max|ref| against complex128 ``torch.fft`` and against its fp32 plain
version, the JAX package's yardstick (tests/test_fft_pallas.py). K5 and
K4: ss and st within rtol 1e-5, gs and gt within 2e-4 x max|ref| of their
plain versions (tests/test_registration_grad.py's bounds), equal bit for
bit from one launch to the next and to ``kernel_numpy``, their numpy
transliteration (the same float32 operations in the same order, the same
float64 reductions). K2 within 2e-5 x max of its plain
version and bit for bit a K1 ratio launch followed by a K1 update launch.
K6's row i bit for bit K5 on matrix i, rtol 1e-5 against its plain
version. K7 bit for bit its plain version in both launch geometries (one
float32 FMA per voxel on both sides)."""

import numpy as np
import pytest
import torch

from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.kernels import fft_ct as F
from microimagelib_tpu_torch.kernels import pipe_copy as K7
from microimagelib_tpu_torch.kernels import rl_fused as KF
from microimagelib_tpu_torch.ops.conv_sep import RLFusedPlan, SepPlan, plan_rl_fused, plan_sep
from microimagelib_tpu_torch.ops.matrix import dof_to_matrix


def _gauss(p, s):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    k = np.exp(-z[:, None, None] ** 2 / (2 * s[0] ** 2)
               - y[None, :, None] ** 2 / (2 * s[1] ** 2)
               - x[None, None, :] ** 2 / (2 * s[2] ** 2))
    return (k / k.sum()).astype(np.float32)


def _tilted(p=(17, 9, 25)):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
    u, w = (xx + zz) / np.sqrt(2.0), (xx - zz) / np.sqrt(2.0)
    k = np.exp(-u ** 2 / 32.0 - w ** 2 / 2.88 - yy ** 2 / 2.88)
    return (k / k.sum()).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _max_taps_plan(shape=(40, 136, 140)):
    """Rank 4 with 128 taps on every axis and wide per-tap rolls: more than
    any ring fits, so K1 reads its z taps from device memory."""
    rng = np.random.default_rng(5)
    rolls = rng.integers(-9, 10, size=(128, 2)).astype(np.int32)
    return SepPlan(shape=shape, a=70, b=57,
                   tz=rng.random((4, 128), dtype=np.float32) / 128,
                   ty=rng.random((4, 128), dtype=np.float32) / 128, oy=-60,
                   tx=rng.random((4, 128), dtype=np.float32) / 128, ox=-64,
                   rolls=rolls)


# (name, psf, grid, plan kwargs); psf None takes _max_taps_plan
K1_CASES = [
    ("gauss9", _gauss((9, 9, 9), (1.5, 1.5, 1.5)), (32, 64, 128), {}),
    ("even8", _gauss((8, 8, 8), (1.2, 1.2, 1.2)), (16, 48, 96), {}),
    ("tilted", _tilted(), (32, 64, 256), dict(align=True, tol=1e-4)),
    ("oversized", _gauss((5, 41, 9), (1.0, 4.0, 1.5)), (16, 32, 100), {}),
    ("nz37-nx100", _gauss((9, 9, 9), (1.5, 1.5, 1.5)), (37, 48, 100), {}),
    ("fusionA-25z", _gauss((25, 25, 25), (3.5, 1.2, 1.2)), (40, 64, 96), {}),
    ("fusionB-25x", _gauss((25, 25, 25), (1.2, 1.2, 3.5)), (37, 40, 100), {}),
    ("max-taps", None, None, {}),
]


def _k1_plan(case):
    _name, psf, shape, kw = case
    plan = _max_taps_plan() if psf is None else plan_sep(psf, shape, **kw)
    assert plan is not None
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("mode", ["plain", "ratio", "update"])
def test_conv3_sep_kernel_matches_plain(cuda, case, mode):
    plan = _k1_plan(case)
    shape = plan.shape
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100).to(cuda)
    aux = torch.from_numpy(rng.random(shape, dtype=np.float32) + 0.5).to(cuda)
    before = K.LAUNCHES
    out = K.conv3_sep(v, plan, aux=aux, mode=mode)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref = K.conv3_sep_torch(v, plan, aux=aux, mode=mode)
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: c[0])
def test_conv3_sep_launches_repeat_bit_for_bit(cuda, case):
    """Two launches give the same bits (no atomics), and so do the paths
    the switches force: no ring, the generic instantiation and both keep
    the arithmetic order."""
    plan = _k1_plan(case)
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.random(plan.shape, dtype=np.float32) * 100).to(cuda)
    aux = torch.from_numpy(rng.random(plan.shape, dtype=np.float32) + 0.5).to(cuda)
    out = K.conv3_sep(v, plan, aux=aux, mode="ratio").view(torch.int32)
    for flags in (0, K.NO_RING, K.GENERIC, K.GENERIC | K.NO_RING):
        again = K.conv3_sep(v, plan, aux=aux, mode="ratio", flags=flags)
        assert torch.equal(out, again.view(torch.int32)), flags


# (grid, rank, z taps, y taps, x taps, y roll span, x roll span)
K1_PLAN_SWEEP = [
    ((512, 512, 512), 1, 9, 9, 9, 0, 0), ((256, 512, 512), 4, 17, 9, 17, 0, 14),
    ((320, 512, 512), 1, 25, 15, 15, 0, 0), ((320, 512, 320), 1, 15, 15, 25, 0, 0),
    ((32, 32, 128), 1, 5, 32, 9, 0, 0), ((37, 48, 100), 2, 7, 9, 11, 3, 2),
    ((40, 136, 140), 4, 128, 128, 128, 18, 18), ((24, 40, 100), 3, 1, 1, 1, 0, 0),
    ((130, 70, 36), 4, 128, 41, 8, 0, 0), ((8, 8, 8), 1, 8, 8, 8, 0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [0, K.GENERIC, K.NO_RING, K.GENERIC | K.NO_RING])
def test_conv3_sep_kernel_plan_is_the_hosts(cuda, flags):
    """The compiled kernel's tile, run, ring, prefetch, rank group, shared
    bytes and path are the ones launch_plan computes, on this card's SM
    count and on 132."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for case in K1_PLAN_SWEEP:
        for n in {sms, K.H100_SMS}:
            want = K.launch_plan(*case, sm_count=n, flags=flags)
            assert want is not None, case
            assert K.kernel_plan(*case, sm_count=n, flags=flags) == want, case


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_CASES[2::3], ids=lambda c: c[0])
def test_conv3_sep_allocates_only_out(cuda, case):
    """A K1 call adds only ``out`` to the device memory, at its peak too:
    the z sums stay on chip (the two-launch version held rank volumes)."""
    plan = _k1_plan(case)
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.random(plan.shape, dtype=np.float32)).to(cuda)
    K.conv3_sep(v, plan)   # the plan's tap tensors are made on first use
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    out = K.conv3_sep(v, plan, aux=v, mode="update")
    torch.cuda.synchronize()
    nbytes = out.numel() * 4
    assert torch.cuda.memory_allocated(cuda) - base == nbytes
    assert torch.cuda.max_memory_allocated(cuda) - base == nbytes


# the lengths specialised after 128, 256, 320 and 512
NEW_LENGTHS = (64, 192, 384, 576, 640, 704, 768, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (32, 32, 128),
    (64, 96, 128),    # m = 3 in y
    (20, 6, 40),      # m = 5 in z and x, m = 3 in y, odd row pairs
    # the length-specialised transforms: 128, 256, 320 and 512 on each axis
    (128, 256, 128),
    (320, 48, 512),   # y generic (48 = 16 x 3)
    (64, 512, 320),   # z generic; kx = 161 in a pitch of 176
    (256, 40, 256),
    (5, 3, 512),      # 15 rows: the last x pair has no partner, one partial block
    (512, 24, 64),    # z 512: the OTF read from device memory, not staged
    # every other length the FFT size policy gives from 64 to 1024 on each
    # axis: z with y generic, y with x generic, x with 15 rows (odd)
    *((n, 24, 128) for n in NEW_LENGTHS),
    *((8, n, 96) for n in NEW_LENGTHS),
    *((5, 3, n) for n in NEW_LENGTHS),
])
def test_conv3_ct_kernel_matches_references(cuda, shape):
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    psf = rng.random(shape).astype(np.float32)
    otf = torch.fft.rfftn(torch.from_numpy(psf / psf.sum()).to(cuda)).contiguous()
    before = F.LAUNCHES
    spec_before = dict(F.LAUNCHES_SPECIALISED)
    out = F.conv3_ct(v, otf)
    torch.cuda.synchronize()
    assert F.LAUNCHES == before + 1
    for axis, n in zip("zyx", shape):
        rose = F.LAUNCHES_SPECIALISED[axis] - spec_before[axis]
        assert rose == (1 if F.radix_plan(n) else 0), (axis, n)
    ref = torch.fft.irfftn(torch.fft.rfftn(v.double()) * otf.to(torch.complex128),
                           s=shape)
    m = ref.abs().max().item()
    assert (out.double() - ref).abs().max().item() <= 1e-4 * m
    plain = F.conv3_ct_torch(v, otf)
    assert (out - plain).abs().max().item() <= 1e-4 * m


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 128, 256, 320, 512, *NEW_LENGTHS, 1088])
def test_conv3_ct_kernel_plan_is_the_hosts(cuda, n):
    """The compiled kernel's radix plan and spectrum pitch are the ones the
    host dispatches on and allocates for."""
    assert F.kernel_plan(n) == (F.spec_pitch(n), F.radix_plan(n) or ())


@pytest.mark.cuda
def test_conv3_ct_refuses_a_misaligned_volume(cuda):
    """The x launches read v as float4: a contiguous view off a 16-byte
    boundary is refused before any launch."""
    base = torch.zeros(1 + 4 * 8 * 128, device=cuda)
    v = base[1:].view(4, 8, 128)
    assert v.is_contiguous() and v.data_ptr() % 16
    otf = torch.zeros((4, 8, 65), dtype=torch.complex64, device=cuda)
    before = F.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        F.conv3_ct(v, otf)
    assert F.LAUNCHES == before
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# numpy transliteration of csrc/corr.cu (K5, K4), bit for bit
# --------------------------------------------------------------------------

def _fma32(a, b, c):
    """float32 a*b + c rounded once (__fmaf_rn). The product is exact in
    float64; rounding the float64 sum to float32 rounds twice only where
    that sum lies exactly halfway between two float32 values, and there its
    own rounding error (TwoSum) says which way the exact value lies."""
    f64 = np.float64
    p = np.asarray(a, f64) * np.asarray(b, f64)
    c = np.asarray(c, f64)
    hi = p + c
    bv = hi - p
    err = (p - (hi - bv)) + (c - bv)
    r = hi.astype(np.float32)
    other = np.nextafter(r, np.where(hi > r, np.float32(np.inf), np.float32(-np.inf)))
    tie = (r.astype(f64) + other.astype(f64)) / 2 == hi
    return np.where(tie & (err != 0) & ((err > 0) == (other > r)), other, r)


def _lerp(a, b, f):
    return a + (b - a) * f


def corr_fields(src, tgt, m):
    """Per voxel, as csrc/corr.cu computes it in float32, each operation
    rounded on its own: the box mask, s (0 outside), and ds/dc_a for
    a = x, y, z. Coordinates m00*x + ((m01*y + m02*z) + m03), floors,
    per-corner clamps, the lerps and the derivative lerps."""
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
    ds = [_lerp(_lerp(v001 - v000, v011 - v010, fy),
                _lerp(v101 - v100, v111 - v110, fy), fz),
          _lerp(c01 - c00, c11 - c10, fz),
          c1 - c0]
    return valid, s, ds


def _block_sum(v):
    """csrc/corr.cu's block_sum over the last two axes (warps, lanes):
    the shuffle-down tree in each warp, then the warps in order."""
    v = np.array(v, np.float64)
    for off in (16, 8, 4, 2, 1):
        v[..., :32 - off] = v[..., :32 - off] + v[..., off:]
    s = np.zeros(v.shape[:-2])
    for w in range(v.shape[-2]):
        s = s + v[..., w, 0]
    return s


def kernel_numpy(src, tgt, m, grad, sm_count=C.H100_SMS):
    """K5 (``grad=False``: [ss, st]) or K4 ([ss, st, gs, gt]) as
    csrc/corr.cu computes them on a card of ``sm_count`` SMs: the voxel
    fields of :func:`corr_fields`; each thread's float32 sums over the
    voxels its launch plan gives it, in its order (__fmaf_rn; K4's sums
    over x and 1 within a step, then scaled by y and z); the block's
    float64 reduction; the last block's sum of the block rows."""
    f32 = np.float32
    sz, sy, sx = src.shape
    p = C.launch_plan(src.shape, grad, sm_count)
    vx, wsegs, tasks, steps, blocks = (p[k] for k in ("vx", "wsegs", "tasks", "steps",
                                                     "blocks"))
    valid, s, ds = corr_fields(src, tgt, m)
    nv = 26 if grad else 2
    b = np.arange(blocks)[:, None, None]
    lane = np.arange(32)[None, None, :]
    acc = np.zeros((nv, blocks, C.WARPS, 32), f32)
    for k in range(steps):
        task = (b * steps + k) * C.WARPS + np.arange(C.WARPS)[None, :, None]
        live = task < tasks
        row, seg = np.divmod(task, wsegs)
        z, y = np.divmod(row, sy)
        a1 = np.zeros((2, 3) + acc.shape[1:], f32)   # [s | t][axis]: sum u*x
        a0 = np.zeros_like(a1)                       # sum u
        for j in range(vx):
            x = seg * 32 * vx + lane + 32 * j
            ok = live & (x < sx)
            zc, yc, xc = (np.where(ok, q, 0) for q in (z, y, x))
            ok &= valid[zc, yc, xc]
            sv, tv = s[zc, yc, xc], tgt[zc, yc, xc]
            acc[0] = np.where(ok, _fma32(sv, sv, acc[0]), acc[0])
            acc[1] = np.where(ok, _fma32(sv, tv, acc[1]), acc[1])
            if grad:
                for a in range(3):
                    d = ds[a][zc, yc, xc]
                    for q, w in enumerate((sv, tv)):
                        u = w * d
                        a1[q, a] = np.where(ok, _fma32(u, x.astype(f32), a1[q, a]), a1[q, a])
                        a0[q, a] = np.where(ok, a0[q, a] + u, a0[q, a])
        if grad:
            yf, zf = y.astype(f32), z.astype(f32)
            for q, base in ((0, 2), (1, 14)):
                for a in range(3):
                    i = base + 4 * a
                    upd = (acc[i] + a1[q, a], _fma32(yf, a0[q, a], acc[i + 1]),
                           _fma32(zf, a0[q, a], acc[i + 2]), acc[i + 3] + a0[q, a])
                    for n, v in enumerate(upd):
                        acc[i + n] = np.where(live, v, acc[i + n])
    rows = _block_sum(acc)                  # (nv, blocks)
    cols = np.zeros((nv, C.THREADS))        # thread t: rows t, t + THREADS, ...
    for r0 in range(0, blocks, C.THREADS):
        chunk = rows[:, r0:r0 + C.THREADS]
        cols[:, :chunk.shape[1]] = cols[:, :chunk.shape[1]] + chunk
    return _block_sum(cols.reshape(nv, C.WARPS, 32))


_CORR_MATRICES = [
    np.array([1, 0, 0, 0.6, 0, 1, 0, -0.8, 0, 0, 1, 0.3], np.float32),
    np.array([0.99, 0.05, 0, 0.2, -0.05, 0.99, 0, 0.1, 0, 0.02, 1.01, -0.4],
             np.float32),
    dof_to_matrix([0.5, -0.3, 0.2, 10.0, 0, 0, 1, 1, 1], 6),
    dof_to_matrix([6.0, -3.0, 2.0, 4.0, 0, 0, 1, 1, 1], 6),
]


# chip_smoke.py's REG_LEVELS (Phase 10's pyramid) and fusion_levels()
# (Phase 14's), and shapes off the warp multiples
CORR_LEVELS = [(16, 32, 128), (32, 64, 256), (64, 128, 512), (128, 256, 512),
               (256, 512, 512)]
FUSION_LEVELS = [(10, 16, 320), (20, 32, 320), (40, 64, 320), (80, 128, 320),
                 (160, 256, 320), (320, 512, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 32), (9, 7, 300), (8, 32, 1024), (32, 64, 512)]
                         + CORR_LEVELS)
@pytest.mark.parametrize("grad", [False, True], ids=["K5", "K4"])
def test_corr3d_kernels_match_plain(cuda, shape, grad):
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    tgt = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    for m in _CORR_MATRICES:
        before = (C.K4_LAUNCHES, C.K5_LAUNCHES, C.PLAIN_CALLS)
        out = C.corr3d(src, tgt, m, grad=grad).cpu().numpy()
        again = C.corr3d(src, tgt, m, grad=grad).cpu().numpy()
        after = (C.K4_LAUNCHES, C.K5_LAUNCHES, C.PLAIN_CALLS)
        assert after == ((before[0] + 2, before[1], before[2]) if grad
                         else (before[0], before[1] + 2, before[2]))
        np.testing.assert_array_equal(out, again)
        ref = C.corr3d_torch(src, tgt, m, grad=grad).cpu().numpy()
        np.testing.assert_allclose(out[:2], ref[:2], rtol=1e-5)
        if grad:
            for lo, hi in ((2, 14), (14, 26)):
                scale = max(np.abs(ref[lo:hi]).max(), 1e-6)
                np.testing.assert_allclose(out[lo:hi], ref[lo:hi],
                                           atol=2e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 32), (9, 7, 300), (16, 32, 128), (20, 32, 320),
                                   (32, 64, 256)])
@pytest.mark.parametrize("grad", [False, True], ids=["K5", "K4"])
def test_corr3d_kernel_equals_transliteration(cuda, shape, grad):
    """K5 and K4 give the bits of kernel_numpy on this card's plan: the
    per-voxel arithmetic, each thread's voxel order and the two float64
    reductions are the ones the transliteration spells out."""
    rng = np.random.default_rng(3)
    src = rng.random(shape, dtype=np.float32)
    tgt = rng.random(shape, dtype=np.float32)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in _CORR_MATRICES:
        out = C.corr3d(torch.from_numpy(src).to(cuda), torch.from_numpy(tgt).to(cuda), m,
                       grad=grad).cpu().numpy()
        np.testing.assert_array_equal(out, kernel_numpy(src, tgt, m, grad, sms))


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True], ids=["K5", "K4"])
def test_corr3d_one_launch_per_call(cuda, grad):
    """One kernel launch per call (the profiler sees one kernel, no second
    row-sum kernel) and no allocation but ``out`` once the workspace
    exists."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.random((64, 128, 512), dtype=np.float32)).to(cuda)
    tgt = torch.from_numpy(rng.random((64, 128, 512), dtype=np.float32)).to(cuda)
    m = _CORR_MATRICES[2]
    C.corr3d(src, tgt, m, grad=grad)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    before = C.K4_LAUNCHES if grad else C.K5_LAUNCHES
    outs = []
    for _attempt in range(3):       # a trace can come back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs += [C.corr3d(src, tgt, m, grad=grad) for _ in range(3)]
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_time_total > 0]
        if kernels:
            break
    assert (C.K4_LAUNCHES if grad else C.K5_LAUNCHES) == before + len(outs)
    # one kernel, at most once a call (a trace can miss a launch, never add one)
    assert len(kernels) == 1 and "corr_kernel" in kernels[0][0], kernels
    assert 1 <= kernels[0][1] <= 3, kernels
    # out rounds up to the caching allocator's 512-byte block
    assert torch.cuda.max_memory_allocated(cuda) - base == len(outs) * 512
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.cuda
def test_corr3d_kernel_plan_is_the_hosts(cuda):
    """The compiled plan is the one launch_plan mirrors, on this card's SM
    count and on 132, for both pyramids' levels, shapes off the warp
    multiples and grids on both sides of 2^31 voxels."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for shape in CORR_LEVELS + FUSION_LEVELS + [(9, 7, 300), (1, 1, 5000), (8, 32, 1024),
                                                 (1023, 1024, 2048), (1024, 1024, 2048)]:
        for grad in (False, True):
            for n in {sms, C.H100_SMS}:
                assert C.kernel_plan(shape, grad, n) == C.launch_plan(shape, grad, n), \
                    (shape, grad, n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K5", "K4", "K6"])
def test_corr3d_kernels_fit_their_launch_bounds(cuda, kind):
    """Every instantiation keeps the registers its launch bounds allow
    (80 for K5 and K6, 128 for K4) with no spill: the plans count on a
    wave of RESIDENT blocks an SM (K6 takes K5's plan)."""
    blocks = C.RESIDENT[kind == "K4"]
    for vx in C.VX_CHOICES:
        for wide in (0, 1):
            a = C.kernel_attrs(kind, vx, wide)
            assert a["spill_bytes"] == 0, (vx, wide, a)
            assert a["blocks_per_sm"] >= blocks, (vx, wide, a)
            assert a["registers"] <= 65536 // (C.THREADS * blocks), (vx, wide, a)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("bench9", _gauss((9, 9, 9), (1.5, 1.5, 1.5)), (64, 128, 128)),
    ("fusionA", _gauss((25, 25, 25), (3.5, 1.2, 1.2)), (40, 96, 160)),
    ("fusionB", _gauss((25, 25, 25), (1.2, 1.2, 3.5)), (37, 96, 160)),
    ("rank2", _gauss((7, 9, 11), (1.0, 1.5, 2.0)) + 0.3 * _gauss((7, 9, 11), (2.0, 1.0, 0.8)),
     (20, 48, 100)),
], ids=lambda c: c[0])
def test_rl_fused_kernel_matches_plain_and_k1_pair(cuda, case):
    """K2 against its plain version (2e-5 x max, tests/test_conv_sep.py's
    bound), and bit for bit against a K1 ratio launch then a K1 update
    launch (the same fp32 operations in the same order)."""
    _name, psf, shape = case
    plan = plan_rl_fused(psf, np.ascontiguousarray(psf[::-1, ::-1, ::-1]), shape)
    assert plan is not None
    rng = np.random.default_rng(0)
    est = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(cuda)
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(cuda)
    before = KF.LAUNCHES
    out = KF.rl_iter_fused(est, img, plan)
    again = KF.rl_iter_fused(est, img, plan)
    torch.cuda.synchronize()
    assert KF.LAUNCHES == before + 2
    assert torch.equal(out, again)
    ref = KF.rl_iter_fused_torch(est, img, plan)
    assert (out - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()
    ratio = K.conv3_sep(est, plan.fwd, aux=img, mode="ratio")
    pair = K.conv3_sep(ratio, plan.bp, aux=est, mode="update")
    assert torch.equal(out, pair)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["zero-slab", "inf-plane"])
def test_rl_fused_kernel_nonfinite_planes_match_k1_pair(cuda, where):
    """A zero slab in est makes fwd(est) 0 and the ratio inf (stage 2 sees
    inf planes); an inf plane in est reaches stage 1. Either way K2 gives
    the K1 pair's bits: a non-finite value spreads only as far as its
    taps reach, not to the other outputs of its z batch."""
    shape = (48, 32, 64)
    psf = _gauss((9, 5, 5), (1.5, 1.0, 1.0))
    plan = plan_rl_fused(psf, np.ascontiguousarray(psf[::-1, ::-1, ::-1]), shape)
    rng = np.random.default_rng(0)
    est = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(cuda)
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(cuda)
    if where == "zero-slab":
        est[13:33] = 0.0
    else:
        est[21] = float("inf")
    out = KF.rl_iter_fused(est, img, plan)
    ratio = K.conv3_sep(est, plan.fwd, aux=img, mode="ratio")
    pair = K.conv3_sep(ratio, plan.bp, aux=est, mode="update")
    stage_input = ratio if where == "zero-slab" else est
    assert not torch.isfinite(stage_input).all()
    assert torch.equal(out.view(torch.int32), pair.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 32, 128), (9, 7, 300), (32, 64, 512),
                                   (10, 16, 320), (64, 128, 512), (160, 256, 320)])
def test_nprobe_kernel_equals_k5_per_probe(cuda, shape):
    """K6's row i is K5 on matrix i bit for bit, for 8 probes along a line
    plus a wild 35-degree probe (two launches), and repeats bit for bit."""
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    tgt = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    base = _CORR_MATRICES[1]
    step = np.array([0.01, 0, 0, 0.4, 0, 0, 0, -0.2, 0, 0, 0, 0.1], np.float32)
    mats = np.stack([base + a * step for a in (-2.618, -1.0, -0.382, 0.382,
                                                1.0, 1.618, 2.618, 4.236)]
                    + [dof_to_matrix([0, 0, 0, 35.0, 0, 0, 1, 1, 1], 6)]
                    ).astype(np.float32)
    before = (C.K6_LAUNCHES, C.K5_LAUNCHES, C.PLAIN_CALLS)
    rows = C.corr3d_nprobe(src, tgt, mats).cpu().numpy()
    again = C.corr3d_nprobe(src, tgt, mats).cpu().numpy()
    assert (C.K6_LAUNCHES, C.K5_LAUNCHES, C.PLAIN_CALLS) == \
        (before[0] + 4, before[1], before[2])
    np.testing.assert_array_equal(rows, again)
    for i, m in enumerate(mats):
        np.testing.assert_array_equal(rows[i], C.corr3d(src, tgt, m).cpu().numpy())
    plain = C.corr3d_nprobe_torch(src, tgt, mats).cpu().numpy()
    np.testing.assert_allclose(rows, plain, rtol=1e-5)


def _rank4_plan(shape):
    """Rank 4, no rolls, tap counts no specialised instantiation has."""
    rng = np.random.default_rng(7)
    return SepPlan(shape=shape, a=5, b=5, tz=rng.random((4, 11), dtype=np.float32) / 11,
                   ty=rng.random((4, 7), dtype=np.float32) / 7, oy=-3,
                   tx=rng.random((4, 9), dtype=np.float32) / 9, ox=-4, rolls=None)


def _wide_plan(shape):
    """Rank 2, 33 z taps and 100 y and x taps: no ring fits a block, so each
    stage reads its z taps from device memory (the ratio through L2)."""
    rng = np.random.default_rng(8)
    return SepPlan(shape=shape, a=16, b=16, tz=rng.random((2, 33), dtype=np.float32) / 33,
                   ty=rng.random((2, 100), dtype=np.float32) / 100, oy=-50,
                   tx=rng.random((2, 100), dtype=np.float32) / 100, ox=-50, rolls=None)


def _k2_plan(kind, shape):
    if kind == "rank4":
        return RLFusedPlan(_rank4_plan(shape), _rank4_plan(shape))
    if kind == "wide":
        return RLFusedPlan(_wide_plan(shape), _wide_plan(shape))
    psf = {"bench9": _gauss((9, 9, 9), (1.5, 1.5, 1.5)),
           "fusionA": _gauss((25, 25, 25), (3.5, 1.2, 1.2))}[kind]
    return plan_rl_fused(psf, np.ascontiguousarray(psf[::-1, ::-1, ::-1]), shape)


# (plan, grid, group, flags, store): the store K2's plan gives there,
# "ring" where the ratio lives in the ring of z planes, "volume" where the
# grid is smaller than head + ring
K2_RING_CASES = [
    ("fusionA", (26, 48, 64), 0, 0, "volume"),
    ("fusionA", (83, 32, 64), 8, 0, "ring"),
    ("fusionA", (83, 32, 64), 8, K.NO_RING, "ring"),
    ("bench9", (61, 48, 64), 8, 0, "ring"),
    ("bench9", (61, 48, 64), 3, 0, "ring"),
    ("bench9", (61, 48, 64), 1, 0, "ring"),
    ("bench9", (64, 40, 96), 8, K.GENERIC, "ring"),
    ("bench9", (128, 64, 64), 0, 0, "ring"),
    ("rank4", (45, 40, 72), 4, 0, "ring"),
    ("wide", (40, 64, 104), 8, 0, "volume"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_RING_CASES,
                         ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}-g{c[2]}-f{c[3]}")
def test_rl_fused_ring_plans_equal_the_k1_pair(cuda, case):
    """K2 bit for bit a K1 ratio launch then a K1 update launch, and again
    from one launch to the next, wherever the ratio lives (the ring of z
    planes at nz off the group multiple, or the whole volume), at the
    default group size and others, on the generic stage (rank 4),
    K1's ring-less stage (wide taps, or forced) and the forced generic
    instantiation; within 2e-5 x max of its plain version. The compiled
    plan is the host's."""
    kind, shape, group, flags, store = case
    plan = _k2_plan(kind, shape)
    assert plan is not None
    host = KF.launch_plan(plan, group=group, flags=flags)
    assert (host["ring"] > 0) == (store == "ring"), host
    assert KF.kernel_plan(plan, group=group, flags=flags) == host
    if kind in ("rank4", "wide") or flags & K.GENERIC:
        assert host["path"] == -1
    if kind == "wide" or flags & K.NO_RING:
        assert host["ring_fwd"] == host["ring_bp"] == 0
    rng = np.random.default_rng(0)
    est = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(cuda)
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(cuda)
    before = KF.LAUNCHES
    out = KF.rl_iter_fused(est, img, plan, group=group, flags=flags)
    again = KF.rl_iter_fused(est, img, plan, group=group, flags=flags)
    torch.cuda.synchronize()
    assert KF.LAUNCHES == before + 2
    assert KF.LAST_CONFIG["ring"] == host["ring"]
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    pair = K.conv3_sep(K.conv3_sep(est, plan.fwd, aux=img, mode="ratio"), plan.bp,
                       aux=est, mode="update")
    assert torch.equal(out.view(torch.int32), pair.view(torch.int32))
    ref = KF.rl_iter_fused_torch(est, img, plan)
    assert (out - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


# K7's shapes in chip_smoke.py's Phase 16: the roofline's 512^3 with the
# bench plan's shift, shapes off the chunk multiples, and an nx that is not
# a multiple of 4 (4-byte accesses)
PIPE_COPY_CASES = [((512, 512, 512), 4), ((24, 40, 100), 0), ((37, 96, 160), 36),
                   ((8, 16, 64), 0), ((32, 128, 128), 8), ((9, 7, 301), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PIPE_COPY_CASES, ids=lambda c: f"{c[0]}-shift{c[1]}")
@pytest.mark.parametrize("geometry", ["z", "xy"])
def test_pipe_copy_kernel_equals_plain(cuda, case, geometry):
    shape, shift = case
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(cuda)
    aux = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(cuda)
    before = K7.LAUNCHES
    out = K7.pipe_copy(v, aux, shift, geometry)
    again = K7.pipe_copy(v, aux, shift, geometry)
    torch.cuda.synchronize()
    assert K7.LAUNCHES == before + 2
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    ref = K7.pipe_copy_torch(v, aux, shift)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["z", "xy"])
def test_pipe_copy_kernel_on_misaligned_volumes_equals_plain(cuda, geometry):
    """Volumes that start 4 bytes past a 16-byte boundary take the 4-byte
    accesses and give the same bits."""
    shape, shift = (20, 48, 64), 5
    n = int(np.prod(shape))
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(rng.random(3 * n + 3, dtype=np.float32) * 100 + 1).to(cuda)
    v, aux = buf[1:n + 1].view(shape), buf[n + 2:2 * n + 2].view(shape)
    assert v.data_ptr() % 16 and aux.data_ptr() % 16
    out = K7.pipe_copy(v, aux, shift, geometry)
    ref = K7.pipe_copy_torch(v, aux, shift)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


# --------------------------------------------------------------------------
# the beyond-HBM tiers' device memory (no kernel of their own: the streamed
# RL runs torch.fft, the streamed transform and NCC plain torch)
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_streamed_rl_peak_memory_stays_under_the_budget(cuda, monkeypatch):
    from microimagelib_tpu_torch.models import deconvolution as D

    rng = np.random.default_rng(18)
    img = (rng.random((200, 256, 256), dtype=np.float32) * 100 + 1)
    budget_mb = 64   # below the (256, 256, 256) grid's 6-volume working set
    monkeypatch.setenv("MIL_HBM_BUDGET_MB", str(budget_mb))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    rec = np.zeros(10)
    out = D.decon_singleview(img, _gauss((9, 9, 9), (1.5, 1.5, 1.5)), 2, device=cuda,
                             mem_mode=-1, records=rec)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert rec[0] == 2 and np.isfinite(out).all()
    assert peak <= budget_mb * 1048576, peak


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["transform", "ncc"])
@pytest.mark.parametrize("planes", [1, 4, 24])
def test_streamed_block_peak_factor_under_the_constant(cuda, kind, planes):
    from microimagelib_tpu_torch.ops import affine as AF

    sz, sy, sx = 96, 512, 512
    rng = np.random.default_rng(planes)
    src = rng.random((sz, sy, sx), dtype=np.float32)
    tgt = rng.random((sz, sy, sx), dtype=np.float32)
    tmx = dof_to_matrix([1.5, -2.0, 3.0, 4.0, -3.0, 2.0, 1.02, 0.98, 1.0], 9)
    z0 = 40
    lo, hi = AF._zspan_for_rows(np.asarray(tmx, np.float64).reshape(3, 4), z0,
                                z0 + planes - 1, sy, sx, sz)
    raw = AF._block_bytes(planes, lo, hi, sy * sx, sy * sx)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    win = torch.from_numpy(src[lo:hi]).to(cuda)
    if kind == "transform":
        out = AF.affine_transform_3d_window(win, tmx, (planes, sy, sx), z0, lo, sz)
    else:
        out = AF.corr3d_partials_window(win, torch.from_numpy(tgt[z0:z0 + planes]).to(cuda),
                                        tmx, z0, lo, sz)
    torch.cuda.synchronize()
    factor = (torch.cuda.max_memory_allocated(cuda) - base) / raw
    assert out is not None and factor <= AF.STREAM_PEAK_FACTOR, factor


def _blob_pair(shape, shift, seed):
    """A smooth random volume and its copy moved by ``shift`` (x, y, z)
    voxels, both mean-subtracted, on the card, with the target's SD."""
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32))
    for ax in range(3):      # a few box passes: smooth, registrable texture
        for _ in range(3):
            vol = (vol + torch.roll(vol, 1, ax) + torch.roll(vol, -1, ax)) / 3
    m = np.array([1, 0, 0, shift[0], 0, 1, 0, shift[1], 0, 0, 1, shift[2]], np.float32)
    from microimagelib_tpu_torch.ops.affine import affine_transform_3d
    moved = affine_transform_3d(vol, m, shape)
    src = (moved - moved.double().mean().float()).contiguous()
    tgt = (vol - vol.double().mean().float()).contiguous()
    sd_t = float(torch.sum(tgt.double() ** 2).sqrt())
    return src, tgt, sd_t


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["grad", "device"])
@pytest.mark.parametrize("method", [1, 7])
@pytest.mark.parametrize("shape", [(16, 32, 128), (24, 40, 100)])
def test_reg_ladder_kernel_matches_host_loop(cuda, engine, method, shape):
    """K9 against its plain version (the host loop over K4/K5 on the card)
    from the same start: evaluations within 20%, the final cost within
    1e-4, the matrix within 0.05 voxel over the central half-box; each
    evaluation's sums bit for bit a K4/K5 launch on its matrix; two runs bit
    for bit."""
    from microimagelib_tpu_torch.kernels import reg_ladder as RL
    from microimagelib_tpu_torch.models import registration_grad as RG

    src, tgt, sd_t = (x.to(cuda) if isinstance(x, torch.Tensor) else x
                      for x in _blob_pair(shape, (0.6, -0.8, 0.3), 7))
    p0 = np.array([0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1], np.float32)
    args = RL.ladder_args(engine, method, p0, 1e-4, 3000, sd_t, shape, True, 1)
    launches = RL.K9_LAUNCHES
    st, trace = RL.launch(src, tgt, args, trace_cap=10000)
    assert RL.K9_LAUNCHES - launches == RL.stage_count(args)
    st2, _ = RL.launch(src, tgt, args)
    assert bytes(st) == bytes(st2)
    assert len(trace) == st.nev == st.evals[0] + st.evals[1]
    assert (st.evals[1] > 0) == (engine == "grad") and st.evals[0] > 0
    for r in trace:
        g = bool(r[0])
        out = C.corr3d(src, tgt, r[1:13].astype(np.float32), grad=g).cpu().numpy()
        np.testing.assert_array_equal(out.view(np.int64), r[13:13 + out.size].view(np.int64))
    aff, fret, _stage, nev = RG.reg_ladder_host(src, tgt, sd_t, p0, method, 1e-4, 3000,
                                                engine, True, 1)
    assert abs(st.nev - nev) <= 0.2 * nev
    assert abs(float(st.fret) - float(fret)) <= 1e-4
    sz, sy, sx = shape
    pts = np.array([[x, y, z, 1.0] for x in (sx / 4, 3 * sx / 4)
                    for y in (sy / 4, 3 * sy / 4) for z in (sz / 4, 3 * sz / 4)])
    a = np.array(st.aff, np.float64).reshape(3, 4)
    b = np.asarray(aff, np.float64).reshape(3, 4)
    assert np.abs(pts @ a.T - pts @ b.T).max() <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True, 2], ids=["powell", "lbfgs", "probes"])
def test_reg_ladder_kernel_fits_its_launch_bounds(cuda, grad):
    """The stage kernel of every (BODY, VX, IDX) instantiation of the body
    keeps K5's (Powell, and the probe stages over K6's body) or K4's
    (L-BFGS) residency and register cap, so its plans' blocks are
    co-resident for the cooperative launch; every (vx, wide) the plan can
    give has an instantiation."""
    from microimagelib_tpu_torch.kernels import reg_ladder as RL

    kinds = [k for k in RL.INSTANTIATIONS if k[0] == int(grad)]
    assert sorted((vx, wide) for _g, vx, wide in kinds) == sorted(
        (vx, wide) for vx in (4, 2, 1) for wide in (0, 1))
    resident = C.RESIDENT[grad is True]
    for _g, vx, wide in kinds:
        at = RL.kernel_attrs(grad, vx, wide)
        assert at["blocks_per_sm"] >= resident
        assert at["registers"] <= 65536 // (128 * resident)


def _ladder_start(cuda, shape):
    src, tgt, sd_t = (x.to(cuda) if isinstance(x, torch.Tensor) else x
                      for x in _blob_pair(shape, (0.6, -0.8, 0.3), 7))
    return src, tgt, sd_t, np.array([0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["grad", "device"])
@pytest.mark.parametrize("method", [1, 7])
@pytest.mark.parametrize("shape", [(16, 32, 128), (24, 40, 100), (32, 64, 256)])
def test_reg_ladder_probe_stages_equal_the_host_loop(cuda, engine, method, shape):
    """MIL_REG_BATCH_LS=1 in K9 (the Powell stages over K6's body) against
    its plain version, the host loop over K5 and K6 launches, from the same
    start: the same point, cost, stage costs and evaluations, bit for bit;
    every traced probe evaluation's sums bit for bit a K6 launch on its
    matrices; two runs bit for bit."""
    from microimagelib_tpu_torch.kernels import reg_ladder as RL
    from microimagelib_tpu_torch.models import registration_grad as RG

    src, tgt, sd_t, p0 = _ladder_start(cuda, shape)
    args = RL.ladder_args(engine, method, p0, 1e-4, 3000, sd_t, shape, True, 1,
                          batch_ls=True)
    before = (RL.K9_LAUNCHES, RL.K9_EVALS_K6, C.K6_LAUNCHES)
    st, trace = RL.launch(src, tgt, args, trace_cap=10000)
    assert RL.K9_LAUNCHES - before[0] == RL.stage_count(args)
    assert RL.K9_EVALS_K6 - before[1] == st.evals[2] > 0 and C.K6_LAUNCHES == before[2]
    st2, _ = RL.launch(src, tgt, args)
    assert bytes(st) == bytes(st2)
    assert len(trace) == sum(st.evals) and (st.evals[1] > 0) == (engine == "grad")
    assert st.evals[0] == 0
    for r in trace:
        mats, sums = RL.trace_matrices(r)
        if int(r[0]) == RL.BODIES["K6"]:
            out = C.corr3d_nprobe(src, tgt, mats).cpu().numpy().reshape(-1)
        else:
            out = C.corr3d(src, tgt, mats[0], grad=bool(r[0])).cpu().numpy()
        np.testing.assert_array_equal(out.view(np.int64), sums.view(np.int64))
    assert max(int(r[39]) for r in trace) == 8
    aff, fret, stage, nev = RG.reg_ladder_host(src, tgt, sd_t, p0, method, 1e-4, 3000,
                                               engine, True, 1, batch_ls=True)
    assert st.nev == nev and np.float32(st.fret) == fret
    np.testing.assert_array_equal(np.array(st.aff, np.float32), aff)
    np.testing.assert_array_equal(np.array(st.stage_costs, np.float32), stage)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dof3", "dof6", "dof7", "dof9", "p12"])
@pytest.mark.parametrize("shape", [(16, 32, 128), (24, 40, 100)])
def test_reg_line_equals_the_host_linmin(cuda, mode, shape):
    """The hybrid engine's line in K9 (one launch, K5's body) against the
    host loop's _linmin over K5 launches, bit for bit, for each mode; the
    model's linmin_reg_device takes it on a CUDA pair."""
    from microimagelib_tpu_torch.kernels import reg_ladder as RL
    from microimagelib_tpu_torch.models import registration_device as RD
    from microimagelib_tpu_torch.ops.powell_device import _linmin

    src, tgt, sd_t, p12 = _ladder_start(cuda, shape)
    n = RL.LINE_MODES[mode]
    if mode == "p12":
        p = p12
        xi = np.array([0.6, -0.8, 0.4, 0.002, -0.001, 0.0015, 0.001, 0.002, -0.001, 0.0005,
                       0.001, -0.002], np.float32)
    else:
        p = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1], np.float32)[:n]
        xi = np.array([0.6, -0.8, 0.4, 1.5, -0.7, 0.5, 0.01, -0.008, 0.012], np.float32)[:n]
    before = (RL.K9_LINES, RL.K9_EVALS_K5, C.K5_LAUNCHES, RD.HOST_LINES)
    got = RL.reg_line(src, tgt, sd_t, p, xi, mode)
    assert RL.K9_LINES == before[0] + 1 and RL.K9_EVALS_K5 - before[1] == got[3]
    assert C.K5_LAUNCHES == before[2]
    want = _linmin(RD._cost_for_mode(src, tgt, sd_t, mode), p, xi)
    assert C.K5_LAUNCHES - before[2] == want[3]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    via_model = RD.linmin_reg_device(src, tgt, sd_t, p, xi, mode)
    assert RL.K9_LINES == before[0] + 2 and RD.HOST_LINES == before[3]
    for a, b in zip(via_model, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["grad", "device"])
def test_reg_ladder_trace_stamps_are_in_order(cuda, engine):
    """Every traced evaluation's stamps run publish <= latest row start <=
    the other blocks' last arrival, publish <= block 0's row done, both <=
    block 0 sees the count <= column sum done <= next publish, and the next
    publish is the following evaluation's publish within a stage; the
    batch_ls ladder's probe evaluations too."""
    for batch_ls in (False, True):
        _trace_stamps_in_order(cuda, engine, batch_ls)


def _trace_stamps_in_order(cuda, engine, batch_ls):
    from microimagelib_tpu_torch.kernels import reg_ladder as RL

    shape = (24, 40, 100)
    src, tgt, sd_t = (x.to(cuda) if isinstance(x, torch.Tensor) else x
                      for x in _blob_pair(shape, (0.6, -0.8, 0.3), 7))
    p0 = np.array([0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1], np.float32)
    args = RL.ladder_args(engine, 7, p0, 1e-4, 3000, sd_t, shape, batch_ls=batch_ls)
    st, trace = RL.launch(src, tgt, args, trace_cap=10000)
    t = np.ascontiguousarray(trace[:, RL.STAMP_AT:]).view(np.int64)
    pub, start, arrive, row0, seen, summed, nxt = t.T
    assert len(t) == sum(st.evals) and (pub > 0).all()
    assert (st.nev == len(t)) != (batch_ls and st.evals[2] > 0)
    assert (pub <= start).all() and (start <= arrive).all() and (pub <= row0).all()
    assert (np.maximum(arrive, row0) <= seen).all()
    assert (seen <= summed).all() and (summed <= nxt).all()
    assert (nxt[:-1] <= pub[1:]).all()
    # within a stage the next publish is the next evaluation's; at a
    # stage's end it is the stop
    assert (nxt[:-1] == pub[1:]).sum() >= len(t) - RL.stage_count(args)
    sp = RL.trace_split(trace)
    assert (sp["evaluation"] > 0).all() and np.isfinite(sp["rows"]).all()
