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
plain versions (tests/test_registration_grad.py's bounds), and equal bit
for bit from one launch to the next. K2 within 2e-5 x max of its plain
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
from microimagelib_tpu_torch.ops.conv_sep import SepPlan, plan_rl_fused, plan_sep
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
@pytest.mark.parametrize("n", [40, 64, 128, 256, 320, 384, 512])
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


_CORR_MATRICES = [
    np.array([1, 0, 0, 0.6, 0, 1, 0, -0.8, 0, 0, 1, 0.3], np.float32),
    np.array([0.99, 0.05, 0, 0.2, -0.05, 0.99, 0, 0.1, 0, 0.02, 1.01, -0.4],
             np.float32),
    dof_to_matrix([0.5, -0.3, 0.2, 10.0, 0, 0, 1, 1, 1], 6),
    dof_to_matrix([6.0, -3.0, 2.0, 4.0, 0, 0, 1, 1, 1], 6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 32), (16, 32, 128), (9, 7, 300),
                                   (32, 64, 512), (8, 32, 1024)])
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
                                   (10, 16, 320)])
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


# K7's shapes in chip_smoke.py's Phase 16: the roofline's 512^3 with the
# bench plan's shift, and shapes off the z-chunk and xy-tile multiples
PIPE_COPY_CASES = [((512, 512, 512), 4), ((24, 40, 100), 0), ((37, 96, 160), 36),
                   ((8, 16, 64), 0), ((32, 128, 128), 8)]


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
