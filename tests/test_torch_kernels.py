"""The hand-written CUDA kernels against their plain PyTorch versions on
the card. Needs a CUDA device and nvcc; skips elsewhere. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances: K1 max|diff| <= 1e-5 x max|ref| — both sides are fp32 FMAs
over the same taps; only the summation order may differ. K3 1e-4 x
max|ref| against complex128 ``torch.fft`` and against its fp32 plain
version, the JAX package's yardstick (tests/test_fft_pallas.py). K5 and
K4: ss and st within rtol 1e-5, gs and gt within 2e-4 x max|ref| of their
plain versions (tests/test_registration_grad.py's bounds), and equal bit
for bit from one launch to the next."""

import numpy as np
import pytest
import torch

from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.kernels import fft_ct as F
from microimagelib_tpu_torch.ops.conv_sep import plan_sep
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("gauss9", _gauss((9, 9, 9), (1.5, 1.5, 1.5)), (32, 64, 128), {}),
    ("even8", _gauss((8, 8, 8), (1.2, 1.2, 1.2)), (16, 48, 96), {}),
    ("tilted", _tilted(), (32, 64, 256), dict(align=True, tol=1e-4)),
    ("oversized", _gauss((5, 41, 9), (1.0, 4.0, 1.5)), (16, 32, 100), {}),
], ids=lambda c: c[0])
@pytest.mark.parametrize("mode", ["plain", "ratio", "update"])
def test_conv3_sep_kernel_matches_plain(cuda, case, mode):
    _name, psf, shape, kw = case
    plan = plan_sep(psf, shape, **kw)
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
@pytest.mark.parametrize("shape", [
    (32, 32, 128),
    (64, 96, 128),    # m = 3 in y
    (20, 6, 40),      # m = 5 in z and x, m = 3 in y, odd row pairs
])
def test_conv3_ct_kernel_matches_references(cuda, shape):
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    psf = rng.random(shape).astype(np.float32)
    otf = torch.fft.rfftn(torch.from_numpy(psf / psf.sum()).to(cuda)).contiguous()
    before = F.LAUNCHES
    out = F.conv3_ct(v, otf)
    torch.cuda.synchronize()
    assert F.LAUNCHES == before + 1
    ref = torch.fft.irfftn(torch.fft.rfftn(v.double()) * otf.to(torch.complex128),
                           s=shape)
    m = ref.abs().max().item()
    assert (out.double() - ref).abs().max().item() <= 1e-4 * m
    plain = F.conv3_ct_torch(v, otf)
    assert (out - plain).abs().max().item() <= 1e-4 * m


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
