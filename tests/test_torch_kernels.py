"""The hand-written CUDA kernels against their plain PyTorch versions on
the card. Needs a CUDA device and nvcc; skips elsewhere. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances: K1 max|diff| <= 1e-5 x max|ref| — both sides are fp32 FMAs
over the same taps; only the summation order may differ. K3 1e-4 x
max|ref| against complex128 ``torch.fft`` and against its fp32 plain
version, the JAX package's yardstick (tests/test_fft_pallas.py)."""

import numpy as np
import pytest
import torch

from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.kernels import fft_ct as F
from microimagelib_tpu_torch.ops.conv_sep import plan_sep


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
