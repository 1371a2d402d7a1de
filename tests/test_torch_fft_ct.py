"""The port's FFT convolution K3 (ops/fft_ct.py) against the JAX package's
Pallas CT convolution (interpret mode, fed ``permute_otf`` of the same
OTF) and float64 numpy, its support test and the FFT route policy
(``_fft_impl``), mirroring tests/test_fft_pallas.py. On the CPU
``conv3_ct`` runs its plain ``torch.fft`` version; the mixed-radix
Stockham algorithm of csrc/fft_ct.cu is checked here through a numpy
transliteration of its index arithmetic, both paths: the generic one and
the length-specialised register butterflies over the pitched spectrum
(the kernel itself runs only on the card: tests/test_torch_kernels.py).

Tolerance: 1e-4 x max, the JAX package's (tests/test_fft_pallas.py:35)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.ops import fft_pallas as JF
from microimagelib_tpu_torch.kernels import fft_ct as K
from microimagelib_tpu_torch.models import deconvolution as PD
from microimagelib_tpu_torch.ops.fft_ct import conv3_ct, ct_supported

torch.set_num_threads(1)


def _make(shape, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape).astype(np.float32)
    psf = rng.random(shape).astype(np.float32)
    psf /= psf.sum()
    otf = np.fft.rfftn(psf)          # a general complex OTF, not symmetric
    ref = np.fft.irfftn(np.fft.rfftn(v.astype(np.float64)) * otf, s=shape,
                        axes=(0, 1, 2))
    return v, otf, ref


@pytest.mark.parametrize("shape", [(32, 32, 128), (64, 32, 128), (32, 96, 128)])
def test_conv3_ct_matches_jax_and_f64(shape):
    v, otf, ref = _make(shape)
    assert ct_supported(shape) and JF.ct_supported(shape)
    before = K.LAUNCHES
    out = conv3_ct(torch.from_numpy(v),
                   torch.from_numpy(otf.astype(np.complex64))).numpy()
    assert K.LAUNCHES == before          # CPU: the plain version runs
    o_re, o_im = JF.permute_otf(otf.real, otf.imag, shape)
    jax_out = np.asarray(JF.conv3_ct(jnp.asarray(v), o_re, o_im,
                                     interpret=True))
    m = np.abs(ref).max()
    assert np.abs(out - ref).max() < 1e-4 * m
    assert np.abs(out - jax_out).max() < 1e-4 * m


def _radices(n):
    rs = []
    while n % 4 == 0:
        rs.append(4)
        n //= 4
    if n % 2 == 0:
        rs.append(2)
        n //= 2
    if n > 1:
        rs.append(n)
    return rs


def _stockham(x, sign, tab):
    """csrc/fft_ct.cu::fft_lines on (lines, n) complex64, pass by pass:
    radix-4/2 butterflies and the dense odd-factor pass, with the same
    twiddle indices into the (cos, sin)(2 pi t / n) table."""
    n = x.shape[1]
    w = tab[:, 0] + 1j * sign * tab[:, 1]
    ns = 1
    for r_ in _radices(n):
        y = np.empty_like(x)
        span, tstep = n // r_, n // (ns * r_)
        for j in range(span):
            k = j % ns
            o = (j // ns) * ns * r_ + k
            if r_ in (2, 4):
                a = [x[:, j + r * span] * w[r * k * tstep] for r in range(r_)]
                if r_ == 2:
                    outs = [a[0] + a[1], a[0] - a[1]]
                else:
                    e, f, g, h = a[0] + a[2], a[0] - a[2], a[1] + a[3], a[1] - a[3]
                    ih = 1j * sign * h
                    outs = [e + g, f + ih, e - g, f - ih]
            else:
                outs = []
                for r in range(r_):
                    step = (k * tstep + r * span) % n
                    outs.append(sum(x[:, j + q * span] * w[(q * step) % n]
                                    for q in range(r_)))
            for r in range(r_):
                y[:, o + r * ns] = outs[r]
        x = y.astype(np.complex64)
        ns *= r_
    return x


def _kernel_transliteration(v, otf):
    """The five launches of csrc/fft_ct.cu: x rows paired into complex
    lines, y, z x OTF x z inverse, y inverse, paired x inverse."""
    nz, ny, nx = v.shape
    kx = nx // 2 + 1
    rows = v.reshape(-1, nx)
    if len(rows) % 2:
        rows = np.concatenate([rows, np.zeros((1, nx), np.float32)])
    z = _stockham((rows[0::2] + 1j * rows[1::2]).astype(np.complex64), -1,
                  K.twiddles(nx))
    k = np.arange(kx)
    zk, zm = z[:, k], z[:, (nx - k) % nx]
    spec = np.empty((len(rows), kx), np.complex64)
    spec[0::2] = 0.5 * (zk + np.conj(zm))
    spec[1::2] = -0.5j * (zk - np.conj(zm))
    s = spec[:nz * ny].reshape(nz, ny, kx)

    def along(a, axis, sign, n):
        lines = np.moveaxis(a, axis, -1)
        shp = lines.shape
        out = _stockham(lines.reshape(-1, n), sign, K.twiddles(n))
        return np.moveaxis(out.reshape(shp), -1, axis)

    s = along(s, 1, -1, ny)
    s = along(s, 0, -1, nz) * otf.astype(np.complex64)
    s = along(s, 0, 1, nz)
    s = along(s, 1, 1, ny).reshape(-1, kx)
    if len(s) % 2:
        s = np.concatenate([s, np.zeros((1, kx), np.complex64)])
    fa, fb = s[0::2].copy(), s[1::2].copy()
    for c in (0, nx // 2):              # irfft drops these imaginary parts
        fa[:, c] = fa[:, c].real
        fb[:, c] = fb[:, c].real
    full = np.empty((len(fa), nx), np.complex64)
    full[:, :kx] = fa + 1j * fb
    mk = np.arange(kx, nx)
    full[:, kx:] = np.conj(fa[:, nx - mk]) + 1j * np.conj(fb[:, nx - mk])
    zz = _stockham(full, 1, K.twiddles(nx))
    out = np.empty((2 * len(zz), nx), np.float32)
    out[0::2], out[1::2] = zz.real, zz.imag
    return out[:nz * ny].reshape(nz, ny, nx) / (nz * ny * nx)


@pytest.mark.parametrize("shape", [
    (8, 12, 16),      # radix 4 and 2 with m = 3 in y
    (5, 6, 20),       # z = m = 5 alone, y = 2 x 3, x = 4 x 5
    (15, 3, 10),      # odd row count 45: the last x line has no partner
    (7, 9, 14),       # m = 7 and 9, x = 2 x 7
])
def test_kernel_algorithm_transliteration_matches_f64(shape):
    v, otf, ref = _make(shape, seed=1)
    assert ct_supported(shape)
    out = _kernel_transliteration(v, otf)
    assert np.abs(out - ref).max() < 1e-5 * np.abs(ref).max()


# ---- the length-specialised path (csrc/fft_ct.cu fft_tile) ---------------

_C8 = np.float32(0.70710678118654752)
_C1, _C2 = np.float32(0.30901699437494742), np.float32(-0.80901699437494742)
_S1, _S2 = np.float32(0.95105651629515357), np.float32(0.58778525229247313)


def _mul_i(a, s):
    return np.complex64(s * 1j) * a


def _dft4(a0, a1, a2, a3, s):
    e, f, g, h = a0 + a2, a0 - a2, a1 + a3, _mul_i(a1 - a3, s)
    return [e + g, f + h, e - g, f - h]


def _dft8(a, s):
    ev = _dft4(a[0], a[2], a[4], a[6], s)
    od = _dft4(a[1], a[3], a[5], a[7], s)
    od = [od[0], od[1] * np.complex64(_C8 * (1 + s * 1j)), _mul_i(od[2], s),
          od[3] * np.complex64(_C8 * (-1 + s * 1j))]
    return [ev[q] + od[q] for q in range(4)] + [ev[q] - od[q] for q in range(4)]


def _dft5(a, s):
    t1, t2, t3, t4 = a[1] + a[4], a[2] + a[3], a[1] - a[4], a[2] - a[3]
    p1 = a[0] + _C1 * t1 + _C2 * t2
    p2 = a[0] + _C2 * t1 + _C1 * t2
    q1 = _mul_i(_S1 * t3 + _S2 * t4, s)
    q2 = _mul_i(_S2 * t3 - _S1 * t4, s)
    return [a[0] + (t1 + t2), p1 + q1, p2 + q2, p2 - q2, p1 - q1]


_DFT = {4: lambda a, s: _dft4(*a, s), 5: _dft5, 8: _dft8}


def _specialised(x, sign, tab):
    """csrc/fft_ct.cu::fft_tile on (lines, n) complex64, n with a
    radix_plan: per pass, butterfly j loads x[j + r n/R], multiplies the
    twiddle tab[r (j % ns) n/(ns R)] (none in the first pass), runs the
    register DFT and stores output q at (j // ns) ns R + j % ns + q ns."""
    n = x.shape[1]
    w = (tab[:, 0] + 1j * sign * tab[:, 1]).astype(np.complex64)
    ns = 1
    for r_ in K.radix_plan(n):
        span, tstep = n // r_, n // (ns * r_)
        j = np.arange(span)
        k = j % ns
        a = [x[:, j + r * span] for r in range(r_)]
        if ns > 1:
            a = [a[0]] + [a[r] * w[r * k * tstep] for r in range(1, r_)]
        outs = _DFT[r_](a, sign)
        o = (j // ns) * ns * r_ + k
        y = np.empty_like(x)
        for q in range(r_):
            y[:, o + q * ns] = outs[q]
        x = y
        ns *= r_
    return x


def _line_fft(lines, sign):
    """The kernel's transform of (lines, n): the specialised path where n
    has a radix_plan, the generic one elsewhere (the host's choice)."""
    n = lines.shape[1]
    run = _specialised if K.radix_plan(n) else _stockham
    return run(lines.astype(np.complex64), sign, K.twiddles(n))


def _pitched_transliteration(v, otf):
    """The five launches with the pitched spectrum: rows of
    spec_pitch(nx) complex values, y and z tiles that load the padding
    columns as zeros and store only the valid ones, the OTF (natural
    layout) applied to the valid columns as the inverse z transform loads
    them. The padding stays NaN throughout, so a read of it shows."""
    nz, ny, nx = v.shape
    kx, kxp = nx // 2 + 1, K.spec_pitch(nx)
    rows = v.reshape(-1, nx)
    if len(rows) % 2:
        rows = np.concatenate([rows, np.zeros((1, nx), np.float32)])
    z = _line_fft(rows[0::2] + 1j * rows[1::2], -1)
    k = np.arange(kx)
    zk, zm = z[:, k], z[:, (nx - k) % nx]
    spec = np.full((len(rows), kxp), np.nan, np.complex64)
    spec[0::2, :kx] = 0.5 * (zk + np.conj(zm))
    spec[1::2, :kx] = -0.5j * (zk - np.conj(zm))
    spec = spec[:nz * ny].reshape(nz, ny, kxp)

    def tiles(s, axis, sign, otf_=None):
        t = np.where(np.arange(kxp) < kx, s, 0).astype(np.complex64)  # move_tile load
        lines = np.moveaxis(t, axis, -1)
        shp = lines.shape
        out = _line_fft(lines.reshape(-1, shp[-1]), sign).reshape(shp)
        out = np.moveaxis(out, -1, axis)
        if otf_ is not None:
            out[..., :kx] *= otf_.astype(np.complex64)
            lines = np.moveaxis(out, axis, -1)
            out = np.moveaxis(_line_fft(lines.reshape(-1, shp[-1]), 1).reshape(shp),
                              -1, axis)
        res = s.copy()
        res[..., :kx] = out[..., :kx]                                   # masked store
        return res

    spec = tiles(spec, 1, -1)
    spec = tiles(spec, 0, -1, otf)
    spec = tiles(spec, 1, 1)
    assert np.isnan(spec[..., kx:]).all()        # no byte of padding moved
    s = spec.reshape(-1, kxp)[:, :kx]
    if len(s) % 2:
        s = np.concatenate([s, np.zeros((1, kx), np.complex64)])
    fa, fb = s[0::2].copy(), s[1::2].copy()
    for c in (0, nx // 2):
        fa[:, c] = fa[:, c].real
        fb[:, c] = fb[:, c].real
    full = np.empty((len(fa), nx), np.complex64)
    full[:, :kx] = fa + 1j * fb
    mk = np.arange(kx, nx)
    full[:, kx:] = np.conj(fa[:, nx - mk]) + 1j * np.conj(fb[:, nx - mk])
    zz = _line_fft(full, 1)
    out = np.empty((2 * len(zz), nx), np.float32)
    out[0::2], out[1::2] = zz.real, zz.imag
    return out[:nz * ny].reshape(nz, ny, nx) / (nz * ny * nx)


@pytest.mark.parametrize("n", [128, 256, 320, 512])
@pytest.mark.parametrize("sign", [-1, 1])
def test_specialised_transform_matches_f64(n, sign):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))).astype(np.complex64)
    out = _specialised(x, sign, K.twiddles(n))
    ref = (np.fft.fft if sign < 0 else lambda a, axis: n * np.fft.ifft(a, axis=axis))(
        x.astype(np.complex128), axis=1)
    assert out.dtype == np.complex64
    assert np.abs(out - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [
    (128, 6, 128),    # z and x specialised, y generic (2 x 3)
    (6, 256, 256),    # y and x specialised, z generic
    (320, 4, 320),    # kx = 161 in a pitch of 176
    (3, 512, 512),    # 1536 rows; y 512
])
def test_pitched_transliteration_matches_f64(shape):
    v, otf, ref = _make(shape, seed=2)
    assert ct_supported(shape)
    out = _pitched_transliteration(v, otf)
    assert np.abs(out - ref).max() < 1e-5 * np.abs(ref).max()


def test_radix_plan_covers_the_main_grids():
    for shape in ((320, 512, 512), (256, 512, 512), (320, 512, 320)):
        for n in shape:
            plan = K.radix_plan(n)
            assert plan is not None and int(np.prod(plan)) == n, (shape, n)
            assert set(plan) <= {4, 5, 8}
    for n in (6, 40, 48, 64, 96, 100, 384, 1024):
        assert K.radix_plan(n) is None
    assert K.ct_specialised((320, 512, 512)) and K.ct_specialised((128, 128, 256))
    assert not K.ct_specialised((64, 256, 256))            # z generic
    assert not K.ct_specialised((320, 384, 512))           # y generic
    assert not K.ct_specialised((320, 512, 384))           # x generic
    assert K.spec_pitch(512) == 272 and K.spec_pitch(320) == 176
    assert K.spec_pitch(40) == 32 and K.spec_pitch(128) == 80


def _slot(e, p, swz):
    """csrc/fft_ct.cu::at: shared slot of element e of line p."""
    return e * 16 + ((p ^ ((e ^ (e >> 2)) & 15)) if swz else p)


@pytest.mark.parametrize("n", [128, 256, 320, 512])
def test_shared_tile_is_bank_conflict_free(n):
    """Every 16-thread half-warp of 8-byte accesses the kernel makes hits 16
    distinct 8-byte slots of a 128-byte row group (32 banks): the butterfly
    loads and stores (16 lines, one element), and in the x launches the
    float4 rows (element 4q + i, 16 aligned q) and the spectrum rows (16
    aligned k). The layout is a permutation of the tile."""
    for swz in (False, True):
        slots = {_slot(e, p, swz) for e in range(n) for p in range(16)}
        assert slots == set(range(16 * n))
        for e in range(n):
            assert len({_slot(e, p, swz) % 16 for p in range(16)}) == 16
    for p in range(16):
        for q0 in range(0, n // 4, 16):
            for i in range(4):
                assert len({_slot(4 * q + i, p, True) % 16 for q in range(q0, q0 + 16)}) == 16
        for k0 in range(0, n, 16):
            assert len({_slot(k, p, True) % 16 for k in range(k0, k0 + 16)}) == 16


def test_twiddle_table_is_float64_rounded():
    tab = K.twiddles(320)
    assert tab.dtype == np.float32 and tab.shape == (320, 2)
    ang = 2 * np.pi * np.arange(320) / 320
    np.testing.assert_array_equal(tab[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tab[:, 1], np.sin(ang).astype(np.float32))


def test_ct_supported_policy():
    assert ct_supported((512, 512, 512))
    assert ct_supported((128, 256, 512))
    assert ct_supported((320, 512, 512)) and ct_supported((256, 512, 704))
    # the JAX package's refusals that were TPU layout limits are lifted
    assert ct_supported((30, 32, 128)) and ct_supported((32, 20, 128))
    assert ct_supported((32, 32, 120)) and ct_supported((64, 1024, 1024))
    assert not ct_supported((32, 32, 127))     # nx odd
    assert not ct_supported((32, 32, 8194))    # an axis beyond 8192
    assert not ct_supported((8224, 32, 128))
    # every shape the JAX test accepts with axes <= 8192 is accepted here
    for nz in (32, 96, 320, 8192):
        for ny in (32, 64, 160, 512, 2048):
            for nx in (128, 384, 512, 8192):
                if JF.ct_supported((nz, ny, nx)):
                    assert ct_supported((nz, ny, nx)), (nz, ny, nx)


def test_conv3_ct_refuses_explicitly():
    v = torch.zeros((4, 4, 7))
    with pytest.raises(ValueError, match="does not take"):
        conv3_ct(v, torch.zeros((4, 4, 4), dtype=torch.complex64))
    with pytest.raises(ValueError, match="complex64"):
        conv3_ct(torch.zeros((4, 4, 8)), torch.zeros((4, 4, 5)))
    with pytest.raises(TypeError):
        conv3_ct(torch.zeros((4, 4, 8), dtype=torch.float64),
                 torch.zeros((4, 4, 5), dtype=torch.complex64))


def test_fft_impl_policy(monkeypatch):
    monkeypatch.delenv("MIL_FFT_IMPL", raising=False)
    monkeypatch.delenv("MIL_FFT_CT_MIN_VOXELS", raising=False)
    cpu = torch.zeros(1)
    assert PD._fft_impl((512, 512, 512), cpu) == "torch"   # CPU: torch.fft
    assert PD._fft_impl((512, 512, 512)) == "torch"
    monkeypatch.setattr(PD, "_on_cuda", lambda arr: True)
    assert PD._fft_impl((512, 512, 512), cpu) == "ct"
    assert PD._fft_impl((320, 512, 512), cpu) == "ct"
    assert PD._fft_impl((512, 512, 511), cpu) == "torch"   # unsupported
    assert PD.CT_MIN_VOXELS == 2 ** 21                     # the H100 ladder's
    assert PD._fft_impl((128, 128, 128), cpu) == "ct"      # exactly 2^21
    assert PD._fft_impl((128, 128, 256), cpu) == "ct"
    assert PD._fft_impl((128, 512, 512), cpu) == "ct"
    # a generic length on any axis: torch.fft, whatever the size
    assert PD._fft_impl((64, 256, 256), cpu) == "torch"
    assert PD._fft_impl((64, 384, 384), cpu) == "torch"
    assert PD._fft_impl((384, 512, 512), cpu) == "torch"
    assert PD._fft_impl((512, 512, 1024), cpu) == "torch"
    monkeypatch.setenv("MIL_FFT_CT_MIN_VOXELS", str(2 ** 18))
    assert PD._fft_impl((64, 64, 64), cpu) == "torch"      # 64 is a generic length
    monkeypatch.setenv("MIL_FFT_CT_MIN_VOXELS", str(2 ** 25))
    assert PD._fft_impl((128, 256, 512), cpu) == "torch"   # the knob keeps its meaning
    assert PD._fft_impl((128, 512, 512), cpu) == "ct"      # exactly 2^25
    monkeypatch.setenv("MIL_FFT_IMPL", "pallas")
    monkeypatch.setattr(PD, "_on_cuda", lambda arr: False)
    assert PD._fft_impl((32, 32, 128)) == "ct"
    assert PD._fft_impl((32, 32, 127)) == "torch"          # unsupported shape
    for impl in ("xla", "matmul"):
        monkeypatch.setenv("MIL_FFT_IMPL", impl)
        monkeypatch.setattr(PD, "_on_cuda", lambda arr: True)
        assert PD._fft_impl((512, 512, 512), cpu) == "torch"


@pytest.mark.parametrize("shape,route", [((32, 32, 128), "ct"),
                                         ((32, 32, 126 + 1), "torch")])
def test_rl_dual_takes_the_policy_route(monkeypatch, shape, route):
    """MIL_FFT_IMPL=pallas sends the dual loop through conv3_ct (4 calls
    per iteration) where K3 takes the grid; a grid it refuses (nx odd)
    goes to torch.fft without touching conv3_ct."""
    monkeypatch.setenv("MIL_FFT_IMPL", "pallas")
    calls = []

    def counting(v, otf):
        calls.append(tuple(v.shape))
        return conv3_ct(v, otf)

    monkeypatch.setattr(PD, "conv3_ct", counting)
    rng = np.random.default_rng(2)
    a = (rng.random(shape) * 100 + 1).astype(np.float32)
    b = (rng.random(shape) * 100 + 1).astype(np.float32)
    psf = np.ones((3, 3, 3), np.float32) / 27
    otf = PD.gen_otf(psf, shape)
    out = PD.rl_decon_dual(a, b, otf, otf, otf, otf, 2)
    assert out.shape == shape and torch.isfinite(out).all()
    assert len(calls) == (8 if route == "ct" else 0)


def test_convolver_relays_otfs_only_for_k3():
    """K3 reads C-order OTFs (re-laid once, outside the loop); the
    torch.fft route keeps the strided layout cuFFT hands back."""
    otf = torch.zeros((4, 6, 5), dtype=torch.complex64).transpose(0, 2)
    assert not otf.is_contiguous()
    conv, (o,) = PD._convolver("ct", (5, 6, 8), (otf,))
    assert o.is_contiguous() and torch.equal(o, otf)
    conv, (o,) = PD._convolver("torch", (5, 6, 8), (otf,))
    assert o is otf
