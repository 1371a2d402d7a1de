"""Beyond-HBM Richardson-Lucy deconvolution: host-staged, slab-streamed
(the JAX package's ``models/decon_streamed.py``).

The reference's ``gpuMemMode 2`` ping-pongs stacks, OTFs and spectra
through host RAM between whole-volume cuFFT calls
(``decon_singleview_OTF2`` reference:src/api_subfunc.cu:3468-3516, dual
``decon_dualview_OTF2`` :3697-3791), so the whole volume must still fit
on the card for each FFT. Here, as in the JAX package, the 3-D FFT
convolution itself is split so the device holds one chunk at a time:

  pass 1  z slabs   : 2-D rFFT over (y, x)                -> host spectrum
  pass 2  y chunks  : FFT over z, x OTF, inverse FFT over z -> host spectrum
  pass 3  z slabs   : 2-D irFFT fused with the RL ratio or
                      the estimate update and its clamp   -> host volume

FFTs along different axes commute, so the three passes give
``irfftn(rfftn(x) * OTF)`` with backward normalization, the transform of
the device-resident loop, to float32 rounding. The FFTs are ``torch.fft``
(cuFFT on the card), as the JAX package runs ``jnp.fft`` there.

Host working set: the image (per view), the estimate, the ratio, one
complex spectrum and the OTFs, as CPU tensors: pinned when the chunks go
to a CUDA device, so every copy is a DMA from or into them with no host
staging copy. A chunk that is not contiguous on the host (pass 2's y
chunks when there are several) moves as one copy per z plane, each a
contiguous run. Every chunk, the tail included, is processed at its own
size: a partial tail gives the same rows as a padded one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from microimagelib_tpu_torch.utils.device import resolve_device

SMALLVALUE = 0.01


# --------------------------------------------------------------------------
# numpy twins of the prep ops (host side, no device memory)
# --------------------------------------------------------------------------

def np_pad_stack_edge(img, out_shape):
    """Host twin of ops.basics.pad_stack_edge (replicate-edge, centered)."""
    iz, iy, ix = img.shape
    oz, oy, ox = out_shape
    lo = ((oz - iz) // 2, (oy - iy) // 2, (ox - ix) // 2)
    hi = (oz - iz - lo[0], oy - iy - lo[1], ox - ix - lo[2])
    return np.pad(img, tuple(zip(lo, hi)), mode="edge")


def np_align_size_3d(img, out_shape):
    """Host twin of ops.basics.align_size_3d (centered zero-pad/crop)."""
    img = np.asarray(img, np.float32)
    out = np.zeros(out_shape, np.float32)
    spans_o, spans_i = [], []
    for i_sz, o_sz in zip(img.shape, out_shape):
        so = (o_sz - i_sz) // 2
        o_lo = max(so, 0)
        i_lo = o_lo - so
        n = min(i_sz - i_lo, o_sz - o_lo)
        spans_o.append(slice(o_lo, o_lo + n))
        spans_i.append(slice(i_lo, i_lo + n))
    out[tuple(spans_o)] = img[tuple(spans_i)]
    return out


def np_crop_center(img, out_shape):
    """Host twin of ops.basics.crop_center."""
    iz, iy, ix = img.shape
    oz, oy, ox = out_shape
    so = ((iz - oz) // 2, (iy - oy) // 2, (ix - ox) // 2)
    return img[so[0]: so[0] + oz, so[1]: so[1] + oy, so[2]: so[2] + ox]


def _np_psf_on_grid(psf, fft_shape, normalize=True):
    """The PSF sum-normalized, re-sized when it exceeds the grid, and
    circularly split to the origin of ``fft_shape``: what ``genOTFcpu``
    transforms (reference:src/api_subfunc.cu:1650-1676)."""
    psf = np.asarray(psf, np.float32)
    if normalize:
        psf = psf / psf.sum()
    if any(p > f for p, f in zip(psf.shape, fft_shape)):
        psf = np_align_size_3d(psf, fft_shape)
    pz, py, px = psf.shape
    tmp = np.zeros(fft_shape, np.float32)
    tmp[:pz, :py, :px] = psf
    return np.roll(tmp, shift=(-(pz // 2), -(py // 2), -(px // 2)),
                   axis=(0, 1, 2))


def np_gen_otf(psf, fft_shape, normalize=True):
    """Host twin of models.deconvolution.gen_otf: the forward rfftn of
    :func:`_np_psf_on_grid`. Returns complex64."""
    return np.fft.rfftn(_np_psf_on_grid(psf, fft_shape, normalize)).astype(
        np.complex64)


def _chunk_counts(fft_shape, budget_bytes):
    """Pick power-of-two chunk counts along z (pass 1/3) and y (pass 2) so
    each per-chunk device call stays within ~1/4 of the budget. The
    counts need not divide the axes: the streamed loops use ceil-sized
    chunks with a shorter tail, so any extent is covered."""
    fz, fy, fx = fft_shape
    xh = fx // 2 + 1
    if budget_bytes is None or budget_bytes <= 0:
        return 1, 1
    per_call = budget_bytes / 4

    def pick(n_axis, bytes_full):
        n = 1
        while n < n_axis and bytes_full / n > per_call:
            n *= 2
        return min(n, n_axis)

    # pass 1/3: real slab (cz, fy, fx)*4 + complex slab (cz, fy, xh)*8
    z_bytes = fz * fy * (fx * 4 + xh * 8)
    # pass 2: ~3 complex (fz, cy, xh) buffers (in, otf, out)
    y_bytes = fz * fy * xh * 8 * 3
    return pick(fz, z_bytes), pick(fy, y_bytes)


# --------------------------------------------------------------------------
# host buffers and chunk transfers
# --------------------------------------------------------------------------

class _Mover:
    """Moves chunks between host buffers and ``device``, counting the
    bytes each way. ``stats``, when given, receives ``h2d_bytes`` and
    ``d2h_bytes`` in all, the same at the end of the set-up
    (``setup_h2d_bytes``, ``setup_d2h_bytes``: buffers and OTFs) and the
    wall seconds of each RL iteration (``iter_s``, the device synchronized
    after each)."""

    def __init__(self, device, stats=None):
        self.device = device
        self.timed = stats is not None
        self.stats = stats if stats is not None else {}
        self.stats.setdefault("h2d_bytes", 0)
        self.stats.setdefault("d2h_bytes", 0)
        self._t = 0.0

    def setup_done(self):
        if self.timed:
            self.sync()
            self.stats["setup_h2d_bytes"] = self.stats["h2d_bytes"]
            self.stats["setup_d2h_bytes"] = self.stats["d2h_bytes"]
            self.stats["iter_s"] = []
            self._t = time.perf_counter()

    def iteration_done(self):
        if self.timed:
            self.sync()
            t = time.perf_counter()
            self.stats["iter_s"].append(t - self._t)
            self._t = t

    def host(self, shape, dtype):
        """An empty host buffer, pinned when the device is CUDA."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def host_copy(self, arr, dtype):
        """A host buffer holding ``arr`` (numpy or tensor)."""
        if isinstance(arr, torch.Tensor):
            src = arr.detach().cpu()
        else:
            arr = np.asarray(arr)
            src = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        out = self.host(tuple(src.shape), dtype)
        out.copy_(src)
        return out

    @staticmethod
    def _copy(dst, src):
        if dst.is_contiguous() and src.is_contiguous():
            dst.copy_(src, non_blocking=True)
        else:   # one contiguous run per leading index
            for i in range(src.shape[0]):
                dst[i].copy_(src[i], non_blocking=True)

    def up(self, host_view):
        out = torch.empty(tuple(host_view.shape), dtype=host_view.dtype,
                          device=self.device)
        self._copy(out, host_view)
        self.stats["h2d_bytes"] += host_view.numel() * host_view.element_size()
        return out

    def down(self, host_view, dev):
        self._copy(host_view, dev)
        self.stats["d2h_bytes"] += dev.numel() * dev.element_size()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _spans(n, parts):
    step = -(-n // parts)
    return [slice(lo, min(n, lo + step)) for lo in range(0, n, step)]


# --------------------------------------------------------------------------
# the three passes
# --------------------------------------------------------------------------

def _pass_rfft2(mv, vol, spec, nz):
    """Pass 1: spec[z] = rFFT2 over (y, x) of vol[z], by z slabs."""
    for sl in _spans(vol.shape[0], nz):
        mv.down(spec[sl], torch.fft.rfft2(mv.up(vol[sl])))


def _pass_z(mv, spec, otf, ny):
    """Pass 2: FFT along z of each y chunk of ``spec``; with ``otf``, times
    the OTF and back by the inverse z FFT."""
    for sl in _spans(spec.shape[1], ny):
        s = torch.fft.fft(mv.up(spec[:, sl]), dim=0)
        if otf is not None:
            s *= mv.up(otf[:, sl])
            s = torch.fft.ifft(s, dim=0)
        mv.down(spec[:, sl], s)


def _pass_irfft2(mv, spec, other, out, elementwise, nz, x_out):
    """Pass 3: irFFT2 of each z slab fused with the RL elementwise stage:
    'ratio' gives other / conv, 'update' max(other * conv, SMALLVALUE)
    (``out`` may be ``other``)."""
    for sl in _spans(spec.shape[0], nz):
        conv = torch.fft.irfft2(mv.up(spec[sl]), s=(spec.shape[1], x_out))
        oth = mv.up(other[sl])
        res = (oth / conv if elementwise == "ratio"
               else torch.clamp_min(oth * conv, SMALLVALUE))
        mv.down(out[sl], res)


def _conv_streamed(mv, vol, spec, otf, out, elementwise, other, nz, ny):
    """One streamed FFT convolution: out = elementwise(irfftn(rfftn(vol) *
    otf), other). vol, other, out: host float32 (Z, Y, X); spec: host
    complex64 (Z, Y, X//2+1) scratch; otf: host complex64."""
    _pass_rfft2(mv, vol, spec, nz)
    _pass_z(mv, spec, otf, ny)
    _pass_irfft2(mv, spec, other, out, elementwise, nz, vol.shape[2])


def _otf_streamed(mv, psf, fft_shape, nz, ny):
    """The OTF of ``psf`` on ``fft_shape`` (host complex64), its rfftn
    taken by passes 1 and 2 on the device: the host twin of
    :func:`np_gen_otf` without a whole-volume host FFT."""
    vol = mv.host_copy(_np_psf_on_grid(psf, fft_shape), torch.float32)
    spec = mv.host((fft_shape[0], fft_shape[1], fft_shape[2] // 2 + 1),
                   torch.complex64)
    _pass_rfft2(mv, vol, spec, nz)
    _pass_z(mv, spec, None, ny)
    return spec


def _host_otf(mv, otf_or_psf, fft_shape, nz, ny):
    """A host complex64 OTF buffer: given an OTF (complex array), copied;
    given a PSF (real array), transformed on the device."""
    if np.iscomplexobj(otf_or_psf) or (isinstance(otf_or_psf, torch.Tensor)
                                       and otf_or_psf.is_complex()):
        return mv.host_copy(otf_or_psf, torch.complex64)
    return _otf_streamed(mv, otf_or_psf, fft_shape, nz, ny)


def _clamped_host(mv, img):
    img = mv.host_copy(img, torch.float32)
    return img.clamp_min_(SMALLVALUE)


# --------------------------------------------------------------------------
# streamed RL
# --------------------------------------------------------------------------

def rl_decon_single_streamed(img, otf, otf_bp, n_iters, const_initial=False,
                             budget_bytes=None, *, device=None, stats=None):
    """Single-view RL on a pre-padded FFT-grid image, streamed through host
    RAM so the device never holds a full volume; matches
    ``rl_decon_single`` to float32 rounding. ``otf``/``otf_bp``: complex
    OTFs (numpy or tensors), or real PSFs, whose OTFs are then built here
    on the device. Chunks run on ``device`` (default cuda:0;
    ``device="cpu"`` for the CPU). Returns the estimate as host float32
    numpy; ``stats`` (a dict) receives the bytes moved each way."""
    mv = _Mover(resolve_device(None, device), stats)
    fft_shape = tuple(np.shape(img))
    xh = fft_shape[2] // 2 + 1
    nz, ny = _chunk_counts(fft_shape, budget_bytes)
    img = _clamped_host(mv, img)
    est = mv.host(fft_shape, torch.float32)
    if const_initial:
        est.fill_(float(img.sum(dtype=torch.float64)))
    else:
        est.copy_(img)
    ratio = mv.host(fft_shape, torch.float32)
    spec = mv.host((fft_shape[0], fft_shape[1], xh), torch.complex64)
    otf = _host_otf(mv, otf, fft_shape, nz, ny)
    otf_bp = _host_otf(mv, otf_bp, fft_shape, nz, ny)
    mv.setup_done()
    for _ in range(n_iters):
        _conv_streamed(mv, est, spec, otf, ratio, "ratio", img, nz, ny)
        _conv_streamed(mv, ratio, spec, otf_bp, est, "update", est, nz, ny)
        mv.iteration_done()
    mv.sync()
    return est.numpy()


def rl_decon_dual_streamed(img_a, img_b, otf_a, otf_b, otf_bp_a, otf_bp_b,
                           n_iters, const_initial=False, budget_bytes=None, *,
                           device=None, stats=None):
    """Joint dual-view RL, streamed: view A then view B per iteration
    (``rl_decon_dual``, reference:src/api_subfunc.cu:3634-3660). OTFs,
    ``device`` and ``stats`` as in :func:`rl_decon_single_streamed`."""
    mv = _Mover(resolve_device(None, device), stats)
    fft_shape = tuple(np.shape(img_a))
    xh = fft_shape[2] // 2 + 1
    nz, ny = _chunk_counts(fft_shape, budget_bytes)
    img_a = _clamped_host(mv, img_a)
    img_b = _clamped_host(mv, img_b)
    est = mv.host(fft_shape, torch.float32)
    if const_initial:
        est.fill_((float(img_a.sum(dtype=torch.float64))
                   + float(img_b.sum(dtype=torch.float64))) / 2)
    else:
        torch.mul(img_a + img_b, 0.5, out=est)
    ratio = mv.host(fft_shape, torch.float32)
    spec = mv.host((fft_shape[0], fft_shape[1], xh), torch.complex64)
    views = [(img, _host_otf(mv, o, fft_shape, nz, ny),
              _host_otf(mv, obp, fft_shape, nz, ny))
             for img, o, obp in ((img_a, otf_a, otf_bp_a),
                                 (img_b, otf_b, otf_bp_b))]
    mv.setup_done()
    for _ in range(n_iters):
        for img, o, obp in views:
            _conv_streamed(mv, est, spec, o, ratio, "ratio", img, nz, ny)
            _conv_streamed(mv, ratio, spec, obp, est, "update", est, nz, ny)
        mv.iteration_done()
    mv.sync()
    return est.numpy()
