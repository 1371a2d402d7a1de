"""The plain reference: what the program computes, written out in plain
PyTorch from the reference's semantics, with no code of the program.

* isotropic resample: per axis c = (in/out) * i, linear interpolation
  between floor(c) and floor(c) + 1, each texel clamped to the volume,
  zero where c lies outside [-0.5, n - 0.5) (imresize3d,
  apifunc.cpp:429-446, and the texture mask of cukernel.cuh:515);
* +-90 degree turn about y (cukernel.cuh:437-453);
* trilinear affine transform through a 3x4 matrix, and the registration's
  NCC: both volumes less their means, the source moved and zero outside
  the strict mask (c > -0.5), sum(s t) / sqrt(sum s^2) / sqrt(sum t^2)
  (cukernel.cuh:500-556, api_subfunc.cu:2802-2824);
* Richardson-Lucy, single view and joint dual view (view A then view B
  each iteration), on the FFT grid of the reference's size policy with
  edge-replicated padding, sum-normalised PSFs centred on the origin,
  the flipped PSF as back projector, the image and the estimate clamped
  at 0.01 (api_subfunc.cu:3269-3416, 3634-3660).

``Prec`` says how it is computed: ``float64`` is the reference, every
value and the arithmetic in float64 (complex128 spectra); ``bfloat16`` is
the control, every volume and matrix stored in bfloat16 and the
arithmetic between, the transforms and their spectra in float32 (torch.fft
has no bfloat16 transform; a spectrum rounded to bfloat16 puts errors of
its largest term on the smallest voxels, and the RL ratio then divides by
zero); ``float32`` makes inputs.
"""

from __future__ import annotations

import numpy as np
import torch

SMALLVALUE = 0.01
CHUNK_VOXELS = 1 << 22


class Prec:
    def __init__(self, name):
        if name not in ("float64", "float32", "bfloat16"):
            raise ValueError(f"unknown precision {name}")
        self.name = name
        self.real = torch.float64 if name == "float64" else torch.float32
        self.cplx = torch.complex128 if name == "float64" else torch.complex64

    def __call__(self, x):
        x = torch.as_tensor(x).to(self.real)
        if self.name == "bfloat16":
            x = x.to(torch.bfloat16).to(torch.float32)
        return x

    def c(self, z):
        return z.to(self.cplx)


F64 = Prec("float64")
F32 = Prec("float32")     # for making inputs, not for judging
BF16 = Prec("bfloat16")


# --- FFT grid and padding (api_subfunc.cu:57-87 and the size policy of
# the program's callers: the next power of two when within 25%)

def snap_transform_size(n):
    n = -(-int(n) // 16) * 16
    low = 1 << (n.bit_length() - 1)
    if low == n:
        return n
    if (low << 1) <= 128:
        return low << 1
    return -(-n // 64) * 64


def snap_fft_size(n):
    base = snap_transform_size(n)
    pot = 1 << (base - 1).bit_length()
    return pot if pot != base and pot <= base * 1.25 else base


def fft_grid(shape):
    return tuple(snap_fft_size(s) for s in shape)


def pad_edge(img, out_shape):
    for ax, (i, o) in enumerate(zip(img.shape, out_shape)):
        if o != i:
            idx = (torch.arange(o, device=img.device) - (o - i) // 2).clamp_(0, i - 1)
            img = img.index_select(ax, idx)
    return img


def crop(img, out_shape):
    so = [(i - o) // 2 for i, o in zip(img.shape, out_shape)]
    return img[so[0]:so[0] + out_shape[0], so[1]:so[1] + out_shape[1],
               so[2]:so[2] + out_shape[2]]


def otf(psf_np, grid, p, device):
    """Sum-normalised PSF centred on the origin of ``grid``, transformed."""
    k = p(torch.from_numpy(np.ascontiguousarray(psf_np, np.float64)).to(device))
    k = p(k / k.sum())
    pad = torch.zeros(grid, dtype=p.real, device=device)
    pz, py, px = k.shape
    pad[:pz, :py, :px] = k
    pad = torch.roll(pad, shifts=(-(pz // 2), -(py // 2), -(px // 2)), dims=(0, 1, 2))
    return p.c(torch.fft.rfftn(pad))


def _conv(x, spec, grid, p):
    return p(torch.fft.irfftn(p.c(p.c(torch.fft.rfftn(x)) * spec), s=grid))


def _flip(psf_np):
    return np.ascontiguousarray(np.asarray(psf_np)[::-1, ::-1, ::-1])


def rl_single(img, psf_np, n_iters, p=F64):
    """Single-view RL of the (z, y, x) tensor ``img`` on its device;
    returns the estimate at ``img``'s shape in ``p.real``."""
    shape = tuple(img.shape)
    grid = fft_grid(shape)
    dev = img.device
    img = p(pad_edge(p(img), grid).clamp_min(SMALLVALUE))
    f, b = otf(psf_np, grid, p, dev), otf(_flip(psf_np), grid, p, dev)
    est = img
    for _ in range(n_iters):
        ratio = p(img / _conv(est, f, grid, p))
        est = p(torch.clamp_min(est * _conv(ratio, b, grid, p), SMALLVALUE))
    return crop(est, shape)


def rl_dual(img_a, img_b, psf_a, psf_b, n_iters, p=F64):
    """Joint dual-view RL, view A then view B each iteration, from
    (a + b) / 2; returns the estimate at the views' shape."""
    shape = tuple(img_a.shape)
    grid = fft_grid(shape)
    dev = img_a.device
    a = p(pad_edge(p(img_a), grid).clamp_min(SMALLVALUE))
    b = p(pad_edge(p(img_b), grid).clamp_min(SMALLVALUE))
    views = ((a, otf(psf_a, grid, p, dev), otf(_flip(psf_a), grid, p, dev)),
             (b, otf(psf_b, grid, p, dev), otf(_flip(psf_b), grid, p, dev)))
    est = p((a + b) * 0.5)
    for _ in range(n_iters):
        for img, f, bp in views:
            ratio = p(img / _conv(est, f, grid, p))
            est = p(torch.clamp_min(est * _conv(ratio, bp, grid, p), SMALLVALUE))
    return crop(est, shape)


# --- resampling

def interp_matrix(n_out, n_in, scale):
    """(n_out, n_in) linear-interpolation weights for c = scale * i."""
    c = scale * np.arange(n_out, dtype=np.float64)
    valid = (c >= -0.5) & (c < n_in - 0.5)
    i0 = np.floor(c).astype(np.int64)
    f = c - i0
    w = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.arange(n_out)
    np.add.at(w, (rows, np.clip(i0, 0, n_in - 1)), (1.0 - f) * valid)
    np.add.at(w, (rows, np.clip(i0 + 1, 0, n_in - 1)), f * valid)
    return w


def resize(vol, out_shape, p=F64):
    """``vol`` (z, y, x) resampled onto ``out_shape`` by the pure scaling
    in/out per axis; z, then y, then x."""
    dev = vol.device
    iz, iy, ix = vol.shape
    oz, oy, ox = out_shape
    wz, wy, wx = (p(torch.from_numpy(interp_matrix(o, i, i / o)).to(dev))
                  for o, i in ((oz, iz), (oy, iy), (ox, ix)))
    t = p(torch.einsum("ab,byx->ayx", wz, p(vol)))
    t = p(torch.einsum("cb,abx->acx", wy, t))
    return p(torch.einsum("dx,acx->acd", wx, t))


def rot_y(vol, direction):
    """direction 1: out[z', y, x'] = in[x', y, sx-1-z'];
    -1: out[z', y, x'] = in[sz-1-x', y, z']."""
    t = vol.permute(2, 1, 0)
    return torch.flip(t, dims=(0,) if direction == 1 else (2,)).contiguous()


def isotropize(view_a, view_b, cfg, p=F64):
    """The fusion's preprocessing: view A resampled onto the isotropic grid;
    view B turned by the configuration's rotation, then resampled onto it.
    Pixel sizes of both views are the configuration's ``pixel_a``."""
    px, py, pz = cfg["pixel_a"]
    nz, ny, nx = view_a.shape
    grid = (int(round(nz * pz / px)), int(round(ny * py / px)), nx)
    a = resize(view_a, grid, p) if tuple(view_a.shape) != grid else p(view_a)
    b = rot_y(p(view_b), 1 if cfg["im_rotation"] == 1 else -1)
    b = resize(b, grid, p) if tuple(b.shape) != grid else b
    return a, b


def _samples(flat, shape, m, z0, z1, oy, ox, real, strict_lo):
    """Trilinear samples of the flattened (sz, sy, sx) volume at output
    rows z0..z1-1 through the 12-vector ``m``, zero outside the mask."""
    sz, sy, sx = shape
    dev = flat.device
    xs = torch.arange(ox, dtype=real, device=dev)[None, None, :]
    ys = torch.arange(oy, dtype=real, device=dev)[None, :, None]
    zs = torch.arange(z0, z1, dtype=real, device=dev)[:, None, None]
    cx, cy, cz = (m[4 * a] * xs + m[4 * a + 1] * ys + m[4 * a + 2] * zs + m[4 * a + 3]
                  for a in range(3))
    lo = (lambda c: c > -0.5) if strict_lo else (lambda c: c >= -0.5)
    valid = lo(cx) & lo(cy) & lo(cz) & (cx < sx - 0.5) & (cy < sy - 0.5) & (cz < sz - 0.5)

    def corners(c, n):
        c0 = torch.floor(c)
        r = c0.clamp(-1, n).to(torch.int64)
        return r.clamp(0, n - 1), (r + 1).clamp(0, n - 1), c - c0

    x0, x1, fx = corners(cx, sx)
    y0, y1, fy = corners(cy, sy)
    z0i, z1i, fz = corners(cz, sz)

    def at(zi, yi, xi):
        return flat[(zi * sy + yi) * sx + xi]

    c00 = at(z0i, y0, x0) * (1 - fx) + at(z0i, y0, x1) * fx
    c01 = at(z0i, y1, x0) * (1 - fx) + at(z0i, y1, x1) * fx
    c10 = at(z1i, y0, x0) * (1 - fx) + at(z1i, y0, x1) * fx
    c11 = at(z1i, y1, x0) * (1 - fx) + at(z1i, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    val = c0 * (1 - fz) + c1 * fz
    return torch.where(valid, val, torch.zeros((), dtype=val.dtype, device=dev))


def _chunks(oz, oy, ox):
    step = max(1, CHUNK_VOXELS // max(1, oy * ox))
    return [(z0, min(oz, z0 + step)) for z0 in range(0, oz, step)]


def matrix(m12, p):
    """The 12 entries as floats, rounded to bfloat16 for the control."""
    m = np.asarray(m12, np.float64).reshape(12)
    if p.name == "bfloat16":
        m = torch.tensor(m).to(torch.bfloat16).double().numpy()
    return [float(v) for v in m]


def affine(vol, m12, out_shape, p=F64):
    """``vol`` moved through the 3x4 matrix onto ``out_shape`` (the
    transform's mask: c >= -0.5)."""
    flat = p(vol).reshape(-1)
    m = matrix(m12, p)
    oz, oy, ox = out_shape
    out = torch.empty(out_shape, dtype=p.real, device=vol.device)
    for z0, z1 in _chunks(oz, oy, ox):
        out[z0:z1] = p(_samples(flat, tuple(vol.shape), m, z0, z1, oy, ox, p.real, False))
    return out


def ncc(target, source, m12, p=F64):
    """The registration's NCC of ``source`` moved by ``m12`` against
    ``target``: means taken out of both first, sums in float64."""
    src = p(source)
    tgt = p(target)
    src = p(src - torch.sum(src, dtype=torch.float64).item() / src.numel())
    tgt = p(tgt - torch.sum(tgt, dtype=torch.float64).item() / tgt.numel())
    flat = src.reshape(-1)
    m = matrix(m12, p)
    oz, oy, ox = tgt.shape
    ss = st = 0.0
    for z0, z1 in _chunks(oz, oy, ox):
        s = p(_samples(flat, tuple(src.shape), m, z0, z1, oy, ox, p.real, True))
        t = tgt[z0:z1]
        ss += torch.sum(s * s, dtype=torch.float64).item()
        st += torch.sum(s * t, dtype=torch.float64).item()
    tt = torch.sum(tgt * tgt, dtype=torch.float64).item()
    return st / np.sqrt(ss) / np.sqrt(tt)
