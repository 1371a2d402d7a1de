"""Affine transform with trilinear interpolation, and the fused
resample-and-correlate sums that registration minimizes (the JAX
package's ``ops/affine.py``).

The reference samples through CUDA 3D textures: output voxel (x, y, z)
maps through a 3x4 matrix and ``tex3D(tx+0.5, ...)`` interpolates texels
floor(c) and floor(c)+1 with fraction frac(c), each texel clamped to the
volume on its own (reference:include/cukernel.cuh:500-556). Texture
filtering rounds its weights to 8 bits; here, as in the JAX package, the
same footprint is gathered and the lerp taken in fp32.

Boundary masks (the reference's asymmetry, kept on purpose):
  * transform: valid iff c >= -0.5 and c < size - 0.5
    (``tx >= 0`` after the +0.5 shift, reference:include/cukernel.cuh:515)
  * correlate: strict c > -0.5 (``tx > 0``,
    reference:include/cukernel.cuh:545)
Outside the mask the sample is 0.

Everything here is plain PyTorch and runs on the input's device, chunked
over output z (or, in 2-D, over candidate matrices) so a (256, 512, 512)
volume peaks at a few volumes of temporaries. None of the 2-D and batched
sums is a Pallas kernel in the JAX package, so plain torch is their port on
the CPU and on the card. :func:`corr3d_partials` is the plain version of the kernel
K5 and :func:`corr3d_grad_torch` (autograd through it) the plain version
of K4 (``kernels/corr.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from microimagelib_tpu_torch.utils.device import resolve_device

__all__ = ["affine_transform_3d", "corr3d_partials", "corr3d_grad_torch",
           "corr3d_partials_batch", "affine_transform_2d", "corr2d_partials",
           "corr2d_partials_batch", "affine_transform_3d_window",
           "corr3d_partials_window", "affine_transform_3d_streamed",
           "corr3d_partials_streamed", "zslab_footprint_hops"]

# output voxels per chunk: ~30 temporaries of 4-8 bytes each, so a chunk
# holds well under 1 GB of scratch
CHUNK_VOXELS = 1 << 22


def _matrix_floats(tmx):
    """The 12 entries as Python floats, each rounded to float32 first."""
    if isinstance(tmx, torch.Tensor):
        tmx = tmx.detach().cpu().numpy()
    return [float(v) for v in np.asarray(tmx, np.float32).reshape(12)]


def _z_chunks(oz, oy, ox):
    step = max(1, CHUNK_VOXELS // max(1, oy * ox))
    return [(z0, min(oz, z0 + step)) for z0 in range(0, oz, step)]


def _coords(m, z0, z1, oy, ox, device, row_first=False):
    """Source coordinates (cx, cy, cz) of output rows z0..z1-1 in fp32.
    By default each is ``m[a,0]*x + m[a,1]*y + m[a,2]*z + m[a,3]``
    evaluated left to right, as the JAX gather path does; ``row_first``
    evaluates ``m[a,0]*x + ((m[a,1]*y + m[a,2]*z) + m[a,3])``, the order of
    the Pallas kernels and of K4/K5 (csrc/corr.cu). The two orders round
    differently: where that moves a coordinate across a lattice point, its
    floor flips, and with it the one-sided derivative the gradient sums
    take.
    ``m`` is a 12-vector of floats or a float32 tensor (for autograd)."""
    f32 = torch.float32
    xs = torch.arange(ox, dtype=f32, device=device)[None, None, :]
    ys = torch.arange(oy, dtype=f32, device=device)[None, :, None]
    zs = torch.arange(z0, z1, dtype=f32, device=device)[:, None, None]
    if row_first:
        return tuple(m[4 * a] * xs + ((m[4 * a + 1] * ys + m[4 * a + 2] * zs)
                                      + m[4 * a + 3]) for a in range(3))
    return tuple(m[4 * a] * xs + m[4 * a + 1] * ys + m[4 * a + 2] * zs
                 + m[4 * a + 3] for a in range(3))


def _trilerp(flat, shape, cx, cy, cz, strict_lo, win_start=0, wz=None):
    """Trilinear sample of the (sz, sy, sx) volume ``shape`` at (cx, cy,
    cz), zero outside the validity box: the JAX package's
    ``_trilerp_window`` in the same fp32 order. ``flat`` holds the whole
    volume flattened, or with ``wz`` only its z rows [win_start, win_start
    + wz): the validity box and the clamps stay those of the whole volume,
    so a window that covers every valid sample's footprint gives the same
    bits (a sample outside the window is always one the mask zeroes)."""
    sz, sy, sx = shape
    if strict_lo:
        valid = (cx > -0.5) & (cy > -0.5) & (cz > -0.5)
    else:
        valid = (cx >= -0.5) & (cy >= -0.5) & (cz >= -0.5)
    valid &= (cx < sx - 0.5) & (cy < sy - 0.5) & (cz < sz - 0.5)

    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    z0 = torch.floor(cz)
    fx = cx - x0
    fy = cy - y0
    fz = cz - z0

    # clamp each footprint texel on its own (CUDA clamp addressing): at c
    # in [-1, 0) both neighbours resolve to texel 0. Clamping the floor to
    # [-1, n] first keeps far-out coordinates inside int64 and changes no
    # clamped index.
    def corners(c0, n):
        r = c0.clamp(-1, n).to(torch.int64)
        return r.clamp(0, n - 1), (r + 1).clamp(0, n - 1)

    x0i, x1i = corners(x0, sx)
    y0i, y1i = corners(y0, sy)
    z0i, z1i = corners(z0, sz)
    if wz is not None:
        z0i = (z0i - win_start).clamp_(0, wz - 1)
        z1i = (z1i - win_start).clamp_(0, wz - 1)
    syx = sy * sx
    b00 = z0i * syx + y0i * sx
    b01 = z0i * syx + y1i * sx
    b10 = z1i * syx + y0i * sx
    b11 = z1i * syx + y1i * sx

    v000 = flat[b00 + x0i]
    v001 = flat[b00 + x1i]
    v010 = flat[b01 + x0i]
    v011 = flat[b01 + x1i]
    v100 = flat[b10 + x0i]
    v101 = flat[b10 + x1i]
    v110 = flat[b11 + x0i]
    v111 = flat[b11 + x1i]

    c00 = v000 + (v001 - v000) * fx
    c01 = v010 + (v011 - v010) * fx
    c10 = v100 + (v101 - v100) * fx
    c11 = v110 + (v111 - v110) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    val = c0 + (c1 - c0) * fz
    return torch.where(valid, val, torch.zeros((), dtype=val.dtype,
                                               device=val.device))


def affine_transform_3d(src, tmx, out_shape):
    """Resample ``src`` (z, y, x) float32 tensor through the 3x4 matrix
    ``tmx`` onto ``out_shape`` (z, y, x), on src's device — the
    ``affinetransformkernel`` + texture fetch
    (reference:include/cukernel.cuh:500-524); non-strict lower mask."""
    m = _matrix_floats(tmx)
    oz, oy, ox = (int(s) for s in out_shape)
    flat = src.contiguous().reshape(-1)
    out = torch.empty((oz, oy, ox), dtype=torch.float32, device=src.device)
    for z0, z1 in _z_chunks(oz, oy, ox):
        cx, cy, cz = _coords(m, z0, z1, oy, ox, src.device)
        out[z0:z1] = _trilerp(flat, tuple(src.shape), cx, cy, cz, False)
    return out


def _partials_chunk(flat, shape, tgt, m, z0, z1):
    sz, sy, sx = shape
    cx, cy, cz = _coords(m, z0, z1, sy, sx, tgt.device, row_first=True)
    s = _trilerp(flat, shape, cx, cy, cz, True)
    t = tgt[z0:z1]
    return (torch.sum(s * s, dtype=torch.float64),
            torch.sum(s * t, dtype=torch.float64))


def corr3d_partials(src, tgt, tmx):
    """(sum s^2, sum s*t) as float64 0-d tensors, where s is ``src``
    resampled through ``tmx`` onto ``tgt``'s grid (zero outside, strict
    lower bound) and t the target — the ``corrkernel``
    (reference:include/cukernel.cuh:526-556). Coordinates in the kernels'
    order (``_coords(row_first=True)``), so a voxel's sample here and in
    K4/K5 is the same fp32 number; products in fp32, sums in float64 as the
    reference accumulates them. The plain version of K5."""
    shape = tuple(src.shape)
    m = _matrix_floats(tmx)
    flat = src.contiguous().reshape(-1)
    ss = st = None
    for z0, z1 in _z_chunks(*shape):
        a, b = _partials_chunk(flat, shape, tgt, m, z0, z1)
        ss = a if ss is None else ss + a
        st = b if st is None else st + b
    return ss, st


def corr3d_grad_torch(src, tgt, tmx):
    """(ss, st, gs, gt): the sums of :func:`corr3d_partials` and their
    gradients in the 12 matrix entries, gs = d(ss/2)/dm and gt = d(st)/dm,
    by autograd through the gather formulation (the JAX package's
    ``grad_fallback_xla``). The plain version of K4. Each z chunk runs its
    own backward pass, so the graph never holds more than one chunk; the
    per-chunk gradients add up in float64. Returns float64 tensors on the
    volumes' device."""
    shape = tuple(src.shape)
    flat = src.contiguous().reshape(-1)
    m = torch.tensor(_matrix_floats(tmx), dtype=torch.float32,
                     device=src.device, requires_grad=True)
    f64 = dict(dtype=torch.float64, device=src.device)
    ss, st = torch.zeros((), **f64), torch.zeros((), **f64)
    gs, gt = torch.zeros(12, **f64), torch.zeros(12, **f64)
    with torch.enable_grad():
        for z0, z1 in _z_chunks(*shape):
            a, b = _partials_chunk(flat, shape, tgt, m, z0, z1)
            ga, = torch.autograd.grad(a, m, retain_graph=True)
            gb, = torch.autograd.grad(b, m)
            ss += a.detach()
            st += b.detach()
            gs += 0.5 * ga.double()
            gt += gb.double()
    return ss, st, gs, gt


def corr3d_partials_batch(src, tgt, tmx_batch):
    """:func:`corr3d_partials` for each of N matrices (``tmx_batch``:
    (N, 12)): (N,) float64 tensors of ss and st."""
    ss, st = zip(*(corr3d_partials(src, tgt, m)
                   for m in np.asarray(tmx_batch, np.float32).reshape(-1, 12)))
    return torch.stack(ss), torch.stack(st)


# --------------------------------------------------------------------------
# z windows and the streamed (beyond-HBM) drivers
# --------------------------------------------------------------------------

def affine_transform_3d_window(src_win, tmx, block_shape, z0_out, win_start,
                               sz_global):
    """Output rows [z0_out, z0_out + bz) of :func:`affine_transform_3d`
    (``block_shape`` = (bz, oy, ox)) sampled from the source's z rows
    [win_start, win_start + wz) held in ``src_win`` (wz, sy, sx), of a
    source of ``sz_global`` rows. Coordinates and masks are those of the
    whole transform, so blocks put together give its bits exactly, where
    each window covers its rows' footprint (:func:`_zspan_for_rows`)."""
    m = _matrix_floats(tmx)
    bz, oy, ox = (int(s) for s in block_shape)
    wz, sy, sx = src_win.shape
    flat = src_win.contiguous().reshape(-1)
    out = torch.empty((bz, oy, ox), dtype=torch.float32, device=src_win.device)
    for c0, c1 in _z_chunks(bz, oy, ox):
        cx, cy, cz = _coords(m, z0_out + c0, z0_out + c1, oy, ox, src_win.device)
        out[c0:c1] = _trilerp(flat, (int(sz_global), sy, sx), cx, cy, cz,
                              False, int(win_start), wz)
    return out


def corr3d_partials_window(src_win, target_block, tmx, z0_out, win_start,
                           sz_global):
    """(sum s^2, sum s*t) as float64 0-d tensors over the target's z rows
    [z0_out, z0_out + bz) (``target_block``, (bz, sy, sx)), the source's
    rows [win_start, win_start + wz) held in ``src_win``: the terms of
    :func:`corr3d_partials` for those rows, in the same fp32 order, so
    the partials of blocks that cover the target add up to its sums."""
    m = _matrix_floats(tmx)
    bz, sy, sx = target_block.shape
    wz = src_win.shape[0]
    flat = src_win.contiguous().reshape(-1)
    f64 = dict(dtype=torch.float64, device=src_win.device)
    ss, st = torch.zeros((), **f64), torch.zeros((), **f64)
    for c0, c1 in _z_chunks(bz, sy, sx):
        cx, cy, cz = _coords(m, z0_out + c0, z0_out + c1, sy, sx,
                             src_win.device, row_first=True)
        s = _trilerp(flat, (int(sz_global), sy, sx), cx, cy, cz, True,
                     int(win_start), wz)
        ss += torch.sum(s * s, dtype=torch.float64)
        st += torch.sum(s * target_block[c0:c1], dtype=torch.float64)
    return ss, st


def _zspan_for_rows(m, zlo, zhi, oy_n, ox_n, sz):
    """Source z window [lo, hi) that output rows [zlo, zhi] can sample:
    the affine z coordinate at the 8 corners (an affine map takes its
    extrema at corners), floored, plus the second texel."""
    czs = [m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3]
           for x in (0.0, ox_n - 1.0) for y in (0.0, oy_n - 1.0)
           for z in (float(zlo), float(zhi))]
    lo = int(np.clip(np.floor(min(czs)), 0, sz - 1))
    hi = int(np.clip(np.floor(max(czs)) + 2, 1, sz))
    return lo, hi


# Peak device bytes of one streamed block over the bytes of its source
# window and its output (or target) block, the raw bytes the JAX package's
# block plan budgets. The gather's int64 corners, indices, fractions and
# samples make it ~20x, where the JAX plan assumed 1x (its beyond-HBM
# registration ran out of memory). chip_smoke.py Phase 18 measures it with
# torch.cuda.max_memory_allocated for the transform and the NCC sums
# (tests/test_torch_kernels.py holds one block under it): PERF.md section 5.
STREAM_PEAK_FACTOR = 24.0
# the share of the budget one block may take at that peak
STREAM_BUDGET_SHARE = 0.5


def _block_bytes(n, lo, hi, plane_src, plane_out):
    """Raw bytes of one block: its source window and its output rows."""
    return 4 * ((hi - lo) * plane_src + n * plane_out)


def _stream_blocks(tmx, sz, oz, oy_n, ox_n, sy, sx, budget_bytes,
                   n_blocks=None):
    """Block plan of the streamed drivers: [(z0, n, lo, hi)], output rows
    [z0, z0 + n) from source rows [lo, hi). Without ``n_blocks`` the
    count doubles from 1 until every block's peak (STREAM_PEAK_FACTOR x
    its raw bytes) fits STREAM_BUDGET_SHARE of ``budget_bytes`` (one
    block without a budget); blocks are ceil-sized, the tail shorter."""
    m = np.asarray(tmx, np.float64).reshape(3, 4)

    def plan(nb):
        bz = -(-oz // nb)
        return [(z0, min(bz, oz - z0),
                 *_zspan_for_rows(m, z0, min(oz, z0 + bz) - 1, oy_n, ox_n, sz))
                for z0 in range(0, oz, bz)]

    def peak(blocks):
        return max(STREAM_PEAK_FACTOR * _block_bytes(n, lo, hi, sy * sx,
                                                     oy_n * ox_n)
                   for _z0, n, lo, hi in blocks)

    if n_blocks is None:
        n_blocks = 1
        if budget_bytes:
            while (n_blocks < oz
                   and peak(plan(n_blocks)) > budget_bytes * STREAM_BUDGET_SHARE):
                n_blocks *= 2
    return plan(max(1, min(int(n_blocks), oz)))


def _host_tensor(a):
    """A CPU tensor view of a numpy array or tensor (pinned stays pinned)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def affine_transform_3d_streamed(src_host, tmx, out_shape, budget_bytes=None,
                                 n_blocks=None, *, device=None):
    """Beyond-HBM affine transform: the source stays in host memory (numpy
    or a CPU tensor, best pinned); each output z block goes to ``device``
    (default cuda:0; ``device="cpu"`` for the CPU) with only the source
    rows it can sample. Returns host float32 numpy, bit-equal to
    :func:`affine_transform_3d`."""
    dev = resolve_device(None, device)
    src = _host_tensor(src_host)
    sz, sy, sx = src.shape
    oz, oy_n, ox_n = (int(s) for s in out_shape)
    out = torch.empty((oz, oy_n, ox_n), dtype=torch.float32,
                      pin_memory=dev.type == "cuda")
    for z0, n, lo, hi in _stream_blocks(tmx, sz, oz, oy_n, ox_n, sy, sx,
                                        budget_bytes, n_blocks):
        win = src[lo:hi].to(dev, non_blocking=True)
        out[z0:z0 + n].copy_(affine_transform_3d_window(
            win, tmx, (n, oy_n, ox_n), z0, lo, sz), non_blocking=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out.numpy()


def corr3d_partials_streamed(src_host, tgt_host, tmx, budget_bytes=None,
                             n_blocks=None, *, device=None):
    """NCC partials (sum s^2, sum s*t) as Python floats with both volumes
    in host memory (numpy or CPU tensors, best pinned, mean-subtracted like
    :func:`corr3d_partials`' inputs): each target z block goes to
    ``device`` (default cuda:0) with only the source rows its samples can
    reach, and the blocks' float64 partials add up on the device — the
    beyond-HBM registration cost."""
    dev = resolve_device(None, device)
    src = _host_tensor(src_host)
    tgt = _host_tensor(tgt_host)
    sz, sy, sx = src.shape
    oz = tgt.shape[0]
    f64 = dict(dtype=torch.float64, device=dev)
    ss, st = torch.zeros((), **f64), torch.zeros((), **f64)
    for z0, n, lo, hi in _stream_blocks(tmx, sz, oz, sy, sx, sy, sx,
                                        budget_bytes, n_blocks):
        a, b = corr3d_partials_window(
            src[lo:hi].to(dev, non_blocking=True),
            tgt[z0:z0 + n].to(dev, non_blocking=True), tmx, z0, lo, sz)
        ss += a
        st += b
    return float(ss), float(st)


def zslab_footprint_hops(tmx, shape_zyx, n_shards):
    """Host-side bound for a z-sharded registration's halo: the number of
    neighbour z shards each shard must receive so its source window covers
    the footprint of every valid sample of its own target rows
    (:func:`_zspan_for_rows` over each shard's rows); n_shards - 1 (a full
    gather) at most."""
    m = np.asarray(tmx, np.float64).reshape(3, 4)
    sz, sy, sx = shape_zyx
    dz = sz // n_shards
    hops = 0
    for i in range(n_shards):
        zlo, zhi = i * dz, (i + 1) * dz - 1
        lo, hi_ex = _zspan_for_rows(m, zlo, zhi, sy, sx, sz)
        hi = hi_ex - 1
        need_lo_hops = -(-(i * dz - lo) // dz) if lo < i * dz else 0
        need_hi_hops = -(-(hi - ((i + 1) * dz - 1)) // dz) if hi >= (i + 1) * dz else 0
        hops = max(hops, need_lo_hops, need_hi_hops)
    return min(hops, n_shards - 1)


# --------------------------------------------------------------------------
# 2-D: the transform and correlate kernels both use the strict lower bound
# (``tx > 0``, reference:include/cukernel.cuh:558-596)
# --------------------------------------------------------------------------

def _coords_2d(m, oy, ox, device):
    """Source coordinates (cx, cy) over an (oy, ox) grid for the 6-vector
    matrices ``m`` ((N, 6) float32 tensor): (N, oy, ox) each, evaluated
    ``m[0]*x + m[1]*y + m[2]`` left to right in fp32, as the JAX package
    does."""
    xs = torch.arange(ox, dtype=torch.float32, device=device)[None, None, :]
    ys = torch.arange(oy, dtype=torch.float32, device=device)[None, :, None]
    col = [m[:, j, None, None] for j in range(6)]
    return (col[0] * xs + col[1] * ys + col[2],
            col[3] * xs + col[4] * ys + col[5])


def _bilerp(src, cx, cy):
    """Bilinear sample of the (sy, sx) image at (cx, cy), zero outside the
    strict validity box (c > -0.5 and c < size - 0.5), each texel clamped
    on its own: the JAX package's ``_bilerp_flat`` with ``strict_lo``."""
    sy, sx = src.shape
    flat = src.contiguous().reshape(-1)
    valid = (cx > -0.5) & (cy > -0.5) & (cx < sx - 0.5) & (cy < sy - 0.5)
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = cx - x0
    fy = cy - y0
    xr = x0.clamp(-1, sx).to(torch.int64)
    yr = y0.clamp(-1, sy).to(torch.int64)
    x0i, x1i = xr.clamp(0, sx - 1), (xr + 1).clamp(0, sx - 1)
    y0i, y1i = yr.clamp(0, sy - 1) * sx, (yr + 1).clamp(0, sy - 1) * sx
    v00 = flat[y0i + x0i]
    v01 = flat[y0i + x1i]
    v10 = flat[y1i + x0i]
    v11 = flat[y1i + x1i]
    c0 = v00 + (v01 - v00) * fx
    c1 = v10 + (v11 - v10) * fx
    val = c0 + (c1 - c0) * fy
    return torch.where(valid, val, torch.zeros((), dtype=val.dtype,
                                               device=val.device))


def _matrices_6(tmx, device):
    return torch.as_tensor(np.asarray(
        tmx.detach().cpu() if isinstance(tmx, torch.Tensor) else tmx,
        np.float32).reshape(-1, 6), device=device)


def affine_transform_2d(src, tmx6, out_shape):
    """2-D affine resample of the (y, x) tensor ``src`` through the
    6-parameter matrix onto ``out_shape`` (y, x), on src's device
    (reference:include/cukernel.cuh:558-573)."""
    oy, ox = (int(s) for s in out_shape)
    cx, cy = _coords_2d(_matrices_6(tmx6, src.device)[:1], oy, ox, src.device)
    return _bilerp(src, cx[0], cy[0])


def corr2d_partials_batch(src, tgt, tmx_batch):
    """(ss, st) of the 2-D fused resample + NCC partials (``corr2Dkernel``,
    reference:include/cukernel.cuh:575-596) for each of N 6-vector
    matrices (``tmx_batch``: (N, 6)): (N,) float64 tensors on the images'
    device. Products in fp32, sums in float64. Candidates go in chunks of
    at most :data:`CHUNK_VOXELS` samples."""
    mats = _matrices_6(tmx_batch, src.device)
    oy, ox = tgt.shape
    step = max(1, CHUNK_VOXELS // max(1, oy * ox))
    ss, st = [], []
    for i in range(0, mats.shape[0], step):
        cx, cy = _coords_2d(mats[i:i + step], oy, ox, src.device)
        s = _bilerp(src, cx, cy)
        ss.append(torch.sum(s * s, dim=(1, 2), dtype=torch.float64))
        st.append(torch.sum(s * tgt, dim=(1, 2), dtype=torch.float64))
    return torch.cat(ss), torch.cat(st)


def corr2d_partials(src, tgt, tmx6):
    """:func:`corr2d_partials_batch` for one matrix: float64 0-d tensors."""
    ss, st = corr2d_partials_batch(src, tgt, tmx6)
    return ss[0], st[0]
