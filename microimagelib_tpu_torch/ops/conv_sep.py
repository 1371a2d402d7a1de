"""Separable compact-PSF convolution: the RL deconvolution hot op with no
spectrum at all.

Microscopy PSFs are compact (a few dozen voxels of support) and of low
separation rank — a Gaussian bead PSF is exactly rank 1 — so a circular
convolution with them needs short stencils only:

    out = sum_r  kz_r (*)_z  ky_r (*)_y  kx_r (*)_x  v      (circular)

This module plans that decomposition on the host (two-stage unfold-SVD of
the PSF: z vs (y, x), then y vs x per component) and hands the taps to
the hand-written CUDA kernel behind :func:`conv3_sep`
(kernels/conv_sep.py, csrc/conv_sep.cu). Tilted or curved measured PSFs
plan at low rank through :func:`slab_align`: each z slab is recentered on
its own mass centroid, and the kernel re-applies the shift as an exact
per-tap xy roll at the z pass.

Exactness: a plan is accepted only if the separable reconstruction
matches the (sum-normalized) PSF to ``tol`` relative Frobenius error, so
the result matches irfftn(rfftn(v) * gen_otf(psf)) with gen_otf's
conventions (center = size//2 circular split, ops/basics.py::
pad_psf_to_origin). Callers take the FFT route when :func:`plan_sep`
returns None.

The planner is numerically the JAX package's (same SVD, support trimming,
crop offsets and tap order), so both packages plan identical taps; it
emits the taps themselves instead of the TPU's bf16 circulant blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from microimagelib_tpu_torch.kernels.conv_sep import conv3_sep, conv3_sep_torch

__all__ = ["SepPlan", "plan_sep", "plan_from_numpy", "plan_sep_pair",
           "slab_align", "conv3_sep", "conv3_sep_torch"]

# What the Hopper kernel (csrc/conv_sep.cu) takes; the planner refuses
# anything beyond, so a plan never fails at launch. Shared memory of the
# xy pass grows with the y/x tap counts: at 128 taps each it needs
# ~127 KB of the 227 KB a block may use.
MAX_RANK = 4
MAX_Z_TAPS = 128
MAX_XY_TAPS = 128
MAX_NY_NZ = 65535   # grid.y / grid.z extents of the two launches


@dataclass(frozen=True, eq=False)
class SepPlan:
    """Planned separable convolution on grid ``shape`` (z, y, x).

    Per rank r: ``tz[r, s]`` multiplies ``v[z - a + s]`` (tap index
    s = a - d for z displacement d), after the xy roll ``rolls[s]`` =
    (dy, dx) in ``torch.roll`` sense (None when the plan has no rolls);
    ``ty[r, i]`` sits at y displacement ``oy + i`` and ``tx[r, j]`` at x
    displacement ``ox + j``: out[w] = sum_j k[j] in[(w - off_j) mod n]."""

    shape: tuple
    a: int
    b: int
    tz: np.ndarray          # (R, nsteps) f32
    ty: np.ndarray          # (R, Ly) f32
    oy: int
    tx: np.ndarray          # (R, Lx) f32
    ox: int
    rolls: np.ndarray | None  # (nsteps, 2) int32
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def rank(self):
        return self.tz.shape[0]

    @property
    def nsteps(self):
        return self.tz.shape[1]

    def tensors(self, device):
        """(tz, ty, tx, rolls) as contiguous tensors on ``device``, made
        once per device and kept with the plan."""
        key = str(torch.device(device))
        hit = self._dev.get(key)
        if hit is None:
            def put(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)

            hit = (put(self.tz, torch.float32), put(self.ty, torch.float32),
                   put(self.tx, torch.float32),
                   None if self.rolls is None else put(self.rolls,
                                                       torch.int32))
            self._dev[key] = hit
        return hit


def _support_1d(mass, tol):
    """[lo, hi) of the entries of nonneg vector ``mass`` whose excluded
    tails keep below tol of the total."""
    n = mass.shape[0]
    total = float(mass.sum())
    if total <= 0:
        return 0, 1
    lo, hi = 0, n
    while lo < n - 1 and mass[:lo + 1].sum() <= tol * total:
        lo += 1
    while hi > lo + 1 and mass[hi - 1:].sum() <= tol * total:
        hi -= 1
    return lo, hi


def _decompose(psf, tol, max_rank):
    """Greedy two-stage SVD separation: psf ~= sum_r kz_r x ky_r x kx_r.
    Returns (terms, err) with terms = list of (kz, ky, kx) f64 vectors on
    the FULL psf box, or None if max_rank is not enough."""
    pz, py, px = psf.shape
    m = psf.reshape(pz, py * px)
    u, s, vt = np.linalg.svd(m, full_matrices=False)
    cands = []
    for r in range(min(len(s), max_rank)):
        if s[r] <= 1e-14 * s[0]:
            break
        v2 = vt[r].reshape(py, px)
        uy, sy, vx = np.linalg.svd(v2, full_matrices=False)
        for q in range(min(len(sy), max_rank)):
            w = s[r] * sy[q]
            if w <= 1e-14 * s[0]:
                break
            cands.append((w, u[:, r] * s[r] * sy[q], uy[:, q], vx[q]))
    cands.sort(key=lambda c: -c[0])
    norm = np.linalg.norm(psf)
    terms = []
    recon = np.zeros_like(psf, dtype=np.float64)
    for _w, kz, ky, kx in cands[:max_rank]:
        terms.append((kz.astype(np.float64), ky.astype(np.float64),
                      kx.astype(np.float64)))
        recon += np.einsum("i,j,k->ijk", *terms[-1])
        if np.linalg.norm(psf - recon) <= tol * norm:
            return terms, float(np.linalg.norm(psf - recon) / norm)
    return None


def _crop_offsets(pshape, shape):
    """Per-axis (slice, displacement array) of a PSF of box ``pshape`` on
    grid ``shape``: identity when the PSF fits, else genOTF's
    alignsize-crop re-centering (reference:src/api_subfunc.cu:3269-3307)."""
    if any(p > f for p, f in zip(pshape, shape)):
        sls, offsets = [], []
        for p, f in zip(pshape, shape):
            so = (f - p) // 2
            o_lo = max(so, 0)
            i_lo = o_lo - so
            n = min(p - i_lo, f - o_lo)
            sls.append(slice(i_lo, i_lo + n))
            offsets.append(o_lo - f // 2 + np.arange(n))
        return tuple(sls), offsets
    return (tuple(slice(None) for _ in pshape),
            [np.arange(p) - p // 2 for p in pshape])


def slab_align(psf, mass_tol=1e-3):
    """Per-slab integer recentering of a tilted/curved PSF — the step that
    makes real light-sheet PSFs low-separation-rank: slab k is shifted by
    -(uy_k, ux_k), uy/ux = rint(slab xy mass centroid - the mass-weighted
    mean centroid), onto an enlarged zero canvas whose center convention
    (size//2) is preserved. Returns (aligned, rolls_z) with rolls_z[k] =
    (uy_k, ux_k): slab k of ``aligned`` stands for the true slab shifted
    by +rolls_z[k], which :func:`plan_sep` re-applies exactly as per-tap
    xy rolls at the z pass. Slabs below ``mass_tol`` of the peak mass
    inherit the nearest fitted slab's shift."""
    p = np.asarray(psf, np.float64)
    pz, py, px = p.shape
    q = np.abs(p)
    m = q.sum(axis=(1, 2))
    u = np.zeros((pz, 2), np.int64)
    if not (np.isfinite(m.max()) and m.max() > 0):
        return p, u
    keep = m > mass_tol * m.max()
    cy = (q[keep] * np.arange(py)[None, :, None]).sum(axis=(1, 2)) / m[keep]
    cx = (q[keep] * np.arange(px)[None, None, :]).sum(axis=(1, 2)) / m[keep]
    w = m[keep]
    u[keep, 0] = np.rint(cy - np.average(cy, weights=w))
    u[keep, 1] = np.rint(cx - np.average(cx, weights=w))
    fitted = np.where(keep)[0]
    for k in np.where(~keep)[0]:
        u[k] = u[fitted[np.argmin(np.abs(fitted - k))]]
    if not u.any():
        return p, u
    my, mx = int(np.abs(u[:, 0]).max()), int(np.abs(u[:, 1]).max())
    out = np.zeros((pz, py + 2 * my, px + 2 * mx))
    for k in range(pz):
        out[k, my - u[k, 0]:my - u[k, 0] + py,
            mx - u[k, 1]:mx - u[k, 1] + px] = p[k]
    return out, u


def plan_sep(psf, shape, tol=1e-6, max_rank=MAX_RANK, rolls_z=None,
             align=False):
    """Plan the separable conv of a compact PSF on grid ``shape``
    (z, y, x). Returns a :class:`SepPlan`, or None when the PSF does not
    separate to ``tol`` within ``max_rank`` terms, its z reach is wider
    than the grid, or the taps exceed what the kernel takes (rank <= 4,
    <= 128 z taps, <= 128 y and x taps, ny and nz <= 65535). The PSF is
    sum-normalized like ``gen_otf``.

    ``rolls_z``: optional (pz, 2) int array parallel to the PSF z axis —
    slab k of the given (already recentered) PSF stands for the true slab
    shifted by (+uy, +ux); the kernel re-applies the shift as a per-tap
    xy roll. ``align=True`` computes it with :func:`slab_align`.

    Fed the same PSF, this gives the JAX ``plan_sep(..., sigma=(0, 0))``'s
    rank, z reach, z taps and rolls, and x/y taps that rebuild its
    circulants."""
    nz, ny, nx = shape
    psf = np.asarray(psf, np.float64)
    if psf.ndim != 3 or max(nz, ny) > MAX_NY_NZ:
        return None
    if align:
        if rolls_z is not None:
            raise ValueError("align=True computes rolls_z internally")
        psf, rolls_z = slab_align(psf)
    tot = psf.sum()
    if not np.isfinite(tot) or tot <= 0:
        return None
    psf = psf / tot
    rolls_z = (np.zeros((psf.shape[0], 2), np.int64) if rolls_z is None
               else np.asarray(rolls_z, np.int64))
    if rolls_z.shape != (psf.shape[0], 2):
        raise ValueError("rolls_z must be (psf_z, 2)")

    # genOTF's oversized-PSF path center-crops to the FFT grid with
    # alignsize offsets and re-centers at grid//2, which shifts odd-size
    # axes by the (f-p)//2 truncation: tap t of axis (p -> f) sits at grid
    # index o_lo + (t - i_lo), displacement = that - f//2
    sls, (offz, offy, offx) = _crop_offsets(psf.shape, shape)
    psf = psf[sls]
    rolls_z = rolls_z[sls[0]]

    # trim the y/x box to its mass support (recentered/oversized canvases
    # carry zero margins)
    ylo, yhi = _support_1d(np.abs(psf).sum(axis=(0, 2)), tol * 1e-2)
    xlo, xhi = _support_1d(np.abs(psf).sum(axis=(0, 1)), tol * 1e-2)
    psf = psf[:, ylo:yhi, xlo:xhi]
    offy, offx = offy[ylo:yhi], offx[xlo:xhi]

    # compact z support (absolute indices) around the center convention
    zlo, zhi = _support_1d(np.abs(psf).sum(axis=(1, 2)), tol * 1e-2)
    d_min, d_max = int(offz[zlo]), int(offz[zhi - 1])
    a, b = max(d_max, 0), max(-d_min, 0)
    nsteps = a + b + 1
    if nsteps > nz or nsteps > MAX_Z_TAPS:
        return None
    if len(offy) > MAX_XY_TAPS or len(offx) > MAX_XY_TAPS:
        return None

    dec = _decompose(psf[zlo:zhi], tol, max_rank)
    if dec is None:
        return None
    terms, _err = dec
    rank = len(terms)
    if rank > MAX_RANK:
        return None

    tz = np.zeros((rank, nsteps), np.float32)
    rolls = np.zeros((nsteps, 2), np.int64)
    for r, (kz, _ky, _kx) in enumerate(terms):
        # z displacement d reads v[z - d] = v[z - a + s]: tap s = a - d
        for idx in range(zlo, zhi):
            d = int(offz[idx])
            tz[r, a - d] += kz[idx - zlo]
            rolls[a - d] = rolls_z[idx]
    # torus rolls: keep the representative nearest zero
    half = np.array([ny, nx]) // 2
    rolls = (rolls + half) % np.array([ny, nx]) - half
    return SepPlan(
        shape=(nz, ny, nx), a=a, b=b, tz=tz,
        ty=np.stack([ky for _kz, ky, _kx in terms]).astype(np.float32),
        oy=int(offy[0]),
        tx=np.stack([kx for _kz, _ky, kx in terms]).astype(np.float32),
        ox=int(offx[0]),
        rolls=rolls.astype(np.int32) if rolls.any() else None)


# The name under which a PSF given as a numpy array ("the weights" of this
# system) is turned into the port's plan.
plan_from_numpy = plan_sep


def plan_sep_pair(psf, psf_bp, shape, tol=1e-6, max_rank=MAX_RANK):
    """Plan the RL projector pair (forward PSF, back projector). Both the
    raw projectors and their :func:`slab_align` recentered forms are
    tried, and the lower total separation rank wins (ties favor raw: no
    per-tap rolls): tilted measured PSFs plan at the straight-PSF rank
    this way. Returns (fwd_plan, bp_plan), or None when every candidate
    fails :func:`plan_sep`."""
    p1 = np.asarray(psf, np.float64)
    p2 = np.asarray(psf_bp, np.float64)
    cands = [(p1, None, p2, None)]
    a1, rz1 = slab_align(p1)
    a2, rz2 = slab_align(p2)
    if rz1.any() or rz2.any():
        cands.append((a1, rz1, a2, rz2))
    best = None
    for q1, r1, q2, r2 in cands:
        fwd = plan_sep(q1, shape, tol=tol, max_rank=max_rank, rolls_z=r1)
        bp = (plan_sep(q2, shape, tol=tol, max_rank=max_rank, rolls_z=r2)
              if fwd is not None else None)
        if bp is None:
            continue
        rank = fwd.rank + bp.rank
        if best is None or rank < best[0]:
            best = (rank, (fwd, bp))
    return None if best is None else best[1]
