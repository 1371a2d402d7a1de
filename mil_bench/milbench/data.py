"""The benchmark's inputs, made from ``--seed`` on the run's device.

Frozen copies of the data makers the repository's own tools use, so that
a later change to those tools cannot move the yardstick:

* the blobs and the sCMOS camera model of
  ``microimagelib_tpu_torch/tools/e2e_surrogate.py`` (``_blobs``,
  ``camera``, ``_axial_blur``, ``build_inputs``' view geometry and its
  per-timepoint drift of view B), with the bead density of
  ``chip_smoke.py``'s ``beads`` (80 per 128^3 voxels);
* ``curved_tilted_psf`` of the same file, the measured-PSF class;
* the 9^3 Gaussian of ``bench.py`` (``bench_psf`` in ``chip_smoke.py``);
* ``dof_to_matrix`` and ``compose_affine`` of
  ``microimagelib_tpu_torch/ops/matrix.py``, rounding as they do.

Everything large is made on ``device`` with one ``torch.Generator`` in a
few whole-volume calls; only the bead positions and amplitudes (a few
thousand numbers) come from a numpy generator on the host. The same seed
gives the same inputs.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

BASELINE_OFFSET = 100.0   # sCMOS fixed offset, counts
READ_NOISE = 2.0          # e- rms
PEAK_COUNTS = 2500.0      # brightest structure, photons (peak SNR ~50)
BLOB_SIGMA = 2.5          # e2e_surrogate.py's blob width, voxels


# --- point spread functions (host numpy, as the program's callers hand them)

def gauss9():
    """The 9^3 Gaussian of bench.py: exp(-r^2 / 4.5), sum-normalised."""
    zz, yy, xx = np.meshgrid(*[np.arange(9) - 4] * 3, indexing="ij")
    psf = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 4.5).astype(np.float32)
    return psf / psf.sum()


def curved_tilted_psf(p=(19, 11, 27), sl=3.6, ss=1.1, st=1.3, curve=0.045,
                      floor=2e-4):
    """Measured-class detection PSF: the lateral centroid drifts linearly
    (tilt) and quadratically (focal curvature) with z, the widths are
    anisotropic, and a constant pedestal rides on top."""
    z = np.arange(p[0]) - p[0] // 2
    y = np.arange(p[1]) - p[1] // 2
    x = np.arange(p[2]) - p[2] // 2
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
    xc = 0.9 * zz + curve * zz ** 2
    yc = 0.15 * zz
    u = (xx - xc) / np.sqrt(2.0)
    w = (xx - xc) * 0.0 + zz / np.sqrt(2.0)
    g = np.exp(-(u + w) ** 2 / (2 * sl ** 2)
               - (u - w) ** 2 / (2 * ss ** 2)
               - (yy - yc) ** 2 / (2 * st ** 2)).astype(np.float32)
    g = g + floor * g.max()
    return (g / g.sum()).astype(np.float32)


PSFS = {"gauss9": gauss9, "curved_tilted": curved_tilted_psf}
PSF_DIR = Path(__file__).resolve().parents[1] / "psfs"


def psf(name):
    """A PSF by name: one made here, or ``mil_bench/psfs/<name>.npy`` (a
    new PSF is a new file)."""
    if name in PSFS:
        return PSFS[name]()
    return np.load(PSF_DIR / f"{name}.npy").astype(np.float32)


# --- matrices (ops/matrix.py, frozen)

def compose_affine(m1, m2):
    """3x4 composition m1 @ m2 in float64, rounded to float32."""
    a = np.asarray(m1, dtype=np.float64).reshape(3, 4)
    b = np.asarray(m2, dtype=np.float64).reshape(3, 4)
    out = np.empty((3, 4), dtype=np.float64)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out.reshape(12).astype(np.float32)


def _rz(a):
    return np.array([[math.cos(a), math.sin(a), 0, 0],
                     [-math.sin(a), math.cos(a), 0, 0], [0, 0, 1, 0]])


def _rx(b):
    return np.array([[1, 0, 0, 0], [0, math.cos(b), math.sin(b), 0],
                     [0, -math.sin(b), math.cos(b), 0]])


def _ry(t):
    return np.array([[math.cos(t), 0, -math.sin(t), 0], [0, 1, 0, 0],
                     [math.sin(t), 0, math.cos(t), 0]])


def dof6_to_matrix(dof):
    """[x, y, z, alpha, beta, theta(, ...)] with angles in degrees (divided
    by 57.3 as the reference does) -> 12-vector, (T) @ Rz @ Rx @ Ry."""
    x, y, z = (float(v) for v in dof[:3])
    alpha, beta, theta = (float(v) / 57.3 for v in dof[3:6])
    ts = np.array([[1, 0, 0, x], [0, 1, 0, y], [0, 0, 1, z]], np.float64)
    m = compose_affine(ts.reshape(12), _rz(alpha).reshape(12))
    m = compose_affine(m, _rx(beta).reshape(12))
    return compose_affine(m, _ry(theta).reshape(12))


def drift_matrix(t, per_tp):
    """View B's drift at timepoint ``t``: ``per_tp`` (6 DOF per timepoint,
    e2e_surrogate.py's [0.12, -0.08, 0.03, 0, 0, 0.04]) times t."""
    return dof6_to_matrix([v * t for v in per_tp])


def h4(m12):
    """3x4 (12-vector) -> 4x4 homogeneous float64."""
    return np.vstack([np.asarray(m12, np.float64).reshape(3, 4), [0, 0, 0, 1]])


def rot_y_matrix(direction, in_zyx):
    """The source coordinates (x, y, z) that a +-90 degree turn about y
    (``rot_y`` in reference.py) reads for an output voxel, as a 4x4."""
    sz, _sy, sx = in_zyx
    if direction == 1:      # out[z', y, x'] = in[x', y, sx-1-z']
        return np.array([[0, 0, -1, sx - 1], [0, 1, 0, 0], [1, 0, 0, 0],
                         [0, 0, 0, 1]], np.float64)
    return np.array([[0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, sz - 1],
                     [0, 0, 0, 1]], np.float64)   # out = in[sz-1-x', y, z']


# --- geometry of a diSPIM deployment

def iso_shape(cfg):
    """(z, y, x) of the isotropic grid for the configuration's raw views
    (the reference's spimFusion sizes, spim_fusion.cpp:336-363)."""
    nz, ny, nx = cfg["raw_zyx"]
    px, py, pz = cfg["pixel_a"]
    return (int(round(nz * pz / px)), int(round(ny * py / px)), nx)


def truth_matrix(cfg, t):
    """The matrix registration should find at timepoint ``t``: reg_b(r) =
    b_iso(M r) = a_iso(r). With the object g on the isotropic grid,
    a_iso(r) = g(r) and b_iso(r) = g(T r), T = R(+1) D m_t R(-1) S: S the
    resample of the turned raw view B onto the grid, R(-1) the fusion's
    turn, m_t the drift, D the raw z spacing, R(+1) the turn that made
    view B; so M = T^-1. The views' sampling in z rounds to whole voxels
    (``zsamp``), which this linear truth leaves out (at most 0.5 voxel)."""
    px, _py, pz = cfg["pixel_a"]
    ratio = pz / px
    grid = iso_shape(cfg)
    nz, ny, nx = cfg["raw_zyx"]
    # the turned raw view B is (nx, ny, nz) in (z, y, x)
    s = np.diag([nz / grid[2], ny / grid[1], nx / grid[0], 1.0])
    r_m1 = rot_y_matrix(-1, (nz, ny, nx))
    m_t = h4(drift_matrix(t, cfg["drift_per_tp"]))
    d = np.diag([1.0, 1.0, ratio, 1.0])
    r_p1 = rot_y_matrix(1, grid)
    tm = r_p1 @ d @ m_t @ r_m1 @ s
    return np.linalg.inv(tm)[:3].reshape(12)


def box_error(m, truth, shape):
    """Max distance (voxels) between where ``m`` and ``truth`` map the
    corners of the central half-box of ``shape`` (z, y, x)
    (chip_smoke.py's ``box_error``)."""
    sz, sy, sx = shape
    pts = np.array([[x, y, z, 1.0] for x in (sx / 4, 3 * sx / 4)
                    for y in (sy / 4, 3 * sy / 4) for z in (sz / 4, 3 * sz / 4)])
    a = np.asarray(m, np.float64).reshape(3, 4)
    b = np.asarray(truth, np.float64).reshape(3, 4)
    return float(np.abs(pts @ a.T - pts @ b.T).max())


# --- volumes on the device

def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _gauss_kernel(shape, sigma, device):
    """Sum-normalised separable Gaussian centred on the origin (circular
    distance), float32."""
    g = 1.0
    for ax, s in enumerate(shape):
        d = torch.arange(s, dtype=torch.float64, device=device)
        d = torch.minimum(d, s - d)
        k = torch.exp(-d * d / (2 * sigma ** 2))
        g = g * k.reshape([-1 if i == ax else 1 for i in range(3)])
    return (g / g.sum()).float()


def blobs(shape, rng, device, density, sigma=BLOB_SIGMA):
    """``density`` beads per 128^3 voxels in the central half of each axis
    (chip_smoke.py's beads: 80), amplitudes 80-200, smoothed
    by a circular Gaussian (torch.fft on ``device``). Positions and
    amplitudes from the numpy generator ``rng``; a position drawn twice
    keeps its first amplitude."""
    n = max(1, int(round(density * np.prod(shape) / 128 ** 3)))
    pos = np.stack([rng.integers(s // 4, 3 * s // 4, size=n) for s in shape])
    amp = rng.uniform(80, 200, size=n).astype(np.float32)
    flat = np.ravel_multi_index(tuple(pos), shape)
    flat, first = np.unique(flat, return_index=True)
    vol = torch.zeros(int(np.prod(shape)), dtype=torch.float32, device=device)
    vol[torch.from_numpy(flat).to(device)] = torch.from_numpy(amp[first]).to(device)
    vol = vol.reshape(shape)
    k = _gauss_kernel(shape, sigma, device)
    return torch.fft.irfftn(torch.fft.rfftn(vol) * torch.fft.rfftn(k), s=shape)


def convolve_psf(vol, psf_np):
    """Circular convolution of ``vol`` with the sum-normalised PSF centred
    on the origin (torch.fft, float32)."""
    p = torch.from_numpy(np.asarray(psf_np, np.float32)).to(vol.device)
    p = p / p.sum()
    pad = torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
    pz, py, px = p.shape
    pad[:pz, :py, :px] = p
    pad = torch.roll(pad, shifts=(-(pz // 2), -(py // 2), -(px // 2)), dims=(0, 1, 2))
    return torch.fft.irfftn(torch.fft.rfftn(vol) * torch.fft.rfftn(pad), s=vol.shape)


def axial_blur(v, sigma):
    """Gaussian blur along z (axis 0), circular, float32."""
    n = v.shape[0]
    k = torch.exp(-(torch.arange(n, dtype=torch.float64, device=v.device) - n // 2) ** 2
                  / (2.0 * sigma * sigma))
    k = torch.roll(k / k.sum(), -(n // 2)).float()
    kf = torch.fft.rfft(k).reshape(-1, 1, 1)
    return torch.fft.irfft(torch.fft.rfft(v, dim=0) * kf, n=n, dim=0)


def camera_minus_baseline(photons, gen):
    """Photon image -> u16 camera counts (Poisson shot noise, Gaussian read
    noise, the sCMOS baseline offset, rounded and clipped to 16 bits) ->
    counts less the baseline, clipped at zero: what the spimFusion and
    batch CLIs hand on after ``-bg1/-bg2`` at the camera's offset. float32."""
    counts = torch.poisson(photons.clamp_min(0), generator=gen)
    counts += torch.randn(counts.shape, generator=gen, device=counts.device) * READ_NOISE
    counts = torch.clamp(torch.round(counts + BASELINE_OFFSET), 0, 65535)
    return torch.clamp_min(counts - BASELINE_OFFSET, 0)


def zsamp(cfg):
    """The z planes of the isotropic object that the raw views sample."""
    px, _py, pz = cfg["pixel_a"]
    ratio = pz / px
    n_iso = iso_shape(cfg)[0]
    idx = np.round(np.arange(0, n_iso - 1e-6, ratio)).astype(np.int64)
    if len(idx) != cfg["raw_zyx"][0]:
        raise ValueError(f"{len(idx)} raw planes from the grid, config says "
                         f"{cfg['raw_zyx'][0]}")
    return idx
