"""End-to-end surrogate of the diSPIMFusion dataset run, on the port.

The reference's end-to-end run drives spimFusionBatch over the published
diSPIMFusion sample data (reference:sh_spimFusionBatch.sh:1-21) with
measured PSF files. This tool builds the closest physics surrogate from a
seed, with no download, and drives the port's spimFusionBatch on the
positional protocol a user gives its CLI:

  * u16 camera stacks: Poisson shot noise + Gaussian read noise (2 e-)
    + a constant sCMOS baseline offset (100 counts), quantized to uint16
  * a curved, tilted, asymmetric detection PSF with a background floor —
    the measured-PSF class
  * anisotropic dual views (0.1625/0.1625/1.0 um pixels, imgRotation=-1)
    with a per-timepoint drift of view B, so regMode 2's dependent
    registration tracks it
  * the positional ImageJ protocol, regMode 2, 10 iterations, bg 100,
    16-bit MP_ZProj and MP_3D_Yaxis outputs

It asserts the output tree and ProcessingLog contents (every final NCC
above 0.5) and prints one JSON line per metric: the mean and least final
NCC, the wall time and timepoints per minute.

    python -m microimagelib_tpu_torch.tools.e2e_surrogate [n_timepoints] [--cpu] [--xy N]

``--xy`` sets the lateral extent (default 96); raw view A is then
(ceil(xy * 0.1625), xy, xy) and the isotropic grid (xy, xy, xy).
:func:`run` is the in-process entry (``chip_smoke.py`` Phase 17 counts
the kernels' launches around it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from microimagelib_tpu_torch.cli import spim_fusion_batch as batch_cli
from microimagelib_tpu_torch.io.tiff import gettifinfo, writetifstack
from microimagelib_tpu_torch.models.batch import spim_fusion_batch
from microimagelib_tpu_torch.ops.affine import affine_transform_3d
from microimagelib_tpu_torch.ops.basics import rot_by_y_axis
from microimagelib_tpu_torch.ops.matrix import dof_to_matrix
from microimagelib_tpu_torch.utils.device import resolve_device

BASELINE_OFFSET = 100.0  # sCMOS fixed offset, counts
READ_NOISE = 2.0         # e- rms
PEAK_COUNTS = 2500.0     # brightest-structure photon count (peak SNR ~50)
N_ITERS = 10


def curved_tilted_psf(p=(19, 11, 27), sl=3.6, ss=1.1, st=1.3,
                      curve=0.045, floor=2e-4):
    """Measured-class detection PSF surrogate: the lateral centroid drifts
    linearly (tilt) and quadratically (focal curvature) with z, the widths
    are anisotropic, and a constant pedestal rides on top."""
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


def _blobs(shape, n=40, seed=0, sigma=2.5):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, dtype=np.float32)
    for _ in range(n):
        z, y, x = (rng.integers(s // 4, 3 * s // 4) for s in shape)
        vol[z, y, x] = rng.uniform(80, 200)
    zz, yy, xx = np.meshgrid(*[np.arange(s) - s // 2 for s in shape],
                             indexing="ij")
    g = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / (2 * sigma ** 2))
    g = np.roll(g / g.sum(), [-s // 2 for s in shape], axis=(0, 1, 2))
    return np.fft.irfftn(np.fft.rfftn(vol) * np.fft.rfftn(g), s=shape,
                         axes=(0, 1, 2)).astype(np.float32)


def _axial_blur(v, sigma, axis=0):
    n = v.shape[axis]
    k = np.exp(-(np.arange(n) - n // 2) ** 2 / (2.0 * sigma * sigma))
    k /= k.sum()
    kf = np.fft.rfft(np.roll(k, -(n // 2)))
    shape = [1, 1, 1]
    shape[axis] = -1
    return np.fft.irfft(np.fft.rfft(v, axis=axis) * kf.reshape(shape),
                        n=n, axis=axis).astype(np.float32)


def camera(v, rng):
    """Photon image -> u16 camera frame: Poisson shot noise + Gaussian read
    noise + baseline offset, clipped and quantized."""
    photons = np.clip(v, 0, None)
    counts = rng.poisson(photons).astype(np.float32)
    counts += rng.normal(0.0, READ_NOISE, counts.shape).astype(np.float32)
    counts += BASELINE_OFFSET
    return np.clip(np.round(counts), 0, 65535).astype(np.uint16)


def build_inputs(root, n_t, xy=96, seed=11, device=None):
    """Write the u16 views SPIMA/SPIMA_<t>.tif and SPIMB/SPIMB_<t>.tif and
    psf.tif under ``root``; view B's turn and per-timepoint drift run on
    ``device`` (default cuda:0). Returns the two view directories."""
    dev = resolve_device(None, device)
    rng = np.random.default_rng(seed)
    in1 = os.path.join(root, "SPIMA")
    in2 = os.path.join(root, "SPIMB")
    os.makedirs(in1)
    os.makedirs(in2)
    ratio = 1.0 / 0.1625
    g = _blobs((xy, xy, xy), n=60, seed=seed)
    zsamp = np.round(np.arange(0, xy - 1e-6, ratio)).astype(int)
    a_f = np.ascontiguousarray(_axial_blur(g, ratio / 2.0)[zsamp])
    b_full = rot_by_y_axis(torch.from_numpy(g).to(dev), 1).cpu().numpy()
    b_f = np.ascontiguousarray(_axial_blur(b_full, ratio / 2.0)[zsamp])
    # one shared photon normalization (keeps A/B relative intensity)
    scale = PEAK_COUNTS / max(a_f.max(), 1e-6)
    a_f = a_f * scale
    b_f = b_f * scale
    b_dev = torch.from_numpy(b_f).to(dev)
    for t in range(n_t):
        writetifstack(os.path.join(in1, f"SPIMA_{t}.tif"),
                      camera(a_f * (1 + 0.01 * t), rng), 16)
        if t > 0:
            m = dof_to_matrix([0.12 * t, -0.08 * t, 0.03 * t,
                               0.0, 0.0, 0.04 * t, 1.0, 1.0, 1.0], 6)
            b_t = affine_transform_3d(b_dev, m, b_f.shape).cpu().numpy()
        else:
            b_t = b_f
        writetifstack(os.path.join(in2, f"SPIMB_{t}.tif"),
                      camera(b_t * (1 + 0.01 * t), rng), 16)
    writetifstack(os.path.join(root, "psf.tif"), curved_tilted_psf(), 32)
    return in1, in2


def batch_argv(root, in1, in2, out, n_t):
    """The positional ImageJ protocol (reference:src/spim_fusion_batch.cpp:
    67-113): outDir in1 in2 name1 name2 start end interval test px1 py1 pz1
    px2 py2 pz2 regMode rotation flagTmx tmxFile ftol itLimit saveRegA
    saveRegB psf1 psf2 itDecon saveMPx saveMPy saveMPz save3DX save3DY bit
    query dev."""
    psf = os.path.join(root, "psf.tif")
    return [out, in1, in2, "SPIMA_", "SPIMB_", "0", str(n_t - 1), "1", "0",
            "0.1625", "0.1625", "1.0", "0.1625", "0.1625", "1.0",
            "2", "-1", "0", "none", "0.0001", "3000", "0", "0", psf, psf,
            str(N_ITERS), "0", "0", "1", "0", "1", "16", "0", "0"]


def run(n_t=5, xy=96, device=None, timings=None):
    """Build the surrogate, run the batch in this process on the CLI's own
    parse of the positional protocol and check its outputs. ``device``
    goes to ``spim_fusion_batch`` (default cuda:0, ``"cpu"`` for the CPU);
    ``timings`` too. Returns {'nccs', 'wall_s', 'tp_per_min', 'build_s'}."""
    root = tempfile.mkdtemp(prefix="mil_e2e_")
    try:
        t0 = time.perf_counter()
        in1, in2 = build_inputs(root, n_t, xy=xy, device=device)
        build_s = time.perf_counter() - t0
        out = os.path.join(root, "out")
        # subtract the known camera baseline, as MIL_BATCH_BG1/BG2 would: a
        # constant offset wrecks the NCC objective over the zero-filled
        # resample boundary
        cfg = dataclasses.replace(
            batch_cli.config_from_args(batch_argv(root, in1, in2, out, n_t)),
            bg1=BASELINE_OFFSET, bg2=BASELINE_OFFSET)
        t0 = time.perf_counter()
        processed = spim_fusion_batch(cfg, device=device, timings=timings)
        wall = time.perf_counter() - t0
        if processed != list(range(n_t)):
            raise SystemExit(f"batch processed {processed}, not {n_t} timepoints")
        with open(os.path.join(out, "ProcessingLog.txt")) as f:
            log = f.read()
        assert "dependently" in log, "regMode-2 header missing"
        for t in range(n_t):
            p = os.path.join(out, "Decon", f"Decon_{t}.tif")
            assert os.path.exists(p), p
            _, bits = gettifinfo(p)
            assert bits == 16, f"expected u16 decon output, got {bits}"
            for rel in (("TMX", f"Matrix_{t}.tmx"),
                        ("Decon", "MP_ZProj", f"MP_XY_{t}.tif"),
                        ("Decon", "MP_3D_Yaxis", f"MP_3D_Yaxis_{t}.tif")):
                assert os.path.exists(os.path.join(out, *rel)), rel
        nccs = [float(v) for v in
                re.findall(r"final cost function value: ([0-9.eE+-]+)", log)]
        assert len(nccs) == n_t, nccs
        # the noisy u16 views still register well: the cascade never fell
        # back to the identity
        assert min(nccs) > 0.5, f"registration degraded: {nccs}"
        return {"nccs": nccs, "wall_s": wall, "tp_per_min": 60.0 * n_t / wall,
                "build_s": build_s}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    xy = 96
    if "--cpu" in args:
        device = "cpu"
        args.remove("--cpu")
    if "--xy" in args:
        i = args.index("--xy")
        xy = int(args[i + 1])
        del args[i:i + 2]
    n_t = int(args[0]) if args else 5
    res = run(n_t, xy, device)
    nccs = res["nccs"]
    for metric, value, unit in (
            ("e2e_surrogate_mean_final_ncc", sum(nccs) / len(nccs), "ncc"),
            ("e2e_surrogate_min_final_ncc", min(nccs), "ncc"),
            ("e2e_surrogate_wall_s", res["wall_s"], "s"),
            ("e2e_surrogate_tp_per_min", res["tp_per_min"], "tp/min")):
        print(json.dumps({"metric": metric, "value": value, "unit": unit}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
