"""The one generator of the benchmark's traffic: a mix's data file names
what its pool holds (``inputs``), how many items (``pool``), where they
live (``resident``: ``host`` numpy or ``device`` tensors) and the PSF;
the configuration gives the sizes. The same configuration, mix and seed
give the same pool.

``inputs``:

* ``dispim_views``: timepoints of a diSPIM pair as the spimFusion CLI
  hands them on after ``-bg1/-bg2``: raw views A and B of one bead object
  (axial blur, z sampling, sCMOS noise), view B turned +90 degrees about y
  and drifting by ``drift_per_tp`` x t from timepoint to timepoint;
* ``dispim_iso_pairs``: the same timepoints isotropised by the reference's
  resample and turn (float64, rounded to float32), as ``fusion_dualview``
  hands them to the registration;
* ``stacks``: single-view stacks, a bead object each, blurred by the mix's
  PSF, with the same camera noise;
* any other name: ``make_pool`` of ``mil_bench/inputs/<name>.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from milbench import data, reference, spec


def _dispim_photons(cfg, rng, device):
    """(a_f, b_f): the raw views in photons before the camera, and the
    object's isotropic grid."""
    if cfg["im_rotation"] != -1 or list(cfg["pixel_a"]) != list(cfg["pixel_b"]):
        raise ValueError("the diSPIM generator makes view B turned by +90 degrees "
                         "(im_rotation -1) with view A's pixel sizes")
    grid = data.iso_shape(cfg)
    if grid[0] != grid[2]:
        raise ValueError(f"isotropic grid {grid}: the turned view B lands on view A's "
                         "grid only where z and x agree")
    g = data.blobs(grid, rng, device, density=cfg["beads_per_128_cube"])
    px, _py, pz = cfg["pixel_a"]
    sigma = (pz / px) / 2.0
    zs = torch.from_numpy(data.zsamp(cfg)).to(device)
    a_f = data.axial_blur(g, sigma).index_select(0, zs).contiguous()
    b_f = data.axial_blur(reference.rot_y(g, 1), sigma).index_select(0, zs).contiguous()
    del g
    scale = data.PEAK_COUNTS / max(float(a_f.max()), 1e-6)
    return a_f * scale, b_f * scale


def _dispim_timepoints(cfg, traffic, seed, device):
    rng = np.random.default_rng([int(seed), 1])
    gen = data.generator(seed, device)
    a_f, b_f = _dispim_photons(cfg, rng, device)
    for t in range(traffic["pool"]):
        gain = 1.0 + 0.01 * t
        a = data.camera_minus_baseline(a_f * gain, gen)
        b_t = b_f if t == 0 else reference.affine(
            b_f, data.drift_matrix(t, cfg["drift_per_tp"]), tuple(b_f.shape),
            reference.F32)
        b = data.camera_minus_baseline(b_t * gain, gen)
        yield t, a, b


def make_pool(cfg, traffic, seed, device):
    """The mix's items, a list of dicts."""
    kind = traffic["inputs"]
    host = traffic["resident"] == "host"
    items = []
    if kind == "dispim_views":
        for t, a, b in _dispim_timepoints(cfg, traffic, seed, device):
            if host:
                a, b = a.cpu().numpy(), b.cpu().numpy()
            items.append({"t": t, "a": a, "b": b, "truth": data.truth_matrix(cfg, t)})
    elif kind == "dispim_iso_pairs":
        for t, a, b in _dispim_timepoints(cfg, traffic, seed, device):
            a_iso, b_iso = (v.float().contiguous()
                            for v in reference.isotropize(a, b, cfg, reference.F64))
            items.append({"t": t, "a_iso": a_iso, "b_iso": b_iso,
                          "truth": data.truth_matrix(cfg, t)})
    elif kind == "stacks":
        rng = np.random.default_rng([int(seed), 2])
        gen = data.generator(seed, device)
        psf = data.psf(traffic["psf"])
        shape = tuple(cfg["shape_zyx"])
        for i in range(traffic["pool"]):
            photons = data.convolve_psf(
                data.blobs(shape, rng, device, density=cfg["beads_per_128_cube"]), psf)
            photons *= data.PEAK_COUNTS / max(float(photons.max()), 1e-6)
            img = data.camera_minus_baseline(photons, gen)
            items.append({"i": i, "img": img.cpu().numpy() if host else img})
    else:
        # a new kind of input is a new file with the same function
        path = spec.BENCH_DIR / "inputs" / f"{kind}.py"
        return spec.load_module(path).make_pool(cfg, traffic, seed, device)
    return items
