"""The program's entries that the cells drive, one class each, named by a
mix's ``entry``. Each says how one call is made on a pool item, what the
call completes (its units of work), what the reference compares in its
outputs, and what the control (the reference in bfloat16, put in the
program's place) outputs.

A call returns when its answer is complete: the entries return host
numpy or, for ``reg3d(..., as_device=True)``, the registered volume on
the device after one ``synchronize``.
"""

from __future__ import annotations

import numpy as np
import torch

from milbench import data, reference, spec
from milbench.judge import as_f64, rel_l2
from milbench.reference import BF16, F64


def _dev_tensor(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def _bf16_matrix(m12):
    return np.asarray(reference.matrix(m12, BF16), np.float64)


class _Entry:
    units = {}

    def __init__(self, cfg, traffic, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        # the program's memory tiers: the card picks its mode from the
        # working set (the CLIs' default); the CPU runs the plain versions
        self.mem_mode = -1 if self.cuda else 0
        self.psf = data.psf(traffic["psf"])

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


class FusionDualview(_Entry):
    """``models.fusion.fusion_dualview`` on one timepoint's raw views."""

    units = {"timepoints": 1}

    def call(self, item):
        from microimagelib_tpu_torch.models import fusion

        c = self.cfg
        rec = np.zeros(22, dtype=np.float64)
        decon, tmx, reg_b, a_iso = fusion.fusion_dualview(
            item["a"], item["b"], self.psf, self.psf, tuple(c["pixel_a"]),
            tuple(c["pixel_b"]), c["im_rotation"], c["reg_choice"], c["aff_method"],
            ftol=c["ftol"], it_limit=c["it_limit"], n_iters=c["n_iters"],
            device=self.device, mem_mode=self.mem_mode, records=rec)
        return {"decon": decon, "tmx": np.asarray(tmx, np.float64), "reg_b": reg_b,
                "a_iso": a_iso, "ncc": float(rec[3])}

    def _views(self, item, p):
        return reference.isotropize(_dev_tensor(item["a"], self.device),
                                    _dev_tensor(item["b"], self.device), self.cfg, p)

    def judge(self, out, item):
        a_ref, b_ref = self._views(item, F64)
        grid = tuple(a_ref.shape)
        r = {"a_iso_rel_l2": rel_l2(out["a_iso"], a_ref),
             "tmx_truth_vox": data.box_error(out["tmx"], item["truth"], grid),
             "ncc_gap": abs(out["ncc"] - reference.ncc(a_ref, b_ref, out["tmx"]))}
        reg_ref = reference.affine(b_ref, out["tmx"], grid)
        del b_ref
        r["reg_b_rel_l2"] = rel_l2(out["reg_b"], reg_ref)
        ref = reference.rl_dual(a_ref, reg_ref, self.psf, self.psf, self.cfg["n_iters"])
        r["decon_rel_l2"] = rel_l2(out["decon"], ref)
        return r

    def control(self, item):
        a_c, b_c = self._views(item, BF16)
        tmx = _bf16_matrix(item["truth"])
        reg_c = reference.affine(b_c, tmx, tuple(a_c.shape), BF16)
        return {"a_iso": a_c, "tmx": tmx, "ncc": reference.ncc(a_c, b_c, tmx, BF16),
                "reg_b": reg_c,
                "decon": reference.rl_dual(a_c, reg_c, self.psf, self.psf,
                                           self.cfg["n_iters"], BF16)}


class DeconSingleview(_Entry):
    """``models.deconvolution.decon_singleview`` on one stack."""

    def __init__(self, cfg, traffic, device):
        super().__init__(cfg, traffic, device)
        self.units = {"voxel_iters": int(np.prod(cfg["shape_zyx"])) * cfg["n_iters"]}

    def call(self, item):
        from microimagelib_tpu_torch.models import deconvolution

        return {"decon": deconvolution.decon_singleview(
            item["img"], self.psf, n_iters=self.cfg["n_iters"], device=self.device,
            mem_mode=self.mem_mode)}

    def judge(self, out, item):
        img = as_f64(_dev_tensor(item["img"], self.device), self.device)
        ref = reference.rl_single(img, self.psf, self.cfg["n_iters"])
        return {"decon_rel_l2": rel_l2(out["decon"], ref)}

    def control(self, item):
        img = _dev_tensor(item["img"], self.device)
        return {"decon": reference.rl_single(img, self.psf, self.cfg["n_iters"], BF16)}


class Reg3d(_Entry):
    """``models.registration.reg3d(..., as_device=True)`` on one
    isotropised pair; the pair is done when its matrix is on the host and
    the registered volume complete."""

    units = {"pairs": 1}

    def call(self, item):
        from microimagelib_tpu_torch.models import registration

        c = self.cfg
        rec = np.zeros(11, dtype=np.float64)
        reg_b, tmx, rec = registration.reg3d(
            item["a_iso"], item["b_iso"], c["reg_choice"], c["aff_method"], False, None,
            c["ftol"], c["it_limit"], device=self.device, mem_mode=self.mem_mode,
            records=rec, as_device=True)
        self.sync()
        return {"tmx": np.asarray(tmx, np.float64), "ncc": float(rec[3]), "reg_b": reg_b}

    def judge(self, out, item):
        a, b = (as_f64(item[k], self.device) for k in ("a_iso", "b_iso"))
        grid = tuple(a.shape)
        return {"tmx_truth_vox": data.box_error(out["tmx"], item["truth"], grid),
                "ncc_gap": abs(out["ncc"] - reference.ncc(a, b, out["tmx"])),
                "reg_b_rel_l2": rel_l2(out["reg_b"], reference.affine(b, out["tmx"], grid))}

    def control(self, item):
        a, b = item["a_iso"], item["b_iso"]
        tmx = _bf16_matrix(item["truth"])
        return {"tmx": tmx, "ncc": reference.ncc(a, b, tmx, BF16),
                "reg_b": reference.affine(b, tmx, tuple(a.shape), BF16)}


ENTRIES = {"fusion_dualview": FusionDualview, "decon_singleview": DeconSingleview,
           "reg3d": Reg3d}


def resolve(name):
    """The entry class of a mix's ``entry``: one of :data:`ENTRIES`, or the
    class ``Entry`` of ``mil_bench/entries/<name>.py`` (a new entry is a
    new file)."""
    if name in ENTRIES:
        return ENTRIES[name]
    return spec.load_module(spec.BENCH_DIR / "entries" / f"{name}.py").Entry


def make(cfg, traffic, device):
    return resolve(traffic["entry"])(cfg, traffic, device)
