"""How far 3-D registration lands from the truth over several data seeds,
with the ladder in K9 and on the host loop, on one CUDA device.

    python microimagelib_tpu_torch/tools/reg_seeds.py [--seeds 2,3,...]
        [--shape Z,Y,X]

For each seed it makes the reg3D CLI's data of ``chip_smoke.py`` Phase 11
(a bead volume times 2000 plus 100, and its copy moved by the reg128
matrix, both written as 16-bit TIFFs and read back), runs ``reg3d``
(choice 2, method 7, the automatic pyramid, default knobs) once with the
ladders in K9 and once on the host loop (K9's plain version), and prints
one JSON line: each run's distance from the true matrix over the central
half-box (voxels) and its final NCC. The first line is the card's name and
power limit. The pyramid's end point moves with the last bit of the
optimizer's arithmetic, so one seed's distance says little about either
version.
"""

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REG_DOF = [2.0, -1.5, 1.0, 2.0, -1.0, 1.5, 1, 1, 1]   # bench_all.py:122


def box_error(m, truth, shape):
    """Max distance (voxels) between where ``m`` and ``truth`` map the
    corners of the central half-box of ``shape`` (z, y, x)."""
    import numpy as np

    sz, sy, sx = shape
    pts = np.array([[x, y, z, 1.0] for x in (sx / 4, 3 * sx / 4)
                    for y in (sy / 4, 3 * sy / 4) for z in (sz / 4, 3 * sz / 4)])
    a = np.asarray(m, np.float64).reshape(3, 4)
    b = np.asarray(truth, np.float64).reshape(3, 4)
    return float(np.abs(pts @ a.T - pts @ b.T).max())


def run(seeds, shape):
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from microimagelib_tpu_torch.io.tiff import readtifstack, writetifstack
    from microimagelib_tpu_torch.models import registration as R
    from microimagelib_tpu_torch.models import registration_device as RD
    from microimagelib_tpu_torch.models import registration_grad as RG
    from microimagelib_tpu_torch.ops.affine import affine_transform_3d
    from microimagelib_tpu_torch.ops.matrix import dof_to_matrix
    from microimagelib_tpu_torch.tools import turns
    from microimagelib_tpu_torch.tools.reg_times import beads

    print(turns.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    true_m = dof_to_matrix(REG_DOF, 6)
    a = np.vstack([np.asarray(true_m, np.float64).reshape(3, 4), [0, 0, 0, 1]])
    inv = np.linalg.inv(a)[:3].reshape(12)
    on_kernel_route = RD.on_kernel_route
    for seed in seeds:
        vol = beads(shape, seed, dev) * 2000 + 100
        moved = affine_transform_3d(vol, true_m, shape)
        with tempfile.TemporaryDirectory() as tmp:
            writetifstack(os.path.join(tmp, "t.tif"), vol.cpu().numpy(), 16)
            writetifstack(os.path.join(tmp, "s.tif"), moved.cpu().numpy(), 16)
            img1, _ = readtifstack(os.path.join(tmp, "t.tif"))
            img2, _ = readtifstack(os.path.join(tmp, "s.tif"))
        del vol, moved
        out = {"seed": seed, "shape": list(shape)}
        for label, route in (("k9", on_kernel_route), ("host_loop", lambda *a, **k: False)):
            RD.on_kernel_route = RG.on_kernel_route = route
            try:
                _, tmx, rec = R.reg3d(img1, img2, 2, 7, device=dev, want_reg=False)
            finally:
                RD.on_kernel_route = RG.on_kernel_route = on_kernel_route
            out[label] = {"voxels_from_truth": box_error(tmx, inv, shape), "ncc": rec[3]}
        print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="2,3,4,5,6,7,8,9")
    ap.add_argument("--shape", default="200,512,512")
    args = ap.parse_args(argv)
    run([int(s) for s in args.seeds.split(",")],
        tuple(int(n) for n in args.shape.split(",")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
