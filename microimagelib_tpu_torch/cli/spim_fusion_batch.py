"""spimFusionBatch — time-lapse batch fusion CLI using the 34/36
positional-argument protocol of the ImageJ diSPIMFusion plugin
(reference:src/spim_fusion_batch.cpp:59-115). Runs on ``cuda:<argument
34>``; ``MIL_PLATFORM=cpu`` runs it on the CPU. Argument 2 set to "1"
makes argument 3 the main folder of a multicolor layout
(<color>/SPIMA|SPIMB); ``MIL_BATCH_BG1``/``MIL_BATCH_BG2`` subtract a
camera background from view A / B. ``MIL_MESH="n_dp,n_sp"`` deconvolves
over a device mesh of the visible CUDA devices (round-robin when the mesh
has more places than devices; a CPU mesh under ``MIL_PLATFORM=cpu``);
``MIL_MULTIHOST=1`` with JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID splits the timepoints over processes.

    python -m microimagelib_tpu_torch.cli.spim_fusion_batch out SPIMA SPIMB SPIMA_ SPIMB_ 0 4 1 0 ...
"""

from __future__ import annotations

import os
import sys

HELP = """
spimFusionBatch: Dual-view fusion (registration and joint deconvolution) for diSPIM images in batch mode

Usage:\tspimFusionBatch [OPTIONS: 34 or 36 mandatory arguments]
\tOnly 16-bit or 32-bit standard TIFF images are currently supported.

= = = [Mandatory arguments exactly ordered as following] = = =
\t 1: <path>\t\tOutput directory
\t 2: <path>\t\tInput image 1 (SPIM A) directory
\t 3: <path>\t\tInput image 2 (SPIM B) directory
\t 4: <string>\t\tInput image 1 base name
\t 5: <string>\t\tInput image 2 base name
\t 6: <int>\t\tInput image index - start
\t 7: <int>\t\tInput image index - end
\t 8: <int>\t\tInput image index - interval
\t 9: <int>\t\tInput image index - test (used when argument 16 is set as 1)
\t10-12: <float>\t\tPixel Size X/Y/Z 1 (um)
\t13-15: <float>\t\tPixel Size X/Y/Z 2 (um)
\t16: <int>\t\tRegistration mode (0 none+input matrix; 1 one-for-all via test; 2 dependent; 3 independent)
\t17: <int>\t\tImage 2 rotation (0, 1: 90 deg by Y, -1: -90 deg by Y)
\t18: <int>\t\tInitial matrix (0 identity; 1 file; 2 3D phase; 3 2D MIP)
\t19: <filename>\t\tInput matrix file (any string if 18 != 1)
\t20: <float>\t\tRegistration tolerance (typically 0.001~0.00001)
\t21: <int>\t\tMax registration iterations (typically 2000~5000)
\t22: <int>\t\tSave registered image 1 (0/1)
\t23: <int>\t\tSave registered image 2 (0/1)
\t24: <filename>\t\tPSF1 (forward projector 1) filename
\t25: <filename>\t\tPSF2 (forward projector 2) filename
\t26: <int>\t\tDeconvolution iterations (typically 10~20)
\t27-29: <int>\t\tSave decon max projections X/Y/Z (0/1)
\t30: <int>\t\tSave 3D max projection X-axis (0/1)
\t31: <int>\t\tSave 3D max projection Y-axis (0/1)
\t32: <int>\t\tBit of output images (16 or 32)
\t33: <int>\t\tQuery device information before processing (0/1)
\t34: <int>\t\tDevice number (1st device indexed as 0)
\t35: <filename>\t(optional) Backward projector 1 (default: flip of PSF1)
\t36: <filename>\t(optional) Backward projector 2 (default: flip of PSF2)

Arguments are set same with the ImageJ diSPIMFusion plugin.
"""


def config_from_args(a):
    """The BatchConfig of the 34/36 positional arguments (and
    MIL_BATCH_BG1/BG2, which keep the protocol at 34/36 arguments)."""
    from microimagelib_tpu_torch.models.batch import BatchConfig

    return BatchConfig(
        out_dir=a[0], in_dir1=a[1], in_dir2=a[2], name1=a[3], name2=a[4],
        img_start=int(a[5]), img_end=int(a[6]), img_interval=int(a[7]), img_test=int(a[8]),
        pixel1=(float(a[9]), float(a[10]), float(a[11])),
        pixel2=(float(a[12]), float(a[13]), float(a[14])),
        reg_mode=int(a[15]), im_rotation=int(a[16]),
        flag_initial_tmx=int(a[17]), tmx_file=a[18],
        ftol=float(a[19]), it_limit=int(a[20]),
        save_reg_a=bool(int(a[21])), save_reg_b=bool(int(a[22])),
        psf1_file=a[23], psf2_file=a[24], it_num_decon=int(a[25]),
        save_mp_x=bool(int(a[26])), save_mp_y=bool(int(a[27])), save_mp_z=bool(int(a[28])),
        save_3d_x=bool(int(a[29])), save_3d_y=bool(int(a[30])),
        bit_per_sample=int(a[31]), query_device=bool(int(a[32])), device_num=int(a[33]),
        psf1_bp_file=a[34] if len(a) == 36 else "",
        psf2_bp_file=a[35] if len(a) == 36 else "",
        bg1=float(os.environ.get("MIL_BATCH_BG1", "0")),
        bg2=float(os.environ.get("MIL_BATCH_BG2", "0")),
    )


def main(argv=None, *, timings=None):
    """Run the CLI on ``argv``; ``timings`` goes to ``spim_fusion_batch``
    (per-timepoint stage seconds, single-color runs)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(HELP.split("= = = [Mandatory")[0])
        print("Use command for more details:\n\tspimFusionBatch -help or spimFusionBatch -h")
        return 0
    if "-h" in argv or "-help" in argv:
        print(HELP)
        return 0
    if len(argv) not in (34, 36):
        print(f"*** Expected 34 or 36 arguments, got {len(argv)}")
        return 1
    from microimagelib_tpu_torch.models.batch import (
        spim_fusion_batch,
        spim_fusion_batch_multicolor,
    )
    from microimagelib_tpu_torch.parallel.mesh import make_mesh
    from microimagelib_tpu_torch.utils.device import query_device

    cfg = config_from_args(argv)
    device = "cpu" if os.environ.get("MIL_PLATFORM") == "cpu" else None
    if cfg.query_device and device is None:
        query_device(verbose=True)
    # MIL_MESH="n_dp,n_sp" runs the deconvolution stage over a device mesh
    # (an extension of the JAX package; the reference is single-GPU)
    mesh = None
    mesh_env = os.environ.get("MIL_MESH")
    if mesh_env:
        n_dp, n_sp = (int(v) for v in mesh_env.split(","))
        mesh = make_mesh(n_sp=n_sp, n_dp=n_dp,
                         devices=None if device is None else [device] * (n_dp * n_sp))
    if argv[1].strip() == "1":
        # multicolor protocol: argument 3 is the main folder holding
        # <color>/SPIMA|SPIMB (reference:src/spim_fusion_batch.cpp:215-241,
        # Windows-only there)
        results = spim_fusion_batch_multicolor(argv[2], argv[0], cfg, device=device)
        total = sum(len(v) for v in results.values())
        print(f"Processed {total} timepoint(s) across {len(results)} color(s)")
    else:
        processed = spim_fusion_batch(cfg, mesh, device=device, timings=timings)
        print(f"Processed {len(processed)} timepoint(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
