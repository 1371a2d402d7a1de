"""spimFusion — single-timepoint diSPIM dual-view fusion CLI,
flag-compatible with the reference app (reference:src/spim_fusion.cpp:
84-688). ``-dev n`` selects ``cuda:n``; ``-gm 0`` runs on the CPU; ``-gm 2``
(host-staged streaming) is not ported and raises NotImplementedError.
``MIL_CONV_SEP_FUSED=1`` runs the decon's iterations on K2 and
``MIL_REG_BATCH_LS=1`` the registration finisher's line searches on K6.

    python -m microimagelib_tpu_torch.cli.spim_fusion -i1 a.tif -i2 b.tif -fp1 pa.tif -fp2 pb.tif -o fused.tif -otmx b.tmx
"""

from __future__ import annotations

import sys
import time

import numpy as np

from microimagelib_tpu_torch.cli._common import FlagParser, read_stack_checked, tifinfo_checked

HELP = """
spimFusion: dual-view fusion (registration + joint deconvolution) for diSPIM images

Usage:\tspimFusion -i1 <image1> -i2 <image2> -fp1 <psf1> -fp2 <psf2> -o <output> [OPTIONS]

= = [OPTIONS] = = = = = = = = = = = = = = = = = = = = = = = = = = = = = = =
\t-i1/-i2 <filename>\tInput view A / view B image (mandatory)
\t-fp1/-fp2 <filename>\tForward projector (PSF) A / B (mandatory)
\t-o <filename>\t\tOutput (fused, deconvolved) image filename (mandatory)
\t-pxx1 -pxy1 -pxz1 <float>\tPixel size of image 1 [0.1625 0.1625 1.0]
\t-pxx2 -pxy2 -pxz2 <float>\tPixel size of image 2 [0.1625 0.1625 1.0]
\t-bg1/-bg2 <float>\tBackground subtraction values [none]
\t-imgrot <int>\t\tImage 2 rotation: 0 none; 1: 90 deg by Y; -1: -90 deg by Y [-1]
\t-oreg1/-oreg2 <filename>\tSave registered view A / B [no]
\t-itmx <filename>\tInput transformation matrix [identity]
\t-otmx <filename>\tOutput transformation matrix [no output]
\t-regc <int>\t\tRegistration choice as reg3D [2]
\t-affm <int>\t\tAffine method as reg3D [7]
\t-ftol <float>\t\tRegistration tolerance [0.0001]
\t-itreg <int>\t\tMaximum registration iteration number [3000]
\t-bp1/-bp2 <filename>\tBackward projectors [flips of forward projectors]
\t-it <int>\t\tDeconvolution iteration number [10]
\t-cON or -cOFF\t\tConstant initialization of deconvolution [OFF]
\t-gm <int>\t\tMemory mode: -1 auto, 0 CPU, 1 HBM-resident, 2 host-staged streaming [-1]
\t-dev <int>\t\tDevice number [0]
\t-bit <int>\t\tOutput image bit: 16 or 32 [same as input]
\t-verbON or -verbOFF\tVerbose [ON]
"""

VALUE_FLAGS = {"-i1", "-i2", "-fp1", "-fp2", "-o", "-pxx1", "-pxy1", "-pxz1",
               "-pxx2", "-pxy2", "-pxz2", "-bg1", "-bg2", "-imgrot", "-oreg1",
               "-oreg2", "-itmx", "-otmx", "-regc", "-affm", "-ftol", "-itreg",
               "-bp1", "-bp2", "-it", "-gm", "-dev", "-bit", "-log"}
BARE_FLAGS = {"-cON", "-cOFF", "-verbON", "-verbOFF", "-h", "-help"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(HELP.split("= = [OPTIONS]")[0])
        print("Use command for more details:\n\tspimFusion -help or spimFusion -h")
        return 0
    if "-h" in argv or "-help" in argv:
        print(HELP)
        return 0
    fp = FlagParser(argv).parse(VALUE_FLAGS, BARE_FLAGS)
    for flag in ("-i1", "-i2", "-fp1", "-fp2", "-o"):
        if not fp.has(flag):
            print(f"*** {flag} is mandatory")
            return 1
    pixel_a = (fp.get("-pxx1", 0.1625, float), fp.get("-pxy1", 0.1625, float), fp.get("-pxz1", 1.0, float))
    pixel_b = (fp.get("-pxx2", 0.1625, float), fp.get("-pxy2", 0.1625, float), fp.get("-pxz2", 1.0, float))
    im_rotation = fp.get("-imgrot", -1, int)
    reg_choice = fp.get("-regc", 2, int)
    aff_method = fp.get("-affm", 7, int)
    ftol = fp.get("-ftol", 1e-4, float)
    it_reg = fp.get("-itreg", 3000, int)
    n_iters = fp.get("-it", 10, int)
    const_initial = fp.has("-cON")
    device_num = fp.get("-dev", 0, int)
    verbose = not fp.has("-verbOFF")
    bg1 = fp.get("-bg1", None, float)
    bg2 = fp.get("-bg2", None, float)
    start = time.time()

    from microimagelib_tpu_torch.io.tiff import writetifstack
    from microimagelib_tpu_torch.io.tmx import read_tmx, write_tmx
    from microimagelib_tpu_torch.models.fusion import fusion_dualview, fusion_sizes
    from microimagelib_tpu_torch.utils.device import get_device

    _, bits_in = tifinfo_checked(fp.get("-i1"))
    bit_out = fp.get("-bit", int(bits_in), int)
    img1, _ = read_stack_checked(fp.get("-i1"), "image 1")
    img2, _ = read_stack_checked(fp.get("-i2"), "image 2")
    if bg1 is not None:
        img1 = np.maximum(img1 - bg1, 0)
    if bg2 is not None:
        img2 = np.maximum(img2 - bg2, 0)
    psf1, psf_size1 = read_stack_checked(fp.get("-fp1"), "PSF 1")
    psf2, psf_size2 = read_stack_checked(fp.get("-fp2"), "PSF 2")
    if psf_size1 != psf_size2:
        print("*** The two forward projectors don't have the same image size, processing stopped !!!")
        return 1
    psf1_bp = psf2_bp = None
    if fp.has("-bp1") and fp.has("-bp2"):
        psf1_bp, _ = read_stack_checked(fp.get("-bp1"), "backward projector 1")
        psf2_bp, _ = read_stack_checked(fp.get("-bp2"), "backward projector 2")
    tmx = None
    flag_tmx = False
    if fp.has("-itmx"):
        tmx = read_tmx(fp.get("-itmx"))
        flag_tmx = True
    io_s = time.time() - start

    def save_reg(a_iso, reg_b):
        nonlocal io_s
        t = time.time()
        if fp.has("-oreg1"):
            writetifstack(fp.get("-oreg1"), a_iso, int(bits_in))
        if fp.has("-oreg2"):
            writetifstack(fp.get("-oreg2"), reg_b, int(bits_in))
        io_s += time.time() - t

    # settings dump (reference:src/spim_fusion.cpp:368-430)
    size1_xyz = (img1.shape[2], img1.shape[1], img1.shape[0])
    size2_xyz = (img2.shape[2], img2.shape[1], img2.shape[0])
    out_xyz, _, _ = fusion_sizes(size1_xyz, size2_xyz, pixel_a, pixel_b, im_rotation)
    print("=====================================================")
    print("=== diSPIM fusion settings ...")
    print("... Image information: ")
    print(f"\tInput image 1 path: {fp.get('-i1')}")
    print(f"\tInput image 2 path: {fp.get('-i2')}")
    print(f"\tOutput image path: {fp.get('-o')}")
    print(f"\tInput image 1 size {size1_xyz[0]} x {size1_xyz[1]} x {size1_xyz[2]}")
    print(f"\t\t pixel size {pixel_a[0]:.4f} um x {pixel_a[1]:.4f} um x {pixel_a[2]:.4f} um")
    print(f"\tInput image 2 size {size2_xyz[0]} x {size2_xyz[1]} x {size2_xyz[2]}")
    print(f"\t\t pixel size {pixel_b[0]:.4f} um x {pixel_b[1]:.4f} um x {pixel_b[2]:.4f} um")
    print(f"\tPSF image size {psf1.shape[2]} x {psf1.shape[1]} x {psf1.shape[0]}")
    print(f"\tOutput image size {out_xyz[0]} x {out_xyz[1]} x {out_xyz[2]}")
    print(f"\t\t pixel size {pixel_a[0]:.4f} um x {pixel_a[0]:.4f} um x {pixel_a[0]:.4f} um")
    print("... Parameters:")
    rot_text = {0: "no rotation", 1: "90 degree by Y axis", -1: "-90 degree by Y axis"}
    print(f"\tImage 2 rotation: {rot_text.get(im_rotation, im_rotation)}")
    print(f"\tRegistration choice: {reg_choice}; affine method: {aff_method}")
    print(f"\tInitial transformation matrix: {fp.get('-itmx') if flag_tmx else 'Default'}")
    print(f"\tRegistration tolerance: {ftol:f}; max sub-iterations: {it_reg}")
    print(f"\tUse unmatched backward projectors: {'yes' if psf1_bp is not None else 'no'}")
    print(f"\tIteration number for joint deconvolution: {n_iters}")
    print(f"\tConstant initialization: {'on' if const_initial else 'off'}")
    print(f"\tMemory mode: {fp.get('-gm', -1, int)} (-1 auto, 0 CPU, 1 HBM-resident, 2 host-staged)")
    print(f"\tDevice number: {device_num}")
    print(f"\tOutput image bit: {bit_out} bit")
    print("=====================================================\n")

    records = np.zeros(22)
    decon, out_tmx, _, _ = fusion_dualview(
        img1, img2, psf1, psf2, pixel_a, pixel_b, im_rotation,
        reg_choice, aff_method, flag_tmx, tmx, ftol, it_reg, n_iters,
        const_initial, psf1_bp, psf2_bp, device=get_device(device_num),
        mem_mode=fp.get("-gm", -1, int),
        verbose=verbose, records=records, save_reg_callback=save_reg)
    t = time.time()
    writetifstack(fp.get("-o"), decon, bit_out)
    if fp.has("-otmx"):
        write_tmx(fp.get("-otmx"), out_tmx)
    io_s += time.time() - t
    print(f"=== Time cost for image reading/writing: {io_s:2.3f} s")
    print(f"\n=== Processing completed, time cost for  whole processing: {time.time() - start:2.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
