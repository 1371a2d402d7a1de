"""deconDualView — joint dual-view RL deconvolution CLI, flag-compatible
with the reference app (reference:src/decon_dv.cpp:45-288), including the
input-size equality validation (reference:src/decon_dv.cpp:167-188).
``-dev n`` selects ``cuda:n``; ``-gm 0`` runs on the CPU; ``-gm 2`` (or
``-gm -1`` beyond the device memory budget) streams the RL through host
memory.

    python -m microimagelib_tpu_torch.cli.decon_dv -i1 a.tif -i2 b.tif -fp1 pa.tif -fp2 pb.tif -o out.tif -it 10
"""

from __future__ import annotations

import sys
import time

import numpy as np

from microimagelib_tpu_torch.cli._common import FlagParser, read_stack_checked, tifinfo_checked

HELP = """
deconDualView: joint Richardson-Lucy deconvolution for two views

Usage:\tdeconDualView -i1 <image1> -i2 <image2> -fp1 <psf1> -fp2 <psf2> -o <output> [OPTIONS]
\tOnly 16-bit or 32-bit standard TIFF images are currently supported.

= = [OPTIONS] = = = = = = = = = = = = = = = = = = = = = = = = = = = = = = =
\t-i1 <filename>\t\tInput image 1 filename (mandatory)
\t-i2 <filename>\t\tInput image 2 filename (mandatory)
\t-fp1 <filename>\t\tPSF 1 image filename (mandatory)
\t-fp2 <filename>\t\tPSF 2 image filename (mandatory)
\t-o <filename>\t\tOutput image filename (mandatory)
\t-bp1 <filename>\t\tBackward projector 1 filename [flip of PSF 1]
\t-bp2 <filename>\t\tBackward projector 2 filename [flip of PSF 2]
\t-it <int>\t\tIteration number of the deconvolution [10]
\t-cON or -cOFF\t\tTurn on/off constant initialization [OFF]
\t-gm <int>\t\tMemory mode: -1 auto, 0 CPU, 1 HBM-resident, 2 host-staged streaming [-1]
\t-dev <int>\t\tSpecify the device if multiple devices [0]
\t-bit <int>\t\tSpecify output image bit: 16 or 32 [same as input image]
\t-verbON or -verbOFF\tTurn on/off verbose information [ON]
\t-log <filename>\t\tLog filename [no log file]
"""

VALUE_FLAGS = {"-i1", "-i2", "-fp1", "-fp2", "-o", "-bp1", "-bp2", "-it",
               "-gm", "-dev", "-bit", "-log"}
BARE_FLAGS = {"-cON", "-cOFF", "-verbON", "-verbOFF", "-h", "-help"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(HELP.split("= = [OPTIONS]")[0])
        print("Use command for more details:\n\tdeconDualView -help or deconDualView -h")
        return 0
    if "-h" in argv or "-help" in argv:
        print(HELP)
        return 0
    fp = FlagParser(argv).parse(VALUE_FLAGS, BARE_FLAGS)
    for flag in ("-i1", "-i2", "-fp1", "-fp2", "-o"):
        if not fp.has(flag):
            print(f"*** {flag} is mandatory")
            return 1
    n_iters = fp.get("-it", 10, int)
    device_num = fp.get("-dev", 0, int)
    const_initial = fp.has("-cON")
    verbose = not fp.has("-verbOFF")
    start = time.time()

    from microimagelib_tpu_torch.io.tiff import writetifstack
    from microimagelib_tpu_torch.models.deconvolution import decon_dualview
    from microimagelib_tpu_torch.utils.device import get_device

    _, bits_in = tifinfo_checked(fp.get("-i1"))
    bit_out = fp.get("-bit", int(bits_in), int)
    img1, size1 = read_stack_checked(fp.get("-i1"), "image 1")
    img2, size2 = read_stack_checked(fp.get("-i2"), "image 2")
    if size1 != size2:
        print("*** The two input images don't have the same image size, processing stopped !!!")
        return 1
    psf1, psf_size1 = read_stack_checked(fp.get("-fp1"), "PSF 1")
    psf2, psf_size2 = read_stack_checked(fp.get("-fp2"), "PSF 2")
    if psf_size1 != psf_size2:
        print("*** The two forward projectors don't have the same image size, processing stopped !!!")
        return 1
    psf1_bp = psf2_bp = None
    if fp.has("-bp1") and fp.has("-bp2"):
        psf1_bp, _ = read_stack_checked(fp.get("-bp1"), "backward projector 1")
        psf2_bp, _ = read_stack_checked(fp.get("-bp2"), "backward projector 2")

    mem_mode = fp.get("-gm", -1, int)
    print("=====================================================")
    print("=== Deconvolution settings ...")
    print("... Image information: ")
    print(f"\tInput image 1 path: {fp.get('-i1')}")
    print(f"\tInput image 2 path: {fp.get('-i2')}")
    print(f"\tPSF 1 path: {fp.get('-fp1')}")
    print(f"\tPSF 2 path: {fp.get('-fp2')}")
    if psf1_bp is not None:
        print(f"\tBackward projector 1 path: {fp.get('-bp1')}")
        print(f"\tBackward projector 2 path: {fp.get('-bp2')}")
    print(f"\tOutput image path: {fp.get('-o')}")
    print(f"\tInput image size {img1.shape[2]} x {img1.shape[1]} x {img1.shape[0]}")
    print(f"\tPSF image size {psf1.shape[2]} x {psf1.shape[1]} x {psf1.shape[0]}")
    print("... Parameters:")
    print(f"\tUse unmatched backward projectors: {'yes' if psf1_bp is not None else 'no'}")
    print(f"\tIteration number of the deconvolution: {n_iters}")
    print(f"\tConstant initialization: {'on' if const_initial else 'off'}")
    print(f"\tMemory mode: {mem_mode} (-1 auto, 0 CPU, 1 HBM-resident, 2 host-staged)")
    print(f"\tDevice number: {device_num}")
    print(f"\tOutput image bit: {bit_out} bit")
    print(f"\tverbose information: {'true' if verbose else 'false'}")
    print("=====================================================\n")

    records = np.zeros(10)
    out = decon_dualview(img1, img2, psf1, psf2, n_iters=n_iters,
                         const_initial=const_initial, psf_bp_a=psf1_bp,
                         psf_bp_b=psf2_bp, device=get_device(device_num),
                         mem_mode=mem_mode,
                         verbose=verbose, records=records)
    writetifstack(fp.get("-o"), out, bit_out)
    if verbose:
        print(f"...Time cost for decon is {records[8]:2.3f} s")
    print(f"\n****Time cost for  whole processing: {time.time() - start:2.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
