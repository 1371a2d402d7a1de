"""deconSingleView — single-view RL deconvolution CLI, flag-compatible
with the reference app (reference:src/decon_sv.cpp:44-239). ``-dev n``
selects ``cuda:n``; ``-gm 0`` runs on the CPU.

    python -m microimagelib_tpu_torch.cli.decon_sv -i img.tif -fp psf.tif -o out.tif -it 20
"""

from __future__ import annotations

import sys
import time

import numpy as np

from microimagelib_tpu_torch.cli._common import FlagParser, read_stack_checked, tifinfo_checked

HELP = """
deconSingleView: single-view Richardson-Lucy deconvolution

Usage:\tdeconSingleView -i <inputImageName> -fp <psfImageName> -o <outputImageName> [OPTIONS]
\tOnly 16-bit or 32-bit standard TIFF images are currently supported.

= = [OPTIONS] = = = = = = = = = = = = = = = = = = = = = = = = = = = = = = =
\t-i <filename>\t\tInput image filename (mandatory)
\t-fp <filename>\t\tPSF image filename (forward projector) (mandatory)
\t-o <filename>\t\tOutput image filename (mandatory)
\t-bp <filename>\t\tBackward projector image filename [flip of forward projector]
\t-it <int>\t\tIteration number of the deconvolution [20]
\t-gm <int>\t\tMemory mode: -1 auto, 0 CPU, 1 HBM-resident, 2 host-staged streaming [-1]
\t-dev <int>\t\tSpecify the device if multiple devices [0]
\t-cON or -cOFF\t\tTurn on/off constant initialization of the deconvolution [OFF]
\t-bit <int>\t\tSpecify output image bit: 16 or 32 [same as input image]
\t-verbON or -verbOFF\tTurn on/off verbose information [ON]
\t-log <filename>\t\tLog filename [no log file]
"""

VALUE_FLAGS = {"-i", "-fp", "-o", "-bp", "-it", "-gm", "-dev", "-bit", "-log"}
BARE_FLAGS = {"-cON", "-cOFF", "-verbON", "-verbOFF", "-h", "-help"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(HELP.split("= = [OPTIONS]")[0])
        print("Use command for more details:\n\tdeconSingleView -help or deconSingleView -h")
        return 0
    if "-h" in argv or "-help" in argv:
        print(HELP)
        return 0
    fp = FlagParser(argv).parse(VALUE_FLAGS, BARE_FLAGS)
    file_img = fp.get("-i")
    file_psf = fp.get("-fp")
    file_out = fp.get("-o")
    if not (file_img and file_psf and file_out):
        print("*** -i, -fp and -o are mandatory")
        return 1
    n_iters = fp.get("-it", 20, int)
    device_num = fp.get("-dev", 0, int)
    const_initial = fp.has("-cON")
    verbose = not fp.has("-verbOFF")
    start = time.time()

    from microimagelib_tpu_torch.io.tiff import writetifstack
    from microimagelib_tpu_torch.models.deconvolution import decon_singleview
    from microimagelib_tpu_torch.utils.device import get_device

    _, bits_in = tifinfo_checked(file_img)
    bit_out = fp.get("-bit", int(bits_in), int)
    img, _ = read_stack_checked(file_img, "input image")
    psf, _ = read_stack_checked(file_psf, "PSF image")
    psf_bp = None
    if fp.has("-bp"):
        psf_bp, _ = read_stack_checked(fp.get("-bp"), "backward projector")

    mem_mode = fp.get("-gm", -1, int)
    print("=====================================================")
    print("=== Deconvolution settings ...")
    print("... Image information: ")
    print(f"\tInput image path: {file_img}")
    print(f"\tPSF (forward projector) image path: {file_psf}")
    if psf_bp is not None:
        print(f"\tBackward projector image path: {fp.get('-bp')}")
    print(f"\tOutput image path: {file_out}")
    print(f"\tInput image size {img.shape[2]} x {img.shape[1]} x {img.shape[0]}")
    print(f"\tPSF image size {psf.shape[2]} x {psf.shape[1]} x {psf.shape[0]}")
    print(f"\tOutput image size {img.shape[2]} x {img.shape[1]} x {img.shape[0]}")
    print("... Parameters:")
    if psf_bp is not None:
        print("\tUse unmatched backward projector: yes")
    print(f"\tIteration number of the deconvolution: {n_iters}")
    print(f"\tConstant initialization: {'on' if const_initial else 'off'}")
    print(f"\tMemory mode: {mem_mode} (-1 auto, 0 CPU, 1 HBM-resident, 2 host-staged)")
    print(f"\tDevice number: {device_num}")
    print(f"\tOutput image bit: {bit_out} bit")
    print(f"\tverbose information: {'true' if verbose else 'false'}")
    print("=====================================================\n")

    records = np.zeros(10)
    out = decon_singleview(img, psf, n_iters=n_iters, const_initial=const_initial,
                           psf_bp=psf_bp, device=get_device(device_num),
                           mem_mode=mem_mode,
                           verbose=verbose, records=records)
    writetifstack(file_out, out, bit_out)
    if verbose:
        print(f"...Time cost for decon is {records[8]:2.3f} s")
    print(f"\n****Time cost for  whole processing: {time.time() - start:2.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
