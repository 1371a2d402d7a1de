"""reg3D — intensity-based 3D image registration CLI, flag-compatible with
the reference app (reference:src/reg3D.cpp:13-54 for the manual,
:56-339 for behavior). ``-dev n`` selects ``cuda:n``; ``-gm 0`` runs on
the CPU. Registration choices 1, 3 and 4 (phasor, 2-D MIP) and memory
mode 2 are not ported yet and raise NotImplementedError.

    python -m microimagelib_tpu_torch.cli.reg3d -t target.tif -s source.tif -o out.tif -otmx out.tmx
"""

from __future__ import annotations

import sys
import time

import numpy as np

from microimagelib_tpu_torch.cli._common import FlagParser, read_stack_checked, tifinfo_checked

HELP = """
reg3D: intensity-based 3D image registration

Usage:\treg3D -t <targetImageName> -s <sourceImageName> -o <outputImageName> [OPTIONS]
\tOnly 16-bit or 32-bit standard TIFF images are currently supported.

= = [OPTIONS] = = = = = = = = = = = = = = = = = = = = = = = = = = = = = = =
\t-t <filename>\t\tTarget image filename (Fixed or Base image) (mandatory)
\t-s <filename>\t\tSource image filename (Moving or Floating image) (mandatory)
\t-o <filename>\t\tOutput filename of the registered image (mandatory)
\t-itmx <filename>\tInput tranformation matrix filename [identity matrix]
\t-otmx <filename>\tOutput tranformation matrix filename [no output]
\t-regc <int>\t\tOptions for registration choice [2]
\t\t\t\t0: no registration, but transform source image based on input matrix
\t\t\t\t1: phasor registraion (pixel-level translation, input matrix disabled)
\t\t\t\t2: affine registration (with or without input matrix)
\t\t\t\t3: phasor registration --> affine registration (input matrix disabled)
\t\t\t\t4: 2D MIP registration --> affine registration (input matrix disabled)
\t-affm <int>\t\tOptions for affine method [7]
\t\t\t\t0: no affine, but transform source image based on input matrix
\t\t\t\t1: translation only (3 DOF)
\t\t\t\t2: rigid-body (6 DOF)
\t\t\t\t3: 7 DOF\t4: 9 DOF\t5: directly 12 DOF
\t\t\t\t6: rigid body (6 DOF) --> 12 DOF
\t\t\t\t7: 3 DOF --> 6 DOF--> 9 DOF--> 12 DOF
\t-ftol <float>\t\tTolerance or threshold of the stop point [0.0001]
\t-it <int>\t\tMaximum iteration number [3000]
\t-gm <int>\t\tMemory mode: -1 auto, 0 CPU, 1 HBM-resident, 2 host-staged streaming [-1]
\t-dev <int>\t\tSpecify the device if multiple devices [0]
\t-bit <int>\t\tSpecify output image bit: 16 or 32 [same as input image]
\t-verbON or -verbOFF\tTurn on/off verbose information [ON]
\t-log <filename>\t\tLog filename [no log file]
"""

VALUE_FLAGS = {"-t", "-s", "-o", "-itmx", "-otmx", "-regc", "-affm", "-ftol",
               "-it", "-gm", "-dev", "-bit", "-log"}
BARE_FLAGS = {"-verbON", "-verbOFF", "-h", "-help"}

REG_CHOICE_NAMES = {
    0: "no registration",
    1: "phasor registration",
    2: "affine registration",
    3: "phasor registration --> affine registration",
    4: "2D registration --> affine registration",
}
AFF_METHOD_NAMES = {
    0: "no registration",
    1: "translation only",
    2: "rigid body",
    3: "7 DOF",
    4: "9 DOF",
    5: "12 DOF",
    6: "rigid body --> 12 DOF",
    7: "3 DOF --> 6 DOF --> 9 DOF --> 12 DOF",
}
MEM_MODE_NAMES = {
    -1: "automatically setting",
    0: "CPU",
    1: "HBM-resident device",
    2: "memory-saved (host-staged) device",
}


def _print_settings_banner(fp, file_tgt, file_src, file_out, size1, size2,
                           reg_choice, aff_method, ftol, it_limit, mem_mode,
                           device_num, bit_out, flag_bit_input, verbose):
    """Full settings dump before processing — the reference's de-facto
    provenance record for experiments (reference:src/reg3D.cpp:161-271)."""
    print("=====================================================")
    print("=== Registration settings ...")
    print("... Image information: ")
    print(f"\tTarget (fixed) image: {file_tgt}")
    print(f"\tSource (floating) image: {file_src}")
    print(f"\tOutput (registered) image: {file_out}")
    print(f"\tTarget (fixed) image size {size1[0]} x {size1[1]} x {size1[2]}")
    print(f"\tSource (floating) image size {size2[0]} x {size2[1]} x {size2[2]}")
    print(f"\tOutput (registered) image size {size1[0]} x {size1[1]} x {size1[2]}")
    print("... Parameters:")
    print(f"\tInitial transformation matrix: "
          f"{fp.get('-itmx') if fp.has('-itmx') else 'Default'}")
    print(f"\tSave output transformation matrix: "
          f"{fp.get('-otmx') if fp.has('-otmx') else 'no'}")
    if reg_choice not in REG_CHOICE_NAMES:
        print("\tWrong registration choice, processing stopped !!!")
        return False
    print(f"\tRegistration choice: {REG_CHOICE_NAMES[reg_choice]}")
    if reg_choice >= 2:
        if aff_method not in AFF_METHOD_NAMES:
            print("\tWrong affine registration method, processing stopped !!!")
            return False
        print(f"\tAffine registration method: {AFF_METHOD_NAMES[aff_method]}")
    print(f"\tTolerance or threshold: {ftol:f}")
    print(f"\tMaximum iteration number: {it_limit}")
    if mem_mode not in MEM_MODE_NAMES:
        print("\tWrong memory mode setting, processing stopped !!!")
        return False
    print(f"\tCPU or device processing: {MEM_MODE_NAMES[mem_mode]}")
    if mem_mode != 0:
        print(f"\tDevice number: {device_num}")
    suffix = ", same as input image" if flag_bit_input else ""
    print(f"\tOutput image bit: {bit_out} bit{suffix}")
    print(f"\tverbose information: {'true' if verbose else 'false'}")
    print("=====================================================\n")
    return True


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(HELP.split("= = [OPTIONS]")[0])
        print("Use command for more details:\n\treg3D -help or reg3D -h")
        return 0
    if "-h" in argv or "-help" in argv:
        print(HELP)
        return 0
    fp = FlagParser(argv).parse(VALUE_FLAGS, BARE_FLAGS)
    file_tgt = fp.get("-t")
    file_src = fp.get("-s")
    file_out = fp.get("-o")
    if not (file_tgt and file_src and file_out):
        print("*** -t, -s and -o are mandatory")
        return 1
    reg_choice = fp.get("-regc", 2, int)
    aff_method = fp.get("-affm", 7, int)
    ftol = fp.get("-ftol", 1e-4, float)
    it_limit = fp.get("-it", 3000, int)
    device_num = fp.get("-dev", 0, int)
    verbose = not fp.has("-verbOFF")
    start = time.time()

    from microimagelib_tpu_torch.io.tiff import (
        readtifstack_16to16,
        writetifstack,
        writetifstack_16to16,
    )
    from microimagelib_tpu_torch.io.tmx import read_tmx, write_tmx
    from microimagelib_tpu_torch.models.registration import atrans3dgpu_16bit, reg3d
    from microimagelib_tpu_torch.utils.device import get_device

    size1_info, bits_in = tifinfo_checked(file_tgt)
    bit_out = fp.get("-bit", int(bits_in), int)
    mem_mode = fp.get("-gm", -1, int)
    img1, size1 = read_stack_checked(file_tgt, "target image")
    img2, size2 = read_stack_checked(file_src, "source image")
    if not _print_settings_banner(fp, file_tgt, file_src, file_out, size1,
                                  size2, reg_choice, aff_method, ftol,
                                  it_limit, mem_mode, device_num, bit_out,
                                  not fp.has("-bit"), verbose):
        return 1
    tmx = None
    flag_tmx = False
    if fp.has("-itmx"):
        tmx = read_tmx(fp.get("-itmx"))
        flag_tmx = True

    records = np.zeros(11)
    time1 = time.time()
    print("=== Registration starting ...")
    reg, out_tmx, records = reg3d(
        img1, img2, reg_choice, aff_method, flag_tmx, tmx, ftol, it_limit,
        device=get_device(device_num), mem_mode=mem_mode, verbose=verbose,
        records=records)
    time2 = time.time()

    if bit_out == 16 and int(bits_in) == 16 and size1 == size2:
        # native 16-bit journey: re-read the source as u16 and apply the
        # final matrix through the u16 transform path, as the reference
        # does for -bit 16 (reference:src/api_reg.cpp:87-113
        # atrans3dgpu_16bit)
        src_u16, _ = readtifstack_16to16(file_src)
        reg_u16 = atrans3dgpu_16bit(src_u16, out_tmx, np.asarray(img1).shape,
                                    device=get_device(device_num),
                                    mem_mode=mem_mode)
        writetifstack_16to16(file_out, reg_u16)
    else:
        writetifstack(file_out, reg, bit_out)
    if fp.has("-otmx"):
        write_tmx(fp.get("-otmx"), out_tmx)
    end = time.time()
    print(f"\n****Time cost for  image reading/writing: {end - time2 + time1 - start:2.3f} s")
    print(f"\n****Time cost for  registration: {time2 - time1:2.3f} s")
    print(f"\n****Time cost for  whole processing: {end - start:2.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
