"""genBackProjector — generate unmatched back-projector PSFs
(Wiener / Butterworth / Wiener-Butterworth, Guo et al. 2020) for the
``-bp`` / ``-bp1/-bp2`` flags of the deconvolution and fusion apps.

The reference expects these files to be produced by external MATLAB
scripts; this tool makes the framework self-contained.

    python -m microimagelib_tpu_torch.cli.gen_bp -fp psf.tif -o bp.tif
"""

from __future__ import annotations

import sys

from microimagelib_tpu_torch.cli._common import FlagParser, read_stack_checked

HELP = """
genBackProjector: generate an unmatched back projector from a forward PSF

Usage:\tgenBackProjector -fp <psfImageName> -o <outputName> [OPTIONS]

= = [OPTIONS] = = = = = = = = = = = = = = = = = = = = = = = = = = = = = = =
\t-fp <filename>\t\tForward projector (PSF) image (mandatory)
\t-o <filename>\t\tOutput back-projector image (mandatory)
\t-method <string>\twiener | butterworth | wiener-butterworth [wiener-butterworth]
\t-alpha <float>\t\tWiener regularization [0.001]
\t-beta <float>\t\tButterworth passband gain at cutoff [0.001]
\t-n <int>\t\tButterworth order [10]
\t-kc <float>\t\tExplicit normalized cutoff frequency [auto from OTF support]
\t-bit <int>\t\tOutput bit depth: 16 or 32 [32]
"""

VALUE_FLAGS = {"-fp", "-o", "-method", "-alpha", "-beta", "-n", "-kc", "-bit"}
BARE_FLAGS = {"-h", "-help"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "-h" in argv or "-help" in argv:
        print(HELP)
        return 0
    fp = FlagParser(argv).parse(VALUE_FLAGS, BARE_FLAGS)
    if not (fp.has("-fp") and fp.has("-o")):
        print("*** -fp and -o are mandatory")
        return 1

    from microimagelib_tpu_torch.io.tiff import writetifstack
    from microimagelib_tpu_torch.models.backprojector import gen_backprojector

    psf, _ = read_stack_checked(fp.get("-fp"), "PSF image")
    bp = gen_backprojector(
        psf,
        method=fp.get("-method", "wiener-butterworth"),
        alpha=fp.get("-alpha", 0.001, float),
        beta=fp.get("-beta", 0.001, float),
        n=fp.get("-n", 10, int),
        kc=fp.get("-kc", None, float) if fp.has("-kc") else None,
    )
    writetifstack(fp.get("-o"), bp, fp.get("-bit", 32, int))
    print(f"Back projector written to {fp.get('-o')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
