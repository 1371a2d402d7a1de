from microimagelib_tpu_torch.io.tiff import gettifinfo, readtifstack, readtifstack_16to16, writetifstack, writetifstack_16to16
from microimagelib_tpu_torch.io.tmx import read_tmx, write_tmx

__all__ = [
    "gettifinfo",
    "readtifstack",
    "readtifstack_16to16",
    "writetifstack",
    "writetifstack_16to16",
    "read_tmx",
    "write_tmx",
]
