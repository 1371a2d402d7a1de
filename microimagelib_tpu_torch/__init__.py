"""microimagelib_tpu_torch — the PyTorch/CUDA port of microimagelib_tpu.

The port runs on an NVIDIA Hopper GPU (H100): plain tensor code is
PyTorch, and each Pallas TPU kernel of the JAX package becomes a
hand-written CUDA kernel (``csrc/``, loaded by ``kernels/``). Volumes are
C-order ``(z, y, x)`` float32 tensors; size tuples facing TIFF files stay
(x, y, z). Every entry takes an explicit ``torch.device``.

This first slice covers single-view Richardson-Lucy deconvolution
(``models.deconvolution.decon_singleview`` and the ``cli.decon_sv`` CLI)
with its separable-conv kernel, TIFF/.tmx I/O and the device census.
The JAX package ``microimagelib_tpu`` is the reference it is tested
against; this package never imports it or JAX.
"""

__version__ = "0.1.0"

from microimagelib_tpu_torch.io.tiff import gettifinfo, readtifstack, writetifstack
from microimagelib_tpu_torch.io.tmx import read_tmx, write_tmx
from microimagelib_tpu_torch.ops.basics import align_size_3d as alignsize3d
from microimagelib_tpu_torch.utils.device import query_device
from microimagelib_tpu_torch.utils.pathutil import concat, fexists

__all__ = [
    "concat",
    "fexists",
    "alignsize3d",
    "gettifinfo",
    "readtifstack",
    "writetifstack",
    "read_tmx",
    "write_tmx",
    "query_device",
    "__version__",
]
