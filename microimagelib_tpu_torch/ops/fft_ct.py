"""The FFT circular convolution of the RL loops for PSFs the separable
planner refuses (the JAX package's ``ops/fft_pallas.py``).

:func:`conv3_ct` computes ``irfftn(rfftn(v) * otf, s=v.shape)`` with the
same normalization as ``torch.fft`` (forward unscaled, inverse scaled by
1/(nz*ny*nx)). On a CUDA tensor it is one call of the hand-written kernel
K3 (kernels/fft_ct.py, csrc/fft_ct.cu); on a CPU tensor, its plain
``torch.fft`` version. The OTF is the natural-order half spectrum that
``models.deconvolution.gen_otf`` makes: the TPU kernel's pre-permuted OTF
layout (``permute_otf``) is not needed here.
"""

from microimagelib_tpu_torch.kernels.fft_ct import (
    conv3_ct,
    conv3_ct_torch,
    ct_specialised,
    ct_supported,
)

__all__ = ["conv3_ct", "conv3_ct_torch", "ct_specialised", "ct_supported"]
