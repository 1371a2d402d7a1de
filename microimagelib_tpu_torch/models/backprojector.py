"""Unmatched back-projector generation (Guo et al. 2020, Nature
Biotechnology 38:1337-1346): traditional RL uses the flipped PSF as the
back projector; replacing it with a Wiener-Butterworth (WB) filter lets
~1-2 RL iterations reach the quality of ~10-20 traditional ones.

The reference consumes pre-made back-projector files (``-bp`` flags,
reference:src/decon_sv.cpp:91-95) and delegates their creation to the
authors' MATLAB scripts; this module generates them natively so the
framework is self-contained:

  * 'wiener':       B = conj(OTF) / (|OTF|^2 + alpha)
  * 'butterworth':  B = 1 / sqrt(1 + (k/kc)^(2n))   (low-pass)
  * 'wiener-butterworth' (default): the product of both — the paper's
    recommended accelerator.

The cutoff kc defaults to the OTF support radius: the largest frequency
where |OTF|/|OTF(0)| still exceeds ``otf_cutoff`` (resolution limit).
Returns a real-space back-projector PSF the same shape as the input PSF,
directly usable as ``psf_bp`` in decon_singleview/decon_dualview.

numpy only: a copy of the JAX package's ``models/backprojector.py``, so
that this package never imports that one (whose ``__init__`` imports
JAX); the tests hold the two equal.
"""

from __future__ import annotations

import numpy as np


def _freq_grid(shape):
    axes = [np.fft.fftfreq(n) for n in shape]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    return np.sqrt(zz**2 + yy**2 + xx**2)


def gen_backprojector(psf, method="wiener-butterworth", alpha=0.001, beta=0.001,
                      n=10, otf_cutoff=0.01, kc=None):
    """Build an unmatched back-projector PSF from a forward PSF.

    psf: (z, y, x) array. alpha: Wiener regularization. beta: Butterworth
    passband gain at the cutoff (sets epsilon = sqrt(1/beta^2 - 1)).
    n: Butterworth order. kc: explicit normalized cutoff (cycles/voxel);
    default derives it from the OTF support at ``otf_cutoff``."""
    psf = np.asarray(psf, np.float64)
    psf = psf / psf.sum()
    shape = psf.shape
    # center the PSF at the origin for a zero-phase OTF
    center = tuple(s // 2 for s in shape)
    otf = np.fft.fftn(np.roll(psf, tuple(-c for c in center), axis=(0, 1, 2)))
    mag = np.abs(otf)
    mag0 = mag.flat[0]

    k = _freq_grid(shape)
    if kc is None:
        support = mag / mag0 > otf_cutoff
        kc = float(k[support].max()) if support.any() else 0.5
        kc = max(kc, 1e-3)

    if method in ("wiener", "wiener-butterworth"):
        wiener = np.conj(otf) / (mag**2 + alpha)
    else:
        wiener = np.ones_like(otf)

    if method in ("butterworth", "wiener-butterworth"):
        eps = np.sqrt(1.0 / beta**2 - 1.0)
        bw = 1.0 / np.sqrt(1.0 + eps**2 * (k / kc) ** (2 * n))
    else:
        bw = np.ones(shape)

    # DC gains: the PSF is sum-normalized so |OTF(0)| = 1, the Wiener part
    # has DC gain 1/(1+alpha) ~= 1 and Butterworth exactly 1 — the RL
    # update stays scale-correct without extra normalization
    if method == "wiener":
        spec = wiener
    elif method == "butterworth":
        spec = bw.astype(np.complex128)
    elif method == "wiener-butterworth":
        spec = wiener * bw
    else:
        raise ValueError(f"Unknown back-projector method: {method}")

    bp = np.real(np.fft.ifftn(spec))
    bp = np.roll(bp, center, axis=(0, 1, 2))
    return bp.astype(np.float32)
