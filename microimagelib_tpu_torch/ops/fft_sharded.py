"""Pencil-decomposed distributed 3D rFFT over a mesh axis — the port of
the JAX package's ``ops/fft_sharded.py``.

A volume (z, y, x) cut along z into one shard per place of the mesh axis
'sp' is transformed by:
  1. local rFFT along x and FFT along y on each z-slab,
  2. one ``all_to_all`` re-partitioning the z-slabs into y-chunks,
  3. local FFT along z.
The spectrum lives y-sharded (global spec (None, 'sp', None)); the
inverse reverses the steps. Each shard's transforms are ``torch.fft``
(cuFFT on the card), as the JAX package runs ``jnp.fft`` there. The last
three axes are the volume's: a leading batch axis on every shard
transforms each of its volumes."""

from __future__ import annotations

import torch

from microimagelib_tpu_torch.parallel.collectives import all_to_all


def rfft3_pencil(x_shards):
    """z-shards (.., z_loc, y, x) real -> spectral y-shards (.., z, y_loc, xh)."""
    a = [torch.fft.fft(torch.fft.rfft(x, dim=-1), dim=-2) for x in x_shards]
    # re-partition: split y into n chunks, concatenate the z-slabs
    a = all_to_all(a, split_axis=-2, concat_axis=-3)
    return [torch.fft.fft(s, dim=-3) for s in a]


def irfft3_pencil(spec_shards, nx):
    """Inverse of :func:`rfft3_pencil`: spectral y-shards (.., z, y_loc, xh)
    -> real z-shards (.., z_loc, y, x). ``nx`` is the full (even or odd) x
    extent."""
    a = [torch.fft.ifft(s, dim=-3) for s in spec_shards]
    a = all_to_all(a, split_axis=-3, concat_axis=-2)
    return [torch.fft.irfft(torch.fft.ifft(s, dim=-2), n=nx, dim=-1) for s in a]


def conv_spec_pencil(x_shards, otf_shards, nx):
    """FFT convolution of a z-sharded volume with a y-sharded OTF."""
    spec = rfft3_pencil(x_shards)
    return irfft3_pencil([s * o for s, o in zip(spec, otf_shards)], nx)
