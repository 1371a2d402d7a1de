"""The port's pencil FFT and mesh collectives against the JAX package's
under ``shard_map`` on the conftest's 8-device virtual CPU mesh. Each port
call runs on a mesh of CPU places (``make_mesh(..., devices=["cpu"] *
n)``) of the same shape. Bounds: the spectrum at rtol 1e-4, atol 1e-3
(tests/test_parallel.py's bound against ``jnp.fft.rfftn``), the round trip
at rtol 1e-4, atol 1e-5; the collectives move data, bit for bit."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from microimagelib_tpu.ops.fft_sharded import irfft3_pencil as j_irfft3
from microimagelib_tpu.ops.fft_sharded import rfft3_pencil as j_rfft3
from microimagelib_tpu.parallel.mesh import make_mesh as j_make_mesh
from microimagelib_tpu_torch.ops.fft_sharded import conv_spec_pencil, irfft3_pencil, rfft3_pencil
from microimagelib_tpu_torch.parallel import collectives as CO
from microimagelib_tpu_torch.parallel.mesh import gather, make_mesh, split

N_SP = 4


def _cpu_row(n=N_SP):
    return make_mesh(n, 1, devices=["cpu"] * n).row(0)


def _vol(shape, seed=3):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 15)])
def test_rfft3_pencil_shards_match_jax(shape):
    x = _vol(shape)
    mesh = j_make_mesh(n_sp=N_SP, n_dp=1)
    fwd = jax.jit(shard_map(j_rfft3, mesh=mesh, in_specs=P("sp", None, None),
                            out_specs=P(None, "sp", None)))
    ref = np.asarray(fwd(jnp.asarray(x)))
    spec = rfft3_pencil(split(torch.from_numpy(x), 0, _cpu_row()))
    ny = shape[1] // N_SP
    for i, s in enumerate(spec):
        assert tuple(s.shape) == (shape[0], ny, shape[2] // 2 + 1)
        np.testing.assert_allclose(s.numpy(), ref[:, i * ny:(i + 1) * ny], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gather(spec, 1).numpy(), np.fft.rfftn(x), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("nx", [16, 15])
def test_pencil_round_trip_and_inverse_match_jax(nx):
    """irfft3_pencil(rfft3_pencil(x)) gives x back, an odd x extent
    included, and the inverse's shards equal JAX's on the same spectrum."""
    x = _vol((16, 8, nx), seed=5)
    row = _cpu_row()
    back = irfft3_pencil(rfft3_pencil(split(torch.from_numpy(x), 0, row)), nx)
    np.testing.assert_allclose(gather(back, 0).numpy(), x, rtol=1e-4, atol=1e-5)
    mesh = j_make_mesh(n_sp=N_SP, n_dp=1)
    spec = np.fft.rfftn(x).astype(np.complex64)
    inv = jax.jit(shard_map(partial(j_irfft3, nx=nx), mesh=mesh,
                            in_specs=P(None, "sp", None), out_specs=P("sp", None, None)))
    ref = np.asarray(inv(jnp.asarray(spec)))
    got = irfft3_pencil(split(torch.from_numpy(spec), 1, row), nx)
    np.testing.assert_allclose(gather(got, 0).numpy(), ref, rtol=1e-4, atol=1e-5)


def test_conv_spec_pencil_matches_resident_fft():
    x = _vol((16, 16, 12), seed=7)
    otf = np.fft.rfftn(_vol((16, 16, 12), seed=8)).astype(np.complex64)
    row = _cpu_row()
    got = conv_spec_pencil(split(torch.from_numpy(x), 0, row),
                           split(torch.from_numpy(otf), 1, row), 12)
    ref = np.fft.irfftn(np.fft.rfftn(x) * otf, s=x.shape, axes=(0, 1, 2))
    np.testing.assert_allclose(gather(got, 0).numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def _jax_collective(fn, x, in_spec=P("sp"), out_spec=P("sp")):
    mesh = j_make_mesh(n_sp=N_SP, n_dp=1)
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=in_spec,
                                        out_specs=out_spec))(jnp.asarray(x)))


def test_all_to_all_order_on_source_indices():
    """Shards filled with their source index: after the forward exchange
    (split y, join z) every place holds z blocks 0..n-1 in source order;
    the inverse (split z, join y) puts each source's rows back. Both equal
    ``lax.all_to_all(tiled=True)``."""
    nz, ny, nx = 8, 8, 3
    x = np.repeat(np.arange(N_SP, dtype=np.float32), nz // N_SP)[:, None, None]
    x = np.broadcast_to(x, (nz, ny, nx)).copy()
    x += np.arange(ny, dtype=np.float32)[None, :, None] / 100   # tag the y rows
    shards = split(torch.from_numpy(x), 0, _cpu_row())
    fwd = CO.all_to_all(shards, split_axis=1, concat_axis=0)
    dz, dy = nz // N_SP, ny // N_SP
    for j, s in enumerate(fwd):
        assert tuple(s.shape) == (nz, dy, nx)
        for k in range(N_SP):
            np.testing.assert_array_equal(np.floor(s[k * dz:(k + 1) * dz].numpy()), k)
        np.testing.assert_array_equal(s.numpy(), x[:, j * dy:(j + 1) * dy])
    ref = _jax_collective(lambda a: lax.all_to_all(a, "sp", 1, 0, tiled=True), x,
                          out_spec=P(None, "sp"))
    np.testing.assert_array_equal(gather(fwd, 1).numpy(), ref)
    inv = CO.all_to_all(fwd, split_axis=0, concat_axis=1)
    np.testing.assert_array_equal(gather(inv, 0).numpy(), x)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_ppermute_direction_matches_jax(k):
    """perm (j, j + k): place idx receives the shard of idx - k."""
    x = np.arange(N_SP * 2 * 3, dtype=np.float32).reshape(N_SP * 2, 3)
    perm = [(j, (j + k) % N_SP) for j in range(N_SP)]
    got = CO.ppermute(split(torch.from_numpy(x), 0, _cpu_row()), perm)
    ref = _jax_collective(lambda a: lax.ppermute(a, "sp", perm), x)
    np.testing.assert_array_equal(gather(got, 0).numpy(), ref)
    for idx, s in enumerate(got):
        src = (idx - k) % N_SP
        np.testing.assert_array_equal(s.numpy(), x[2 * src:2 * src + 2])


def test_psum_all_gather_axis_index_match_jax():
    x = np.random.default_rng(1).random((N_SP * 2, 5)).astype(np.float32)
    shards = split(torch.from_numpy(x), 0, _cpu_row())
    sums = CO.psum([s.sum(dim=0, keepdim=True) for s in shards])
    ref = _jax_collective(lambda a: lax.psum(jnp.sum(a, 0, keepdims=True), "sp"), x)
    for s, r in zip(sums, np.split(ref, N_SP)):
        np.testing.assert_allclose(s.numpy(), r, rtol=1e-6)
    full = CO.all_gather(shards, axis=0)
    ref = _jax_collective(lambda a: lax.all_gather(a, "sp", axis=0, tiled=True), x)
    for f, r in zip(full, np.split(ref, N_SP)):
        np.testing.assert_array_equal(f.numpy(), r)
    ref = _jax_collective(lambda a: lax.axis_index("sp")[None], np.zeros(N_SP, np.float32))
    assert CO.axis_index(shards) == ref.tolist()
