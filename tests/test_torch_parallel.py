"""The port's mesh-sharded paths (``microimagelib_tpu_torch.parallel``)
against the JAX package's on the conftest's 8-device virtual CPU mesh,
with the same mesh shapes; each port call runs on a mesh of CPU places
(``devices=["cpu"] * n``). Each case also matches the port's own resident
function. Bounds are tests/test_parallel.py's: RL rtol/atol 2e-5, NCC
partials rtol 1e-5, registration matrices atol 5e-3 and NCC 1e-3.

The JAX package's sharded RL raises with const_initial=True in this JAX
version (its fori_loop carry mixes a mesh-invariant start with a varying
estimate), so those cases hold the port against JAX's resident RL, which
the sharded loop must equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P
from scipy import ndimage

from microimagelib_tpu.models import deconvolution as JD
from microimagelib_tpu.ops.affine import affine_transform_3d as j_affine
from microimagelib_tpu.ops.matrix import dof_to_matrix
from microimagelib_tpu.parallel import mesh as JM
from microimagelib_tpu.parallel import sharded as JS
from microimagelib_tpu_torch import parallel as PAR
from microimagelib_tpu_torch.models import deconvolution as PD
from microimagelib_tpu_torch.models import registration as PR
from microimagelib_tpu_torch.ops import affine as PA
from microimagelib_tpu_torch.parallel import mesh as PM
from microimagelib_tpu_torch.parallel import sharded as PS

torch.set_num_threads(1)
RTOL = ATOL = 2e-5
IDENTITY = np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float32)


def gaussian_psf(shape, sigma):
    zz, yy, xx = np.meshgrid(*[np.arange(s) - s // 2 for s in shape], indexing="ij")
    g = np.exp(-(xx**2 + yy**2 + zz**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    shape = (16, 16, 16)
    rng = np.random.default_rng(0)
    img_a = (rng.random(shape) * 100 + 1).astype(np.float32)
    img_b = (rng.random(shape) * 100 + 1).astype(np.float32)
    psf = gaussian_psf((5, 5, 5), 1.0)
    otf = np.asarray(JD.gen_otf(jnp.asarray(psf), shape))
    otf_bp = np.asarray(JD.gen_otf(jnp.asarray(psf[::-1, ::-1, ::-1]), shape))
    return shape, img_a, img_b, otf, otf_bp


def _mesh(n_sp, n_dp):
    return PM.make_mesh(n_sp, n_dp, devices=["cpu"] * (n_sp * n_dp))


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_exports_are_the_jax_packages():
    import microimagelib_tpu.parallel as JP

    assert PAR.__all__ == JP.__all__
    assert all(callable(getattr(PAR, n)) for n in PAR.__all__)


@pytest.mark.parametrize("const_initial", [False, True])
def test_single_sharded_matches_jax_and_resident(setup, const_initial):
    shape, img_a, _, otf, otf_bp = setup
    out = PS.rl_decon_single_sharded(img_a, otf, otf_bp, 5, _mesh(4, 2), const_initial)
    assert out.device.type == "cpu" and tuple(out.shape) == shape
    _close(out, PD.rl_decon_single(img_a, otf, otf_bp, 5, const_initial, device="cpu"))
    if const_initial:
        ref = JD.rl_decon_single(jnp.asarray(img_a), otf, otf_bp, 5, const_initial=True)
    else:
        ref = JS.rl_decon_single_sharded(jnp.asarray(img_a), otf, otf_bp, 5,
                                         JM.make_mesh(n_sp=4, n_dp=2))
    _close(out, ref)


@pytest.mark.parametrize("const_initial", [False, True])
def test_dual_sharded_matches_jax_and_resident(setup, const_initial):
    shape, img_a, img_b, otf, otf_bp = setup
    out = PS.rl_decon_dual_sharded(img_a, img_b, otf, otf, otf_bp, otf_bp, 4,
                                   _mesh(8, 1), const_initial)
    _close(out, PD.rl_decon_dual(img_a, img_b, otf, otf, otf_bp, otf_bp, 4,
                                 const_initial, device="cpu"))
    if const_initial:
        ref = JD.rl_decon_dual(jnp.asarray(img_a), jnp.asarray(img_b), otf, otf,
                               otf_bp, otf_bp, 4, const_initial=True)
    else:
        ref = JS.rl_decon_dual_sharded(jnp.asarray(img_a), jnp.asarray(img_b), otf, otf,
                                       otf_bp, otf_bp, 4, JM.make_mesh(n_sp=8, n_dp=1))
    _close(out, ref)


def test_batch_dp_matches_jax_and_per_timepoint(setup):
    shape, img_a, img_b, otf, otf_bp = setup
    batch_a = np.stack([img_a, img_b, img_a * 0.5 + 1, img_b * 2 + 1]).astype(np.float32)
    batch_b = np.stack([img_b, img_a, img_b * 0.7 + 1, img_a * 1.5 + 1]).astype(np.float32)
    out = PS.rl_decon_dual_batch_dp(batch_a, batch_b, otf, otf, otf_bp, otf_bp, 3,
                                    _mesh(2, 4))
    ref = JS.rl_decon_dual_batch_dp(jnp.asarray(batch_a), jnp.asarray(batch_b), otf, otf,
                                    otf_bp, otf_bp, 3, JM.make_mesh(n_sp=2, n_dp=4))
    _close(out, ref)
    for t in range(4):
        _close(out[t], PD.rl_decon_dual(batch_a[t], batch_b[t], otf, otf, otf_bp, otf_bp,
                                        3, device="cpu"))
    with pytest.raises(ValueError, match="'dp' mesh extent"):
        PS.rl_decon_dual_batch_dp(batch_a[:3], batch_b[:3], otf, otf, otf_bp, otf_bp, 1,
                                  _mesh(2, 4))


def test_sharded_entries_accept_device_tensors(setup):
    """Inputs handed over as tensors (the batch driver's device-resident
    pads and OTFs) are laid out on the mesh as numpy inputs are; the input
    tensors are left untouched."""
    shape, img_a, img_b, otf, otf_bp = setup
    a_t, b_t = torch.from_numpy(img_a.copy()), torch.from_numpy(img_b.copy())
    otf_t, bp_t = torch.from_numpy(otf.copy()), torch.from_numpy(otf_bp.copy())
    out = PS.rl_decon_dual_batch_dp(torch.stack([a_t, b_t]), torch.stack([b_t, a_t]),
                                    otf_t, otf_t, bp_t, bp_t, 2, _mesh(2, 2))
    ref = JD.rl_decon_dual(jnp.asarray(img_a), jnp.asarray(img_b), otf, otf, otf_bp,
                           otf_bp, 2)
    _close(out[0], ref)
    out2 = PS.rl_decon_dual_sharded(a_t, b_t, otf_t, otf_t, bp_t, bp_t, 2, _mesh(4, 1))
    _close(out2, ref)
    np.testing.assert_array_equal(a_t.numpy(), img_a)
    with pytest.raises(ValueError, match="divisible by the 'sp' mesh extent"):
        PS.rl_decon_single_sharded(img_a[:, :15], otf, otf_bp, 1, _mesh(4, 1))


@pytest.mark.parametrize("hops", [1, 2])
def test_gather_zwindow_matches_jax_on_every_shard(hops):
    """Each place's window and origin equal JAX's ``_gather_zwindow``: the
    shards of idx - hops .. idx + hops, wrapped at the ends, and win_start
    = (idx - hops) * dz, negative on the first ``hops`` places."""
    n, dz = 4, 2
    x = np.arange(n * dz * 3 * 2, dtype=np.float32).reshape(n * dz, 3, 2)
    wins, starts = PS._gather_zwindow(PM.split(torch.from_numpy(x), 0, _mesh(n, 1).row(0)),
                                      hops)

    def local(a):
        w, s = JS._gather_zwindow(a, hops, "sp")
        return w, s[None]

    jmesh = JM.make_mesh(n_sp=n, n_dp=1)
    jw, js = jax.jit(shard_map(local, mesh=jmesh, in_specs=P("sp"),
                               out_specs=(P("sp"), P("sp"))))(jnp.asarray(x))
    wz = (2 * hops + 1) * dz
    assert starts == np.asarray(js).tolist() == [(i - hops) * dz for i in range(n)]
    for i, w in enumerate(wins):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw)[i * wz:(i + 1) * wz])
        rows = [((i + k) % n) for k in range(-hops, hops + 1)]
        np.testing.assert_array_equal(
            w.numpy(), np.concatenate([x[r * dz:(r + 1) * dz] for r in rows]))


@pytest.mark.parametrize("dof", [[1.7, -0.8, 2.3, 0, 0, 0, 1, 1, 1],
                                 [1.3, -0.7, 2.2, 4.0, -2.0, 3.0, 1.05, 0.97, 1.02]])
def test_window_partials_never_read_wrapped_rows(dof):
    """On every shard, edge shards included, the wrapped part of the window
    is never read by a valid sample: with those rows poisoned by NaN the
    per-shard partials still sum to ``corr3d_partials`` of the whole pair."""
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.random((16, 16, 16)).astype(np.float32))
    tgt = torch.from_numpy(rng.random((16, 16, 16)).astype(np.float32))
    n, dz = 4, 4
    m = dof_to_matrix(dof, 9)
    hops = PA.zslab_footprint_hops(m, (16, 16, 16), n)
    assert 1 <= hops < n - 1
    row = _mesh(n, 1).row(0)
    wins, starts = PS._gather_zwindow(PM.split(src, 0, row), hops)
    tgt_sh = PM.split(tgt, 0, row)
    ss = st = 0.0
    for i, (w, s0) in enumerate(zip(wins, starts)):
        w = w.clone()
        for r in range(w.shape[0]):
            if not 0 <= s0 + r < 16:
                w[r] = float("nan")
        a, b = PA.corr3d_partials_window(w, tgt_sh[i], m, i * dz, s0, 16)
        ss, st = ss + float(a), st + float(b)
    ss0, st0 = PA.corr3d_partials(src, tgt, m)
    np.testing.assert_allclose(ss, float(ss0), rtol=1e-5)
    np.testing.assert_allclose(st, float(st0), rtol=1e-5)


@pytest.mark.parametrize("shift_z", [2.3, 12.0], ids=["window", "all_gather"])
def test_fusion_step_multichip_matches_jax(setup, shift_z):
    """Both branches: a z shift within a 1-2 hop window, and one that
    reaches across the volume (hops = n_sp - 1: the whole source)."""
    shape, img_a, img_b, otf, otf_bp = setup
    m = IDENTITY.copy()
    m[3], m[7], m[11] = 1.7, -0.8, shift_z
    hops = PA.zslab_footprint_hops(m, shape, 4)
    assert (hops >= 3) == (shift_z > 10)
    tmx = np.stack([m, IDENTITY])
    batch_a = np.stack([img_a, img_b])
    batch_b = np.stack([img_b, img_a])
    est, ss, st = PS.fusion_step_multichip(_mesh(4, 2), batch_a, batch_b, otf, otf,
                                           otf_bp, otf_bp, tmx, n_iters=2)
    assert tuple(est.shape) == (2, *shape) and ss.dtype == torch.float64
    jest, jss, jst = JS.fusion_step_multichip(JM.make_mesh(n_sp=4, n_dp=2), batch_a,
                                              batch_b, otf, otf, otf_bp, otf_bp, tmx,
                                              n_iters=2)
    _close(est, jest)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5)
    for t in range(2):
        ss0, st0 = PA.corr3d_partials(torch.from_numpy(batch_b[t]),
                                      torch.from_numpy(batch_a[t]), tmx[t])
        np.testing.assert_allclose(float(ss[t]), float(ss0), rtol=1e-5)
        np.testing.assert_allclose(float(st[t]), float(st0), rtol=1e-5)
        _close(est[t], PD.rl_decon_dual(batch_a[t], batch_b[t], otf, otf, otf_bp,
                                        otf_bp, 2, device="cpu"))


def _bead_pair(shape, seed, n, sigma, m_true=None, roll=None):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, dtype=np.float32)
    for _ in range(n):
        z, y, x = (rng.integers(s // 4, 3 * s // 4) for s in shape)
        vol[z, y, x] = rng.uniform(80, 200)
    vol = ndimage.gaussian_filter(vol, sigma).astype(np.float32)
    if roll is not None:
        return vol, np.roll(vol, roll, axis=(0, 1, 2)).astype(np.float32)
    return vol, np.asarray(j_affine(jnp.asarray(vol), m_true, shape))


@pytest.mark.parametrize("method", [1, 7])
def test_reg3d_affine_sharded_matches_jax(method):
    """Method 1 on tests/test_parallel.py's translated pair; method 7 on
    its rotation + z-scale pair, whose search escalates its windows up to
    the whole source. The windows used equal JAX's, and the matrix, NCC
    and registered volume match JAX's sharded search and the port's
    resident host engine (method 7 with room to converge:
    it_limit 3000)."""
    if method == 1:
        vol, moved = _bead_pair((32, 24, 20), 31, 14, 2.0, roll=(2, -1, 1))
        kw = dict(aff_method=1, ftol=1e-4, it_limit=2000)
    else:
        m_true = dof_to_matrix([1.0, -0.5, 2.0, 0.0, 8.0, 5.0, 1.0, 1.0, 1.12], 9)
        vol, moved = _bead_pair((16, 24, 20), 33, 16, 1.8, m_true=m_true)
        kw = dict(aff_method=7, ftol=5e-3, it_limit=3000)
    stats, jstats = {}, {}
    reg, tmx, rec = PS.reg3d_affine_sharded(_mesh(4, 2), vol, moved, stats=stats, **kw)
    jreg, jtmx, jrec = JS.reg3d_affine_sharded(JM.make_mesh(n_sp=4, n_dp=2), vol, moved,
                                               stats=jstats, **kw)
    assert stats["cost_fn_keys"] == jstats["cost_fn_keys"]
    if method == 7:
        keys = stats["cost_fn_keys"]
        assert len(keys) >= 2 and any(full for _, full in keys), keys
    np.testing.assert_allclose(tmx, jtmx, atol=5e-3)
    assert abs(rec[3] - jrec[3]) < 1e-3, (rec[3], jrec[3])
    hreg, htmx, hrec = PR.reg3d_affine(vol, moved, engine="host", device="cpu",
                                       mem_mode=0, **kw)
    np.testing.assert_allclose(tmx, htmx, atol=5e-3)
    assert abs(rec[3] - hrec[3]) < 1e-3, (rec[3], hrec[3])
    assert isinstance(reg, np.ndarray) and reg.shape == vol.shape
    np.testing.assert_allclose(reg, hreg, atol=1e-2)
    if method == 1:
        np.testing.assert_allclose(reg, jreg, atol=1e-2)
    assert rec[3] > 0.9 and rec[5] > 0


def test_make_mesh_devices_and_no_cuda(monkeypatch):
    """Repeated devices fill a mesh row-major; the specs split and gather as
    JAX's place shards, the spectrum's as the sharded RL lays out OTFs; without devices the mesh takes the CUDA devices
    round-robin, and without CUDA it raises (never the CPU)."""
    mesh = PM.make_mesh(4, 2, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "sp": 4} and mesh.axis_names == ("dp", "sp")
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    assert PM.make_mesh(n_dp=2, devices=["cpu"] * 8).shape == {"dp": 2, "sp": 4}
    with pytest.raises(ValueError, match="needs 8 devices"):
        PM.make_mesh(4, 2, devices=["cpu"] * 6)
    x = np.arange(4 * 8 * 2 * 3, dtype=np.float32).reshape(4, 8, 2, 3)
    jmesh = JM.make_mesh(n_sp=4, n_dp=2)
    for spec_fn, arr in ((PM.batch_sharding, x), (PM.volume_sharding, x[0]),
                         (PM.replicated, x[0])):
        sh = spec_fn(mesh)
        blocks = sh.shard(arr)
        jarr = jax.device_put(jnp.asarray(arr), getattr(JM, spec_fn.__name__)(jmesh))
        place = {d: (i, j) for (i, j), d in np.ndenumerate(jmesh.devices)}
        for s in jarr.addressable_shards:
            np.testing.assert_array_equal(blocks[place[s.device]].numpy(), np.asarray(s.data))
        np.testing.assert_array_equal(sh.gather(blocks).numpy(), arr)
    # the spectrum spec is the y split that JAX's sharded RL lays its OTFs
    # out in (_spec_spec), and the port's _spec_shards
    spec = (x.reshape(4, 8, 6) * (1 - 1j)).astype(np.complex64)
    blocks = PM.spectrum_sharding(mesh).shard(spec)
    jspec = jax.device_put(jnp.asarray(spec), jax.sharding.NamedSharding(jmesh, JS._spec_spec()))
    for s in jspec.addressable_shards:
        np.testing.assert_array_equal(blocks[place[s.device]].numpy(), np.asarray(s.data))
    for i in range(2):
        for b, ps in zip(blocks[i], PS._spec_shards(spec, mesh.row(i))):
            np.testing.assert_array_equal(b.numpy(), ps.numpy())
    np.testing.assert_array_equal(PM.spectrum_sharding(mesh).gather(blocks).numpy(), spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    rr = PM.make_mesh(2, 2)
    assert [str(d) for d in rr.devices.ravel()] == ["cuda:0", "cuda:1", "cuda:2", "cuda:0"]
    assert PM.make_mesh().shape == {"dp": 1, "sp": 3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.make_mesh(2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.make_mesh(2, devices=["cuda:0", "cuda:0"])
