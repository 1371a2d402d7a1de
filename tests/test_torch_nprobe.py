"""K6's plain version and the batched line search against the JAX package
on the CPU: ``corr3d_partials_nprobe`` against the JAX N-probe kernel
(interpret mode, K = 8 pinned) on the matrices of
tests/test_affine_fast.py::test_nprobe_batch_matches_gather, the float32
``_linmin_nprobe`` / ``powell_device(cost_batch=...)`` against the lax
versions on analytic costs, and ``MIL_REG_BATCH_LS=1`` registration.

Bounds: the sums rtol 5e-4 (st also atol 1e-3), the JAX test's; the
optimizer's point within 1e-4, f within 1e-6 and the evaluation count
within 10% of JAX's (tests/test_torch_optim.py); the batched finisher's
final NCC within 1e-3 of the serial one (tests/test_registration_grad.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.ops.matrix import dof_to_matrix, identity_tmx
from microimagelib_tpu.ops.pallas_corr import corr3d_partials_nprobe as jax_nprobe
from microimagelib_tpu.ops.powell_device import _linmin_nprobe as jax_linmin_nprobe
from microimagelib_tpu.ops.powell_device import powell_device as jax_powell
from microimagelib_tpu_torch.kernels import corr as K
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.models import registration_device as RD
from microimagelib_tpu_torch.models import registration_grad as RG
from microimagelib_tpu_torch.ops.powell_device import _linmin_nprobe, powell_device
from microimagelib_tpu_torch.ops.corr import corr3d_auto, corr3d_partials_nprobe
from test_affine_fast import vols
from test_registration_grad import _pair
from test_torch_optim import COSTS

torch.set_num_threads(1)


def _probe_matrices():
    base = np.asarray(identity_tmx(), np.float32)
    mats = []
    for t in (-2.0, -0.5, 0.3, 1.0, 2.7):
        m = base.copy()
        m[3] += t
        m[7] += 0.5 * t
        mats.append(m)
    mats.append(np.asarray(dof_to_matrix([0, 0, 0, 35.0, 0, 0, 1, 1, 1], 6),
                           np.float32))
    return np.stack(mats)


def test_nprobe_plain_matches_jax_kernel():
    src, tgt = vols((16, 16, 32), seed=9)
    mats = _probe_matrices()
    ss_j, st_j = jax_nprobe(src, tgt, jnp.asarray(mats), interpret=True, k_mode=8)
    ts, tt = (torch.from_numpy(np.array(v)) for v in (src, tgt))
    ss, st = corr3d_partials_nprobe(ts, tt, mats)
    assert ss.shape == st.shape == (len(mats),) and ss.dtype == torch.float64
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_j), rtol=5e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=5e-4, atol=1e-3)
    # row i is the single-matrix result, bit for bit (one plain loop)
    for i, m in enumerate(mats):
        s1, t1 = corr3d_auto(ts, tt, m)
        assert float(s1) == float(ss[i]) and float(t1) == float(st[i])


def test_nprobe_dispatch_and_counts(monkeypatch):
    """A CPU tensor runs the plain version once per batch (one sync), more
    than K6's 8 matrices included; nothing launches."""
    src, tgt = vols((8, 12, 20), seed=3)
    ts, tt = (torch.from_numpy(np.array(v)) for v in (src, tgt))
    mats = np.concatenate([_probe_matrices()] * 2)          # 12 > MAX_PROBES
    before = (K.PLAIN_CALLS, K.K6_LAUNCHES, K.K5_LAUNCHES)
    rows = K.corr3d_nprobe(ts, tt, torch.from_numpy(mats))
    assert (K.PLAIN_CALLS, K.K6_LAUNCHES, K.K5_LAUNCHES) == \
        (before[0] + 1, before[1], before[2])
    assert rows.shape == (12, 2)
    np.testing.assert_array_equal(rows[:6].numpy(), rows[6:].numpy())
    for impl in ("pallas", "gather"):
        ss, st = corr3d_partials_nprobe(ts, tt, mats, impl=impl)
        np.testing.assert_array_equal(torch.stack([ss, st], 1).numpy(), rows.numpy())
    with pytest.raises(ValueError, match="N, 12"):
        K.corr3d_nprobe(ts, tt, mats[:, :9])
    with pytest.raises(ValueError):
        corr3d_partials_nprobe(ts, tt, mats, impl="mxu-only")


@pytest.mark.parametrize("name", list(COSTS))
def test_linmin_nprobe_matches_jax(name):
    make, p0 = COSTS[name]
    n = p0.shape[0]
    xi = np.linspace(0.4, 1.3, n).astype(np.float32)
    batch_np = (lambda f: (lambda ps: np.array([f(p) for p in ps], np.float32)))(make(np))
    fret = np.float32(make(np)(p0))
    jp, jxi, jf, jn = jax.jit(lambda p, x, f: jax_linmin_nprobe(
        jax.vmap(make(jnp)), p, x, f))(jnp.asarray(p0), jnp.asarray(xi), jnp.float32(fret))
    p, xi2, f, nev = _linmin_nprobe(batch_np, p0, xi, fret)
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(xi2, np.asarray(jxi), atol=1e-5)
    assert abs(float(f) - float(jf)) <= 1e-6 and nev == int(jn) == 32


@pytest.mark.parametrize("name", list(COSTS))
@pytest.mark.parametrize("max_sweeps", [None, 1])
def test_powell_cost_batch_matches_jax(name, max_sweeps):
    make, p0 = COSTS[name]
    ftol, it_limit = 1e-6, 3000
    jp, jf, jn = jax.jit(lambda x: jax_powell(
        make(jnp), x, ftol, it_limit, cost_batch=jax.vmap(make(jnp)),
        max_sweeps=max_sweeps))(jnp.asarray(p0))
    f_np = make(np)
    calls = {"single": 0, "batch": 0, "probes": 0}

    def cost(p):
        calls["single"] += 1
        return np.float32(f_np(np.asarray(p, np.float32)))

    def cost_batch(ps):
        calls["batch"] += 1
        calls["probes"] += len(ps)
        return np.array([f_np(p) for p in ps], np.float32)

    p, f, n = powell_device(cost, p0, ftol, it_limit, cost_batch=cost_batch,
                            max_sweeps=max_sweeps)
    assert n == calls["single"] + calls["probes"]   # every evaluation is counted
    assert calls["probes"] == 8 * calls["batch"]
    # the bowl starts above the 1.001 abort; the well searches in batches
    assert (calls["batch"] >= 4) == (name == "well")
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-4)
    assert abs(float(f) - float(jf)) <= 1e-6
    assert n <= int(jn) * 1.1


@pytest.fixture(scope="module")
def pair():
    return _pair(shape=(16, 24, 20))


@pytest.mark.parametrize("engine", ["grad", "device"])
def test_batch_ls_registration_reaches_serial_ncc(pair, monkeypatch, engine):
    """MIL_REG_BATCH_LS=1: the line minimizations run as 8-probe batched
    cost calls; the final NCC matches the serial search's within 1e-3."""
    vol, moved = pair
    _, tmx_s, rec_s = R.reg3d_affine(vol, moved, aff_method=7, mem_mode=0,
                                     engine=engine)
    calls = []
    real = RD._make_cost_batch

    def counting(*args, **kw):
        fn = real(*args, **kw)

        def wrapped(m12s):
            calls.append(len(m12s))
            return fn(m12s)
        return wrapped

    monkeypatch.setattr(RD, "_make_cost_batch", counting)
    monkeypatch.setattr(RG, "_make_cost_batch", counting)
    monkeypatch.setenv("MIL_REG_BATCH_LS", "1")
    reg, tmx_b, rec_b = R.reg3d_affine(vol, moved, aff_method=7, mem_mode=0,
                                       engine=engine)
    assert calls and set(calls) == {8}
    assert rec_b[3] >= rec_s[3] - 1e-3, (rec_b[3], rec_s[3])
    assert R.checkmatrix(tmx_b, *vol.shape[::-1])
    assert reg.shape == vol.shape


def test_batch_ladder_kernel_route_matches_plain_route(pair):
    """The ladder's batched cost on the kernel route (corr3d_partials_nprobe,
    one call per batch: K6 on a card, its plain version here) and on the
    plain route (the same call's gather branch) walk the same points."""
    vol, moved = pair
    src, tgt, _se2, st2 = R._reg_stats(torch.from_numpy(moved), torch.from_numpy(vol))
    sd_t = float(np.sqrt(st2))
    p0 = R.matrix_to_params(identity_tmx().astype(np.float64))
    before = K.PLAIN_CALLS
    out_k = RD.reg_ladder_device(src, tgt, sd_t, p0, 6, 1e-4, 3000,
                                 ncc_impl="pallas", batch_ls=True)
    n_kernel_route = K.PLAIN_CALLS - before
    out_p = RD.reg_ladder_device(src, tgt, sd_t, p0, 6, 1e-4, 3000,
                                 ncc_impl="gather", batch_ls=True)
    n_plain_route = K.PLAIN_CALLS - before - n_kernel_route
    np.testing.assert_array_equal(out_k[0], out_p[0])
    assert out_k[1] == out_p[1] and out_k[3] == out_p[3]
    # one plain call per batched cost call, one per single evaluation
    assert 0 < n_kernel_route < out_k[3]
    assert n_plain_route == n_kernel_route
