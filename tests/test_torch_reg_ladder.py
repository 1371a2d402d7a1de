"""K9's optimizer source (``csrc/reg_opt.cuh``), built for the host
(``native/reg_opt.py``, g++), against the JAX package on the CPU, and the
ladder's route.

* The L-BFGS and Powell stages against JAX's ``lbfgs_minimize`` and
  ``powell_device`` on the bowl and well costs of tests/test_torch_optim.py,
  with its bounds: the point within 1e-4, f within 1e-6, no more than 1.1x
  JAX's evaluations; the it_limit cap and the 1.001 abort.
* The matrix builders and their Jacobians at 3, 6, 7, 9 and 12 parameters
  against ``dof_to_matrix_jnp`` / ``params_to_matrix_jnp`` and
  ``jax.jacfwd``, within 1e-6; their reverse-mode pullback against the
  host loop's torch autograd, bit for bit. Their sines and cosines
  (``csrc/torch_trig.cuh``) are torch's CPU float32 ones, bit for bit, and
  so are their 3 x 3 products.
* The whole ladder, methods 1, 5 and 7 on both engines, on the (16, 24, 20)
  pair of tests/test_torch_registration.py, through the port's plain K4/K5
  as its sums: against JAX's ``reg3d_affine`` with that file's bounds (NCC
  within 1e-3, translations within 0.35 voxel, evaluations at most 1.25x
  JAX's + 10), and within 1e-4 NCC of the port's host loop; methods 2, 5
  and 7 repeat the host loop bit for bit.

K9 itself (the card) is tested in tests/test_torch_kernels.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.models.registration import reg3d_affine as jax_reg3d_affine
from microimagelib_tpu.models.registration_device import (
    dof_to_matrix_jnp,
    params_to_matrix_jnp,
)
from microimagelib_tpu.ops.lbfgs import lbfgs_minimize as jax_lbfgs
from microimagelib_tpu.ops.powell_device import powell_device as jax_powell
from microimagelib_tpu_torch.kernels import corr as K
from microimagelib_tpu_torch.kernels import reg_ladder as RL
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.models import registration_device as RD
from microimagelib_tpu_torch.models import registration_grad as RG
from microimagelib_tpu_torch.native import reg_opt as H
from microimagelib_tpu_torch.ops.matrix import matrix_to_params
from test_registration_grad import _pair
from test_torch_optim import COSTS, _counted, _np_grad

torch.set_num_threads(1)

SHAPE = (16, 24, 20)
IDENTITY = np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float64)


@pytest.mark.parametrize("name", list(COSTS))
@pytest.mark.parametrize("max_sweeps", [None, 1])
def test_powell_matches_jax(name, max_sweeps):
    make, p0 = COSTS[name]
    ftol, it_limit = 1e-6, 3000
    jp, jf, jn = jax.jit(lambda x: jax_powell(make(jnp), x, ftol, it_limit,
                                              max_sweeps=max_sweeps))(jnp.asarray(p0))
    cost, calls = _counted(make(np))
    p, f, n = H.powell(cost, p0, ftol, it_limit, max_sweeps=max_sweeps)
    assert n == calls[0]                    # every evaluation is counted
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-4)
    assert abs(float(f) - float(jf)) <= 1e-6
    assert n <= int(jn) * 1.1


@pytest.mark.parametrize("name", list(COSTS))
def test_lbfgs_matches_jax(name):
    make, p0 = COSTS[name]
    ftol, it_limit = 1e-7, 500
    jp, jf, jn = jax.jit(lambda x: jax_lbfgs(jax.value_and_grad(make(jnp)), x,
                                             ftol, it_limit, max_iters=200,
                                             patience=3))(jnp.asarray(p0))
    f_np, g_np = make(np), _np_grad(name)
    calls = [0]

    def vg(p):
        calls[0] += 1
        return np.float32(f_np(p)), g_np(p)

    p, f, n = H.lbfgs(vg, p0, ftol, it_limit, max_iters=200, patience=3)
    assert n == calls[0]
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-4)
    assert abs(float(f) - float(jf)) <= 1e-6
    assert n <= int(jn) * 1.1


def test_lbfgs_solves_quadratic():
    a = np.diag([1.0, 10.0, 100.0]).astype(np.float32)

    def vg(p):
        return np.float32(0.5 * p @ a @ p - p.sum()), (a @ p - 1).astype(np.float32)

    p, _fmin, nev = H.lbfgs(vg, np.zeros(3, np.float32), 1e-10, 200)
    np.testing.assert_allclose(p, [1.0, 0.1, 0.01], atol=1e-3)
    assert nev < 200


def test_it_limit_and_abort():
    """The shared evaluation cap stops Powell and L-BFGS between line
    searches; a cost >= 1.001 at the start stops both at once."""
    cost, calls = _counted(COSTS["well"][0](np))
    _, _, n = H.powell(cost, np.zeros(4, np.float32), 1e-12, 25)
    assert 25 <= n == calls[0] < 25 + 80     # one line search past the cap
    _, f, n = H.powell(lambda p: np.float32(2.0), np.zeros(2, np.float32), 1e-4, 100,
                       nev0=7)
    assert n == 8 and f == np.float32(2.0)
    _, _, n = H.lbfgs(lambda p: (np.float32(1.5), np.ones(2, np.float32)),
                      np.zeros(2, np.float32), 1e-4, 100)
    assert n == 1


def _stage_params(ndof, seed):
    rng = np.random.default_rng(seed)
    if ndof == 12:
        p = matrix_to_params(IDENTITY).astype(np.float32)
        return p + rng.normal(0, 0.05, 12).astype(np.float32) * \
            np.r_[[20.0] * 3, [1.0] * 9].astype(np.float32)
    p = np.zeros(ndof, np.float32)
    p[:3] = rng.uniform(-2, 2, 3)
    if ndof >= 6:
        p[3:6] = rng.uniform(-10, 10, 3)       # degrees
    if ndof >= 7:
        p[6:] = rng.uniform(0.9, 1.1, ndof - 6)
    return p


def _jax_stage_matrix(ndof):
    if ndof == 12:
        return params_to_matrix_jnp

    def fn(p):
        full = jnp.concatenate([p, jnp.asarray([0.0] * 6 + [1.0] * 3, jnp.float32)[ndof:]])
        return dof_to_matrix_jnp(full, ndof)
    return fn


@pytest.mark.parametrize("ndof", [3, 6, 7, 9, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_stage_matrix_and_jacobian_match_jax(ndof, seed):
    p = _stage_params(ndof, seed)
    m, jac = H.stage_matrix(p, ndof)
    fn = _jax_stage_matrix(ndof)
    jm = np.asarray(jax.jit(fn)(jnp.asarray(p)))
    jj = np.asarray(jax.jit(jax.jacfwd(fn))(jnp.asarray(p)))
    np.testing.assert_allclose(m, jm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(jac, jj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ndof", [3, 6, 7, 9, 12])
def test_stage_pullback_is_the_host_loops_autograd(ndof):
    """The L-BFGS stages' gradient: the matrix and the pullback of a matrix
    gradient through the builders equal the host loop's torch autograd bit
    for bit (the sines and cosines are torch's, torch_trig.cuh)."""
    rng = np.random.default_rng(ndof)
    for _ in range(60):
        p = _stage_params(ndof, int(rng.integers(1 << 30)))
        gm = rng.normal(0, 1e-3, 12).astype(np.float32)
        pt = torch.from_numpy(p).requires_grad_(True)
        with torch.enable_grad():
            m_t = (RD.params_to_matrix_t(pt) if ndof == 12
                   else RD.dof_to_matrix_t(RD._full_dof(pt, ndof), ndof))
            gp_t, = torch.autograd.grad((m_t * torch.from_numpy(gm)).sum(), pt)
        m_c, gp_c = H.stage_pullback(p, ndof, gm)
        np.testing.assert_array_equal(m_c, m_t.detach().numpy())
        np.testing.assert_array_equal(gp_c, gp_t.numpy())


def _trig_angles():
    """Angles of the ladder's range: normal at several scales, uniform in
    (-1, 1), the degrees a DOF stage steps by over 57.3, and zeros."""
    rng = np.random.default_rng(17)
    parts = [rng.normal(0, s, 200_000) for s in (1e-3, 1e-2, 0.05, 0.2)]
    parts.append(rng.uniform(-1, 1, 400_000))
    deg = rng.uniform(-45, 45, 200_000).astype(np.float32)
    parts.append(deg / np.float32(57.3))
    parts.append(np.array([0.0, -0.0, 2.0 ** -12, -(2.0 ** -12), 0.5, np.float32(np.pi / 4)]))
    return np.concatenate([np.asarray(q, np.float32) for q in parts])


def test_torch_trig_is_torchs():
    """The matrix builders' sine and cosine (csrc/torch_trig.cuh, which K9
    and the host build share) are torch's CPU float32 torch.sin /
    torch.cos, bit for bit, on 1.2 million angles below 1 rad."""
    x = _trig_angles()
    sn, cs = H.torch_trig(x)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(sn.view(np.int32), torch.sin(t).numpy().view(np.int32))
    np.testing.assert_array_equal(cs.view(np.int32), torch.cos(t).numpy().view(np.int32))


def test_trig_header_is_its_tools_model():
    """tools/torch_trig_fit.py's reading of csrc/torch_trig.cuh (its
    windows' model with its exceptions) gives the host build's values and
    torch's, on angles of each window of the header."""
    from microimagelib_tpu_torch.tools import torch_trig_fit as T

    rng = np.random.default_rng(29)
    for name, (rows, keys, vals) in T.read_header(T.HEADER).items():
        assert rows[0][0] == T.LOW and rows[-1][1] == T.LIMIT
        assert all(r[1] == q[0] for r, q in zip(rows, rows[1:]))
        assert np.all(np.diff(keys.astype(np.int64)) > 0)
        picks = rng.choice(len(rows), 64, replace=False)
        # float32 angles inside each picked window [a, b)
        x = np.concatenate([np.minimum(rng.uniform(rows[i][0], rows[i][1], 64).astype(np.float32),
                                       np.nextafter(np.float32(rows[i][1]), np.float32(0)))
                            for i in picks] + [keys[:64].view(np.float32)])
        got = np.empty_like(x)
        for i in picks:
            a, b, c = rows[i]
            inside = (x >= a) & (x < b)
            got[inside] = T.with_exceptions(x[inside], T.model(name, x[inside], a, b, c),
                                            keys, vals)
        got[-min(64, keys.size):] = vals[:64].view(np.float32)
        sn, cs = H.torch_trig(x)
        np.testing.assert_array_equal(got, sn if name == "sin" else cs)
        np.testing.assert_array_equal(got, T.torch_f32(name, x))


def test_torch_3x3_products_take_the_order_reg_opt_assumes():
    """reg_opt.cuh's compose and its backward repeat torch's 3 x 3 products
    as the host loop's builders and autograd take them (A @ B a fused
    multiply-add chain over k, G @ B^T rounded product by product and summed
    in k order 0, 2, 1). A failure here means this torch build multiplies
    3 x 3 matrices in another order, and the ladder tests that compare K9's
    arithmetic with the host loop's bit for bit cannot hold."""
    rng = np.random.default_rng(23)
    for _ in range(300):
        a = rng.normal(size=(3, 4)).astype(np.float32)
        b = rng.normal(size=(3, 4)).astype(np.float32)
        b[:, 3] = 0.0           # every right factor the builders compose with
        g = rng.normal(size=(3, 4)).astype(np.float32)
        at = torch.from_numpy(a.reshape(12)).requires_grad_(True)
        bt = torch.from_numpy(b.reshape(12)).requires_grad_(True)
        with torch.enable_grad():
            o = RD._compose(at, bt)
            ga, gb = torch.autograd.grad((o * torch.from_numpy(g.reshape(12))).sum(), (at, bt))
        o_c, ga_c, gb_c = H.compose(a, b, g)
        np.testing.assert_array_equal(o_c, o.detach().numpy().reshape(3, 4))
        np.testing.assert_array_equal(ga_c, ga.numpy().reshape(3, 4))
        np.testing.assert_array_equal(gb_c, gb.numpy().reshape(3, 4)[:, :3])


@pytest.mark.parametrize("engine", ["grad", "device"])
@pytest.mark.parametrize("finish", [True, False])
@pytest.mark.parametrize("method", [1, 2, 3, 4, 5, 6, 7])
def test_stage_plan(engine, finish, method):
    """The stages K9 launches: the host mirror's count, the ladder's DOF
    steps, the L-BFGS stages then the finisher on the grad engine, and the
    stage ftols 0.01 / 0.01 / 0.005 / ftol; with batch_ls the Powell stages
    (the grad engine's finisher alone) on K6's sums (body 2), the L-BFGS
    stages still on K4's (body 1), the device engine's otherwise on K5's
    (body 0)."""
    for batch_ls in (False, True):
        args = RL.ladder_args(engine, method, matrix_to_params(IDENTITY), 1e-4, 3000, 1.0,
                              SHAPE, finish=finish, finish_sweeps=1, batch_ls=batch_ls)
        st = H.stages(args)
        assert len(st) == RL.stage_count(args)
        ndofs = {1: [3], 2: [6], 3: [7], 4: [9], 5: [12], 6: [6, 12], 7: [3, 6, 9, 12]}[method]
        ftols = {1: [100], 6: [10000, 100], 7: [10000, 10000, 5000, 100]}.get(method, [100])
        powell = 2 if batch_ls else 0
        kind = 1 if engine == "grad" else powell
        want = [(kind, n, i, 0, f, 0) for i, (n, f) in enumerate(zip(ndofs, ftols))]
        if engine == "grad" and finish:
            want.append((powell, ndofs[-1], len(ndofs) - 1, 1, 100, 0))
        assert st == want


@pytest.fixture(scope="module")
def pair():
    vol, moved = _pair(shape=SHAPE)
    img1, img2 = torch.from_numpy(np.asarray(vol)), torch.from_numpy(np.asarray(moved))
    src_ms, tgt_ms, _se2, st2 = R._reg_stats(img2, img1)
    return vol, moved, src_ms, tgt_ms, float(np.sqrt(st2))


@pytest.mark.parametrize("engine", ["grad", "device"])
@pytest.mark.parametrize("method", [1, 5, 7])
def test_ladder_matches_jax(pair, method, engine):
    vol, moved, src_ms, tgt_ms, sd_t = pair
    _, jtmx, jrec = jax_reg3d_affine(vol, moved, aff_method=method, ftol=1e-4,
                                     it_limit=3000, engine=engine)
    p_init = matrix_to_params(IDENTITY)
    args = RL.ladder_args(engine, method, p_init, 1e-4, 3000, sd_t, SHAPE, finish=True,
                          finish_sweeps=1)
    evals = [0, 0]

    def sums(m, grad):
        evals[grad] += 1
        return K.corr3d_torch(src_ms, tgt_ms, m, grad).numpy()

    st = H.ladder(args, sums)
    aff = np.array(st.aff, np.float32)
    assert list(st.evals) == evals + [0] and st.nev == sum(evals)
    assert abs(-st.fret - jrec[3]) <= 1e-3, (-st.fret, jrec[3])
    np.testing.assert_allclose(aff[[3, 7, 11]], jtmx[[3, 7, 11]], atol=0.35)
    assert R.checkmatrix(aff, SHAPE[2], SHAPE[1], SHAPE[0])
    assert 0 < st.nev <= 1.25 * jrec[5] + 10
    # the K4 sums only in L-BFGS stages, the K5 sums only in Powell stages
    assert (evals[1] > 0) == (engine == "grad") and evals[0] > 0
    # the port's host loop (K9's plain version) from the same start
    h_aff, h_fret, h_stage, h_nev = RG.reg_ladder_host(src_ms, tgt_ms, sd_t, p_init, method,
                                                       1e-4, 3000, engine, True, 1)
    assert abs(float(st.fret) - float(h_fret)) <= 1e-4
    np.testing.assert_allclose(np.array(st.stage_costs), h_stage, atol=1e-4)
    assert st.nev <= 1.25 * h_nev + 10
    if method == 1:
        np.testing.assert_allclose(aff.reshape(3, 4)[:, :3], np.eye(3), atol=1e-6)


def _numpy_dot_sums_products_in_float64():
    """True where numpy's float32 dot rounds each product to float32 and
    sums them in float64 (OpenBLAS's sdot), as reg_opt.cuh's dot does."""
    rng = np.random.default_rng(5)
    for n in (3, 9, 12):
        for _ in range(50):
            a, b = (rng.normal(size=n).astype(np.float32) for _ in range(2))
            want = np.float32(sum(np.float64(np.float32(x * y)) for x, y in zip(a, b)))
            if np.dot(a, b) != want:
                return False
    return True


def _repeats_the_host_loop(pair, engine, method, monkeypatch):
    """The C++ ladder makes the host loop's evaluations, matrix for matrix,
    and ends at its point bit for bit."""
    if engine == "grad" and not _numpy_dot_sums_products_in_float64():
        pytest.skip("numpy's float32 dot does not sum its products in float64 here")
    _vol, _moved, src_ms, tgt_ms, sd_t = pair
    p_init = matrix_to_params(IDENTITY)
    mats = []

    def sums(m, grad):
        mats.append((m.copy(), grad))
        return K.corr3d_torch(src_ms, tgt_ms, m, grad).numpy()

    args = RL.ladder_args(engine, method, p_init, 1e-4, 3000, sd_t, SHAPE, finish=True,
                          finish_sweeps=1)
    st = H.ladder(args, sums)
    host = []
    orig = K.plain

    def recorded(src, tgt, tmx, grad=False):
        host.append((np.asarray(tmx, np.float32).copy(), bool(grad)))
        return orig(src, tgt, tmx, grad)

    monkeypatch.setattr(K, "plain", recorded)
    aff, fret, stage, nev = RG.reg_ladder_host(src_ms, tgt_ms, sd_t, p_init, method, 1e-4,
                                               3000, engine, True, 1)
    assert len(mats) == len(host) == st.nev == nev
    for (m, g), (hm, hg) in zip(mats, host):
        assert g == hg
        np.testing.assert_array_equal(m, hm)
    assert np.float32(st.fret) == fret
    np.testing.assert_array_equal(np.array(st.aff, np.float32), aff)
    np.testing.assert_array_equal(np.array(st.stage_costs, np.float32), stage)


@pytest.mark.parametrize("engine", ["grad", "device"])
def test_matrix_parameter_ladder_repeats_the_host_loop(pair, engine, monkeypatch):
    """Method 5 (the pyramid's mid and full levels): the C++ ladder makes
    the host loop's evaluations, matrix for matrix, and ends at its point
    bit for bit: the same float32 operations, numpy's dot and pairwise
    sum, and autograd's gradient chain."""
    _repeats_the_host_loop(pair, engine, 5, monkeypatch)


@pytest.mark.parametrize("engine", ["grad", "device"])
@pytest.mark.parametrize("method", [2, 7])
def test_dof_ladder_repeats_the_host_loop(pair, engine, method, monkeypatch):
    """Methods 2 (6 DOF) and 7 (3, 6 and 9 DOF, then 12 parameters: the
    pyramid's coarse level): the DOF stages too repeat the host loop bit for
    bit, their rotations built from torch's sines and cosines
    (csrc/torch_trig.cuh)."""
    _repeats_the_host_loop(pair, engine, method, monkeypatch)


def test_ladder_angles_take_torchs_trig(pair, monkeypatch):
    """Every angle the host loop's method-7 ladders build a rotation from
    (both engines) gets torch's sine and cosine from csrc/torch_trig.cuh."""
    _vol, _moved, src_ms, tgt_ms, sd_t = pair
    angles = []
    for name in ("_rz", "_rx", "_ry"):
        orig = getattr(RD, name)

        def recorded(a, orig=orig):
            angles.append(float(a.detach()))
            return orig(a)

        monkeypatch.setattr(RD, name, recorded)
    for engine in ("grad", "device"):
        RG.reg_ladder_host(src_ms, tgt_ms, sd_t, matrix_to_params(IDENTITY), 7, 1e-4, 3000,
                           engine, True, 1)
    x = np.array(angles, np.float32)
    x = x[x != 0]
    assert x.size > 100
    sn, cs = H.torch_trig(x)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(sn, torch.sin(t).numpy())
    np.testing.assert_array_equal(cs, torch.cos(t).numpy())


def test_ladder_it_limit(pair):
    """A small it_limit caps the C++ ladder as it caps the host loop: the
    cap is checked between line searches, and each of the four stages
    starts with one evaluation."""
    _vol, _moved, src_ms, tgt_ms, sd_t = pair
    for engine in ("grad", "device"):
        args = RL.ladder_args(engine, 7, matrix_to_params(IDENTITY), 1e-4, 40, sd_t, SHAPE)
        st = H.ladder(args, lambda m, g: K.corr3d_torch(src_ms, tgt_ms, m, g).numpy())
        assert 0 < st.nev <= 40 + 5 * 60, engine


def test_cpu_pair_and_gather_take_the_host_loop(pair, monkeypatch):
    """A CPU pair, and the gather route, run the host loop (K9's plain
    version); only a CUDA pair on the kernel route takes K9."""
    vol, moved, _src, _tgt, _sd = pair
    launches, plain = RL.K9_LAUNCHES, RG.HOST_LADDERS + RD.HOST_LADDERS
    for engine in ("grad", "device"):
        R.reg3d_affine(vol, moved, aff_method=1, engine=engine, mem_mode=0, want_reg=False)
    assert RG.HOST_LADDERS + RD.HOST_LADDERS - plain == 2 and RL.K9_LAUNCHES == launches
    cuda_pair = types.SimpleNamespace(is_cuda=True, device=types.SimpleNamespace(type="cuda"))
    assert RD.on_kernel_route(cuda_pair)
    assert not RD.on_kernel_route(cuda_pair, "gather")
    assert not RD.on_kernel_route(torch.zeros(2, 2, 2))
    monkeypatch.setenv("MIL_NCC_IMPL", "gather")
    assert not RD.on_kernel_route(cuda_pair)


def test_reg_ladder_raises_off_cpu_and_cuda():
    """The wrapper checks its pair as K4/K5's do, and a CPU pair raises
    (K9 runs on the card only; a CPU pair's ladder is the host loop)."""
    a = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="differ in shape"):
        RL.reg_ladder(a, torch.zeros((16, 24, 21)), 1.0, np.zeros(12), 1, 1e-4, 10)
    with pytest.raises(ValueError, match="CUDA"):
        RL.launch(a, a, RL.ladder_args("grad", 1, np.zeros(12), 1e-4, 10, 1.0, SHAPE))
    with pytest.raises(ValueError, match="CUDA"):
        RL.reg_ladder(a, a, 1.0, np.zeros(12), 1, 1e-4, 10)
    with pytest.raises(ValueError, match="engine"):
        RL.ladder_args("host", 1, np.zeros(12), 1e-4, 10, 1.0, SHAPE)
