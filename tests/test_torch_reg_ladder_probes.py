"""K9's probe stages and line stage in ``csrc/reg_opt.cuh``, built for the
host (``native/reg_opt.py``, g++), against the JAX package on the CPU and
against the port's host loop, and their route.

* (a) The 8-probe line search (``linmin_nprobe``) against JAX's
  ``_linmin_nprobe`` on the analytic costs of tests/test_torch_optim.py at
  tests/test_torch_nprobe.py's atol 1e-5, and against the port's host
  ``_linmin_nprobe`` bit for bit.
* (b) Powell with the probe line search against JAX ``powell_device(...,
  cost_batch=...)`` at atol 1e-4 (f within 1e-6, evaluations within 10%),
  ``max_sweeps`` None and 1; against the host loop bit for bit.
* (c) The whole ``batch_ls`` ladder, both engines, methods 7 and 5, on the
  (16, 24, 20) pair of tests/test_torch_reg_ladder.py with sums from K6's
  and K4/K5's plain versions: it repeats ``reg_ladder_*_host(batch_ls=True)``
  bit for bit, matrix for matrix, and its NCC is within 1e-3 of JAX's
  ``MIL_REG_BATCH_LS=1`` ladder (tests/test_registration_grad.py's bound).
* (d) The line stage for each of dof3, dof6, dof7, dof9 and p12: the host
  loop's ``_linmin`` bit for bit, and JAX's jitted ``linmin_reg_device``
  within 1e-4.
* (e) The route: a CUDA pair on the kernel route sends ``batch_ls`` ladders
  and every line of the hybrid engine to K9; a CPU pair runs the host loop.
* (f) The stage plan of the line stage and of the ``batch_ls`` ladders
  (tests/test_torch_reg_ladder.py::test_stage_plan holds the latter too).

K9 itself (the card) is tested in tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microimagelib_tpu.models.registration import reg3d_affine as jax_reg3d_affine
from microimagelib_tpu.models.registration_device import (
    linmin_reg_device as jax_linmin_reg_device,
)
from microimagelib_tpu.ops.powell_device import _linmin_nprobe as jax_linmin_nprobe
from microimagelib_tpu.ops.powell_device import powell_device as jax_powell
from microimagelib_tpu_torch.kernels import corr as K
from microimagelib_tpu_torch.kernels import reg_ladder as RL
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.models import registration_device as RD
from microimagelib_tpu_torch.models import registration_grad as RG
from microimagelib_tpu_torch.native import reg_opt as H
from microimagelib_tpu_torch.ops.matrix import matrix_to_params
from microimagelib_tpu_torch.ops.powell_device import _linmin, _linmin_nprobe, powell_device
from test_registration_grad import _pair
from test_torch_optim import COSTS

torch.set_num_threads(1)

SHAPE = (16, 24, 20)
IDENTITY = np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float64)
MODES = ("dof3", "dof6", "dof7", "dof9", "p12")


def _batch(f):
    return lambda ps: np.array([f(p) for p in ps], np.float32)


def _equal(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", list(COSTS))
@pytest.mark.parametrize("scale", [1.0, 0.05, 7.0])
def test_linmin_nprobe_matches_jax_and_the_host_loop(name, scale):
    """(a) The probe search: JAX's within 1e-5, the host loop's bit for bit
    (short, unit and long directions: the edge expansions too)."""
    make, p0 = COSTS[name]
    n = p0.shape[0]
    xi = (np.linspace(0.4, 1.3, n) * scale).astype(np.float32)
    f = make(np)
    fret = np.float32(f(p0))
    jp, jxi, jf, jn = jax.jit(lambda p, x, fr: jax_linmin_nprobe(
        jax.vmap(make(jnp)), p, x, fr))(jnp.asarray(p0), jnp.asarray(xi), jnp.float32(fret))
    p, xi2, f2, nev = H.linmin_nprobe(_batch(f), p0, xi, fret)
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(xi2, np.asarray(jxi), atol=1e-5)
    assert abs(float(f2) - float(jf)) <= 1e-5 and nev == int(jn) == 32
    host = _linmin_nprobe(_batch(f), p0, xi, fret)
    assert all(_equal(a, b) for a, b in zip((p, xi2, f2, nev), host))
    assert np.asarray(host[2]).dtype == f2.dtype == np.float32


@pytest.mark.parametrize("name", list(COSTS))
@pytest.mark.parametrize("max_sweeps", [None, 1])
def test_powell_probes_matches_jax_and_the_host_loop(name, max_sweeps):
    """(b) Powell over the probe search: JAX's within 1e-4 (f within 1e-6,
    no more than 1.1x its evaluations), the host loop's bit for bit, every
    evaluation counted (8 a probe pass)."""
    make, p0 = COSTS[name]
    ftol, it_limit = 1e-6, 3000
    jp, jf, jn = jax.jit(lambda x: jax_powell(
        make(jnp), x, ftol, it_limit, cost_batch=jax.vmap(make(jnp)),
        max_sweeps=max_sweeps))(jnp.asarray(p0))
    f = make(np)
    calls = {"single": 0, "probes": 0}

    def cost(p):
        calls["single"] += 1
        return np.float32(f(np.asarray(p, np.float32)))

    def cost_batch(ps):
        calls["probes"] += len(ps)
        return _batch(f)(ps)

    p, fr, n = H.powell(cost, p0, ftol, it_limit, max_sweeps=max_sweeps,
                        cost_batch=cost_batch)
    assert n == calls["single"] + calls["probes"]
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-4)
    assert abs(float(fr) - float(jf)) <= 1e-6
    assert n <= int(jn) * 1.1
    hp, hf, hn = powell_device(lambda q: np.float32(f(np.asarray(q, np.float32))), p0, ftol,
                               it_limit, cost_batch=_batch(f), max_sweeps=max_sweeps)
    assert _equal(p, hp) and fr == hf and n == hn


def test_powell_probes_it_limit_and_abort():
    """The evaluation cap counts 8 a probe pass and is checked where the
    host loop checks it; a start above the 1.001 abort stops at once."""
    f = COSTS["well"][0](np)
    cost = lambda p: np.float32(f(np.asarray(p, np.float32)))   # noqa: E731
    for cap in (10, 40, 100):
        got = H.powell(cost, np.zeros(4, np.float32), 1e-12, cap, cost_batch=_batch(f))
        want = powell_device(cost, np.zeros(4, np.float32), 1e-12, cap, cost_batch=_batch(f))
        assert _equal(got[0], want[0]) and got[2] == want[2] and cap <= got[2] < cap + 8 * 4 * 2
    _, fr, n = H.powell(lambda p: np.float32(2.0), np.zeros(2, np.float32), 1e-4, 100, nev0=7,
                        cost_batch=_batch(lambda p: 2.0))
    assert n == 8 and fr == np.float32(2.0)


@pytest.fixture(scope="module")
def pair():
    vol, moved = _pair(shape=SHAPE)
    img1, img2 = torch.from_numpy(np.asarray(vol)), torch.from_numpy(np.asarray(moved))
    src_ms, tgt_ms, _se2, st2 = R._reg_stats(img2, img1)
    return vol, moved, src_ms, tgt_ms, float(np.sqrt(st2))


def _recorder(src_ms, tgt_ms, log):
    """The host build's sums (K4/K5's and K6's plain versions), each call
    logged as (matrices, kind)."""
    def sums(m, grad):
        log.append((np.asarray(m, np.float32).reshape(1, 12).copy(), int(bool(grad))))
        return K.corr3d_torch(src_ms, tgt_ms, m, grad).numpy()

    def probes(ms):
        log.append((np.asarray(ms, np.float32).copy(), 2))
        return K.corr3d_nprobe_torch(src_ms, tgt_ms, ms).numpy()

    return sums, probes


@pytest.mark.parametrize("engine", ["grad", "device"])
@pytest.mark.parametrize("method", [5, 7])
def test_batch_ls_ladder_repeats_the_host_loop(pair, engine, method, monkeypatch):
    """(c) The batch_ls ladder makes the host loop's evaluations, matrix
    for matrix (each probe pass its K6 call's 8 matrices), and ends at its
    point bit for bit."""
    _vol, _moved, src_ms, tgt_ms, sd_t = pair
    p_init = matrix_to_params(IDENTITY)
    log = []
    sums, probes = _recorder(src_ms, tgt_ms, log)
    args = RL.ladder_args(engine, method, p_init, 1e-4, 3000, sd_t, SHAPE, finish=True,
                          finish_sweeps=1, batch_ls=True)
    st = H.ladder(args, sums, probes)
    host = []
    orig, orig_n = K.plain, K.plain_nprobe

    def rec(src, tgt, tmx, grad=False):
        host.append((np.asarray(tmx, np.float32).reshape(1, 12).copy(), int(bool(grad))))
        return orig(src, tgt, tmx, grad)

    def rec_n(src, tgt, ms):
        host.append((np.asarray(ms, np.float32).copy(), 2))
        return orig_n(src, tgt, ms)

    monkeypatch.setattr(K, "plain", rec)
    monkeypatch.setattr(K, "plain_nprobe", rec_n)
    aff, fret, stage, nev = RG.reg_ladder_host(src_ms, tgt_ms, sd_t, p_init, method, 1e-4,
                                               3000, engine, True, 1, batch_ls=True)
    # the probe stages' single evaluations are K6 passes of one matrix in
    # K9 (K5's bits), K5 calls in the host loop
    kinds = [k for _m, k in log]
    assert kinds.count(2) == st.evals[2] > 0 and kinds.count(1) == st.evals[1]
    assert len(log) == len(host) == sum(st.evals)
    assert st.nev == nev == sum(m.shape[0] for m, _k in log)
    for (m, k), (hm, hk) in zip(log, host):
        assert k == hk or (k == 2 and hk == 0 and m.shape[0] == 1)
        np.testing.assert_array_equal(m, hm)
    assert np.float32(st.fret) == fret
    np.testing.assert_array_equal(np.array(st.aff, np.float32), aff)
    np.testing.assert_array_equal(np.array(st.stage_costs, np.float32), stage)
    assert (engine == "grad") == (st.evals[1] > 0)


@pytest.mark.parametrize("engine", ["grad", "device"])
@pytest.mark.parametrize("method", [5, 7])
def test_batch_ls_ladder_matches_jax(pair, engine, method, monkeypatch):
    """(c) The batch_ls ladder's NCC within 1e-3 of the JAX package's
    MIL_REG_BATCH_LS=1 ladder on the same pair."""
    vol, moved, src_ms, tgt_ms, sd_t = pair
    monkeypatch.setenv("MIL_REG_BATCH_LS", "1")
    _, _jtmx, jrec = jax_reg3d_affine(vol, moved, aff_method=method, ftol=1e-4,
                                      it_limit=3000, engine=engine)
    sums, probes = _recorder(src_ms, tgt_ms, [])
    args = RL.ladder_args(engine, method, matrix_to_params(IDENTITY), 1e-4, 3000, sd_t,
                          SHAPE, finish=True, finish_sweeps=1, batch_ls=True)
    st = H.ladder(args, sums, probes)
    assert abs(-float(st.fret) - jrec[3]) <= 1e-3, (-st.fret, jrec[3])
    assert R.checkmatrix(np.array(st.aff, np.float32), SHAPE[2], SHAPE[1], SHAPE[0])


def _line_start(mode):
    """A start point and direction of each mode: near the identity, the
    direction mixing translations with the mode's other parameters."""
    n = RL.LINE_MODES[mode]
    if mode == "p12":
        p = matrix_to_params(IDENTITY).astype(np.float32)
        xi = np.array([0.6, -0.8, 0.4] + [0.002, -0.001, 0.0015, 0.001, 0.002, -0.001,
                                          0.0005, 0.001, -0.002], np.float32)
        return p, xi
    p = np.zeros(n, np.float32)
    p[6:] = 1.0
    xi = np.array([0.6, -0.8, 0.4, 1.5, -0.7, 0.5, 0.01, -0.008, 0.012], np.float32)[:n]
    return p, xi


@pytest.mark.parametrize("mode", MODES)
def test_line_stage_repeats_the_host_loop_and_matches_jax(pair, mode):
    """(d) The line stage (mnbrak + brent from p along xi): the host loop's
    _linmin over K5's plain version bit for bit, evaluation for evaluation;
    JAX's jitted linmin_reg_device within 1e-4."""
    _vol, _moved, src_ms, tgt_ms, sd_t = pair
    p, xi = _line_start(mode)
    log = []
    sums, probes = _recorder(src_ms, tgt_ms, log)
    st = H.ladder(RL.line_args(p, xi, mode, sd_t), sums, probes)
    n = RL.LINE_MODES[mode]
    got = (np.array(st.p[:n], np.float32), np.array(st.xi[:n], np.float32),
           np.float32(st.fret), int(st.nev))
    before = RD.HOST_LINES
    host = RD.linmin_reg_device(src_ms, tgt_ms, sd_t, p, xi, mode)
    assert RD.HOST_LINES == before + 1
    assert all(_equal(a, b) for a, b in zip(got, host)), (got, host)
    assert st.nev == len(log) == st.evals[0] and not st.evals[1] and not st.evals[2]
    assert st.stage == 1 and got[3] > 3
    jp, jxi, jf, jn = jax_linmin_reg_device(jnp.asarray(src_ms.numpy()),
                                            jnp.asarray(tgt_ms.numpy()), sd_t,
                                            jnp.asarray(p), jnp.asarray(xi), mode)
    np.testing.assert_allclose(got[0], np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(got[1], np.asarray(jxi), atol=1e-4)
    assert abs(float(got[2]) - float(jf)) <= 1e-4


def test_line_stage_plan_and_args():
    """(f) The line stage: one stage on K5's sums over the mode's
    parameters, from p_init along xi; a bad mode or length raises, an
    unknown line ndof plans no stage."""
    for mode in MODES:
        p, xi = _line_start(mode)
        a = RL.line_args(p, xi, mode, 2.0)
        n = RL.LINE_MODES[mode]
        assert H.stages(a) == [(0, n, 0, 0, 0, 1)] and RL.stage_count(a) == 1
        assert list(a.p_init)[:n] == [float(v) for v in p] and not any(a.p_init[n:])
        assert list(a.xi)[:n] == [float(v) for v in xi] and a.engine == RL.ENGINES["line"]
    with pytest.raises(ValueError, match="mode"):
        RL.line_args(np.zeros(4), np.zeros(4), "dof4", 1.0)
    with pytest.raises(ValueError, match="takes 6"):
        RL.line_args(np.zeros(6), np.zeros(5), "dof6", 1.0)
    a = RL.line_args(np.zeros(3), np.ones(3), "dof3", 1.0)
    a.line_ndof = 5
    assert H.stages(a) == []
    with pytest.raises(RuntimeError, match="ladder error 1"):
        H.ladder(a, lambda m, g: np.zeros(26))
    with pytest.raises(ValueError, match="engine"):
        RL.ladder_args("line", 7, np.zeros(12), 1e-4, 10, 1.0, SHAPE)


@pytest.mark.parametrize("method", [1, 2, 3, 4, 5, 6, 7])
def test_batch_ls_stage_plan(method):
    """(f) batch_ls: the device engine's Powell stages and the grad
    engine's finisher on K6's sums, the L-BFGS stages still on K4's; no
    finisher, no probe stage."""
    for engine in ("grad", "device"):
        for finish in (True, False):
            a = RL.ladder_args(engine, method, matrix_to_params(IDENTITY), 1e-4, 3000, 1.0,
                               SHAPE, finish=finish, batch_ls=True)
            plain = RL.ladder_args(engine, method, matrix_to_params(IDENTITY), 1e-4, 3000,
                                   1.0, SHAPE, finish=finish)
            got, want = H.stages(a), H.stages(plain)
            assert len(got) == len(want) == RL.stage_count(a)
            assert [s[1:] for s in got] == [s[1:] for s in want]
            assert [s[0] for s in got] == [2 if s[0] == 0 else s[0] for s in want]
            assert (engine == "grad") == (1 in [s[0] for s in got])


def test_routes_send_batch_ls_and_lines_to_k9(pair, monkeypatch):
    """(e) A CUDA pair on the kernel route: reg_ladder_device and
    reg_ladder_grad call K9 with batch_ls, linmin_reg_device one K9 line a
    call, for every mode; nothing runs the host loop. A CPU pair runs the
    host loop."""
    _vol, _moved, src_ms, tgt_ms, sd_t = pair
    p0 = matrix_to_params(IDENTITY)
    ladders, lines = [], []

    def fake_ladder(*args, **kw):
        ladders.append((args, kw))
        return np.zeros(12, np.float32), np.float32(0), np.zeros(4, np.float32), 1

    def fake_line(*args):
        lines.append(args)
        n = RL.LINE_MODES[args[5]]
        return np.zeros(n, np.float32), np.zeros(n, np.float32), np.float32(0), 1

    host = (RD.HOST_LADDERS, RG.HOST_LADDERS, RD.HOST_LINES)
    monkeypatch.setattr(RL, "reg_ladder", fake_ladder)
    monkeypatch.setattr(RL, "reg_line", fake_line)
    monkeypatch.setattr(RD, "on_kernel_route", lambda *a, **k: True)
    monkeypatch.setattr(RG, "on_kernel_route", lambda *a, **k: True)
    for batch_ls in (False, True):
        RD.reg_ladder_device(src_ms, tgt_ms, sd_t, p0, 7, 1e-4, 3000, batch_ls=batch_ls)
        RG.reg_ladder_grad(src_ms, tgt_ms, sd_t, p0, 7, 1e-4, 3000, batch_ls=batch_ls,
                           finish_sweeps=1)
    assert len(ladders) == 4
    engines = [a[7] for a, _kw in ladders]
    batch = [kw.get("batch_ls", a[-1] if len(a) > 11 else False) for a, kw in ladders]
    assert engines == ["device", "grad"] * 2 and batch == [False, False, True, True]
    for mode in MODES:
        p, xi = _line_start(mode)
        out = RD.linmin_reg_device(src_ms, tgt_ms, sd_t, p, xi, mode)
        assert out[3] == 1 and lines[-1][5] == mode
        np.testing.assert_array_equal(lines[-1][3], p)
    assert len(lines) == len(MODES)
    assert (RD.HOST_LADDERS, RG.HOST_LADDERS, RD.HOST_LINES) == host
    # a CPU pair: the host loop
    monkeypatch.undo()
    ladders.clear()
    lines.clear()
    monkeypatch.setattr(RL, "reg_ladder", fake_ladder)
    monkeypatch.setattr(RL, "reg_line", fake_line)
    RD.reg_ladder_device(src_ms, tgt_ms, sd_t, p0, 1, 1e-4, 3000, batch_ls=True)
    RG.reg_ladder_grad(src_ms, tgt_ms, sd_t, p0, 1, 1e-4, 3000, batch_ls=True)
    RD.linmin_reg_device(src_ms, tgt_ms, sd_t, *_line_start("dof3"), "dof3")
    assert not ladders and not lines
    assert (RD.HOST_LADDERS, RG.HOST_LADDERS, RD.HOST_LINES) == (host[0] + 1, host[1] + 1,
                                                                  host[2] + 1)


def test_hybrid_engine_takes_a_k9_line_per_line(pair, monkeypatch):
    """(e) reg3d_affine's hybrid engine on the kernel route hands every line
    minimization to K9 (here the stub gives the host loop's result, so the
    registration is the CPU run's) and its start and extrapolation points to
    single K5 evaluations."""
    vol, moved, *_ = pair
    _, tmx_cpu, rec_cpu = R.reg3d_affine(vol, moved, aff_method=7, engine="hybrid",
                                         mem_mode=0, want_reg=False)
    lines = []

    def k9_line(src, tgt, sd_t, p, xi, mode):
        lines.append(mode)
        cost = RD._cost_for_mode(src, tgt, sd_t, mode)
        return _linmin(cost, np.asarray(p, np.float32), np.asarray(xi, np.float32))

    before = RD.HOST_LINES
    monkeypatch.setattr(RL, "reg_line", k9_line)
    monkeypatch.setattr(RD, "on_kernel_route", lambda *a, **k: True)
    _, tmx, rec = R.reg3d_affine(vol, moved, aff_method=7, engine="hybrid", mem_mode=0,
                                 want_reg=False)
    assert RD.HOST_LINES == before and len(lines) > 10
    assert set(lines) == {"dof3", "dof6", "dof9", "p12"}
    np.testing.assert_array_equal(tmx, tmx_cpu)
    assert rec[3] == rec_cpu[3] and rec[5] == rec_cpu[5]


def test_trace_matrices_reads_a_record():
    """kernels/reg_ladder.py::trace_matrices: a K6 record's n matrices
    (the first at words 1..12, the rest from MATS_AT) and 2n sums; K4's
    and K5's record one matrix and 26 or 2 sums."""
    rng = np.random.default_rng(4)
    ms = rng.normal(size=(8, 12)).astype(np.float32)
    sums = rng.normal(size=26)
    for kind, n in ((2, 8), (2, 3), (2, 1), (1, 1), (0, 1)):
        r = np.zeros(RL.TRACE_WORDS)
        r[0], r[1:13], r[13:39], r[39] = kind, ms[0], sums, n
        r[RL.MATS_AT:RL.MATS_AT + 12 * (n - 1)] = ms[1:n].reshape(-1)
        got_m, got_s = RL.trace_matrices(r)
        np.testing.assert_array_equal(got_m, ms[:n])
        nv = 2 * n if kind == 2 else (26 if kind == 1 else 2)
        np.testing.assert_array_equal(got_s, sums[:nv])
    assert RL.MATS_AT + 12 * 7 <= RL.STAMP_AT


def test_reg_line_raises_off_cuda():
    """reg_line checks its pair and mode, and a CPU pair raises (its line is
    the host loop)."""
    a = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="CUDA"):
        RL.reg_line(a, a, 1.0, np.zeros(3), np.ones(3), "dof3")
    with pytest.raises(ValueError, match="mode"):
        RL.reg_line(a, a, 1.0, np.zeros(3), np.ones(3), "dof5")
    with pytest.raises(ValueError, match="differ in shape"):
        RL.reg_line(a, torch.zeros((16, 24, 21)), 1.0, np.zeros(3), np.ones(3), "dof3")
