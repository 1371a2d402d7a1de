"""The port's float32 host-driven optimizers against the JAX package's
``lax`` ones on the same smooth analytic costs: the point within 1e-4, f
within 1e-6, and no more than 10% more evaluations than JAX. The port's
loops follow the lax control flow branch for branch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from microimagelib_tpu.ops.lbfgs import lbfgs_minimize as jax_lbfgs
from microimagelib_tpu.ops.powell import powell as jax_host_powell
from microimagelib_tpu.ops.powell_device import powell_device as jax_powell
from microimagelib_tpu_torch.ops.lbfgs import lbfgs_minimize
from microimagelib_tpu_torch.ops.powell import EvalCounter, powell
from microimagelib_tpu_torch.ops.powell_device import powell_device

# a bowl with coupled axes: 0.5 (p-c)' A (p-c). Both costs are 0 at the
# minimum, so float32 resolves f, and with it the point, near the minimum
_A = np.array([[3.0, 0.4, 0.0], [0.4, 1.0, 0.2], [0.0, 0.2, 0.5]], np.float32)
_C3 = np.array([1.0, -2.0, 0.5], np.float32)
# an NCC-like bounded well: 1 - exp(-0.5 sum w (p-c)^2)
_W = np.array([1.0, 0.5, 2.0, 0.25], np.float32)
_C4 = np.array([0.8, -0.6, 0.3, 1.5], np.float32)


def _bowl(xp):
    a, c = xp.asarray(_A), xp.asarray(_C3)

    def f(p):
        d = p - c
        return xp.float32(0.5) * (d @ (a @ d))
    return f


def _well(xp):
    w, c = xp.asarray(_W), xp.asarray(_C4)

    def f(p):
        d = p - c
        return -xp.expm1(xp.float32(-0.5) * xp.sum(w * d * d))
    return f


def _np_grad(name):
    if name == "bowl":
        return lambda p: (_A @ (p - _C3)).astype(np.float32)
    f = _well(np)
    return lambda p: ((1 - f(p)) * _W * (p - _C4)).astype(np.float32)


COSTS = {"bowl": (_bowl, np.zeros(3, np.float32)),
         "well": (_well, np.zeros(4, np.float32))}


def _counted(f):
    calls = [0]

    def g(p):
        calls[0] += 1
        return np.float32(f(np.asarray(p, np.float32)))
    return g, calls


@pytest.mark.parametrize("name", list(COSTS))
@pytest.mark.parametrize("max_sweeps", [None, 1])
def test_powell_device_matches_jax(name, max_sweeps):
    make, p0 = COSTS[name]
    ftol, it_limit = 1e-6, 3000
    jp, jf, jn = jax.jit(lambda x: jax_powell(make(jnp), x, ftol, it_limit,
                                              max_sweeps=max_sweeps))(jnp.asarray(p0))
    cost, calls = _counted(make(np))
    p, f, n = powell_device(cost, p0, ftol, it_limit, max_sweeps=max_sweeps)
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

    p, f, n = lbfgs_minimize(vg, p0, ftol, it_limit, max_iters=200, patience=3)
    assert n == calls[0]
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-4)
    assert abs(float(f) - float(jf)) <= 1e-6
    assert n <= int(jn) * 1.1


def test_lbfgs_solves_quadratic():
    """tests/test_registration_grad.py::test_lbfgs_solves_quadratic, on the
    port."""
    a = np.diag([1.0, 10.0, 100.0]).astype(np.float32)

    def vg(p):
        return np.float32(0.5 * p @ a @ p - p.sum()), (a @ p - 1).astype(np.float32)

    p, fmin, nev = lbfgs_minimize(vg, np.zeros(3, np.float32), 1e-10, 200)
    np.testing.assert_allclose(p, [1.0, 0.1, 0.01], atol=1e-3)
    assert nev < 200


def test_it_limit_and_abort():
    """The shared evaluation cap stops Powell and L-BFGS between line
    searches; a cost >= 1.001 at the start stops both at once."""
    cost, calls = _counted(_well(np))
    _, _, n = powell_device(cost, np.zeros(4, np.float32), 1e-12, 25)
    assert 25 <= n == calls[0] < 25 + 80     # one line search past the cap
    p, f, n = powell_device(lambda p: np.float32(2.0), np.zeros(2, np.float32),
                            1e-4, 100, nev0=7)
    assert n == 8 and f == np.float32(2.0)
    p, f, n = lbfgs_minimize(lambda p: (np.float32(1.5), np.ones(2, np.float32)),
                             np.zeros(2, np.float32), 1e-4, 100)
    assert n == 1


def test_host_powell_matches_jax_host_powell():
    """ops/powell.py is a copy: same point and count as the JAX package's."""
    f = _well(np)
    c1 = EvalCounter(lambda p: float(f(np.asarray(p, np.float32))))
    p, fr, _, _ = powell(np.zeros(4), None, 1e-6, 3000, counter=c1)
    c2 = EvalCounter(lambda p: float(f(np.asarray(p, np.float32))))
    jp, jfr, _, _ = jax_host_powell(np.zeros(4), None, 1e-6, 3000, counter=c2)
    np.testing.assert_array_equal(p, jp)
    assert fr == jfr and c1.count == c2.count
