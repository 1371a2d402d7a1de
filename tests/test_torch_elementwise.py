"""The port's ``ops/elementwise.py`` against the JAX package's aliases of the
same names on the CPU, one case per alias, on the same numpy inputs from a
seed. Real elementwise results are bit-equal (the same IEEE operation on
each element); complex products and the normalised cross power agree to
1e-6 relative (the complex multiply's operations may be ordered or fused
differently); sums agree to 1e-5 relative (another summation order); the
maxima and their first indices are equal.
"""

import numpy as np
import pytest
import torch

from microimagelib_tpu.ops import elementwise as JE
from microimagelib_tpu_torch.ops import elementwise as PE

SHAPE = (5, 6, 7)


def _inputs():
    rng = np.random.default_rng(16)
    a = rng.normal(size=SHAPE).astype(np.float32) * 10
    b = rng.uniform(0.5, 2.0, size=SHAPE).astype(np.float32)
    a[2, 3] = a[1, 3]              # a tie along z: the first maximum wins
    a[4, 5, 6] = a.max() + 1       # one global maximum
    ca = (rng.normal(size=SHAPE) + 1j * rng.normal(size=SHAPE)).astype(np.complex64)
    cb = (rng.normal(size=SHAPE) + 1j * rng.normal(size=SHAPE)).astype(np.complex64)
    cb[0, 0, :3] = 0               # zero products: the normalised product is 0 there
    return a, b, ca, cb


# name: (arguments from (a, b, ca, cb), relative tolerance)
CASES = {
    "add3d": (lambda a, b, ca, cb: (a, b), 0),
    "sub3d": (lambda a, b, ca, cb: (a, b), 0),
    "multi3d": (lambda a, b, ca, cb: (a, b), 0),
    "div3d": (lambda a, b, ca, cb: (a, b), 0),
    "add_value": (lambda a, b, ca, cb: (a, 2.5), 0),
    "multi_value": (lambda a, b, ca, cb: (a, -1.5), 0),
    "max_value": (lambda a, b, ca, cb: (a, 0.01), 0),
    "multicomplex": (lambda a, b, ca, cb: (ca, cb), 1e-6),
    "multidcomplex": (lambda a, b, ca, cb: (ca, cb), 1e-6),
    "multicomplex_norm": (lambda a, b, ca, cb: (ca, cb), 1e-6),
    "conj3d": (lambda a, b, ca, cb: (ca,), 0),
    "sum3d": (lambda a, b, ca, cb: (a,), 1e-5),
    "sum1d": (lambda a, b, ca, cb: (b,), 1e-5),
    "reduce_z": (lambda a, b, ca, cb: (a,), 1e-5),
    "max_z": (lambda a, b, ca, cb: (a,), 0),
    "max3d": (lambda a, b, ca, cb: (a,), 0),
}


def _flat(out):
    """Every array of a result, as numpy, in order."""
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    return [np.asarray(out)]


def test_every_alias_is_ported():
    assert set(PE.__all__) == set(CASES)
    assert all(callable(getattr(JE, name)) for name in CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_alias_matches_jax(name):
    pick, rtol = CASES[name]
    args = pick(*_inputs())
    ref = _flat(getattr(JE, name)(*args))
    out = _flat(getattr(PE, name)(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                                     for x in args)))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert o.dtype == r.dtype or (o.dtype.kind == r.dtype.kind == "i")
        if rtol == 0:
            np.testing.assert_array_equal(o, r)
        else:
            np.testing.assert_allclose(o, r, rtol=rtol, atol=rtol * float(np.abs(r).max()))
