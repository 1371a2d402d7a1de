"""The rotating MIP's three routes in the port against the JAX package's
same routes on the CPU: ``gather``, the one-hot ``matmul`` and the
``factored`` tap tables (with a frame group that leaves a tail), on both
rotation axes, within 1e-5 x max — tests/test_fusion_batch.py's bound
between the JAX routes — at that file's (18, 13, 15) blobs with 7 frames
and tests/test_ops_basics.py's (12, 20, 16) volume with 8 frames. The
route rule (``mip3d_params``) and the tap tables (``mip3d_factored_plan``)
equal JAX's. K8, the factored route's CUDA kernel, is held against its
plain version on the card only (marked ``cuda``; it skips here); on the
CPU its z' interval (``valid_z_interval``) is held to an exhaustive scan
and its walk over the rows-last layout, in numpy, to the plain version. JAX is
imported inside the tests, so the card test also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mip_routes.py -m cuda
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.kernels import mip_rot as M
from microimagelib_tpu_torch.models import projections as PP

torch.set_num_threads(1)

ROUTE_ENV = ("MIL_MIP_IMPL", "MIL_MIP_FGROUP", "MIL_MIP_MATMUL_MAX_BYTES",
             "MIL_MIP_FACTORED_MIN_W_BYTES", "MIL_MIP_PRECISION", "MIL_MIP_TABLE_CACHE")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ROUTE_ENV:
        monkeypatch.delenv(k, raising=False)
    PP._FACTORED_TABLE_CACHE.clear()
    yield
    PP._FACTORED_TABLE_CACHE.clear()


def _jp():
    from microimagelib_tpu.models import projections as JP
    return JP


def _blobs(shape, n, seed):
    """tests/test_fusion_batch.py's blobs: points convolved with a
    Gaussian, circularly."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, dtype=np.float32)
    for _ in range(n):
        z, y, x = (rng.integers(s // 4, 3 * s // 4) for s in shape)
        vol[z, y, x] = rng.uniform(80, 200)
    zz, yy, xx = np.meshgrid(*[np.arange(s) - s // 2 for s in shape], indexing="ij")
    g = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 4.0)
    g = np.roll(g / g.sum(), [-s // 2 for s in shape], axis=(0, 1, 2))
    return np.fft.irfftn(np.fft.rfftn(vol) * np.fft.rfftn(g), s=shape,
                         axes=(0, 1, 2)).astype(np.float32)


def _volume(case):
    if case == "blobs":
        rng = np.random.default_rng(42)
        return (_blobs((18, 13, 15), 8, 7) + rng.normal(0, 0.05, (18, 13, 15))).astype(
            np.float32), 7
    rng = np.random.default_rng(11)
    return rng.random((12, 20, 16)).astype(np.float32) * 100, 8


ROUTES = [("gather", None), ("matmul", None), ("factored", None), ("factored", "5")]


@pytest.mark.parametrize("r_axis", [1, 2])
@pytest.mark.parametrize("impl,fgroup", ROUTES, ids=["gather", "matmul", "factored",
                                                     "factored-fgroup5"])
@pytest.mark.parametrize("case", ["blobs", "random"])
def test_mip3d_route_matches_jax_route(monkeypatch, case, impl, fgroup, r_axis):
    JP = _jp()
    vol, frames = _volume(case)
    monkeypatch.setenv("MIL_MIP_IMPL", impl)
    if fgroup:
        monkeypatch.setenv("MIL_MIP_FGROUP", fgroup)
    p = PP.mip3d_params(vol.shape, r_axis, frames)
    assert p["impl"] == JP.mip3d_params(vol.shape, r_axis, frames)["impl"] == impl
    if fgroup:
        assert p["fgroup"] == int(fgroup) and frames % p["fgroup"]
    ref = JP.mip3d(vol, r_axis, project_num=frames)
    out = PP.mip3d(vol, r_axis, project_num=frames, device="cpu")
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


def _same_params(p, jp):
    assert p.keys() == jp.keys()
    assert p["impl"] == jp["impl"] and p["out_shape"] == jp["out_shape"]
    np.testing.assert_array_equal(p["mats"], jp["mats"])
    for k in ("chunk", "fgroup"):
        assert p.get(k) == jp.get(k)
    if "prec" in jp:
        assert p["prec"] == jp["prec"].name.lower()


ENVS = [{}, {"MIL_MIP_MATMUL_MAX_BYTES": "0"}, {"MIL_MIP_MATMUL_MAX_BYTES": str(3 << 30)},
        {"MIL_MIP_FACTORED_MIN_W_BYTES": "1000"},
        {"MIL_MIP_FGROUP": "4", "MIL_MIP_PRECISION": "highest"},
        {"MIL_MIP_MATMUL_MAX_BYTES": str(40 << 20)}]


@pytest.mark.parametrize("impl", [None, "auto", "gather", "matmul", "factored", "other"])
@pytest.mark.parametrize("env", ENVS, ids=["default", "cap0", "cap3g", "crossover1000",
                                           "fgroup4-highest", "cap40m"])
def test_mip3d_params_equal_jax(monkeypatch, impl, env):
    JP = _jp()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if impl is not None:
        monkeypatch.setenv("MIL_MIP_IMPL", impl)
    for shape, n in (((18, 13, 15), 7), ((12, 20, 16), 8), ((320, 320, 320), 36),
                     ((96, 512, 320), 36)):
        for r_axis in (1, 2):
            _same_params(PP.mip3d_params(shape, r_axis, n), JP.mip3d_params(shape, r_axis, n))
            _same_params(PP.mip3d_params(shape, r_axis, n, impl="matmul", device="cpu"),
                         JP.mip3d_params(shape, r_axis, n, impl="matmul"))


def test_auto_takes_the_kernel_on_cuda_and_gather_without_passthrough(monkeypatch):
    """On a CUDA device ``auto`` takes the factored route (K8) for every
    passthrough stack (the rule decides from the device's type; no card is
    needed to read it). A stack whose rotation axis feeds another axis takes
    the gather route on every device, as in the JAX package."""
    JP = _jp()
    for shape in ((18, 13, 15), (320, 320, 320)):
        for r_axis in (1, 2):
            assert PP.mip3d_params(shape, r_axis, 7, device="cuda")["impl"] == "factored"
            assert PP.mip3d_params(shape, r_axis, 7, "matmul", device="cuda")["impl"] == "matmul"
            assert PP.mip3d_params(shape, r_axis, 7, "gather", device="cuda")["impl"] == "gather"

    def sheared(rot):
        def f(*args):
            m = np.array(rot(*args), np.float32).reshape(12)
            m[1] += 0.05   # y (x about x) now feeds x (y): no passthrough
            m[4] += 0.05
            return m
        return f

    monkeypatch.setattr(PP, "rot_to_matrix", sheared(PP.rot_to_matrix))
    monkeypatch.setattr(JP, "rot_to_matrix", sheared(JP.rot_to_matrix))
    for impl in ("auto", "matmul", "factored"):
        for r_axis in (1, 2):
            p = PP.mip3d_params((18, 13, 15), r_axis, 7, impl)
            _same_params(p, JP.mip3d_params((18, 13, 15), r_axis, 7, impl))
            assert p["impl"] == "gather"
            assert PP.mip3d_params((18, 13, 15), r_axis, 7, impl, device="cuda")["impl"] \
                == "gather"
    vol, _ = _volume("blobs")
    ref = JP.mip3d(vol, 2, project_num=7)
    out = PP.mip3d(vol, 2, project_num=7, device="cpu")
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("r_axis", [1, 2])
@pytest.mark.parametrize("chunk", [1, 4, 32])
@pytest.mark.parametrize("shape,frames", [((12, 20, 16), 8), ((18, 13, 15), 7)])
def test_factored_plan_tables_equal_jax(shape, frames, r_axis, chunk):
    """The tap tables equal JAX's array for array, up to the rounding of
    the coordinates: the port rounds ``(k * q + kz * z') + k0`` after each
    operation (the gather route's order), XLA contracts ``k * q + kz * z'``
    into one FMA in some compiles of the JAX tables and not in others. That
    moves a coordinate, and with it a weight, by a few ulps of the largest
    term (where the floor moves with it, a tap's weight goes to its
    neighbour by as little)."""
    JP = _jp()
    p = JP.mip3d_params(shape, r_axis, frames, impl="factored")
    was, wbs = PP.mip3d_factored_plan(shape, p["mats"], p["out_shape"], r_axis, chunk,
                                      device="cpu")
    jwas, jwbs = JP.mip3d_factored_plan(shape, p["mats"], p["out_shape"], r_axis, chunk)
    ulp = float(np.spacing(np.float32(max(shape + p["out_shape"]))))
    for t, j in ((was, jwas), (wbs, jwbs)):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=4 * ulp)


def test_factored_table_cache_keeps_two_and_can_be_disabled(monkeypatch):
    def plan(shape, r_axis=2, chunk=4):
        p = PP.mip3d_params(shape, r_axis, 5, impl="factored")
        return PP.mip3d_factored_plan(shape, p["mats"], p["out_shape"], r_axis, chunk,
                                      device="cpu")

    first = plan((8, 9, 10))
    assert plan((8, 9, 10))[0] is first[0]            # a hit returns the cached tables
    plan((8, 9, 11))
    assert len(PP._FACTORED_TABLE_CACHE) == 2
    plan((8, 9, 10), r_axis=1)                        # a third key evicts the oldest
    assert len(PP._FACTORED_TABLE_CACHE) == 2
    assert (8, 9, 10, 5, 2, 4, "cpu") not in PP._FACTORED_TABLE_CACHE
    assert plan((8, 9, 10))[0] is not first[0]
    assert list(PP._FACTORED_TABLE_CACHE)[-1] == (8, 9, 10, 5, 2, 4, "cpu")
    PP._FACTORED_TABLE_CACHE.clear()
    monkeypatch.setenv("MIL_MIP_TABLE_CACHE", "0")
    a = plan((8, 9, 10))
    assert not PP._FACTORED_TABLE_CACHE and plan((8, 9, 10))[0] is not a[0]
    torch.testing.assert_close(plan((8, 9, 10))[0], a[0], rtol=0, atol=0)


@pytest.mark.parametrize("r_axis", [1, 2])
def test_mip_rot_cpu_runs_the_plain_contraction(r_axis):
    """The wrapper on a CPU tensor: the plain contraction of the tables, the
    same frames whichever chunk, frame group or table source it takes; a
    device that is neither CPU nor CUDA raises."""
    vol, n = _volume("random")
    img = torch.from_numpy(vol)
    p = PP.mip3d_params(vol.shape, r_axis, n, impl="factored")
    _rows, na, nb, zo, po = M.extents(vol.shape, p["out_shape"], r_axis)
    was, wbs = M.tap_tables(p["mats"], zo, na, nb, po, 3, r_axis)
    ref = M.mip_rot_torch(img, was, wbs, r_axis, 3)
    for kw in ({}, {"chunk": 5, "fgroup": 8}, {"chunk": 32, "plan": PP.mip3d_factored_plan}):
        out = M.mip_rot(img, p["mats"], p["out_shape"], r_axis, **kw)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    assert M.LAUNCHES == 0
    gather = PP._rotate_and_mip_all(img, p["mats"], p["out_shape"])
    torch.testing.assert_close(ref, gather, rtol=0, atol=1e-5 * float(gather.abs().max()))
    with pytest.raises(ValueError):
        M.mip_rot(img.to("meta"), p["mats"], p["out_shape"], r_axis)
    with pytest.raises(TypeError):
        M.mip_rot(img.double(), p["mats"], p["out_shape"], r_axis)


def test_importing_the_routes_builds_nothing():
    """K8 is built at its first launch, never when a module is imported."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import microimagelib_tpu_torch.models.projections\n"
         "import microimagelib_tpu_torch.kernels.mip_rot as m\n"
         "import microimagelib_tpu_torch.kernels.build as b\n"
         "print('STATE', m._lib is None, m.LAUNCHES, b._LIB is None)"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("STATE")[1].split() == ["True", "0", "True"]
    assert build.CSRC_DIR / "mip_rot.cu" in build.sources()


def _exhaustive_valid(row, na, nb, zo, po):
    """(zo, po): the per-sample predicate of the factored route, the joint
    box -0.5 <= c < n - 0.5 on the float32 ``coordinate`` of both axes."""
    kb, kbz, kb0, ka, kaz, ka0 = (np.float32(v) for v in row)
    z = np.arange(zo, dtype=np.float32)[:, None]
    q = np.arange(po, dtype=np.float32)[None, :]
    cb, ca = M.coordinate(kb, kbz, kb0, q, z), M.coordinate(ka, kaz, ka0, q, z)
    return (cb >= -0.5) & (cb < nb - 0.5) & (ca >= -0.5) & (ca < na - 0.5)


def _assert_interval_is_exact(row, na, nb, zo, po):
    lo, hi = M.valid_z_interval(row, np.arange(po), na, nb, zo)
    z = np.arange(zo)[:, None]
    np.testing.assert_array_equal((z >= lo) & (z < hi), _exhaustive_valid(row, na, nb, zo, po))
    for q in (0, po // 2, po - 1):        # the scalar form gives the same ends
        assert tuple(M.valid_z_interval(row, q, na, nb, zo)) == (lo[q], hi[q])


@pytest.mark.parametrize("r_axis", [1, 2])
@pytest.mark.parametrize("shape", [(128, 128, 128), (320, 320, 320), (33, 47, 29)])
def test_valid_z_interval_equals_the_exhaustive_scan(shape, r_axis):
    """K8 walks only [lo, hi) of z' for each (frame, column): for every
    frame of ``mip3d_params``' 36 matrices the interval is exactly the z'
    that the per-sample box test accepts, so the kernel takes the samples
    of the one-thread-a-column scan it replaced."""
    p = PP.mip3d_params(shape, r_axis, 36, impl="factored")
    _rows, na, nb, zo, po = M.extents(shape, p["out_shape"], r_axis)
    for row in M.coefficients(p["mats"], r_axis):
        _assert_interval_is_exact(row, na, nb, zo, po)



@pytest.mark.parametrize("r_axis", [1, 2])
@pytest.mark.parametrize("shape", [(128, 128, 128), (96, 100, 90)])
def test_samples_inside_counts_the_exhaustive_scan(shape, r_axis):
    """K8's bound counts the samples inside the box from the frames'
    intervals: the count of the per-sample predicate over every frame."""
    p = PP.mip3d_params(shape, r_axis, 36, impl="factored")
    _rows, na, nb, zo, po = M.extents(shape, p["out_shape"], r_axis)
    coef = M.coefficients(p["mats"], r_axis)
    want = sum(int(_exhaustive_valid(row, na, nb, zo, po).sum()) for row in coef)
    assert M.samples_inside(coef, na, nb, zo, po) == want
    assert 0 < want < len(coef) * zo * po

def test_valid_z_interval_on_random_and_exact_rotations():
    """200 random rotations from a seeded generator, about both axes and on
    random grids, each with its kz zeroed in one of four; the exact angles
    0, 90, 180 and 270 degrees (kz ~ 1e-16 beside 1); and a coordinate
    whose kz * z' is near an ulp of k * q (kz = 1e-7 beside 100), where the
    rounded coordinate enters the box at z' = 39 and the real line at 76."""
    rng = np.random.default_rng(16)
    for i in range(200):
        shape = tuple(int(n) for n in rng.integers(8, 90, 3))
        r_axis = int(rng.integers(1, 3))
        m = PP.rot_to_matrix(float(rng.uniform(-7, 7)), shape[2], shape[1], shape[0], r_axis)
        _rows, na, nb, zo, po = M.extents(
            shape, PP.mip3d_params(shape, r_axis, 1, "factored")["out_shape"], r_axis)
        row = M.coefficients(np.asarray(m, np.float32)[None], r_axis)[0]
        if i % 4 == 0:
            row[1 if i % 8 else 4] = 0.0          # kz = 0: a constant test on that axis
        _assert_interval_is_exact(row, na, nb, zo, po)
    for theta in (0.0, np.pi / 2, np.pi, 3 * np.pi / 2):
        for r_axis in (1, 2):
            shape = (33, 47, 29)
            p = PP.mip3d_params(shape, r_axis, 1, "factored")
            _rows, na, nb, zo, po = M.extents(shape, p["out_shape"], r_axis)
            m = PP.rot_to_matrix(theta, shape[2], shape[1], shape[0], r_axis)
            _assert_interval_is_exact(
                M.coefficients(np.asarray(m, np.float32)[None], r_axis)[0], na, nb, zo, po)
    row = np.array([1.0, 1e-7, -100.500005, 0.0, 1.0, 0.0], np.float32)
    _assert_interval_is_exact(row, 200, 200, 100, 200)
    assert tuple(M.valid_z_interval(row, 100, 200, 200, 100)) == (39, 100)


def _kernel_numpy(img, mats, out_shape, r_axis):
    """K8's walk in numpy: per (frame, column) the z' of ``valid_z_interval``
    in chunks of 32; per sample the record a lane writes (the tap pixel a0 *
    nb + b0, whether a1 and b1 step past a0 and b0, whether it is inside the
    box, fa, fb), and from it the four taps read from the rows-last source
    as a vector over the rows (a warp's lanes)."""
    src = M.rows_last(img, r_axis).numpy()
    rows, na, nb, zo, po = M.extents(tuple(img.shape), out_shape, r_axis)
    pixels = src.reshape(na * nb, rows)
    f32 = np.float32
    frames = np.zeros((len(mats), rows, po), np.float32)
    for f, row in enumerate(M.coefficients(mats, r_axis)):
        kb, kbz, kb0, ka, kaz, ka0 = (f32(v) for v in row)
        los, his = M.valid_z_interval(row, np.arange(po), na, nb, zo)
        for q in range(po):
            acc = np.zeros(rows, np.float32)
            for z0 in range(los[q], his[q], 32):
                chunk = []
                for z in range(z0, z0 + 32):          # lane z - z0
                    cb = M.coordinate(kb, kbz, kb0, f32(q), f32(z))
                    ca = M.coordinate(ka, kaz, ka0, f32(q), f32(z))
                    valid = z < his[q] and -0.5 <= cb < nb - 0.5 and -0.5 <= ca < na - 0.5
                    b0, a0 = np.floor(cb), np.floor(ca)
                    ib, ia = int(b0), int(a0)
                    b0i, b1i = min(max(ib, 0), nb - 1), min(ib + 1, nb - 1)
                    a0i, a1i = min(max(ia, 0), na - 1), min(ia + 1, na - 1)
                    flags = (a1i != a0i) | ((b1i != b0i) << 1) | (valid << 2)
                    chunk.append((a0i * nb + b0i, flags, f32(ca - a0), f32(cb - b0)))
                for pix, flags, fa, fb in chunk[:min(32, his[q] - z0)]:
                    if not flags & 4:
                        continue
                    p1 = pix + (nb if flags & 1 else 0)
                    d = 1 if flags & 2 else 0
                    v0 = fb * pixels[pix + d] + (f32(1) - fb) * pixels[pix]
                    v1 = fb * pixels[p1 + d] + (f32(1) - fb) * pixels[p1]
                    acc = np.maximum(acc, fa * v1 + (f32(1) - fa) * v0)
            frames[f, :, q] = acc
    return frames.transpose(0, 2, 1) if r_axis == 1 else frames


@pytest.mark.parametrize("r_axis", [1, 2])
@pytest.mark.parametrize("shape", [(12, 20, 16), (18, 13, 15), (9, 35, 33)])
def test_rows_last_layout_gives_the_rows_first_frames(shape, r_axis):
    """K8's source layout (a, b, rows) is the plain version's (rows, a, b)
    permuted, element for element; the kernel's walk over it (lanes on rows,
    only the valid z' interval, the samples' records in chunks of 32) gives
    the plain contraction's frames within 1e-5 x max."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100)
    last = M.rows_last(img, r_axis)
    assert last.is_contiguous()
    assert torch.equal(last.permute(2, 0, 1), M.rows_first(img, r_axis))
    p = PP.mip3d_params(shape, r_axis, 7, impl="factored")
    ref = M.mip_rot(img, p["mats"], p["out_shape"], r_axis)
    out = _kernel_numpy(img, p["mats"], p["out_shape"], r_axis)
    assert out.shape == tuple(ref.shape)
    np.testing.assert_allclose(out, ref.numpy(), rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("r_axis", [1, 2])
@pytest.mark.parametrize("shape", [(18, 13, 15), (12, 20, 16), (40, 96, 64), (24, 100, 70)])
def test_mip_rot_kernel_matches_plain_and_gather(cuda, shape, r_axis):
    """K8 against its plain version (the factored einsums) and the gather
    route on the card, within 1e-5 x max; one launch a call, the same bits
    from one launch to the next; ``mip3d_frames`` on ``auto`` launches it."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100).to(cuda)
    p = PP.mip3d_params(shape, r_axis, 36, impl="factored", device=cuda)
    before = M.LAUNCHES
    out = M.mip_rot(img, p["mats"], p["out_shape"], r_axis)
    torch.cuda.synchronize()
    assert M.LAUNCHES == before + 1
    was, wbs = PP.mip3d_factored_plan(shape, p["mats"], p["out_shape"], r_axis, p["chunk"],
                                      device=cuda)
    ref = M.mip_rot_torch(img, was, wbs, r_axis, p["fgroup"])
    gather = PP._rotate_and_mip_all(img, p["mats"], p["out_shape"])
    for other in (ref, gather):
        torch.testing.assert_close(out, other, rtol=0, atol=1e-5 * float(other.abs().max()))
    again = M.mip_rot(img, p["mats"], p["out_shape"], r_axis)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    before = M.LAUNCHES
    frames = PP.mip3d_frames(img, r_axis, 36)
    assert M.LAUNCHES == before + 1 and torch.equal(frames, out)
