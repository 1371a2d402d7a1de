"""K1's launch plan (kernels/conv_sep.py::launch_plan, the host's copy of
csrc/conv_sep.cu::make_plan) and the separable/FFT route rule of the
decon (models/deconvolution.py::sep_auto_takes), on the CPU.

The kernel's own plan is held to launch_plan on the card
(tests/test_torch_kernels.py::test_conv3_sep_kernel_plan_is_the_hosts)."""

import itertools

import numpy as np
import pytest

from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.models import deconvolution as D
from microimagelib_tpu_torch.ops.conv_sep import plan_sep, plan_sep_pair

TAPS = (1, 8, 9, 17, 25, 41, 128)
# (grid, y roll span, x roll span): the bench volume, a short y axis with
# nx off the tile multiples, and the tilted class's x span on both
GRIDS = (((512, 512, 512), 0, 0), ((130, 32, 100), 0, 0), ((130, 32, 100), 0, 14),
         ((256, 512, 512), 18, 18))


def gauss3(p, s):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    k = np.exp(-z[:, None, None] ** 2 / (2 * s[0] ** 2)
               - y[None, :, None] ** 2 / (2 * s[1] ** 2)
               - x[None, None, :] ** 2 / (2 * s[2] ** 2))
    return (k / k.sum()).astype(np.float32)


def tilted(p=(17, 9, 25)):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
    u, w = (xx + zz) / np.sqrt(2.0), (xx - zz) / np.sqrt(2.0)
    k = np.exp(-u ** 2 / 32.0 - w ** 2 / 2.88 - yy ** 2 / 2.88)
    return (k / k.sum()).astype(np.float32)


def bench_psf():
    zz, yy, xx = np.meshgrid(*[np.arange(9) - 4] * 3, indexing="ij")
    psf = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 4.5).astype(np.float32)
    return psf / psf.sum()


def _path(pl):
    if pl["ring"] == 0:
        return "no ring"
    return "generic ring" if pl["path"] < 0 else f"specialised {K.SPECS[pl['path']]}"


@pytest.mark.parametrize("rank", [1, 2, 3, 4])
def test_every_plan_k1_took_fits_a_block(rank):
    """Every (rank, z, y, x taps) the two-launch K1 took (rank <= 4, up to
    128 taps an axis) still launches: the plan fits 227 KB of shared
    memory, its runs cover the grid, and it takes the ring wherever one
    fits. The sweep meets every kind of path."""
    seen = {}
    for (shape, ry, rx), (ns, ly, lx) in itertools.product(GRIDS,
                                                           itertools.product(TAPS, repeat=3)):
        pl = K.launch_plan(shape, rank, ns, ly, lx, ry, rx)
        assert pl is not None, (shape, rank, ns, ly, lx)
        assert pl["smem"] <= K.SMEM_PER_BLOCK
        assert pl["blocks_per_sm"] in (1, 2)
        assert pl["run"] * pl["nruns"] >= shape[0] > pl["run"] * (pl["nruns"] - 1)
        assert pl["zq"] == (K.SPEC_ZQ[pl["path"]] if pl["path"] >= 0 else 1)
        assert pl["ring"] in (0, ns - 1 + pl["zq"] * (pl["prefetch"] + 1))
        assert pl["rank_group"] == rank or (pl["ring"] == 0 and pl["rank_group"] == 1)
        spec = (rank, ns, ly, lx) in K.SPECS
        assert (pl["path"] >= 0) == (spec and pl["ring"] > 0)
        seen.setdefault(_path(pl), []).append((shape, ns, ly, lx))
    assert {"no ring", "generic ring"} <= set(seen)
    if rank in (1, 4):
        assert any(k.startswith("specialised") for k in seen)


@pytest.mark.parametrize("case", [
    ("bench", (512, 512, 512), (1, 9, 9, 9, 0, 0), 0, 2),
    ("tilted", (256, 512, 512), (4, 17, 9, 17, 0, 14), 1, 1),
    ("dual A", (320, 512, 512), (1, 25, 15, 15, 0, 0), 2, 1),
    ("dual B", (320, 512, 512), (1, 15, 15, 25, 0, 0), 3, 1),
], ids=lambda c: c[0])
def test_main_paths_take_their_specialised_instantiation(case):
    """The main paths' plans take their specialised instantiation with a
    ring; the bench PSF at 512^3 runs two 32 x 32 blocks per SM, one run of
    all 512 planes per tile, two output planes a step, cp.async two steps
    ahead."""
    _name, shape, args, path, bps = case
    pl = K.launch_plan(shape, *args)
    assert (pl["path"], pl["blocks_per_sm"], pl["zq"]) == (path, bps, K.SPEC_ZQ[path])
    assert pl["ring"] > 0 and pl["prefetch"] in (1, 2)
    assert K.launch_plan(shape, *args, flags=K.GENERIC)["path"] == -1
    assert K.launch_plan(shape, *args, flags=K.NO_RING)["ring"] == 0
    if case[0] == "bench":
        assert (pl["ty"], pl["tx"], pl["run"], pl["nruns"], pl["prefetch"]) == \
            (32, 32, 512, 1, 2)


def test_plan_of_reads_the_roll_span():
    fwd, _ = plan_sep_pair(tilted(), tilted()[::-1, ::-1, ::-1], (64, 64, 256), tol=1e-4)
    dy0, dy1, dx0, dx1 = K._roll_span(fwd)
    assert fwd.rolls is not None and dx1 - dx0 > 0
    assert K.plan_of(fwd) == K.launch_plan(fwd.shape, fwd.rank, fwd.nsteps, fwd.ty.shape[1],
                                           fwd.tx.shape[1], dy1 - dy0, dx1 - dx0)


# (name, psf, grid, plan kwargs, specialised, K1 taken against (K3, torch.fft))
ROUTE_CASES = [
    ("bench 512^3", bench_psf(), (512, 512, 512), {}, True, (True, True)),
    ("tilted rank 4", tilted(), (256, 512, 512), dict(align=True, tol=1e-4), True,
     (False, False)),
    ("fusion A", gauss3((25, 25, 25), (3.5, 1.2, 1.2)), (320, 512, 320), {}, True,
     (False, True)),
    ("fusion B", gauss3((25, 25, 25), (1.2, 1.2, 3.5)), (320, 512, 320), {}, True,
     (False, True)),
    ("generic 3^3", gauss3((3, 3, 3), (0.6,) * 3), (512, 512, 512), {}, False,
     (True, True)),
    ("generic 5^3", gauss3((5, 5, 5), (0.8,) * 3), (512, 512, 512), {}, False,
     (False, True)),
    ("generic 13^3", gauss3((13, 13, 13), (2.0,) * 3), (512, 512, 512), {}, False,
     (False, False)),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: c[0])
def test_auto_route_rule(monkeypatch, case):
    """MIL_CONV_SEP=auto on a CUDA volume takes K1 where every plan's tap
    cost is within the ceiling of the FFT route it would otherwise take and
    of the plan's K1 instantiation: the measured configurations take the
    route that ran faster on the card."""
    _name, psf, shape, kw, spec, takes = case
    plan = plan_sep(psf, shape, **kw)
    cost = D.tap_cost(plan)
    assert D.k1_specialised(plan) == spec
    for impl, want in zip(("ct", "torch"), takes):
        assert D.sep_auto_takes([plan], impl) == want, impl
        assert (cost <= D.SEP_MAX_TAP_COST[impl][0 if spec else 1]) == want
        monkeypatch.setitem(D.SEP_MAX_TAP_COST, impl, (cost, cost))
        assert D.sep_auto_takes([plan, plan], impl)
        monkeypatch.setitem(D.SEP_MAX_TAP_COST, impl, (cost - 1, cost - 1))
        assert not D.sep_auto_takes([plan], impl)


def test_sep_plans_applies_the_rule_only_on_cuda_and_under_auto(monkeypatch):
    psf = tilted()
    bp = np.ascontiguousarray(psf[::-1, ::-1, ::-1])
    shape = (64, 64, 256)
    assert D._sep_plans(psf, bp, shape)[0] == "pair"            # no volume: CPU rule
    monkeypatch.setattr(D, "_on_cuda", lambda arr: True)
    assert D._sep_plans(psf, bp, shape) is None                 # auto on the card
    monkeypatch.setenv("MIL_CONV_SEP", "1")
    assert D._sep_plans(psf, bp, shape)[0] == "pair"            # forced separable
    monkeypatch.setenv("MIL_CONV_SEP", "off")
    assert D._sep_plans(psf, bp, shape) is None                 # forced FFT
    monkeypatch.setenv("MIL_CONV_SEP", "auto")
    g = gauss3((25, 25, 25), (3.5, 1.2, 1.2))
    gb = np.ascontiguousarray(g[::-1, ::-1, ::-1])
    # the fusion PSF against the FFT route the grid takes: K3 on the
    # fusion grid, torch.fft with an axis K3 has no specialised length for
    assert D._fft_impl((320, 512, 320), np.empty(0)) == "ct"
    assert D._sep_plans(g, gb, (320, 512, 320)) is None
    assert D._fft_impl((320, 512, 1088), np.empty(0)) == "torch"
    assert D._sep_plans(g, gb, (320, 512, 1088))[0] == "pair"
    monkeypatch.setenv("MIL_CONV_SEP_FUSED", "1")               # opting into K2 opts in
    assert D._sep_plans(g, gb, shape)[0] == "fused"
