"""K7's plain version and the roofline tool of the port on the CPU.

``pipe_copy_torch`` against the Pallas copy of tools/conv_roofline.py
(rebuilt here from that file's ``pipe_copy``, a closure inside its
``main()``, and run in interpret mode) with the JAX planner's slab height
and lookahead for the bench PSF, bit for bit (tolerance 0: both round
``aux + v * 1e-6`` as one float32 FMA). The FMA helper against exact
rational arithmetic. The wrapper's CPU rule and argument checks, the
tool's CPU run (every metric, finite, no JAX imported) and its model
lines against their formulas. The CUDA kernel itself is compared with
the plain version in test_torch_kernels.py."""

import json
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from microimagelib_tpu.ops.conv_sep import plan_sep_pair as jax_plan_sep_pair
from microimagelib_tpu_torch.kernels import pipe_copy as K7
from microimagelib_tpu_torch.ops.conv_sep import plan_sep_pair
from microimagelib_tpu_torch.tools import conv_roofline as T
from test_conv_sep import tilted_gauss

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
METRICS = {
    "rl512_ms_per_iter", "plan_fwd_rank", "plan_z_taps", "plan_y_taps", "plan_x_taps",
    "conv_ratio_ms_per_call", "conv_update_ms_per_call", "conv_launch_ms",
    "pipe_copy_shift", "pipe_copy_ms_per_call_z", "pipe_copy_bw_z",
    "pipe_copy_ms_per_call_xy", "pipe_copy_bw_xy", "torch_elementwise_bw",
    "model_traffic_per_iter", "model_fp32_tflop_per_iter", "achieved_bw_vs_model",
    "pct_of_pipe_copy_ceiling", "conv_pct_of_copy_ceiling"}


def flip(p):
    return np.ascontiguousarray(p[::-1, ::-1, ::-1])


def jax_pipe_copy(shape, zb, la, lb):
    """tools/conv_roofline.py:124-155 for a (nz, ny, nx) grid: the grid
    and BlockSpecs of its pipe_copy, in interpret mode."""
    nz, ny, nx = shape
    g, lag = nz // zb, la + lb

    def copy_kernel(v_ref, aux_ref, o_ref):
        i = pl.program_id(0)

        @pl.when(i >= lag)
        def _():
            o_ref[...] = aux_ref[...] + v_ref[...] * 1e-6

    @jax.jit
    def pipe_copy(v, aux):
        in_spec = pl.BlockSpec((zb, ny, nx), lambda i: ((i + g - la) % g, 0, 0),
                               memory_space=pltpu.VMEM)
        out_map = lambda i: (jnp.maximum(i - lag, 0), 0, 0)  # noqa: E731
        return pl.pallas_call(
            copy_kernel,
            grid=(g + lag,),
            in_specs=[in_spec, pl.BlockSpec((zb, ny, nx), out_map,
                                            memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((zb, ny, nx), out_map, memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
            compiler_params=pltpu.CompilerParams(vmem_limit_bytes=100 * 1024 * 1024),
            interpret=True,
        )(v, aux)

    return pipe_copy


@pytest.mark.parametrize("shape", [(32, 128, 128), (64, 128, 256), (48, 256, 128)])
def test_plain_copy_equals_jax_pallas_copy(shape):
    psf = T.bench_psf()
    pf, _ = jax_plan_sep_pair(psf, flip(psf), shape)
    zb, a, b = pf.meta[:3]
    la, lb = -(-a // zb), -(-b // zb)
    rng = np.random.default_rng(0)
    v = rng.random(shape, dtype=np.float32) * 100 + 1
    aux = rng.random(shape, dtype=np.float32) * 100 + 1
    want = np.asarray(jax_pipe_copy(shape, zb, la, lb)(v, aux))
    got = K7.pipe_copy_torch(torch.from_numpy(v), torch.from_numpy(aux), lb * zb)
    np.testing.assert_array_equal(got.numpy(), want)
    # the grid's output block j reads v's block j + lb: a roll by -lb * zb
    assert not np.array_equal(want, K7.pipe_copy_torch(
        torch.from_numpy(v), torch.from_numpy(aux), -lb * zb).numpy())


def _fma_exact(x, y, z):
    """x * y + z rounded to float32 (nearest, ties to even) from the exact
    rational value."""
    ex = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    f = np.float32(float(ex))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - ex),
                                     int(np.array(c).view(np.int32)) & 1))


@pytest.mark.parametrize("sign", [1, -1])
def test_fma_f32_rounds_once_where_float64_rounds_twice(sign):
    # x * y = 2^-24 - 2^-60, z = 1 + 2^-23: float64 rounds the sum to the
    # float32 midpoint 1 + 2^-23 + 2^-24, which then rounds to even, up;
    # the exact sum lies below it, so one rounding gives 1 + 2^-23
    x = np.float32(sign * 2.0 ** -24 * (1 + 2.0 ** -18))
    y = np.float32(1 - 2.0 ** -18)
    z = np.float32(sign * (1 + 2.0 ** -23))
    twice = np.float32(float(x) * float(y) + float(z))
    once = K7.fma_f32(torch.tensor([x]), torch.tensor([y]), torch.tensor([z])).numpy()[0]
    assert once == _fma_exact(x, y, z) == np.float32(sign * (1 + 2.0 ** -23))
    assert twice != once


def test_fma_f32_matches_exact_rounding():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(3000) * 100).astype(np.float32)
    y = rng.standard_normal(3000).astype(np.float32)
    z = rng.standard_normal(3000).astype(np.float32)
    got = K7.fma_f32(*(torch.from_numpy(a) for a in (x, y, z))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(x, y, z)], np.float32)
    np.testing.assert_array_equal(got, want)
    v = rng.random(2000, dtype=np.float32) * 100 + 1
    aux = rng.random(2000, dtype=np.float32) * 100 + 1
    got = K7.pipe_copy_torch(torch.from_numpy(v).reshape(2000, 1, 1),
                             torch.from_numpy(aux).reshape(2000, 1, 1), 0).numpy().ravel()
    want = np.array([_fma_exact(a, K7.SCALE, b) for a, b in zip(v, aux)], np.float32)
    np.testing.assert_array_equal(got, want)
    special = K7.fma_f32(torch.tensor([np.inf, np.nan, 1.0]), 2.0,
                         torch.tensor([1.0, 1.0, -np.inf])).numpy()
    assert special[0] == np.inf and np.isnan(special[1]) and special[2] == -np.inf


@pytest.mark.parametrize("geometry", ["z", "xy"])
def test_pipe_copy_on_cpu_is_the_plain_version(geometry):
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.random((12, 20, 36), dtype=np.float32))
    aux = torch.from_numpy(rng.random((12, 20, 36), dtype=np.float32))
    before = K7.LAUNCHES
    for shift in (0, 5, 11, 12 + 5, -7):
        out = K7.pipe_copy(v, aux, shift, geometry)
        assert torch.equal(out, K7.pipe_copy_torch(v, aux, shift % 12))
        assert torch.equal(out, K7.pipe_copy_torch(v, aux, shift))
    assert K7.LAUNCHES == before


_BAD = {
    "dtype": (lambda v, a: (v.double(), a), TypeError),
    "aux dtype": (lambda v, a: (v, a.half()), TypeError),
    "shape": (lambda v, a: (v, a[:, :, :-1].contiguous()), ValueError),
    "2-D": (lambda v, a: (v[0], a[0]), ValueError),
    "empty": (lambda v, a: (v[:0], a[:0]), ValueError),
    "non-contiguous": (lambda v, a: (v.transpose(1, 2), a.transpose(1, 2)), ValueError),
    "not a tensor": (lambda v, a: (v.numpy(), a), TypeError),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_pipe_copy_rejects(case):
    make, err = _BAD[case]
    v = torch.zeros((8, 16, 16))
    aux = torch.ones((8, 16, 16))
    with pytest.raises(err):
        K7.pipe_copy(*make(v, aux), 0)
    with pytest.raises(ValueError):
        K7.pipe_copy(v, aux, 0, geometry="yz")


def test_tool_cpu_run_prints_every_metric_without_jax():
    code = (
        "import sys\n"
        "from microimagelib_tpu_torch.tools import conv_roofline as t\n"
        "rc = t.main(['--device', 'cpu', '--size', '32'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'microimagelib_tpu' or m.startswith('microimagelib_tpu.')]\n"
        "print('LEAKED', bad)\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=240)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "cpu" and lines[-1] == "LEAKED []"
    rows = [json.loads(ln) for ln in lines[1:-1]]
    vals = {r["metric"]: r["value"] for r in rows}
    assert set(vals) == METRICS and len(rows) == len(METRICS)
    assert [r["metric"] for r in rows] == list(T.METRICS)
    assert all(r["card"] == "cpu" for r in rows)
    assert all(np.isfinite(v) for v in vals.values())
    for stage in ("rl512_ms_per_iter", "conv_ratio_ms_per_call", "conv_update_ms_per_call",
                  "conv_launch_ms", "pipe_copy_ms_per_call_z", "pipe_copy_ms_per_call_xy"):
        assert vals[stage] > 0, stage
    assert (vals["plan_fwd_rank"], vals["plan_z_taps"], vals["pipe_copy_shift"]) == (1, 9, 4)


def test_tool_needs_a_card_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert T.main(["--size", "32"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["bench", "tilted rank 4"])
def test_model_lines_follow_their_formulas(case):
    shape = (32, 32, 64)
    if case == "bench":
        psf, kw = T.bench_psf(), {}
    else:
        psf, kw = tilted_gauss((17, 9, 25)), dict(tol=1e-4)
    pf, pb = plan_sep_pair(psf, flip(psf), shape, **kw)
    rank = pf.rank
    taps = pf.nsteps + pf.ty.shape[1] + pf.tx.shape[1]
    assert (pb.rank, pb.nsteps + pb.ty.shape[1] + pb.tx.shape[1]) == (rank, taps)
    assert rank == (1 if case == "bench" else 4)
    n = int(np.prod(shape))
    vol_gb = 4 * n / 1e9
    m = T.model(pf, pb, shape)
    # one launch a call: no rank volumes, whatever the rank
    assert set(m) == {"traffic", "tflop"}
    assert m["traffic"] == pytest.approx(2 * 3 * vol_gb, rel=1e-12)
    assert m["tflop"] == pytest.approx(2 * n * (2 * rank * taps + 1) / 1e12, rel=1e-12)
