"""K9's layout on the CPU: the wrapper's mirrors of ``csrc/reg_ladder.cu``
and ``csrc/reg_opt.cuh`` read from the sources themselves (so that a mirror
cannot drift where there is no ``nvcc`` to check it), and the trace's
stamps as ``kernels/reg_ladder.py::trace_split`` reads them. The card
checks the same mirrors when it loads the library
(``kernels/reg_ladder.py::_library``) and holds the kernel to its host loop
(``tests/test_torch_kernels.py -k reg_ladder``)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.kernels import reg_ladder as RL

CSRC = Path(RL.__file__).resolve().parents[1] / "csrc"
LADDER = (CSRC / "reg_ladder.cu").read_text()
OPT = (CSRC / "reg_opt.cuh").read_text()
C_SIZES = {"float": 4, "int": 4, "unsigned": 4, "double": 8, "unsigned long long": 8}


def _constexpr_ints(text):
    """Every ``constexpr int kName = <integer arithmetic on earlier
    names>;`` (others, such as a sizeof, are left out)."""
    vals = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        if re.fullmatch(r"[\w\s+*/()-]+", expr) and "sizeof" not in expr:
            # C++ integer arithmetic: / truncates
            vals[name] = eval(expr.replace("/", "//"), {}, dict(vals))   # noqa: S307
    return vals


def _struct_bytes(text, name):
    """The size of a plain struct of 4- and 8-byte scalars and arrays of
    them, laid out as the C++ compiler lays it out."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", text, re.S).group(1)
    size = align = 0
    for decl in re.findall(r"^\s*([a-z][a-z ]*?) (\w+(?:\[\d+\])?(?:, \w+(?:\[\d+\])?)*);",
                           body, re.M):
        ctype, names = decl
        width = C_SIZES[ctype]
        for item in names.split(", "):
            count = int(re.search(r"\[(\d+)\]", item).group(1)) if "[" in item else 1
            size = -(-size // width) * width + width * count
            align = max(align, width)
    return -(-size // align) * align


def test_trace_layout_mirrors_the_source():
    k = _constexpr_ints(LADDER)
    assert (k["kStampAt"], k["kStamps"], k["kTraceWords"]) == (
        RL.STAMP_AT, len(RL.STAMPS), RL.TRACE_WORDS)
    # kind, the matrix and the 26 sums fit before the stamps, and so do the
    # matrix count and K6's other matrices
    assert RL.STAMP_AT >= 1 + 12 + 26
    assert k["kMatsAt"] == RL.MATS_AT >= 1 + 12 + 26 + 1
    assert k["kTraceProbes"] == C.MAX_PROBES
    assert RL.MATS_AT + 12 * (C.MAX_PROBES - 1) <= RL.STAMP_AT


def test_stage_kernels_mirror_the_source():
    """MIL_K9_STAGE_KINDS lists one kernel a (BODY, VX, IDX), in the
    wrapper's order, and covers every (vx, wide) K4/K5's plan can give, for
    K4's body (1), K5's (0) and K6's (2, on K5's plan)."""
    block = re.search(r"#define MIL_K9_STAGE_KINDS\(X\)(.*?)\n\n", LADDER, re.S).group(1)
    kinds = [(int(b), int(v), int(i == "long long"))
             for b, v, i in re.findall(r"X\((\d), (\d), (int|long long)\)", block)]
    assert tuple(kinds) == RL.INSTANTIATIONS
    assert len(set(kinds)) == len(kinds) == 18
    assert RL.BODIES == {"K5": 0, "K4": 1, "K6": 2}
    body_ids = {name: int(v) for name, v in re.findall(r"constexpr int kBody(K\d) = (\d);",
                                                          OPT)}
    assert body_ids == RL.BODIES
    for shape in ((16, 32, 128), (24, 40, 100), (64, 128, 512), (256, 512, 512),
                  (3, 5, 7), (1100, 1400, 1400)):
        for grad in (True, False):
            p = C.launch_plan(shape, grad)
            assert (int(grad), p["vx"], p["wide"]) in RL.INSTANTIATIONS
            if not grad:
                assert (2, p["vx"], p["wide"]) in RL.INSTANTIATIONS


def test_ladder_structs_mirror_the_source():
    """LadderArgs and LadderState (reg_opt.cuh) against the ctypes mirrors,
    the state within its words, the control words' lines."""
    k = _constexpr_ints(LADDER)
    assert _struct_bytes(OPT, "LadderArgs") == ctypes.sizeof(RL.LadderArgs)
    assert _struct_bytes(OPT, "LadderState") == ctypes.sizeof(RL.LadderState)
    assert ctypes.sizeof(RL.LadderState) <= 8 * k["kStateWords"]
    # the control words: whole lines, among them kReleaseLines for each copy
    # of the published matrices (K6's 8 matrices and the generation); the
    # state after them starts on a line
    assert (k["kSyncWords"] * 8) % k["kLine"] == 0
    assert k["kSyncWords"] * 8 > k["kCopies"] * k["kLine"] >= k["kLine"]
    assert k["kReleaseLines"] * k["kLine"] >= 16 + 4 * 12 * k["kTraceProbes"]
    assert k["kSyncWords"] * 8 >= k["kCopies"] * k["kReleaseLines"] * k["kLine"]


def test_trace_split_reads_the_stamps():
    """The split's parts are consecutive intervals between the stamps and
    add up to the evaluation; the rows end at the later of the other
    blocks' last arrival and block 0's own row; release sits inside rows."""
    rng = np.random.default_rng(3)
    n = 7
    base = 1_700_000_000_000_000_000 + rng.integers(0, 10 ** 6, n).cumsum() * 100
    gaps = rng.integers(1, 5000, (n, 6))
    p = base
    s = p + gaps[:, 0]
    a = s + gaps[:, 1]
    r0 = p + gaps[:, 2]
    done = np.maximum(a, r0)
    w = done + gaps[:, 3]
    c = w + gaps[:, 4]
    nx = c + gaps[:, 5]
    trace = np.zeros((n, RL.TRACE_WORDS))
    trace[:, 0] = np.arange(n) % 2
    stamps = np.stack([p, s, a, r0, w, c, nx], 1).astype(np.int64)
    trace[:, RL.STAMP_AT:] = stamps.view(np.float64)
    sp = RL.trace_split(trace)
    np.testing.assert_array_equal(sp["rows"], (done - p) / 1e3)
    np.testing.assert_array_equal(sp["rows_others"], (a - p) / 1e3)
    np.testing.assert_array_equal(sp["rows_block0"], gaps[:, 2] / 1e3)
    np.testing.assert_array_equal(sp["release"], gaps[:, 0] / 1e3)
    np.testing.assert_array_equal(sp["handover"], gaps[:, 3] / 1e3)
    np.testing.assert_array_equal(sp["colsum"], gaps[:, 4] / 1e3)
    np.testing.assert_array_equal(sp["step"], gaps[:, 5] / 1e3)
    np.testing.assert_allclose(sp["rows"] + sp["handover"] + sp["colsum"] + sp["step"],
                               sp["evaluation"])
    med = RL.split_medians(trace, 1)
    assert med["n"] == 3 and med["step"] == np.median(gaps[1::2, 5] / 1e3)
    trace[:, RL.STAMP_AT + 1] = 0.0   # a one-block grid: no other block starts
    trace[:, RL.STAMP_AT + 2] = 0.0
    sp = RL.trace_split(trace)
    assert not sp["release"].any() and not sp["rows_others"].any()
    np.testing.assert_array_equal(sp["rows"], gaps[:, 2] / 1e3)


def test_body_takes_the_plan_instantiation():
    """A stage kernel and a row function of each (BODY, VX, IDX), no
    run-time switch over vx or 64-bit offsets inside a body, the optimizer
    one function a body; the source is relocatable device code, so a
    body's six kernels share that one compiled copy."""
    from microimagelib_tpu_torch.kernels import build

    for name in ("__global__ void __launch_bounds__\\([^)]*\\)\nreg_stage_kernel",
                 "__device__ __noinline__ void stage_row"):
        assert re.search(r"template <int BODY, int VX, typename IDX>\n" + name + r"\(",
                         LADDER), name
    assert re.search(r"template <int BODY>\n__device__ __noinline__ void drive\(", LADDER)
    assert "-rdc=true" in build.FILE_FLAGS["reg_ladder.cu"]
    kinds = re.search(r"kStageKinds\[\] = \{MIL_K9_STAGE_KINDS\(MIL_K9_KIND\)\}", LADDER)
    assert kinds and "reg_stage_kernel<B, V, I>" in LADDER


def _sum_columns_model(partials):
    """corr_body.cuh::sum_columns over the columns of ``partials`` ((columns,
    rows) float64): thread t adds rows t, t + 128, ... of each column in
    order, then the block's shuffle tree and the warps in order
    (``tests/test_torch_kernels.py::_block_sum``)."""
    from test_torch_kernels import _block_sum

    ncols, nb = partials.shape
    acc = np.zeros((ncols, C.WARPS, 32))
    flat = acc.reshape(ncols, C.WARPS * 32)
    for start in range(0, nb, C.WARPS * 32):
        rows = partials[:, start:start + C.WARPS * 32]
        flat[:, :rows.shape[1]] = flat[:, :rows.shape[1]] + rows
    return _block_sum(acc)


@pytest.mark.parametrize("nv", [2, 26])
@pytest.mark.parametrize("nb", [1, 2, 127, 128, 129, 512, 527, 790])
def test_spread_column_sum_keeps_sum_columns_bits(nb, nv):
    """K9 sums K4's columns in several blocks (column k by block k + 1, any
    left over by block 0): each column summed alone in sum_columns' order
    gives the bits of block 0 summing all the columns at once."""
    rng = np.random.default_rng(nb * 100 + nv)
    # rows of mixed sign and magnitude, so that the order of the adds shows
    partials = rng.standard_normal((nv, nb)) * 10.0 ** rng.integers(-6, 7, (nv, nb))
    together = _sum_columns_model(partials)
    owned = min(nb - 1, nv)
    spread = [_sum_columns_model(partials[k:k + 1])[0] for k in range(owned)]
    rest = _sum_columns_model(partials[owned:]) if owned < nv else np.zeros(0)
    got = np.concatenate([np.array(spread, np.float64), rest])
    assert got.view(np.int64).tolist() == together.view(np.int64).tolist()
    if nb > 128:
        # the model is not numpy's sum: the order of the adds matters here
        assert (together != partials.sum(axis=1)).any() or nv == 2


def test_record_ladders_gives_each_call_and_its_args():
    """record_ladders sees every call of reg_ladder made through the module
    (as the models make it), restores it on exit, and args_of rebuilds the
    call's LadderArgs; a CPU pair then raises, its ladder being the host
    loop's."""
    import torch

    src = torch.zeros((4, 5, 6))
    p0 = np.eye(3, 4, dtype=np.float32).reshape(12)
    orig = RL.reg_ladder
    with RL.record_ladders() as calls:
        with pytest.raises(ValueError):
            RL.reg_ladder(src, src, 2.5, p0, 7, 1e-4, 300, engine="device")
    assert RL.reg_ladder is orig and len(calls) == 1
    got = RL.args_of(calls[0])
    want = RL.ladder_args("device", 7, p0, 1e-4, 300, 2.5, (4, 5, 6))
    assert bytes(got) == bytes(want)
