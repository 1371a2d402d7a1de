"""Fit, and check on every float32 it covers, a model of the float32 sine
and cosine that torch computes on the CPU, and write it as the header
``csrc/torch_trig.cuh`` that K9's matrix builders (``csrc/reg_opt.cuh``)
use, so that the card's ladder builds its rotations from the same bits as
the host loop (``models/registration_device.py::dof_to_matrix_t``, which
calls ``torch.sin`` / ``torch.cos`` on CPU float32 tensors).

torch's CPU sine and cosine (MKL's vector math in the builds this port
runs on) are not correctly rounded: of the float32 angles from 2**-12 to
1 rad, 1.3% of sines and 7.1% of cosines lie one unit in the last place
from the correctly rounded value (``--check`` counts them). They are, though, the float32 rounding of a smooth function of the
angle: r(x) = round(f(x) + d(x)), f the exact value and d(x) a smooth
error of ~0.1 unit. On each window of the angle this tool finds a
Chebyshev polynomial for d by linear programming (every sampled float32
near a rounding boundary bounds d from one side), then evaluates the model
round(f + d) on every float32 of the window and counts the angles where it
differs from torch. Windows whose fit fails or leaves more than
``MAX_MISSES`` such angles are halved. Below 1/4 torch's error is smooth
only on pieces of 1/128 of a binade or less (the fits there fail on wider
ones), so the windows start that small there.

Below 2**-12 both functions are correctly rounded, and the model there is
float32(f(x)). Above ``LIMIT`` (1 rad, 57.3 degrees: the ladder's angles
are degrees / 57.3) the header's functions return the correctly rounded
value, which torch's differs from on some angles.

    python microimagelib_tpu_torch/tools/torch_trig_fit.py            # fit, write, check
    python microimagelib_tpu_torch/tools/torch_trig_fit.py --check    # check the header

The windows' model misses torch's value on a few angles of each window
(at most ``MAX_MISSES``, where the two lie within the fit's precision of
a rounding boundary); the header lists those angles with torch's values,
so that it gives torch's on every float32 below ``LIMIT``. The last line of
output is a JSON summary (windows, float32s checked, angles where the
header and torch differ: 0, or the exit code is 1; and per function the
angles where torch's value is not the correctly rounded one).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import re
import sys
from pathlib import Path

import numpy as np
import torch

HEADER = Path(__file__).resolve().parents[1] / "csrc" / "torch_trig.cuh"
LOW = 2.0 ** -12
LIMIT = 1.0
DEGREE = 5
PIECES = 32
SAMPLES = 100_000
MAX_MISSES = 4
FUNCS = {"sin": (np.sin, torch.sin), "cos": (np.cos, torch.cos)}


def floats(a, b, step=1):
    """Every ``step``-th float32 in [a, b) (a, b >= 0)."""
    lo = int(np.float32(a).view(np.int32))
    hi = int(np.float32(b).view(np.int32))
    return np.arange(lo, hi, step, dtype=np.int32).view(np.float32)


def chunks(a, b, size=1 << 22):
    """Every float32 in [a, b), a chunk at a time."""
    lo = int(np.float32(a).view(np.int32))
    hi = int(np.float32(b).view(np.int32))
    for i in range(lo, hi, size):
        yield np.arange(i, min(i + size, hi), dtype=np.int32).view(np.float32)


def exact(name, x):
    return FUNCS[name][0](x.astype(np.float64))


def torch_f32(name, x):
    out = np.empty_like(x)
    for i in range(0, x.size, 1 << 24):
        out[i:i + (1 << 24)] = FUNCS[name][1](torch.from_numpy(x[i:i + (1 << 24)])).numpy()
    return out


def local(x, a, b):
    mid = 0.5 * (a + b)
    inv_half = 2.0 / (b - a)
    return (x.astype(np.float64) - mid) * inv_half


def clenshaw(t, c):
    """sum_k c[k] T_k(t), in the order the header evaluates it."""
    b1 = np.zeros_like(t)
    b2 = np.zeros_like(t)
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = 2.0 * t * b1 - b2 + c[k], b1
    return t * b1 - b2 + c[0]


def model(name, x, a, b, c):
    return (exact(name, x) + clenshaw(local(x, a, b), c)).astype(np.float32)


def fit_window(name, a, b, degree=DEGREE):
    """Chebyshev coefficients of d on [a, b) in absolute units, and the LP's
    margin in units of ``unit`` (> 0: every sampled constraint holds)."""
    from numpy.polynomial import chebyshev
    from scipy.optimize import linprog

    n = int(np.float32(b).view(np.int32)) - int(np.float32(a).view(np.int32))
    x = floats(a, b, max(1, n // SAMPLES))
    r = torch_f32(name, x)
    f = exact(name, x)
    unit = float(np.spacing(np.float32(abs(exact(name, np.array([0.5 * (a + b)]))[0]))))
    lo = ((np.nextafter(r, np.float32(-np.inf)).astype(np.float64) + r) / 2 - f) / unit
    hi = ((np.nextafter(r, np.float32(np.inf)).astype(np.float64) + r) / 2 - f) / unit
    keep = np.minimum(np.abs(lo), np.abs(hi)) < 0.3
    v = chebyshev.chebvander(local(x[keep], a, b), degree)
    n = degree + 1
    ones = np.ones((v.shape[0], 1))
    res = linprog(np.r_[np.zeros(n), -1.0],
                  A_ub=np.vstack([np.hstack([-v, ones]), np.hstack([v, ones])]),
                  b_ub=np.r_[-lo[keep], hi[keep]],
                  bounds=[(None, None)] * n + [(None, 1.0)], method="highs",
                  options={"time_limit": 60.0})
    if res.status != 0:
        return None, -1.0
    return res.x[:n] * unit, float(res.x[-1])


def misses(name, a, b, c=None):
    """Float32s in [a, b) where the model (the correctly rounded value
    where ``c`` is None) and torch differ, and float32s checked."""
    bad = total = 0
    for xs in chunks(a, b):
        m = exact(name, xs).astype(np.float32) if c is None else model(name, xs, a, b, c)
        bad += int(np.count_nonzero(m != torch_f32(name, xs)))
        total += xs.size
    return bad, total


def first_windows():
    """Each binade of the angle from LOW to LIMIT in equal windows: 128
    below 1/4 (where torch's error is smooth only on such pieces), 32 above;
    cut at pi/4 and LIMIT."""
    cuts = [float(np.float32(np.pi / 4)), LIMIT]
    edges = []
    lo = LOW
    while lo < LIMIT:
        pieces = 128 if lo < 0.25 else 32
        edges += [lo + k * lo / pieces for k in range(pieces)]
        lo *= 2
    edges = sorted({e for e in edges if e < LIMIT} | set(cuts))
    return list(zip(edges[:-1], edges[1:]))


def fit_one(name, a, b):
    """Windows covering [a, b), halving [a, b) until each window's model
    leaves at most MAX_MISSES float32s where it and torch differ."""
    bad, n = misses(name, a, b)
    if bad == 0:
        # torch's values are the correctly rounded ones here: d = 0
        return [(a, b, np.zeros(DEGREE + 1))], f"{name} [{a!r}, {b!r}): correctly rounded"
    c, margin = fit_window(name, a, b)
    bad = misses(name, a, b, c)[0] if c is not None else None
    if c is not None and margin > 0 and bad <= MAX_MISSES:
        return [(a, b, c)], f"{name} [{a!r}, {b!r}): margin {margin:.3g}, {bad} of {n} differ"
    m = float(np.float32(0.5 * (a + b)))
    lo, log_lo = fit_one(name, a, m)
    hi, log_hi = fit_one(name, m, b)
    return lo + hi, f"{log_lo}\n{log_hi}"


def _task(args):
    torch.set_num_threads(1)
    return args[0], fit_one(*args)


def fit_all(workers):
    tasks = [(name, a, b) for name in FUNCS for a, b in first_windows()]
    out = {name: [] for name in FUNCS}
    with multiprocessing.get_context("fork").Pool(workers) as pool:
        for name, (rows, msg) in pool.imap(_task, tasks):
            log(msg)
            out[name] += rows
    return out


def c_double(v):
    return float.hex(float(v))


def exceptions(name, rows, log):
    """(keys, values): the float32 bits of every angle in [LOW, LIMIT) where
    the windows' model and torch differ, and torch's value's bits there."""
    keys, vals = [], []
    for a, b, c in rows:
        for xs in chunks(a, b):
            r = torch_f32(name, xs)
            bad = model(name, xs, a, b, c) != r
            keys.append(xs[bad].view(np.uint32))
            vals.append(r[bad].view(np.uint32))
    keys, vals = np.concatenate(keys), np.concatenate(vals)
    log(f"{name}: {keys.size} angles where the windows' model and torch differ")
    return keys, vals


def with_exceptions(xs, m, keys, vals):
    """The model ``m`` of the float32s ``xs`` with torch's values at the
    exceptions."""
    if keys.size == 0:
        return m
    i = np.minimum(np.searchsorted(keys, xs.view(np.uint32)), keys.size - 1)
    hit = keys[i] == xs.view(np.uint32)
    out = m.copy()
    out[hit] = vals[i[hit]].view(np.float32)
    return out


def write_header(fits, path):
    """``fits``: {name: [(a, b, coefficients), ...]} in order of a."""
    exc = {name: exceptions(name, rows, log) for name, rows in fits.items()}
    lines = [
        "// Generated by microimagelib_tpu_torch/tools/torch_trig_fit.py from",
        f"// torch {torch.__version__}'s CPU float32 sine and cosine; do not edit.",
        "//",
        "// torch_sinf / torch_cosf return torch's float32 sin / cos of x on the CPU:",
        "// the rounding of the exact value plus a Chebyshev model of torch's error",
        f"// on windows of |x| from 2^-12 to {LIMIT}, and torch's own value at the angles",
        "// where that model misses it (every float32 there checked by the tool); the",
        "// correctly rounded value below 2^-12, where torch's is that too, and above,",
        "// where torch's may differ from it by one unit in the last place.",
        "",
        "#pragma once",
        "",
        "#include <math.h>",
        "",
        "#ifdef __CUDACC__",
        "#define MIL_TRIG_HD __host__ __device__",
        "#else",
        "#define MIL_TRIG_HD",
        "#endif",
        "",
        "namespace mil_trig {",
        "",
        f"constexpr int kDegree = {DEGREE};",
        f"constexpr double kLow = {c_double(LOW)};",
        f"constexpr double kLimit = {c_double(LIMIT)};",
        "",
    ]
    for name, windows in fits.items():
        lines.append(f"// {name}: {len(windows)} windows [a, b), coefficients of T_0..T_{DEGREE}")
        lines.append(f"constexpr int k{name.capitalize()}Windows = {len(windows)};")
        lines.append(f"struct {name.capitalize()}Table {{")
        lines.append(f"  static MIL_TRIG_HD inline const double* row(int i) {{")
        lines.append(f"    static constexpr double t[{len(windows)}][{DEGREE + 3}] = {{")
        for a, b, c in windows:
            vals = ", ".join(c_double(v) for v in (a, b, *c))
            lines.append(f"        {{{vals}}},")
        lines.append("    };")
        lines.append("    return t[i];")
        lines.append("  }")
        lines.append("};")
        keys, vals = exc[name]
        lines.append(f"// {name}: {keys.size} angles where the windows' model misses torch's value "
                     "(|x|'s bits, torch's value's bits), sorted")
        lines.append(f"constexpr int k{name.capitalize()}Exceptions = {keys.size};")
        lines.append(f"struct {name.capitalize()}Exceptions {{")
        lines.append(f"  static MIL_TRIG_HD inline const unsigned* row(int i) {{")
        lines.append(f"    static constexpr unsigned t[{keys.size + 1}][2] = {{")
        pairs = [f"{{0x{int(k):08x}u, 0x{int(v):08x}u}}" for k, v in zip(keys, vals)]
        pairs.append("{0xffffffffu, 0u}")
        for i in range(0, len(pairs), 4):
            lines.append("        " + ", ".join(pairs[i:i + 4]) + ",")
        lines.append("    };")
        lines.append("    return t[i];")
        lines.append("  }")
        lines.append("};")
        lines.append("")
    lines += [
        "// d(x) on the window row w: sum c_k T_k(t), t = (x - mid) * 2 / (b - a), by",
        "// Clenshaw's recurrence in double.",
        "MIL_TRIG_HD inline double window_error(const double* w, double x) {",
        "  const double t = (x - 0.5 * (w[0] + w[1])) * (2.0 / (w[1] - w[0]));",
        "  const double* c = w + 2;",
        "  double b1 = 0.0, b2 = 0.0;",
        "  for (int k = kDegree; k > 0; --k) {",
        "    const double b0 = 2.0 * t * b1 - b2 + c[k];",
        "    b2 = b1;",
        "    b1 = b0;",
        "  }",
        "  return t * b1 - b2 + c[0];",
        "}",
        "",
        "template <class Table>",
        "MIL_TRIG_HD inline double table_error(int n, double ax) {",
        "  int lo = 0, hi = n - 1;",
        "  while (lo < hi) {",
        "    const int mid = (lo + hi + 1) / 2;",
        "    if (Table::row(mid)[0] <= ax) lo = mid; else hi = mid - 1;",
        "  }",
        "  return window_error(Table::row(lo), ax);",
        "}",
        "",
        "MIL_TRIG_HD inline unsigned float_bits(float f) {",
        "  union {",
        "    float f;",
        "    unsigned u;",
        "  } v;",
        "  v.f = f;",
        "  return v.u;",
        "}",
        "",
        "MIL_TRIG_HD inline float bits_float(unsigned u) {",
        "  union {",
        "    unsigned u;",
        "    float f;",
        "  } v;",
        "  v.u = u;",
        "  return v.f;",
        "}",
        "",
        "// r, or torch's value where the angle |x| is one of Table's exceptions.",
        "template <class Table>",
        "MIL_TRIG_HD inline float with_exception(int n, float ax, float r) {",
        "  const unsigned key = float_bits(ax);",
        "  int lo = 0, hi = n;",
        "  while (lo < hi) {",
        "    const int mid = (lo + hi) / 2;",
        "    if (Table::row(mid)[0] < key) lo = mid + 1; else hi = mid;",
        "  }",
        "  return lo < n && Table::row(lo)[0] == key ? bits_float(Table::row(lo)[1]) : r;",
        "}",
        "",
        "MIL_TRIG_HD inline float torch_sinf(float x) {",
        "  const float axf = fabsf(x);",
        "  const double ax = axf;",
        "  float r = static_cast<float>(sin(ax));",
        "  if (ax >= kLow && ax < kLimit) {",
        "    r = static_cast<float>(sin(ax) + table_error<SinTable>(kSinWindows, ax));",
        "    r = with_exception<SinExceptions>(kSinExceptions, axf, r);",
        "  }",
        "  return x < 0.f ? -r : (x == 0.f ? x : r);",
        "}",
        "",
        "MIL_TRIG_HD inline float torch_cosf(float x) {",
        "  const float axf = fabsf(x);",
        "  const double ax = axf;",
        "  float r = static_cast<float>(cos(ax));",
        "  if (ax >= kLow && ax < kLimit) {",
        "    r = static_cast<float>(cos(ax) + table_error<CosTable>(kCosWindows, ax));",
        "    r = with_exception<CosExceptions>(kCosExceptions, axf, r);",
        "  }",
        "  return r;",
        "}",
        "",
        "}  // namespace mil_trig",
        "",
    ]
    path.write_text("\n".join(lines))


def read_header(path):
    """{name: ([(a, b, coefficients)], exception keys, exception values)}
    from the header."""
    text = path.read_text()
    out = {}
    for name in FUNCS:
        cap = name.capitalize()
        body = re.search(rf"struct {cap}Table.*?= \{{(.*?)\n    \}};", text, re.S)
        rows = [[float.fromhex(v.strip()) for v in row.split(",")]
                for row in re.findall(r"\{([^{}]*)\}", body.group(1))]
        body = re.search(rf"struct {cap}Exceptions.*?= \{{(.*?)\n    \}};", text, re.S)
        pairs = (re.findall(r"\{0x([0-9a-f]+)u, 0x([0-9a-f]+)u\}", body.group(1))
                 if body else [])
        keys = np.array([int(k, 16) for k, _ in pairs], np.uint32)
        vals = np.array([int(v, 16) for _, v in pairs], np.uint32)
        out[name] = ([(r[0], r[1], np.array(r[2:])) for r in rows], keys, vals)
    return out


def check(path, log):
    """Every float32 angle from 0 to LIMIT: the header's value (its windows'
    model with its exceptions; the correctly rounded one below LOW) against
    torch's; and how many of torch's values are not the correctly rounded
    ones."""
    total = bad = windows = 0
    not_cr = {}
    for name, (rows, keys, vals) in read_header(path).items():
        n_bad = n = n_cr = 0
        for a, b, c in rows:
            for xs in chunks(a, b):
                r = torch_f32(name, xs)
                m = with_exceptions(xs, model(name, xs, a, b, c), keys, vals)
                n_bad += int(np.count_nonzero(m != r))
                n_cr += int(np.count_nonzero(exact(name, xs).astype(np.float32) != r))
                n += xs.size
        m, n_low = misses(name, 0.0, LOW)
        log(f"{name}: {len(rows)} windows, {keys.size} exceptions; of {n} float32s in "
            f"[2^-12, {LIMIT}) {n_bad} differ from torch's ({n_cr} of torch's are not "
            f"correctly rounded), of {n_low} in [0, 2^-12) {m}")
        total += n + n_low
        bad += n_bad + m
        windows += len(rows)
        not_cr[name] = n_cr + m
    return {"windows": windows, "float32s": total, "differ": bad,
            "torch_not_correctly_rounded": not_cr}


def log(msg):
    print(msg, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="only check the header")
    ap.add_argument("--workers", type=int, default=4, help="fitting processes")
    ap.add_argument("--out", type=Path, default=HEADER)
    args = ap.parse_args(argv)

    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    if not args.check:
        write_header(fit_all(args.workers), args.out)
    summary = check(args.out, log)
    summary["torch"] = torch.__version__
    print(json.dumps(summary))
    return 0 if summary["differ"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
