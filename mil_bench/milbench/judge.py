"""How ``correct`` is decided: each number the cell's entry works out
against the plain reference is held to its limit in
``mil_bench/limits/<cell>.json`` ({name: limit}); a number without a
limit there is printed and not compared. A run is correct when every
call completed, every compared number is at or under its limit, and the
sample was judged at all."""

from __future__ import annotations

import math

import numpy as np
import torch


def as_f64(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=torch.float64)


def rel_l2(out, ref):
    """||out - ref|| / ||ref||, in float64 on ``ref``'s device."""
    o = as_f64(out, ref.device)
    r = ref.to(torch.float64)
    if o.shape != r.shape:
        return math.inf
    num = torch.linalg.vector_norm(o - r).item()
    den = torch.linalg.vector_norm(r).item()
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def worst(readings):
    """{name: worst value} over a list of {name: value} (larger is worse)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            v = float(v) if v is not None and math.isfinite(float(v)) else math.inf
            out[k] = max(out.get(k, -math.inf), v)
    return out


def verdict(readings, limits, attempted, failed):
    """(correct, checks): ``checks`` is {name: {"value", "limit"}} for
    every number, the worst over the judged sample; limit None where the
    number is not compared."""
    w = worst(readings)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in sorted(w.items())}
    ok = bool(readings) and attempted > 0 and failed == 0
    for name, lim in limits.items():
        v = w.get(name, math.inf)
        if not v <= lim:
            ok = False
    return ok, checks
