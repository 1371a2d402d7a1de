"""L-BFGS for the gradient registration engine, in float32, driven from
the host with one device sync per value-and-gradient evaluation (the
JAX package's ``ops/lbfgs.py``, whose ``lax`` loops this follows branch
for branch).

The reference minimizes NCC with a derivative-free NR Powell search
(reference:src/api_powell.c:119-360) because texture sampling has no
derivative; the fused resample + NCC here is differentiable (K4,
``ops/corr.py``), so the search can be quasi-Newton. The reference's
loop-control semantics stay: the shared ``it_limit`` caps evaluations
(each value+grad call counts as one, like itNumStatic), a cost >= 1.001
aborts, and convergence uses Powell's relative ftol test.
"""

from __future__ import annotations

import os

import numpy as np

F32 = np.float32
COST_ABORT = F32(1.001)
HIST = 8
LS_MAX_BACK = 20
LS_MAX_FWD = 24
ARMIJO_C1 = F32(1e-4)


def lbfgs_env():
    """(max_iters, patience) from MIL_LBFGS_MAX_ITERS / MIL_LBFGS_PATIENCE,
    read per call."""
    return (int(os.environ.get("MIL_LBFGS_MAX_ITERS", "200")),
            int(os.environ.get("MIL_LBFGS_PATIENCE", "3")))


def _direction(g, mem_s, mem_y, mem_rho, k):
    """Two-loop recursion over the filled history slots (newest first)."""
    q = g.copy()
    n_hist = min(k, HIST)
    alphas = np.zeros(HIST, np.float32)
    for i in range(n_hist):
        idx = (k - 1 - i) % HIST
        a = mem_rho[idx] * np.dot(mem_s[idx], q)
        q = q - a * mem_y[idx]
        alphas[i] = a
    # H0 scaling: gamma = s.y / y.y of the newest pair
    gamma = F32(1.0)
    if k > 0:
        newest = (k - 1) % HIST
        ys = np.dot(mem_s[newest], mem_y[newest])
        yy = np.dot(mem_y[newest], mem_y[newest])
        if yy > 0:
            gamma = ys / max(yy, F32(1e-20))
    r = gamma * q
    for i in range(HIST):
        j = HIST - 1 - i
        if j < n_hist:
            idx = (k - 1 - j) % HIST
            b = mem_rho[idx] * np.dot(mem_y[idx], r)
            r = r + (alphas[j] - b) * mem_s[idx]
    return -r


def lbfgs_minimize(value_and_grad, p0, ftol, it_limit, nev0=0,
                   max_iters=None, patience=None):
    """Minimize with L-BFGS (two-loop recursion, history 8, Armijo
    backtracking + expansion line search). ``value_and_grad``: (n,)
    float32 numpy -> (float32 f, float32 (n,) g); each call counts one
    evaluation. ``max_iters``/``patience`` default to the MIL_LBFGS_* env
    knobs. Returns (p_min, f_min, total_evals)."""
    if max_iters is None or patience is None:
        env_mi, env_pa = lbfgs_env()
        max_iters = env_mi if max_iters is None else max_iters
        patience = env_pa if patience is None else patience
    p = np.asarray(p0, np.float32).copy()
    n = p.shape[0]
    ftol = F32(ftol)
    it_limit = int(it_limit)

    def vg(x):
        f, g = value_and_grad(x)
        return F32(f), np.asarray(g, np.float32)

    f, g = vg(p)
    nev = int(nev0) + 1
    mem_s = np.zeros((HIST, n), np.float32)
    mem_y = np.zeros((HIST, n), np.float32)
    mem_rho = np.zeros(HIST, np.float32)

    def linesearch(p, f, g, d, nev):
        """Armijo backtracking from alpha=1 with expansion while improving.
        Returns (p', f', g', nev, moved)."""
        gd = np.dot(g, d)
        alpha = F32(1.0)
        fa, ga = vg(p + alpha * d)
        nev += 1
        ok = fa <= f + ARMIJO_C1 * gd
        it = 0
        while not ok and it < LS_MAX_BACK and nev < it_limit:
            alpha = alpha * F32(0.5)
            fa, ga = vg(p + alpha * d)
            ok = fa <= f + ARMIJO_C1 * alpha * gd
            it += 1
            nev += 1
        # expansion: while doubling keeps strictly improving
        best_a, best_f, best_g = alpha, fa, ga
        it = 0
        go = ok
        while go and it < LS_MAX_FWD and nev < it_limit:
            alpha = alpha * F32(2.0)
            fa, ga = vg(p + alpha * d)
            go = fa < best_f
            if go:
                best_a, best_f, best_g = alpha, fa, ga
            it += 1
            nev += 1
        moved = bool(best_f < f) and bool(ok)
        if not moved:
            return p, f, g, nev, False
        return p + best_a * d, best_f, best_g, nev, True

    k = 0
    stall = 0
    done = f >= COST_ABORT or nev >= it_limit
    it = 0
    while not done and it < max_iters:
        d = _direction(g, mem_s, mem_y, mem_rho, k)
        # steepest-descent steps (no curvature yet, or a non-descent
        # direction) are unit-normalized: raw NCC gradients are ~1e-3 in
        # voxel units, and an alpha=1 trial must probe a voxel-scale move
        gd = np.dot(g, d)
        if not (gd < 0 and k > 0):
            gnorm = np.sqrt(np.sum(g * g))
            d = -g / max(gnorm, F32(1e-12))
        p2, f2, g2, nev2, moved = linesearch(p, f, g, d, nev)

        s_vec = p2 - p
        y_vec = g2 - g
        ys = np.dot(s_vec, y_vec)
        use = moved and ys > 1e-10
        if use:
            slot = k % HIST
            mem_s[slot] = s_vec
            mem_y[slot] = y_vec
            mem_rho[slot] = F32(1.0) / max(ys, F32(1e-20))
        # a failed line search with curvature history retries from a fresh
        # steepest-descent state; only a failed plain descent stops
        retry = (not moved) and k > 0
        k = k + 1 if use else (k if moved else 0)
        moved = moved or retry

        # Powell's ftol test holds for `patience` consecutive steps
        small = F32(2.0) * abs(f - f2) <= ftol * (abs(f) + abs(f2))
        stall = stall + 1 if small else 0
        done = (stall >= patience or not moved or nev2 >= it_limit
                or f2 >= COST_ABORT)
        p, f, g, nev = p2, f2, g2, nev2
        it += 1
    return p, f, nev
