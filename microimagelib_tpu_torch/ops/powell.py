"""Powell direction-set minimizer (host-side NumPy): a copy of the JAX
package's ``ops/powell.py`` for the registration ladder's ``host`` engine.

A fresh implementation of the classic Numerical Recipes direction-set
method with the reference's two custom escape hatches preserved
(reference:src/api_powell.c:305-360): abort as soon as the cost reaches
1.001 (an NCC-based cost can only be that high when registration has
degenerated), and a global cap on total cost-function evaluations
(``it_limit``) shared across all linmin calls of one registration stage.

Line minimization follows NR: ``mnbrak`` golden-ratio bracketing then
``brent`` parabolic/golden refinement with tol=0.01
(reference:src/api_powell.c:119-183, 194-248, 255-301). Implemented
0-indexed on NumPy arrays; the cost function is a plain callable, so the
registration state that the reference kept in file-scope statics
(reference:src/api_subfunc.cu:1798-1813) lives in closures instead —
making the optimizer re-entrant.
"""

from __future__ import annotations

import math

import numpy as np

_GOLD = 1.618034
_GLIMIT = 100.0
_TINY = 1.0e-20
_CGOLD = 0.3819660
_ZEPS = 1.0e-10
_BRENT_ITMAX = 100
_POWELL_ITMAX = 100
_LINMIN_TOL = 0.01
_COST_ABORT = 1.001


def _mnbrak(f, ax, bx):
    """Bracket a minimum of f starting from (ax, bx). Returns
    (ax, bx, cx, fa, fb, fc) with bx between ax and cx and fb <= fa, fc."""
    fa = f(ax)
    fb = f(bx)
    if fb > fa:
        ax, bx = bx, ax
        fa, fb = fb, fa
    cx = bx + _GOLD * (bx - ax)
    fc = f(cx)
    while fb > fc:
        r = (bx - ax) * (fb - fc)
        q = (bx - cx) * (fb - fa)
        denom = q - r
        denom = 2.0 * math.copysign(max(abs(denom), _TINY), denom)
        u = bx - ((bx - cx) * q - (bx - ax) * r) / denom
        ulim = bx + _GLIMIT * (cx - bx)
        if (bx - u) * (u - cx) > 0.0:  # u between b and c
            fu = f(u)
            if fu < fc:
                return bx, u, cx, fb, fu, fc
            if fu > fb:
                return ax, bx, u, fa, fb, fu
            u = cx + _GOLD * (cx - bx)
            fu = f(u)
        elif (cx - u) * (u - ulim) > 0.0:  # u between c and its limit
            fu = f(u)
            if fu < fc:
                bx, cx, u = cx, u, u + _GOLD * (u - cx)
                fb, fc, fu = fc, fu, f(u)
        elif (u - ulim) * (ulim - cx) >= 0.0:  # cap at ulim
            u = ulim
            fu = f(u)
        else:
            u = cx + _GOLD * (cx - bx)
            fu = f(u)
        ax, bx, cx = bx, cx, u
        fa, fb, fc = fb, fc, fu
    return ax, bx, cx, fa, fb, fc


def _brent(f, ax, bx, cx, tol):
    """Brent 1D minimization within bracket (ax, bx, cx). Returns
    (xmin, fmin). Mirrors the reference's modified NR brent, including the
    q == 0 early return (reference:src/api_powell.c:150)."""
    a = min(ax, cx)
    b = max(ax, cx)
    x = w = v = bx
    fw = fv = fx = f(x)
    e = 0.0
    d = 0.0
    for _ in range(_BRENT_ITMAX):
        xm = 0.5 * (a + b)
        tol1 = tol * abs(x) + _ZEPS
        tol2 = 2.0 * tol1
        if abs(x - xm) <= (tol2 - 0.5 * (b - a)):
            return x, fx
        if abs(e) > tol1:
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0.0:
                p = -p
            q = abs(q)
            etemp = e
            e = d
            if abs(p) >= abs(0.5 * q * etemp) or p <= q * (a - x) or p >= q * (b - x):
                e = (a - x) if x >= xm else (b - x)
                d = _CGOLD * e
            else:
                if q == 0:
                    return x, fx
                d = p / q
                u = x + d
                if u - a < tol2 or b - u < tol2:
                    d = math.copysign(tol1, xm - x)
        else:
            e = (a - x) if x >= xm else (b - x)
            d = _CGOLD * e
        u = x + d if abs(d) >= tol1 else x + math.copysign(tol1, d)
        fu = f(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx


def _linmin(p, xi, func):
    """Minimize func along direction xi from point p. Returns
    (p_new, xi_scaled, fmin)."""
    def f1dim(t):
        return func(p + t * xi)

    ax, xx, bx, _, _, _ = _mnbrak(f1dim, 0.0, 1.0)
    xmin, fmin = _brent(f1dim, ax, xx, bx, _LINMIN_TOL)
    xi_new = xi * xmin
    return p + xi_new, xi_new, fmin


class EvalCounter:
    """Wraps a cost function, counting evaluations (the reference's
    ``itNumStatic``, reference:src/api_subfunc.cu:2386)."""

    def __init__(self, func):
        self.func = func
        self.count = 0

    def __call__(self, x):
        self.count += 1
        return float(self.func(x))


def powell(p, func, ftol, it_limit, counter=None, xi=None):
    """Minimize ``func`` from start point ``p`` (1D array).

    Returns (p_min, f_min, n_powell_iters, counter). ``counter`` is an
    EvalCounter shared across stages so ``it_limit`` caps *total*
    sub-iterations like the reference's ``*totalIt`` (reference:
    src/api_powell.c:331, 355). ``xi`` optionally carries direction set
    state between calls (the reference re-initializes per stage; we do
    too unless given)."""
    p = np.asarray(p, dtype=np.float64).copy()
    n = p.size
    if counter is None:
        counter = EvalCounter(func)
    f = counter

    if xi is None:
        xi = np.eye(n, dtype=np.float64)
    fret = f(p)
    if fret >= _COST_ABORT:
        return p, fret, 0, counter
    pt = p.copy()
    for it in range(1, _POWELL_ITMAX + 1):
        fp = fret
        ibig = 0
        delta = 0.0
        for i in range(n):
            xit = xi[:, i].copy()
            fptt = fret
            p, xit, fret = _linmin(p, xit, f)
            xi[:, i] = xit
            if abs(fptt - fret) > delta:
                delta = abs(fptt - fret)
                ibig = i
            if f.count >= it_limit:
                return p, fret, it, counter
            if fret >= _COST_ABORT:
                return p, fret, it, counter
        if 2.0 * abs(fp - fret) <= ftol * (abs(fp) + abs(fret)):
            return p, fret, it, counter
        if it == _POWELL_ITMAX:
            return p, fret, it, counter
        ptt = 2.0 * p - pt
        xit = p - pt
        pt = p.copy()
        fptt = f(ptt)
        if fptt < fp:
            t = (
                2.0 * (fp - 2.0 * fret + fptt) * (fp - fret - delta) ** 2
                - delta * (fp - fptt) ** 2
            )
            if t < 0.0:
                p, xit, fret = _linmin(p, xit, f)
                xi[:, ibig] = xi[:, n - 1]
                xi[:, n - 1] = xit
                if f.count >= it_limit:
                    return p, fret, it, counter
                if fret >= _COST_ABORT:
                    return p, fret, it, counter
    return p, fret, _POWELL_ITMAX, counter
