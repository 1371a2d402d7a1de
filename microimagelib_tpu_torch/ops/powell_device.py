"""Powell's direction-set minimizer as the registration ladder runs it on
an accelerator: NR mnbrak + brent + linmin + powell in float32, driven
from the host with one device sync per cost evaluation (the cost itself —
resample + NCC partials — runs on the card, ``ops/corr.py``).

The JAX package writes this optimizer in ``lax`` control flow so a whole
ladder is one TPU program (``microimagelib_tpu/ops/powell_device.py``);
here it is a Python loop with the SAME control flow, branch for branch
(:func:`_mnbrak` the lax ``_mnbrak``, :func:`_brent` the lax ``_brent``,
:func:`powell_device` the lax ``powell_device``), so the evaluation count
and the point match the JAX version's. Semantics: brent tol 0.01,
ITMAX 100, mnbrak GOLD/GLIMIT/TINY, the cost >= 1.001 abort, and the
shared evaluation cap checked between line minimizations
(reference:src/api_powell.c:119-360). Every value is a numpy float32, as
the lax version's are.

Not ported: the batched multi-probe line search (``cost_batch``) — it
exists for the N-probe kernel K6 (ROADMAP.md, queue 2).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
GOLD = F32(1.618034)
GLIMIT = F32(100.0)
TINY = F32(1.0e-20)
CGOLD = F32(0.3819660)
ZEPS = F32(1.0e-10)
BRENT_ITMAX = 100
POWELL_ITMAX = 100
LINMIN_TOL = F32(0.01)
COST_ABORT = F32(1.001)
MNBRAK_MAX = 60  # safety bound; NR's loop terminates long before

_HALF = F32(0.5)
_TWO = F32(2.0)
_ZERO = F32(0.0)


def _sign_like(mag, s):
    return abs(mag) if s >= 0 else -abs(mag)


def _mnbrak(f, ax, bx):
    """Bracket a minimum. Returns (ax, bx, cx, fa, fb, fc, nev)."""
    fa = f(ax)
    fb = f(bx)
    if fb > fa:
        ax, bx = bx, ax
        fa, fb = fb, fa
    cx = bx + GOLD * (bx - ax)
    fc = f(cx)
    nev = 3
    done = False
    while fb > fc and not done and nev < 3 + 3 * MNBRAK_MAX:
        r = (bx - ax) * (fb - fc)
        q = (bx - cx) * (fb - fa)
        dq = q - r
        denom = _TWO * _sign_like(max(abs(dq), TINY), dq)
        u0 = bx - ((bx - cx) * q - (bx - ax) * r) / denom
        ulim = bx + GLIMIT * (cx - bx)

        if (bx - u0) * (u0 - cx) > 0:
            # u0 between b and c: done with (bx, u0, cx) if fu0 < fc, with
            # (ax, bx, u0) if fu0 > fb, else step u past c
            fu0 = f(u0)
            done1 = fu0 < fc
            done2 = (not done1) and fu0 > fb
            early = done1 or done2
            if early:
                nax, nbx, nfa, nfb = (bx, u0, fb, fu0) if done1 else (ax, bx, fa, fb)
                ncx = cx if done1 else u0
                nfc = fu0 if done2 else fc
                u, fu = cx + GOLD * (cx - bx), fu0
                nev_add = 1
            else:
                nax, nbx, ncx, nfa, nfb, nfc = ax, bx, cx, fa, fb, fc
                u = cx + GOLD * (cx - bx)
                fu = f(u)
                nev_add = 2
        elif (cx - u0) * (u0 - ulim) > 0:
            # u0 between c and its limit
            fu0 = f(u0)
            early = False
            if fu0 < fc:
                nax, nbx, ncx, nfa, nfb, nfc = ax, cx, u0, fa, fc, fu0
                u = u0 + GOLD * (u0 - cx)
                fu = f(u)
                nev_add = 2
            else:
                nax, nbx, ncx, nfa, nfb, nfc = ax, bx, cx, fa, fb, fc
                u, fu = u0, fu0
                nev_add = 1
        else:
            early = False
            nax, nbx, ncx, nfa, nfb, nfc = ax, bx, cx, fa, fb, fc
            if (u0 - ulim) * (ulim - cx) >= 0:
                u = ulim  # cap at ulim
            else:
                u = cx + GOLD * (cx - bx)
            fu = f(u)
            nev_add = 1

        # final SHFT(ax,bx,cx,u), SHFT(fa,fb,fc,fu) unless done early
        if early:
            ax, bx, cx, fa, fb, fc = nax, nbx, ncx, nfa, nfb, nfc
        else:
            ax, bx, cx, fa, fb, fc = nbx, ncx, u, nfb, nfc, fu
        nev += nev_add
        done = early
    return ax, bx, cx, fa, fb, fc, nev


def _brent(f, ax, bx, cx, tol):
    """Brent line minimization within a bracket. Returns (xmin, fmin,
    nev)."""
    a = min(ax, cx)
    b = max(ax, cx)
    x = w = v = bx
    fx = f(x)
    fw = fv = fx
    d = e = _ZERO
    nev = 1
    for _ in range(BRENT_ITMAX):
        xm = _HALF * (a + b)
        tol1 = tol * abs(x) + ZEPS
        tol2 = _TWO * tol1
        converged = abs(x - xm) <= (tol2 - _HALF * (b - a))

        # parabolic attempt
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q2 = _TWO * (q - r)
        if q2 > 0:
            p = -p
        q2 = abs(q2)
        etemp = e
        use_golden = (abs(e) <= tol1 or abs(p) >= abs(_HALF * q2 * etemp)
                      or p <= q2 * (a - x) or p >= q2 * (b - x))
        q_zero = (not use_golden) and q2 == 0  # the reference's added escape
        if converged or q_zero:
            break
        if use_golden:
            e = (a - x) if x >= xm else (b - x)
            d_new = CGOLD * e
        else:
            d_new = p / q2
            u_p = x + d_new
            if u_p - a < tol2 or b - u_p < tol2:
                d_new = _sign_like(tol1, xm - x)
            e = d  # e = old d in the parabolic branch
        d = d_new
        u = x + d if abs(d) >= tol1 else x + _sign_like(tol1, d)
        fu = f(u)
        nev += 1

        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, fv, w, fw, x, fx = w, fw, x, fx, u, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, fv, w, fw = w, fw, u, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx, nev


def _linmin(cost, p, xi):
    """Minimize cost along direction xi from p. Returns (p', xi', f',
    nev)."""
    def f1(t):
        return cost(p + t * xi)

    ax, bx, cx, _fa, _fb, _fc, nev1 = _mnbrak(f1, _ZERO, F32(1.0))
    xmin, fmin, nev2 = _brent(f1, ax, bx, cx, LINMIN_TOL)
    xi_new = xi * xmin
    return p + xi_new, xi_new, fmin, nev1 + nev2


def powell_device(cost, p0, ftol, it_limit, nev0=0, max_sweeps=None):
    """Powell over ``cost``: (n,) float32 numpy -> numpy float32 scalar.
    Returns (p_min, f_min, total_evals). ``it_limit`` caps cost
    evaluations as the reference's itNumStatic does; ``nev0`` carries the
    count across ladder stages. ``max_sweeps`` caps the outer
    direction-set sweeps (the gradient ladder's budgeted finisher); None
    runs to Powell's own ftol convergence."""
    p = np.asarray(p0, np.float32).copy()
    n = p.shape[0]
    ftol = F32(ftol)
    it_limit = int(it_limit)
    itmax = POWELL_ITMAX if max_sweeps is None else min(POWELL_ITMAX,
                                                        int(max_sweeps))
    fret = F32(cost(p))
    nev = int(nev0) + 1
    xi = np.eye(n, dtype=np.float32)
    pt = p.copy()
    done = fret >= COST_ABORT
    it = 0
    while not done and it < itmax:
        fp = fret
        delta = _ZERO
        ibig = 0
        stop = False
        for i in range(n):
            if stop:
                break
            xit = xi[:, i].copy()
            fptt = fret
            p, xit, fret, nev_lm = _linmin(cost, p, xit)
            xi[:, i] = xit
            if abs(fptt - fret) > delta:
                delta = abs(fptt - fret)
                ibig = i
            nev += nev_lm
            stop = nev >= it_limit or fret >= COST_ABORT

        converged = _TWO * abs(fp - fret) <= ftol * (abs(fp) + abs(fret))
        if not stop and not converged:
            ptt = _TWO * p - pt
            xit = p - pt
            pt = p
            fptt = F32(cost(ptt))
            nev += 1
            if fptt < fp:
                t = (_TWO * (fp - _TWO * fret + fptt) * (fp - fret - delta) ** 2
                     - delta * (fp - fptt) ** 2)
                if t < 0:
                    p, xit, fret, nev_lm = _linmin(cost, p, xit)
                    xi[:, ibig] = xi[:, n - 1]
                    xi[:, n - 1] = xit
                    nev += nev_lm
        done = stop or converged or nev >= it_limit or fret >= COST_ABORT
        it += 1
    return p, fret, nev
