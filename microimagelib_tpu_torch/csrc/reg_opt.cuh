// The registration ladder's optimizers, matrix builders and stage plan as
// plain C++ that builds for the card (nvcc, inside K9: csrc/reg_ladder.cu)
// and for the host (g++, native/reg_opt.cpp, which the CPU tests load).
//
// A transliteration, branch for branch, of the port's host loop:
//   * lbfgs_minimize: microimagelib_tpu_torch/ops/lbfgs.py (history 8,
//     Armijo backtracking and expansion, the unit-normalised
//     steepest-descent step, the retry rule, the ftol test over `patience`
//     steps);
//   * mnbrak / brent / linmin / powell_minimize: ops/powell_device.py
//     (GOLD, GLIMIT, TINY, MNBRAK_MAX 60, brent ITMAX 100 at tol 0.01 with
//     the q == 0 escape, `max_sweeps`); linmin_nprobe, the batched line
//     search of 8 probes a call (_linmin_nprobe: LS_LADDER, 3 refine
//     rounds), which powell_minimize takes where a batched cost is given;
//   * the shared rules: the cost >= 1.001 abort and the `it_limit` cap on
//     evaluations, checked where the host loop checks them;
//   * dof_to_matrix / params_to_matrix / matrix_to_params and the
//     pullback of a matrix gradient through them (reverse mode, as the
//     host loop's autograd takes it), models/registration_device.py's
//     builders;
//   * the NCC cost and its gradient from the float64 sums of K4/K5
//     (models/registration_grad.py::_make_cost_grad_m, _stage_vg), and
//   * the affMethod 1-7 ladder of both engines (models/registration_grad.py
//     ::reg_ladder_grad, models/registration_device.py::reg_ladder_device),
//     with or without `batch_ls`, as a list of stages, and the hybrid
//     engine's single line minimization (linmin_reg_device) as a ladder of
//     one line stage.
// The JAX package runs the same control flow as lax loops inside one jit
// (microimagelib_tpu/ops/lbfgs.py, ops/powell_device.py). Every value is a
// float32 as there; the cost and its gradient are formed in float64 from
// the sums and rounded once. The reductions are the host loop's (numpy's
// float32 dot and pairwise sum) and the gradient is formed as its autograd
// forms it, so a stage over the 12 matrix parameters (the pyramid's mid
// and full levels) repeats the host loop bit for bit, given the same sums:
// the optimizer's path is chaotic in the last bit, and a pyramid taken on
// other rounding lands up to ~0.8 voxel elsewhere. The DOF stages repeat it
// too: their sines and cosines are torch's (torch_trig.cuh), on angles
// below 1 rad.
//
// The optimizers are templated on the cost: `float operator()(const float*
// p)` for Powell, `float operator()(const float* p, float* g)` for L-BFGS,
// and the batched cost `void operator()(const float* ps, int n, float* f)`
// (n points, rows of kMaxN floats) for the probe line search. The ladder is
// templated on an evaluator of the sums, `void operator()(const float* m12,
// bool grad, double* sums)` with sums = ss, st and, with `grad`, gs(12)
// and gt(12) (K5 / K4's packed result), and `void probes(const float* m12s,
// int n, double* sums)` with sums = ss, st of each of n <= kProbes matrices
// (K6's packed result), which every evaluation of a probe stage takes.

#pragma once

#include <math.h>

#include "torch_trig.cuh"

#ifdef __CUDACC__
#define MIL_HD __host__ __device__
#else
#define MIL_HD
#endif

namespace mil_reg {

constexpr int kMaxN = 12;          // parameters of the largest stage
constexpr float kCostAbort = 1.001f;
// L-BFGS
constexpr int kHist = 8;
constexpr int kLsMaxBack = 20;
constexpr int kLsMaxFwd = 24;
constexpr float kArmijoC1 = 1e-4f;
// Powell
constexpr float kGold = 1.618034f;
constexpr float kGlimit = 100.0f;
constexpr float kTiny = 1.0e-20f;
constexpr float kCgold = 0.3819660f;
constexpr float kZeps = 1.0e-10f;
constexpr int kBrentItmax = 100;
constexpr int kPowellItmax = 100;
constexpr int kMnbrakMax = 60;
constexpr float kLinminTol = 0.01f;
// the probe line search (ops/powell_device.py LS_LADDER, LS_REFINE_ROUNDS)
constexpr int kProbes = 8;
constexpr int kLsRefineRounds = 3;

MIL_HD inline float qnan() {
  union {
    unsigned u;
    float f;
  } x;
  x.u = 0x7fc00000u;
  return x.f;
}

MIL_HD inline float sign_like(float mag, float s) {
  const float a = fabsf(mag);
  return s >= 0.f ? a : -a;
}

// The host loop's float32 reductions, operation for operation. numpy's
// dot of float32 vectors (OpenBLAS sdot): each product rounded to float32,
// the products summed in float64, the sum rounded once.
MIL_HD inline float dot(const float* a, const float* b, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += static_cast<double>(a[i] * b[i]);
  return static_cast<float>(s);
}

// numpy's float32 sum (pairwise_sum): in order below 8 values, else eight
// partial sums, added as a tree, then the rest in order.
MIL_HD inline float sum_pairwise(const float* a, int n) {
  if (n < 8) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += a[i];
    return s;
  }
  float r[8];
  for (int j = 0; j < 8; ++j) r[j] = a[j];
  int i = 8;
  for (; i < n - (n % 8); i += 8)
    for (int j = 0; j < 8; ++j) r[j] += a[i + j];
  float s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) s += a[i];
  return s;
}

// ---------------------------------------------------------------------------
// L-BFGS (ops/lbfgs.py)
// ---------------------------------------------------------------------------

// The two-loop recursion over the filled history slots, newest first.
MIL_HD inline void lbfgs_direction(const float* g, float (*ms)[kMaxN], float (*my)[kMaxN],
                                   const float* rho, int k, int n, float* d) {
  float q[kMaxN], alphas[kHist];
  for (int i = 0; i < n; ++i) q[i] = g[i];
  const int n_hist = k < kHist ? k : kHist;
  for (int i = 0; i < kHist; ++i) alphas[i] = 0.f;
  for (int i = 0; i < n_hist; ++i) {
    const int idx = (k - 1 - i) % kHist;
    const float a = rho[idx] * dot(ms[idx], q, n);
    for (int j = 0; j < n; ++j) q[j] = q[j] - a * my[idx][j];
    alphas[i] = a;
  }
  float gamma = 1.0f;
  if (k > 0) {
    const int newest = (k - 1) % kHist;
    const float ys = dot(ms[newest], my[newest], n);
    const float yy = dot(my[newest], my[newest], n);
    if (yy > 0.f) gamma = ys / (yy > 1e-20f ? yy : 1e-20f);
  }
  for (int j = 0; j < n; ++j) d[j] = gamma * q[j];
  for (int i = 0; i < kHist; ++i) {
    const int j = kHist - 1 - i;
    if (j < n_hist) {
      const int idx = (k - 1 - j) % kHist;
      const float b = rho[idx] * dot(my[idx], d, n);
      for (int t = 0; t < n; ++t) d[t] = d[t] + (alphas[j] - b) * ms[idx][t];
    }
  }
  for (int j = 0; j < n; ++j) d[j] = -d[j];
}

// Minimize vg over n <= kMaxN parameters from p (in place). nev counts
// evaluations across stages (in: the count so far). Returns f at p.
template <class VG>
MIL_HD float lbfgs_minimize(VG& vg, int n, float* p, float ftol, int it_limit, int& nev,
                            int max_iters, int patience) {
  float g[kMaxN], d[kMaxN], p2[kMaxN], g2[kMaxN], x[kMaxN], ga[kMaxN], gb[kMaxN];
  float ms[kHist][kMaxN], my[kHist][kMaxN], rho[kHist];
  for (int i = 0; i < kHist; ++i) {
    rho[i] = 0.f;
    for (int j = 0; j < kMaxN; ++j) ms[i][j] = my[i][j] = 0.f;
  }
  float f = vg(p, g);
  nev += 1;
  int k = 0, stall = 0, it = 0;
  bool done = f >= kCostAbort || nev >= it_limit;
  while (!done && it < max_iters) {
    lbfgs_direction(g, ms, my, rho, k, n, d);
    float gd = dot(g, d, n);
    if (!(gd < 0.f && k > 0)) {
      float gg[kMaxN];
      for (int i = 0; i < n; ++i) gg[i] = g[i] * g[i];
      const float gnorm = sqrtf(sum_pairwise(gg, n));
      const float den = gnorm > 1e-12f ? gnorm : 1e-12f;
      for (int i = 0; i < n; ++i) d[i] = -g[i] / den;
    }
    // the line search: Armijo backtracking from alpha = 1, then expansion
    // while doubling keeps strictly improving
    int nev2 = nev;
    gd = dot(g, d, n);
    float alpha = 1.0f;
    for (int i = 0; i < n; ++i) x[i] = p[i] + alpha * d[i];
    float fa = vg(x, ga);
    nev2 += 1;
    bool ok = fa <= f + kArmijoC1 * gd;
    for (int t = 0; !ok && t < kLsMaxBack && nev2 < it_limit; ++t) {
      alpha = alpha * 0.5f;
      for (int i = 0; i < n; ++i) x[i] = p[i] + alpha * d[i];
      fa = vg(x, ga);
      ok = fa <= f + kArmijoC1 * alpha * gd;
      nev2 += 1;
    }
    float best_a = alpha, best_f = fa;
    for (int i = 0; i < n; ++i) gb[i] = ga[i];
    bool go = ok;
    for (int t = 0; go && t < kLsMaxFwd && nev2 < it_limit; ++t) {
      alpha = alpha * 2.0f;
      for (int i = 0; i < n; ++i) x[i] = p[i] + alpha * d[i];
      fa = vg(x, ga);
      go = fa < best_f;
      if (go) {
        best_a = alpha;
        best_f = fa;
        for (int i = 0; i < n; ++i) gb[i] = ga[i];
      }
      nev2 += 1;
    }
    bool moved = best_f < f && ok;
    float f2 = f;
    if (moved) {
      for (int i = 0; i < n; ++i) {
        p2[i] = p[i] + best_a * d[i];
        g2[i] = gb[i];
      }
      f2 = best_f;
    } else {
      for (int i = 0; i < n; ++i) {
        p2[i] = p[i];
        g2[i] = g[i];
      }
    }

    float sv[kMaxN], yv[kMaxN];
    for (int i = 0; i < n; ++i) {
      sv[i] = p2[i] - p[i];
      yv[i] = g2[i] - g[i];
    }
    const float ys = dot(sv, yv, n);
    const bool use = moved && ys > 1e-10f;
    if (use) {
      const int slot = k % kHist;
      for (int i = 0; i < n; ++i) {
        ms[slot][i] = sv[i];
        my[slot][i] = yv[i];
      }
      rho[slot] = 1.0f / (ys > 1e-20f ? ys : 1e-20f);
    }
    // a failed line search with curvature history retries from a fresh
    // steepest-descent state; only a failed plain descent stops
    const bool retry = !moved && k > 0;
    k = use ? k + 1 : (moved ? k : 0);
    moved = moved || retry;

    const bool small = 2.0f * fabsf(f - f2) <= ftol * (fabsf(f) + fabsf(f2));
    stall = small ? stall + 1 : 0;
    done = stall >= patience || !moved || nev2 >= it_limit || f2 >= kCostAbort;
    for (int i = 0; i < n; ++i) {
      p[i] = p2[i];
      g[i] = g2[i];
    }
    f = f2;
    nev = nev2;
    ++it;
  }
  return f;
}

// ---------------------------------------------------------------------------
// Powell (ops/powell_device.py)
// ---------------------------------------------------------------------------

// cost(p + t xi) along a line.
template <class C>
struct Line {
  C* cost;
  const float* p;
  const float* xi;
  int n;
  MIL_HD float operator()(float t) const {
    float x[kMaxN];
    for (int i = 0; i < n; ++i) x[i] = p[i] + t * xi[i];
    return (*cost)(x);
  }
};

// Bracket a minimum from (ax, bx). Returns the evaluations.
template <class L>
MIL_HD int mnbrak(const L& f, float& ax, float& bx, float& cx) {
  float fa = f(ax), fb = f(bx);
  if (fb > fa) {
    float t = ax;
    ax = bx;
    bx = t;
    t = fa;
    fa = fb;
    fb = t;
  }
  cx = bx + kGold * (bx - ax);
  float fc = f(cx);
  int nev = 3;
  bool done = false;
  while (fb > fc && !done && nev < 3 + 3 * kMnbrakMax) {
    const float r = (bx - ax) * (fb - fc);
    const float q = (bx - cx) * (fb - fa);
    const float dq = q - r;
    const float denom = 2.0f * sign_like(fabsf(dq) > kTiny ? fabsf(dq) : kTiny, dq);
    const float u0 = bx - ((bx - cx) * q - (bx - ax) * r) / denom;
    const float ulim = bx + kGlimit * (cx - bx);
    float nax, nbx, ncx, nfa, nfb, nfc, u, fu;
    bool early = false;
    int nev_add;
    if ((bx - u0) * (u0 - cx) > 0.f) {
      // u0 between b and c: done with (bx, u0, cx) if fu0 < fc, with
      // (ax, bx, u0) if fu0 > fb, else step u past c
      const float fu0 = f(u0);
      const bool done1 = fu0 < fc;
      const bool done2 = !done1 && fu0 > fb;
      early = done1 || done2;
      if (early) {
        if (done1) {
          nax = bx;
          nbx = u0;
          nfa = fb;
          nfb = fu0;
        } else {
          nax = ax;
          nbx = bx;
          nfa = fa;
          nfb = fb;
        }
        ncx = done1 ? cx : u0;
        nfc = done2 ? fu0 : fc;
        u = cx + kGold * (cx - bx);
        fu = fu0;
        nev_add = 1;
      } else {
        nax = ax;
        nbx = bx;
        ncx = cx;
        nfa = fa;
        nfb = fb;
        nfc = fc;
        u = cx + kGold * (cx - bx);
        fu = f(u);
        nev_add = 2;
      }
    } else if ((cx - u0) * (u0 - ulim) > 0.f) {
      // u0 between c and its limit
      const float fu0 = f(u0);
      if (fu0 < fc) {
        nax = ax;
        nbx = cx;
        ncx = u0;
        nfa = fa;
        nfb = fc;
        nfc = fu0;
        u = u0 + kGold * (u0 - cx);
        fu = f(u);
        nev_add = 2;
      } else {
        nax = ax;
        nbx = bx;
        ncx = cx;
        nfa = fa;
        nfb = fb;
        nfc = fc;
        u = u0;
        fu = fu0;
        nev_add = 1;
      }
    } else {
      nax = ax;
      nbx = bx;
      ncx = cx;
      nfa = fa;
      nfb = fb;
      nfc = fc;
      u = (u0 - ulim) * (ulim - cx) >= 0.f ? ulim : cx + kGold * (cx - bx);
      fu = f(u);
      nev_add = 1;
    }
    // the final SHFT(ax,bx,cx,u), SHFT(fa,fb,fc,fu) unless done early
    if (early) {
      ax = nax;
      bx = nbx;
      cx = ncx;
      fa = nfa;
      fb = nfb;
      fc = nfc;
    } else {
      ax = nbx;
      bx = ncx;
      cx = u;
      fa = nfb;
      fb = nfc;
      fc = fu;
    }
    nev += nev_add;
    done = early;
  }
  return nev;
}

// Brent's line minimization within the bracket. Returns the evaluations.
template <class L>
MIL_HD int brent(const L& f, float ax, float bx, float cx, float tol, float& xmin,
                 float& fmin) {
  float a = ax < cx ? ax : cx;
  float b = ax > cx ? ax : cx;
  float x = bx, w = bx, v = bx;
  float fx = f(x);
  float fw = fx, fv = fx;
  float d = 0.f, e = 0.f;
  int nev = 1;
  for (int it = 0; it < kBrentItmax; ++it) {
    const float xm = 0.5f * (a + b);
    const float tol1 = tol * fabsf(x) + kZeps;
    const float tol2 = 2.0f * tol1;
    const bool converged = fabsf(x - xm) <= (tol2 - 0.5f * (b - a));
    // the parabolic attempt
    const float r = (x - w) * (fx - fv);
    const float q = (x - v) * (fx - fw);
    float p = (x - v) * q - (x - w) * r;
    float q2 = 2.0f * (q - r);
    if (q2 > 0.f) p = -p;
    q2 = fabsf(q2);
    const float etemp = e;
    const bool use_golden = fabsf(e) <= tol1 || fabsf(p) >= fabsf(0.5f * q2 * etemp) ||
                            p <= q2 * (a - x) || p >= q2 * (b - x);
    const bool q_zero = !use_golden && q2 == 0.f;   // the reference's added escape
    if (converged || q_zero) break;
    float d_new;
    if (use_golden) {
      e = x >= xm ? a - x : b - x;
      d_new = kCgold * e;
    } else {
      d_new = p / q2;
      const float u_p = x + d_new;
      if (u_p - a < tol2 || b - u_p < tol2) d_new = sign_like(tol1, xm - x);
      e = d;   // e = the old d in the parabolic branch
    }
    d = d_new;
    const float u = fabsf(d) >= tol1 ? x + d : x + sign_like(tol1, d);
    const float fu = f(u);
    nev += 1;
    if (fu <= fx) {
      if (u >= x) {
        a = x;
      } else {
        b = x;
      }
      v = w;
      fv = fw;
      w = x;
      fw = fx;
      x = u;
      fx = fu;
    } else {
      if (u < x) {
        a = u;
      } else {
        b = u;
      }
      if (fu <= fw || w == x) {
        v = w;
        fv = fw;
        w = u;
        fw = fu;
      } else if (fu <= fv || v == x || v == w) {
        v = u;
        fv = fu;
      }
    }
  }
  xmin = x;
  fmin = fx;
  return nev;
}

// Minimize cost along xi from p: p += xmin xi, xi *= xmin. Returns the
// evaluations; fmin is the cost at the new p.
template <class C>
MIL_HD int linmin(C& cost, int n, float* p, float* xi, float& fmin) {
  const Line<C> line{&cost, p, xi, n};
  float ax = 0.f, bx = 1.0f, cx;
  const int nev1 = mnbrak(line, ax, bx, cx);
  float xmin;
  const int nev2 = brent(line, ax, bx, cx, kLinminTol, xmin, fmin);
  for (int i = 0; i < n; ++i) {
    xi[i] = xi[i] * xmin;
    p[i] = p[i] + xi[i];
  }
  return nev1 + nev2;
}

// LS_LADDER as float32 (np.array(LS_LADDER, np.float32)).
MIL_HD inline float ls_ladder(int i) {
  const float t[kProbes] = {-2.618f, -1.0f, -0.382f, 0.382f, 1.0f, 1.618f, 2.618f, 4.236f};
  return t[i];
}

// numpy's argmin of n float32 values: the first minimum, or the first NaN.
MIL_HD inline int argmin_np(const float* f, int n) {
  int b = 0;
  for (int i = 0; i < n; ++i) {
    if (f[i] != f[i]) return i;
    if (f[i] < f[b]) b = i;
  }
  return b;
}

// The probes p + al[i] xi (the product rounded, then the sum, as numpy
// forms p[None] + al[:, None] * xi[None]) through the batched cost.
template <class CB>
MIL_HD void probe_line(CB& cost_batch, int n, const float* p, const float* xi,
                       const float* al, float* f) {
  float ps[kProbes][kMaxN];
  for (int i = 0; i < kProbes; ++i)
    for (int j = 0; j < n; ++j) ps[i][j] = p[j] + al[i] * xi[j];
  cost_batch(&ps[0][0], kProbes, f);
}

// The batched line search (_linmin_nprobe): one round of the golden ladder
// around alpha = 0 (the incoming point, cost fret, a candidate too), then
// kLsRefineRounds rounds of a grid over the bracket, expanded golden-style
// past an edge where the best probe sits on it. p += xb xi, xi *= xb, fret
// the best cost. Returns the evaluations (kProbes a round).
template <class CB>
MIL_HD int linmin_nprobe(CB& cost_batch, int n, float* p, float* xi, float& fret) {
  constexpr int kAll = kProbes + 1;
  const float denom = static_cast<float>(kAll);
  float al[kProbes], fv[kProbes];
  for (int i = 0; i < kProbes; ++i) al[i] = ls_ladder(i);
  probe_line(cost_batch, n, p, xi, al, fv);
  // alpha = 0 first, then the ladder; numpy's stable argsort of the alphas
  float all_a[kAll], all_f[kAll];
  int order[kAll];
  all_a[0] = 0.f;
  all_f[0] = fret;
  for (int i = 0; i < kProbes; ++i) {
    all_a[i + 1] = al[i];
    all_f[i + 1] = fv[i];
  }
  for (int i = 0; i < kAll; ++i) order[i] = i;
  for (int i = 1; i < kAll; ++i)
    for (int j = i; j > 0 && all_a[order[j - 1]] > all_a[order[j]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  float a_s[kAll], f_s[kAll];
  for (int i = 0; i < kAll; ++i) {
    a_s[i] = all_a[order[i]];
    f_s[i] = all_f[order[i]];
  }
  const int b = argmin_np(f_s, kAll);
  float lo = b > 0 ? a_s[b - 1] : a_s[0] - (a_s[1] - a_s[0]) * kGold;
  float hi = b < kAll - 1 ? a_s[b + 1] : a_s[kAll - 1] + (a_s[kAll - 1] - a_s[kAll - 2]) * kGold;
  float xb = a_s[b], fb = f_s[b];
  int nev = kProbes;
  float steps[kProbes];
  for (int i = 0; i < kProbes; ++i) steps[i] = static_cast<float>(i + 1) / denom;
  for (int r = 0; r < kLsRefineRounds; ++r) {
    float grid[kProbes];
    for (int i = 0; i < kProbes; ++i) grid[i] = lo + (hi - lo) * steps[i];
    probe_line(cost_batch, n, p, xi, grid, fv);
    const int gb = argmin_np(fv, kProbes);
    const bool better = fv[gb] < fb;
    if (better) {
      xb = grid[gb];
      fb = fv[gb];
    }
    const float width = hi - lo;
    const float stepw = width / denom;
    // best on an edge: expand golden-style past it instead of shrinking
    const float lo2 = better && gb == 0 ? lo - width * kGold : xb - stepw;
    hi = better && gb == kProbes - 1 ? hi + width * kGold : xb + stepw;
    lo = lo2;
    nev += kProbes;
  }
  for (int i = 0; i < n; ++i) {
    xi[i] = xi[i] * xb;
    p[i] = p[i] + xi[i];
  }
  fret = fb;
  return nev;
}

// No batched cost: Powell's line searches are linmin's.
struct NoBatch {
  MIL_HD void operator()(const float*, int, float*) {}
};

// A line search along xit from p: the probe search over cost_batch where
// one is given (fret in: the cost at p), else linmin over cost.
template <class C, class CB>
MIL_HD int powell_line(C& cost, CB* cost_batch, int n, float* p, float* xit, float& fret) {
  if (cost_batch != nullptr) return linmin_nprobe(*cost_batch, n, p, xit, fret);
  return linmin(cost, n, p, xit, fret);
}

// Powell's direction-set search over n <= kMaxN parameters from p (in
// place), its line searches the probe search where cost_batch is given.
// max_sweeps <= 0 runs to Powell's own ftol convergence. nev as for
// lbfgs_minimize. Returns f at p.
template <class C, class CB>
MIL_HD float powell_minimize(C& cost, CB* cost_batch, int n, float* p, float ftol,
                             int it_limit, int& nev, int max_sweeps) {
  const int itmax = max_sweeps <= 0 ? kPowellItmax
                                    : (max_sweeps < kPowellItmax ? max_sweeps : kPowellItmax);
  float fret = cost(p);
  nev += 1;
  float xi[kMaxN][kMaxN];   // xi[i]: direction i (the host loop's column xi[:, i])
  float pt[kMaxN], xit[kMaxN], ptt[kMaxN];
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) xi[i][j] = i == j ? 1.0f : 0.f;
    pt[i] = p[i];
  }
  bool done = fret >= kCostAbort;
  for (int it = 0; !done && it < itmax; ++it) {
    const float fp = fret;
    float delta = 0.f;
    int ibig = 0;
    bool stop = false;
    for (int i = 0; i < n && !stop; ++i) {
      for (int j = 0; j < n; ++j) xit[j] = xi[i][j];
      const float fptt = fret;
      nev += powell_line(cost, cost_batch, n, p, xit, fret);
      for (int j = 0; j < n; ++j) xi[i][j] = xit[j];
      if (fabsf(fptt - fret) > delta) {
        delta = fabsf(fptt - fret);
        ibig = i;
      }
      stop = nev >= it_limit || fret >= kCostAbort;
    }
    const bool converged = 2.0f * fabsf(fp - fret) <= ftol * (fabsf(fp) + fabsf(fret));
    if (!stop && !converged) {
      for (int j = 0; j < n; ++j) {
        ptt[j] = 2.0f * p[j] - pt[j];
        xit[j] = p[j] - pt[j];
        pt[j] = p[j];
      }
      const float fptt = cost(ptt);
      nev += 1;
      if (fptt < fp) {
        const float a = fp - fret - delta, b = fp - fptt;
        const float t = 2.0f * (fp - 2.0f * fret + fptt) * (a * a) - delta * (b * b);
        if (t < 0.f) {
          nev += powell_line(cost, cost_batch, n, p, xit, fret);
          for (int j = 0; j < n; ++j) {
            xi[ibig][j] = xi[n - 1][j];
            xi[n - 1][j] = xit[j];
          }
        }
      }
    }
    done = stop || converged || nev >= it_limit || fret >= kCostAbort;
  }
  return fret;
}

template <class C>
MIL_HD float powell_minimize(C& cost, int n, float* p, float ftol, int it_limit, int& nev,
                             int max_sweeps) {
  return powell_minimize(cost, static_cast<NoBatch*>(nullptr), n, p, ftol, it_limit, nev,
                         max_sweeps);
}

// ---------------------------------------------------------------------------
// Matrix builders (models/registration_device.py) and their pullback
// ---------------------------------------------------------------------------
// In the host loop's float32 order: torch's 3 x 3 products (A @ B and
// A^T @ G a fused multiply-add chain over k; G @ B^T products rounded one by
// one and added in k order 0, 2, 1), the angle as a float32 quotient by
// 57.3, and the pullback in reverse mode as autograd takes it. The sines
// and cosines are torch's CPU float32 ones (torch_trig.cuh: not correctly
// rounded; ~6% of small angles' cosines differ from the correctly rounded
// value in the last bit), on the card and in the host build alike.

// A @ B of the 3 x 3 blocks of two row-major 3 x 4 matrices (row pitch 4).
MIL_HD inline float mm_nn(const float* a, const float* b, int r, int c) {
  float s = a[4 * r] * b[c];
  s = fmaf(a[4 * r + 1], b[4 + c], s);
  return fmaf(a[4 * r + 2], b[8 + c], s);
}

// (3x4 a) o (3x4 b): rot = a[:, :3] @ b[:, :3], tr = a[:, :3] @ b[:, 3] + a[:, 3]
// (every b this ladder composes with has b[:, 3] = 0, so tr = a[:, 3]).
MIL_HD inline void compose(const float* a, const float* b, float* o) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 4; ++c) o[4 * r + c] = mm_nn(a, b, r, c);
    o[4 * r + 3] = o[4 * r + 3] + a[4 * r + 3];
  }
}

// The backward of o = compose(a, b) for the output gradient g (3 x 4):
// ga = d/da (all 12 entries), gb3 = d/db[:, :3] (row pitch 4; b[:, 3] takes
// no gradient here).
MIL_HD inline void compose_backward(const float* a, const float* b, const float* g,
                                    float* ga, float* gb) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      // g[:, :3] @ b[:, :3]^T, then the mv's outer product g[:, 3] b[c, 3]
      float s = g[4 * r] * b[4 * c];
      s = s + g[4 * r + 2] * b[4 * c + 2];
      s = s + g[4 * r + 1] * b[4 * c + 1];
      ga[4 * r + c] = s + g[4 * r + 3] * b[4 * c + 3];
      // a[:, :3]^T @ g[:, :3]
      float t = a[c] * g[r];
      t = fmaf(a[4 + c], g[4 + r], t);
      gb[4 * c + r] = fmaf(a[8 + c], g[8 + r], t);
    }
    ga[4 * r + 3] = g[4 * r + 3];
  }
}

// The forward pass of dof_to_matrix: (T*S) @ Rz @ Rx @ Ry with
// degrees/57.3 angles from the 9-vector dof9, keeping what the pullback
// needs.
struct DofForward {
  float ang[3], cs[3], sn[3];   // alpha, beta, theta; their cosines, sines
  float ts[12], r[3][12], m1[12], m2[12], m[12];
};

MIL_HD inline void dof_forward(const float* dof9, int ndof, DofForward& f) {
  float a = 1.0f, b = 1.0f, c = 1.0f;
  for (int i = 0; i < 3; ++i) {
    f.ang[i] = ndof == 3 ? 0.f : dof9[3 + i] / 57.3f;
    f.cs[i] = mil_trig::torch_cosf(f.ang[i]);
    f.sn[i] = mil_trig::torch_sinf(f.ang[i]);
  }
  if (ndof == 7) a = b = c = dof9[6];
  if (ndof == 9) {
    a = dof9[6];
    b = dof9[7];
    c = dof9[8];
  }
  const float ts[12] = {a, 0.f, 0.f, dof9[0], 0.f, b, 0.f, dof9[1], 0.f, 0.f, c, dof9[2]};
  const float* cs = f.cs;
  const float* sn = f.sn;
  const float rz[12] = {cs[0], sn[0], 0.f, 0.f, -sn[0], cs[0], 0.f, 0.f, 0.f, 0.f, 1.0f, 0.f};
  const float rx[12] = {1.0f, 0.f, 0.f, 0.f, 0.f, cs[1], sn[1], 0.f, 0.f, -sn[1], cs[1], 0.f};
  const float ry[12] = {cs[2], 0.f, -sn[2], 0.f, 0.f, 1.0f, 0.f, 0.f, sn[2], 0.f, cs[2], 0.f};
  for (int k = 0; k < 12; ++k) {
    f.ts[k] = ts[k];
    f.r[0][k] = rz[k];
    f.r[1][k] = rx[k];
    f.r[2][k] = ry[k];
  }
  compose(f.ts, f.r[0], f.m1);
  compose(f.m1, f.r[1], f.m2);
  compose(f.m2, f.r[2], f.m);
}

MIL_HD inline void dof_to_matrix(const float* dof9, int ndof, float* m) {
  DofForward f;
  dof_forward(dof9, ndof, f);
  for (int k = 0; k < 12; ++k) m[k] = f.m[k];
}

// The gradient of an angle from its rotation's block gradient g (row pitch
// 4): through the stacked entries (a cosine at (i, i) and (j, j), the sine
// at (i, j), its negation at (j, i)) and the cosine's and sine's backward.
MIL_HD inline float angle_backward(const float* g, int i, int j, float c, float s) {
  const float g_c = g[4 * i + i] + g[4 * j + j];
  const float g_s = g[4 * i + j] + (-g[4 * j + i]);
  return g_c * (-s) + g_s * c;
}

// params_to_matrix: m[k] = p[p2m(k)]; matrix_to_params: p[k] = m[m2p(k)]
MIL_HD inline int p2m(int k) {
  const int t[12] = {3, 4, 5, 0, 6, 7, 8, 1, 9, 10, 11, 2};
  return t[k];
}
MIL_HD inline int m2p(int k) {
  const int t[12] = {3, 7, 11, 0, 1, 2, 4, 5, 6, 8, 9, 10};
  return t[k];
}

// The full 9-vector of a DOF vector of ndof entries: angles 0, scales 1.
MIL_HD inline void full_dof(const float* p, int ndof, float* dof9) {
  for (int i = 0; i < 9; ++i) dof9[i] = i < ndof ? p[i] : (i < 6 ? 0.f : 1.0f);
}

// The matrix of a stage's parameters: ndof 3, 6, 7, 9 (a DOF vector) or
// 12 (the matrix parameters, params_to_matrix).
MIL_HD inline void stage_matrix(const float* p, int ndof, float* m) {
  if (ndof == 12) {
    for (int k = 0; k < 12; ++k) m[k] = p[p2m(k)];
    return;
  }
  float dof9[9];
  full_dof(p, ndof, dof9);
  dof_to_matrix(dof9, ndof, m);
}

// The matrix of a stage's parameters and the pullback of the matrix
// gradient gm through it: gp[i] = sum_k gm[k] d m_k / d p_i, in reverse
// mode as the host loop's autograd forms it.
MIL_HD inline void stage_pullback(const float* p, int ndof, const float* gm, float* m,
                                  float* gp) {
  if (ndof == 12) {
    for (int k = 0; k < 12; ++k) {
      m[k] = p[p2m(k)];
      gp[p2m(k)] = gm[k];
    }
    return;
  }
  float dof9[9];
  full_dof(p, ndof, dof9);
  DofForward f;
  dof_forward(dof9, ndof, f);
  for (int k = 0; k < 12; ++k) m[k] = f.m[k];
  // m = m2 o ry, m2 = m1 o rx, m1 = ts o rz
  float g2[12], g1[12], gts[12], gr[3][12];
  compose_backward(f.m2, f.r[2], gm, g2, gr[2]);
  compose_backward(f.m1, f.r[1], g2, g1, gr[1]);
  compose_backward(f.ts, f.r[0], g1, gts, gr[0]);
  gp[0] = gts[3];
  gp[1] = gts[7];
  gp[2] = gts[11];
  if (ndof == 3) return;
  // the sine's place (i, j) in Rz, Rx and Ry (its negation at (j, i))
  const int blk[3][2] = {{0, 1}, {1, 2}, {2, 0}};
  for (int a = 0; a < 3; ++a) {
    const float g_ang = angle_backward(gr[a], blk[a][0], blk[a][1], f.cs[a], f.sn[a]);
    gp[3 + a] = g_ang / 57.3f;
  }
  if (ndof == 7) gp[6] = (gts[0] + gts[5]) + gts[10];
  if (ndof == 9) {
    gp[6] = gts[0];
    gp[7] = gts[5];
    gp[8] = gts[10];
  }
}

// jac[k * ndof + i] = d m_k / d p_i: the pullback of each unit vector.
MIL_HD inline void stage_jacobian(const float* p, int ndof, float* jac) {
  for (int k = 0; k < 12; ++k) {
    float gm[12], m[12], gp[kMaxN];
    for (int j = 0; j < 12; ++j) gm[j] = j == k ? 1.0f : 0.f;
    stage_pullback(p, ndof, gm, m, gp);
    for (int i = 0; i < ndof; ++i) jac[k * ndof + i] = gp[i];
  }
}

MIL_HD inline void matrix_to_params(const float* m, float* p) {
  for (int k = 0; k < 12; ++k) p[k] = m[m2p(k)];
}

// ---------------------------------------------------------------------------
// The cost from the float64 sums
// ---------------------------------------------------------------------------

// -(st / sqrt(ss)) / sd_t rounded once to float32; 2 on zero energy.
MIL_HD inline float ncc_cost(double ss, double st, double sd_t) {
  const double r = sqrt(ss);
  if (r == 0.0) return 2.0f;
  return static_cast<float>(-(st / r) / sd_t);
}

// The cost and its gradient in the 12 matrix entries from K4's sums:
// gm = -(gt / sqrt(ss) - st gs / ss^1.5) / sd_t in float64, formed as the
// host loop's autograd forms it (the backward of -(st / sqrt(ss)) / sd_t,
// then 2 g_ss gs + g_st gt), rounded to float32; 2 and a zero gradient on
// zero energy.
MIL_HD inline float ncc_cost_grad(const double* s, double sd_t, float* gm) {
  const double ss = s[0], st = s[1];
  if (ss == 0.0) {
    for (int k = 0; k < 12; ++k) gm[k] = 0.f;
    return 2.0f;
  }
  const double r = sqrt(ss);
  const double g_q = -(1.0 / sd_t);              // d cost / d (st / r)
  const double g_st = g_q / r;
  const double g_r = -g_q * ((st / r) / r);
  const double g_ss2 = 2.0 * (g_r / (2.0 * r));  // 2 d cost / d ss
  for (int k = 0; k < 12; ++k) gm[k] = static_cast<float>(g_ss2 * s[2 + k] + g_st * s[14 + k]);
  return static_cast<float>(-(st / r) / sd_t);
}

// ---------------------------------------------------------------------------
// The ladder
// ---------------------------------------------------------------------------

// The ladder's inputs; kernels/reg_ladder.py::LadderArgs mirrors the layout.
struct LadderArgs {
  float p_init[12];    // the initial matrix parameters (affMethod 5); the line's start
  float xi[12];        // the line's direction (engine 2)
  float ftol;
  float s_lin;         // preconditioning of linear entries: 2 / mean extent
  double sd_t;         // the target's SD (sqrt of its energy)
  int aff_method;      // 1..7
  int engine;          // 0: grad (L-BFGS stages, optional Powell finisher); 1: device
                       // (Powell); 2: one line minimization (the hybrid engine's)
  int finish;          // grad: end with the Powell finisher
  int finish_sweeps;   // the finisher's sweep cap; <= 0: run to Powell's ftol
  int it_limit;        // the evaluation cap shared by the stages
  int ls_max_iters;    // L-BFGS steps a stage
  int ls_patience;     // L-BFGS ftol-stall patience
  int batch_ls;        // Powell's line searches probe kProbes points a call (K6's sums)
  int line_ndof;       // engine 2: the line's parameters, 3, 6, 7, 9 or 12
  int pad;
};

// What the ladder carries from stage to stage and returns;
// kernels/reg_ladder.py::LadderState mirrors the layout.
struct LadderState {
  float p[12];            // the point, in the parameters of the last stage run
  float aff[12];          // the final matrix (set by ladder_finish)
  float xi[12];           // engine 2: the line's direction scaled by its step
  float stage_costs[4];   // the cost after each ladder step (NaN where none)
  float fret;
  int ndof;               // parameters of p: 3, 6, 7, 9 (DOF vector) or 12
  int nev;                // evaluations so far (the it_limit count; a probe round 8)
  int stage;              // stages run
  int evals[3];           // passes of the K5, the K4 and the K6 sums
  int error;              // 0, or the first error a stage met
};

// The sums a stage evaluates: Powell over K5's, L-BFGS over K4's, Powell
// with the probe line search over K6's (every evaluation, the single ones
// too: K6's sums of one matrix are K5's).
constexpr int kBodyK5 = 0;
constexpr int kBodyK4 = 1;
constexpr int kBodyK6 = 2;
constexpr int kEngineLine = 2;

struct Stage {
  int body;         // kBodyK5, kBodyK4 or kBodyK6
  int ndof;         // 3, 6, 7, 9 or 12
  float ftol;
  int slot;         // stage_costs slot
  int max_sweeps;   // Powell's sweep cap (<= 0: none)
  int line;         // 1: one line minimization from p_init along xi (on K5's sums)
};

constexpr int kMaxStages = 5;

MIL_HD inline bool valid_ndof(int n) { return n == 3 || n == 6 || n == 7 || n == 9 || n == 12; }

// The stages of the ladder (models/registration_grad.py:80-184 for engine
// 0, models/registration_device.py:198-259 for engine 1; batch_ls: the
// Powell stages over K6's sums, engine 0's finisher alone), or the line
// stage (engine 2, models/registration_device.py::linmin_reg_device).
// Returns their count, 0 for an unknown method, engine or line.
MIL_HD inline int ladder_stages(const LadderArgs& a, Stage* st) {
  int n = 0;
  auto add = [&](int body, int ndof, float ftol, int slot, int sweeps, int line) {
    st[n].body = body;
    st[n].ndof = ndof;
    st[n].ftol = ftol;
    st[n].slot = slot;
    st[n].max_sweeps = sweeps;
    st[n].line = line;
    ++n;
  };
  if (a.engine == kEngineLine) {
    if (valid_ndof(a.line_ndof)) add(kBodyK5, a.line_ndof, a.ftol, 0, 0, 1);
    return n;
  }
  const int m = a.aff_method;
  if (m < 1 || m > 7 || a.engine < 0 || a.engine > 1) return 0;
  const int pw = a.batch_ls ? kBodyK6 : kBodyK5;
  const int lb = a.engine == 0 ? kBodyK4 : pw;
  int last_slot = 0, last_ndof = 12;
  if (m <= 4) {
    last_ndof = m == 1 ? 3 : m == 2 ? 6 : m == 3 ? 7 : 9;
    add(lb, last_ndof, a.ftol, 0, 0, 0);
  } else if (m == 5) {
    add(lb, 12, a.ftol, 0, 0, 0);
  } else if (m == 6) {
    add(lb, 6, 0.01f, 0, 0, 0);
    add(lb, 12, a.ftol, 1, 0, 0);
    last_slot = 1;
  } else {
    add(lb, 3, 0.01f, 0, 0, 0);
    add(lb, 6, 0.01f, 1, 0, 0);
    add(lb, 9, 0.005f, 2, 0, 0);
    add(lb, 12, a.ftol, 3, 0, 0);
    last_slot = 3;
  }
  if (a.engine == 0 && a.finish) add(pw, last_ndof, a.ftol, last_slot, a.finish_sweeps, 0);
  return n;
}

// The state before the first stage: the identity in the first stage's
// parameters (affMethod 5: p_init; the line stage: p_init's first ndof).
MIL_HD inline void ladder_init(const LadderArgs& a, LadderState& s) {
  Stage st[kMaxStages];
  const int n = ladder_stages(a, st);
  s.ndof = n ? st[0].ndof : 12;
  const bool given = a.aff_method == 5 || a.engine == kEngineLine;
  for (int i = 0; i < 12; ++i) {
    s.p[i] = given ? (i < s.ndof ? a.p_init[i] : 0.f)
                   : (i >= 6 && i < s.ndof && s.ndof < 12 ? 1.0f : 0.f);
    s.aff[i] = 0.f;
    s.xi[i] = 0.f;
  }
  for (int i = 0; i < 4; ++i) s.stage_costs[i] = qnan();
  s.fret = qnan();
  s.nev = 0;
  s.stage = 0;
  s.evals[0] = s.evals[1] = s.evals[2] = 0;
  s.error = n ? 0 : 1;
}

// The stage's start point from the state: the same parameters, a DOF
// vector grown by identity entries (angles 0, scales 1), or the matrix
// parameters of the DOF vector's matrix.
MIL_HD inline void stage_start(const Stage& st, const LadderState& s, float* x0) {
  if (s.ndof == st.ndof) {
    for (int i = 0; i < st.ndof; ++i) x0[i] = s.p[i];
  } else if (st.ndof == 12) {
    float m[12];
    stage_matrix(s.p, s.ndof, m);
    matrix_to_params(m, x0);
  } else {
    for (int i = 0; i < st.ndof; ++i) x0[i] = i < s.ndof ? s.p[i] : (i < 6 ? 0.f : 1.0f);
  }
}

// The preconditioning scale of a stage's parameters: 1 for translations
// and degrees, s_lin for scale factors and raw linear entries.
MIL_HD inline void stage_scale(const Stage& st, float s_lin, float* sc) {
  for (int i = 0; i < st.ndof; ++i)
    sc[i] = st.ndof == 12 ? (i < 3 ? 1.0f : s_lin) : (i >= 6 ? s_lin : 1.0f);
}

// Powell's cost over a stage's parameters: K5's sums, or (PROBES) K6's of
// the one matrix.
template <class E, bool PROBES = false>
struct StageCost {
  E* ev;
  int ndof;
  double sd_t;
  MIL_HD float operator()(const float* p) {
    float m[12];
    double s[26];
    stage_matrix(p, ndof, m);
    if constexpr (PROBES) {
      ev->probes(m, 1, s);
    } else {
      (*ev)(m, false, s);
    }
    return ncc_cost(s[0], s[1], sd_t);
  }
};

// The probe line search's batched cost over a stage's parameters: the n
// points' matrices in one pass of K6's sums (the host loop's
// _dof_cost_batch / _p12_cost_batch: each row's matrix as the single cost
// builds it).
template <class E>
struct StageCostBatch {
  E* ev;
  int ndof;
  double sd_t;
  MIL_HD void operator()(const float* ps, int n, float* f) {
    float m[kProbes * 12];
    double s[2 * kProbes];
    for (int i = 0; i < n; ++i) stage_matrix(ps + i * kMaxN, ndof, m + 12 * i);
    ev->probes(m, n, s);
    for (int i = 0; i < n; ++i) f[i] = ncc_cost(s[2 * i], s[2 * i + 1], sd_t);
  }
};

// L-BFGS's value and gradient over the preconditioned q = p / scale.
template <class E>
struct StageValueGrad {
  E* ev;
  int ndof;
  double sd_t;
  const float* scale;
  MIL_HD float operator()(const float* q, float* g) {
    float p[kMaxN], m[12], gm[12], gp[kMaxN];
    double s[26];
    for (int i = 0; i < ndof; ++i) p[i] = q[i] * scale[i];
    stage_matrix(p, ndof, m);
    (*ev)(m, true, s);
    const float f = ncc_cost_grad(s, sd_t, gm);
    stage_pullback(p, ndof, gm, m, gp);
    for (int i = 0; i < ndof; ++i) g[i] = gp[i] * scale[i];
    return f;
  }
};

// Run one stage of body BODY (st.body must agree) from the state and write
// its result into it. K9 instantiates one body per stage kernel; the line
// stage runs on K5's.
template <int BODY, class E>
MIL_HD void run_stage_kind(const LadderArgs& a, const Stage& st, LadderState& s, E& ev) {
  float x[kMaxN];
  stage_start(st, s, x);
  int nev = s.nev;
  float f;
  if constexpr (BODY == kBodyK4) {
    float sc[kMaxN];
    stage_scale(st, a.s_lin, sc);
    for (int i = 0; i < st.ndof; ++i) x[i] = x[i] / sc[i];
    StageValueGrad<E> vg{&ev, st.ndof, a.sd_t, sc};
    f = lbfgs_minimize(vg, st.ndof, x, st.ftol, a.it_limit, nev, a.ls_max_iters,
                       a.ls_patience);
    for (int i = 0; i < st.ndof; ++i) x[i] = x[i] * sc[i];
  } else if constexpr (BODY == kBodyK6) {
    StageCost<E, true> cost{&ev, st.ndof, a.sd_t};
    StageCostBatch<E> batch{&ev, st.ndof, a.sd_t};
    f = powell_minimize(cost, &batch, st.ndof, x, st.ftol, a.it_limit, nev, st.max_sweeps);
  } else {
    StageCost<E> cost{&ev, st.ndof, a.sd_t};
    if (st.line) {
      // ops/powell_device.py::_linmin from p_init along xi: the evaluations
      // of this line alone
      float xi[kMaxN];
      for (int i = 0; i < st.ndof; ++i) xi[i] = a.xi[i];
      nev = linmin(cost, st.ndof, x, xi, f);
      for (int i = 0; i < 12; ++i) s.xi[i] = i < st.ndof ? xi[i] : 0.f;
    } else {
      f = powell_minimize(cost, st.ndof, x, st.ftol, a.it_limit, nev, st.max_sweeps);
    }
  }
  for (int i = 0; i < 12; ++i) s.p[i] = i < st.ndof ? x[i] : 0.f;
  s.ndof = st.ndof;
  s.fret = f;
  s.nev = nev;
  s.stage_costs[st.slot] = f;
  s.stage += 1;
}

// Run one stage from the state and write its result into it.
template <class E>
MIL_HD void run_stage(const LadderArgs& a, const Stage& st, LadderState& s, E& ev) {
  if (st.body == kBodyK4) {
    run_stage_kind<kBodyK4>(a, st, s, ev);
  } else if (st.body == kBodyK6) {
    run_stage_kind<kBodyK6>(a, st, s, ev);
  } else {
    run_stage_kind<kBodyK5>(a, st, s, ev);
  }
}

// The final matrix of the state's point.
MIL_HD inline void ladder_finish(LadderState& s) { stage_matrix(s.p, s.ndof, s.aff); }

// The whole ladder with one evaluator (the host build's entry).
template <class E>
MIL_HD void run_ladder(const LadderArgs& a, LadderState& s, E& ev) {
  Stage st[kMaxStages];
  const int n = ladder_stages(a, st);
  ladder_init(a, s);
  for (int i = 0; i < n && !s.error; ++i) run_stage(a, st[i], s, ev);
  ladder_finish(s);
}

}  // namespace mil_reg
