// The host build of csrc/reg_opt.cuh: K9's optimizers, matrix builders and
// ladder compiled by the host C++ compiler, with a plain C interface whose
// costs and sums come from caller-supplied callbacks (ctypes functions in
// native/reg_opt.py). It runs the same source the card runs inside K9, so
// the CPU tests hold that source against the JAX package's optimizers.

#include "../csrc/reg_opt.cuh"

using mil_reg::LadderArgs;
using mil_reg::LadderState;

extern "C" {

typedef float (*mil_cost_fn)(const float* p, void* ctx);
typedef float (*mil_vg_fn)(const float* p, float* g, void* ctx);
typedef int (*mil_sums_fn)(const float* m12, int grad, double* sums, void* ctx);
// n points of a batched cost, rows of mil_reg::kMaxN floats
typedef void (*mil_batch_fn)(const float* ps, int n, float* f, void* ctx);
// the K6 sums (ss, st a matrix) of n <= kProbes matrices
typedef int (*mil_probes_fn)(const float* m12s, int n, double* sums, void* ctx);

}  // extern "C"

namespace {

struct CostCb {
  mil_cost_fn fn;
  void* ctx;
  float operator()(const float* p) { return fn(p, ctx); }
};

struct VgCb {
  mil_vg_fn fn;
  void* ctx;
  float operator()(const float* p, float* g) { return fn(p, g, ctx); }
};

struct BatchCb {
  mil_batch_fn fn;
  void* ctx;
  void operator()(const float* ps, int n, float* f) { fn(ps, n, f, ctx); }
};

// The sums through the callbacks; a nonzero return stops the ladder (the
// evaluator then answers 2.0 with a zero gradient, which ends every stage).
struct SumsCb {
  mil_sums_fn fn;
  mil_probes_fn probes_fn;
  void* ctx;
  LadderState* s;
  void operator()(const float* m, bool grad, double* out) {
    s->evals[grad ? 1 : 0] += 1;
    if (!s->error) s->error = fn(m, grad ? 1 : 0, out, ctx);
    if (s->error) {
      for (int k = 0; k < 26; ++k) out[k] = 0.0;
    }
  }
  void probes(const float* m, int n, double* out) {
    s->evals[2] += 1;
    if (!s->error) s->error = probes_fn(m, n, out, ctx);
    if (s->error) {
      for (int k = 0; k < 2 * n; ++k) out[k] = 0.0;
    }
  }
};

bool valid_n(int n) { return n >= 1 && n <= mil_reg::kMaxN; }

}  // namespace

extern "C" {

// Powell over n parameters from p (in place), its line searches the
// probe search over batch_fn where one is given (else linmin); returns 0,
// or 1 for a bad n.
int mil_reg_powell(int n, float* p, float ftol, int it_limit, int nev0, int max_sweeps,
                   mil_cost_fn fn, mil_batch_fn batch_fn, void* ctx, float* fret, int* nev) {
  if (!valid_n(n)) return 1;
  CostCb cost{fn, ctx};
  BatchCb batch{batch_fn, ctx};
  int count = nev0;
  *fret = mil_reg::powell_minimize(cost, batch_fn != nullptr ? &batch : nullptr, n, p, ftol,
                                   it_limit, count, max_sweeps);
  *nev = count;
  return 0;
}

// The probe line search along xi from p (both in place: p += xb xi, xi *=
// xb); *fret in: the cost at p, out: the best cost. Returns 0, or 1 for a
// bad n.
int mil_reg_linmin_nprobe(int n, float* p, float* xi, float* fret, mil_batch_fn batch_fn,
                          void* ctx, int* nev) {
  if (!valid_n(n)) return 1;
  BatchCb batch{batch_fn, ctx};
  *nev = mil_reg::linmin_nprobe(batch, n, p, xi, *fret);
  return 0;
}

// L-BFGS over n parameters from p (in place); returns 0, or 1 for a bad n.
int mil_reg_lbfgs(int n, float* p, float ftol, int it_limit, int nev0, int max_iters,
                  int patience, mil_vg_fn fn, void* ctx, float* f, int* nev) {
  if (!valid_n(n)) return 1;
  VgCb vg{fn, ctx};
  int count = nev0;
  *f = mil_reg::lbfgs_minimize(vg, n, p, ftol, it_limit, count, max_iters, patience);
  *nev = count;
  return 0;
}

// The matrix of a stage's parameters (ndof 3, 6, 7, 9 or 12) and its
// Jacobian, jac[k * ndof + i] = d m_k / d p_i. Returns 0, or 1 for a bad
// ndof.
int mil_reg_stage_matrix(const float* p, int ndof, float* m, float* jac) {
  if (!mil_reg::valid_ndof(ndof)) return 1;
  mil_reg::stage_matrix(p, ndof, m);
  mil_reg::stage_jacobian(p, ndof, jac);
  return 0;
}

// The matrix of a stage's parameters and the pullback of gm through it
// (gp[i] = sum_k gm[k] d m_k / d p_i). Returns 0, or 1 for a bad ndof.
int mil_reg_stage_pullback(const float* p, int ndof, const float* gm, float* m, float* gp) {
  if (!mil_reg::valid_ndof(ndof)) return 1;
  mil_reg::stage_pullback(p, ndof, gm, m, gp);
  return 0;
}

// The whole ladder (or the line stage) over the sums callbacks; the result
// in *out. Returns out->error (0 on success, 1 for an unknown method,
// engine or line, else a callback's first nonzero return).
int mil_reg_ladder(const LadderArgs* args, mil_sums_fn fn, mil_probes_fn probes_fn, void* ctx,
                   LadderState* out) {
  SumsCb ev{fn, probes_fn, ctx, out};
  mil_reg::run_ladder(*args, *out, ev);
  return out->error;
}

// The ladder's stages: out[6 i .. 6 i + 5] = body (0 K5, 1 K4, 2 K6),
// ndof, slot, max_sweeps, ftol x 1e6 (rounded), line of stage i. Returns
// their count.
int mil_reg_stages(const LadderArgs* args, int* out) {
  mil_reg::Stage st[mil_reg::kMaxStages];
  const int n = mil_reg::ladder_stages(*args, st);
  for (int i = 0; i < n; ++i) {
    const int v[6] = {st[i].body, st[i].ndof, st[i].slot, st[i].max_sweeps,
                      static_cast<int>(st[i].ftol * 1e6f + 0.5f), st[i].line};
    for (int k = 0; k < 6; ++k) out[6 * i + k] = v[k];
  }
  return n;
}

// torch's CPU float32 sine and cosine as the matrix builders take them
// (torch_trig.cuh), of x[0..n).
int mil_reg_torch_trig(const float* x, int n, float* sn, float* cs) {
  for (int i = 0; i < n; ++i) {
    sn[i] = mil_trig::torch_sinf(x[i]);
    cs[i] = mil_trig::torch_cosf(x[i]);
  }
  return 0;
}

// compose(a, b) of two row-major 3 x 4 matrices and its backward for the
// output gradient g: o = a o b, ga = d/da, gb = d/db[:, :3] (row pitch 4).
int mil_reg_compose(const float* a, const float* b, const float* g, float* o, float* ga,
                    float* gb) {
  mil_reg::compose(a, b, o);
  for (int k = 0; k < 12; ++k) gb[k] = 0.f;
  mil_reg::compose_backward(a, b, g, ga, gb);
  return 0;
}

int mil_reg_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(LadderArgs));
  out[1] = static_cast<int>(sizeof(LadderState));
  return 0;
}

}  // extern "C"
