// K9: the registration ladder's optimizer stages on the card, for Hopper
// (sm_90a). One cooperative launch runs one optimizer stage, every
// evaluation of its cost included; the host launches the ladder's stages
// one after another on its stream and syncs once, at the end.
//
// Replaces the JAX package's jitted ladders, one device program each:
// microimagelib_tpu/models/registration_grad.py:111 (reg_ladder_grad: the
// L-BFGS lax.while_loop of microimagelib_tpu/ops/lbfgs.py:198 over K4, then
// the Powell finisher) and microimagelib_tpu/models/registration_device.py
// :126 (reg_ladder_device: the Powell lax.while_loop of
// microimagelib_tpu/ops/powell_device.py:388, mnbrak :129, brent :200,
// over K5). The control flow is csrc/reg_opt.cuh, the transliteration of
// the port's host loop (ops/lbfgs.py, ops/powell_device.py and the ladder
// bodies), so the evaluation count and the point stay the host loop's.
//
// What bounds it on this card. Each evaluation is a K4 or K5 pass over the
// pair (the sums' bound, ~8 bytes a valid voxel); between evaluations the
// optimizer's step is a few thousand scalar operations in one block. The
// host loop paid a host round trip per evaluation (a sync, a copy of the
// sums, CPU autograd through the matrix builders: 0.11-0.30 ms against a
// 4-36 us kernel at the pooled levels). Here the step and the hand-over
// cost two global-memory barriers an evaluation.
//
// The design (the simple one; making it fast is later work):
//   * The stage kernel takes K4's plan and launch bounds (L-BFGS stages)
//     or K5's (Powell stages): at most one wave of resident blocks
//     (corr_body.cuh::make_plan), launched with cudaLaunchCooperativeKernel,
//     which refuses a grid that would not be co-resident; the entry checks
//     the count against cudaOccupancyMaxActiveBlocksPerMultiprocessor first.
//   * Block 0 runs the optimizer: each of its threads runs the same
//     reg_opt.cuh code on the same values (so every branch is uniform), and
//     at each evaluation thread 0 publishes the matrix and a new generation
//     in the workspace, then all of block 0 computes its own block row.
//   * Every other block waits on the generation counter, reads the matrix,
//     writes its row (corr_body.cuh::corr_block, the very body of K4/K5)
//     and counts itself in. Block 0 waits for the count, then sums the
//     columns in K4/K5's fixed order (sum_columns): each evaluation's ss,
//     st, gs and gt equal a standalone K4/K5 launch on the same matrix, bit
//     for bit. The cost and its gradient follow in float64.
//   * The barriers are a counter in global memory with __threadfence, valid
//     under the co-residency the cooperative launch guarantees (no -rdc,
//     no grid.sync). Every wait is bounded (kSpinNs): past the bound a
//     block gives up, the stage ends, and the state's error code says so.
//   * One kernel a stage kind (reg_stage_kernel<GRAD>): the plan's VX and
//     64-bit choice select K4's or K5's body at run time (block_row), and
//     the optimizer (drive), the evaluation and the six bodies are calls
//     (__noinline__), each compiled once a kind: with them inlined into
//     twelve instantiations the file took 339 s to build on the H100
//     machine. The optimizer's state (the history of L-BFGS, Powell's
//     direction set) lives in each block-0 thread's local memory.
//   * No --use_fast_math: cosf, sinf and sqrt round as IEEE says.
//
// The workspace (per device and stream, kernels/reg_ladder.py): kSyncWords
// doubles of control words (zeroed before each stage), kStateWords of
// LadderState (carried from stage to stage), then the block rows.

#include "corr_body.cuh"
#include "reg_opt.cuh"

namespace {

using mil_reg::LadderArgs;
using mil_reg::LadderState;
using mil_reg::Stage;

// The stage's control words, zeroed before each launch.
struct Sync {
  unsigned gen;       // evaluations block 0 has published (then once more: stop)
  unsigned arrived;   // rows the other blocks have written, over the stage
  unsigned stop;      // 1: the stage is done
  unsigned pad;
  float m[12];        // the matrix of the newest evaluation
};

constexpr int kSyncWords = 8;      // doubles
constexpr int kStateWords = 32;
constexpr int kTraceWords = 40;    // a trace record: kind, m(12), sums(26), pad
constexpr unsigned long long kSpinNs = 10ull * 1000ull * 1000ull * 1000ull;
// LadderState::error codes (1: an unknown method or engine, reg_opt.cuh)
constexpr int kErrTimeout = 2;
constexpr int kErrKind = 3;

static_assert(sizeof(Sync) <= kSyncWords * sizeof(double), "Sync outgrew its words");
static_assert(sizeof(LadderState) <= kStateWords * sizeof(double),
              "LadderState outgrew its words");

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// A block's row of K4's (GRAD) or K5's sums for the matrix m, on the
// plan's instantiation (vx voxels a thread a step; wide: 64-bit offsets):
// corr_block itself, so the row equals a K4/K5 launch's. Not inlined, so
// each of the six bodies compiles once a stage kind.
template <bool GRAD>
__device__ __noinline__ void block_row(int vx, int wide, const float* __restrict__ src,
                                       const float* __restrict__ tgt, const float* m,
                                       const Geo g, long long block, double* partials,
                                       size_t stride) {
  if (wide) {
    if (vx == 4) {
      corr_block<GRAD, 4, long long>(src, tgt, m, g, block, partials, stride);
    } else if (vx == 2) {
      corr_block<GRAD, 2, long long>(src, tgt, m, g, block, partials, stride);
    } else {
      corr_block<GRAD, 1, long long>(src, tgt, m, g, block, partials, stride);
    }
  } else if (vx == 4) {
    corr_block<GRAD, 4, int>(src, tgt, m, g, block, partials, stride);
  } else if (vx == 2) {
    corr_block<GRAD, 2, int>(src, tgt, m, g, block, partials, stride);
  } else {
    corr_block<GRAD, 1, int>(src, tgt, m, g, block, partials, stride);
  }
}

// Block 0's evaluator: one K4 (GRAD) or K5 evaluation across the grid.
// Called by every thread of block 0 with the same matrix.
template <bool GRAD>
struct DevEval {
  const float* src;
  const float* tgt;
  Sync* sync;
  double* partials;
  Geo g;
  int vx, wide;
  unsigned nb;        // blocks in the grid
  unsigned gen;       // evaluations published
  int err;
  int count;          // evaluations made
  double* trace;      // test hook: one record an evaluation, or null
  int trace_cap;
  int trace_next;     // the record this evaluation takes

  __host__ __device__ __noinline__ void operator()(const float* m, bool grad, double* out) {
#ifdef __CUDA_ARCH__
    constexpr int NV = GRAD ? 26 : 2;
    __shared__ float sh_m[12];
    __shared__ double sh_res[NV];
    __shared__ int sh_err;
    if (grad != GRAD && !err) err = kErrKind;
    if (err) {
      for (int k = 0; k < 26; ++k) out[k] = 0.0;
      return;
    }
    const unsigned tid = threadIdx.x;
    if (tid == 0) {
      sh_err = 0;
      volatile float* vm = sync->m;
      for (int k = 0; k < 12; ++k) {
        sh_m[k] = m[k];
        vm[k] = m[k];
      }
      __threadfence();
      atomicExch(&sync->gen, gen + 1);
    }
    gen += 1;
    __syncthreads();
    block_row<GRAD>(vx, wide, src, tgt, sh_m, g, 0, partials, nb);
    __threadfence();   // the row, before the column sum reads it from L2
    if (tid == 0) {
      const unsigned want = (nb - 1) * gen;
      const unsigned long long t0 = now_ns();
      while (load_volatile(&sync->arrived) < want) {
        if (now_ns() - t0 > kSpinNs) {
          sh_err = kErrTimeout;
          break;
        }
      }
      __threadfence();
    }
    __syncthreads();
    if (sh_err) {
      err = sh_err;
      for (int k = 0; k < 26; ++k) out[k] = 0.0;
      return;
    }
    sum_columns<NV>(partials, static_cast<int>(nb), NV, sh_res);
    for (int k = 0; k < NV; ++k) out[k] = sh_res[k];
    for (int k = NV; k < 26; ++k) out[k] = 0.0;
    if (trace != nullptr && tid == 0 && trace_next < trace_cap) {
      double* r = trace + static_cast<size_t>(trace_next) * kTraceWords;
      r[0] = GRAD ? 1.0 : 0.0;
      for (int k = 0; k < 12; ++k) r[1 + k] = m[k];
      for (int k = 0; k < 26; ++k) r[13 + k] = out[k];
    }
    trace_next += 1;
    count += 1;
    __syncthreads();   // sh_res and sh_m are reused by the next evaluation
#endif
  }
};

// The blocks other than 0: wait for a generation, write the row, count in;
// until block 0 says stop (or a wait runs past the bound: block 0's own
// wait then runs out too and reports it).
template <bool GRAD>
__device__ __noinline__ void worker(int vx, int wide, const float* __restrict__ src,
                                    const float* __restrict__ tgt, Sync* sync,
                                    double* partials, const Geo g) {
  __shared__ float sh_m[12];
  __shared__ unsigned sh_gen;
  __shared__ int sh_quit;
  unsigned seen = 0;
  for (;;) {
    if (threadIdx.x == 0) {
      const unsigned long long t0 = now_ns();
      unsigned gnow;
      int quit = 0;
      while ((gnow = load_volatile(&sync->gen)) == seen) {
        if (now_ns() - t0 > kSpinNs) {
          quit = 1;
          break;
        }
      }
      __threadfence();
      if (!quit && load_volatile(&sync->stop)) quit = 1;
      if (!quit) {
        const volatile float* vm = sync->m;
        for (int k = 0; k < 12; ++k) sh_m[k] = vm[k];
      }
      sh_gen = gnow;
      sh_quit = quit;
    }
    __syncthreads();
    if (sh_quit) return;
    seen = sh_gen;
    block_row<GRAD>(vx, wide, src, tgt, sh_m, g, blockIdx.x, partials + blockIdx.x,
                    gridDim.x);
    // the row visible device-wide before the block counts itself in (as
    // corr_body.cuh::last_block orders K4/K5's rows before their ticket)
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(&sync->arrived, 1u);
  }
}

// Block 0: run the stage's optimizer (every thread, the same values),
// then publish the state and stop the other blocks. Not inlined: one copy
// of the optimizer a stage kind.
template <bool GRAD>
__device__ __noinline__ void drive(const float* src, const float* tgt, Sync* sync,
                                   LadderState* state, double* partials,
                                   const LadderArgs& args, const Stage& stage, int first,
                                   int last, const Geo g, int vx, int wide, double* trace,
                                   int trace_cap) {
  LadderState s;
  if (first) {
    mil_reg::ladder_init(args, s);
  } else {
    s = *state;
  }
  DevEval<GRAD> ev{src, tgt, sync, partials, g, vx, wide, gridDim.x, 0u, 0, 0,
                   trace, trace_cap, s.evals[0] + s.evals[1]};
  if (!s.error) {
    mil_reg::run_stage_kind<GRAD>(args, stage, s, ev);
    s.evals[GRAD ? 1 : 0] += ev.count;
    if (ev.err) s.error = ev.err;
  }
  if (last) mil_reg::ladder_finish(s);
  if (threadIdx.x == 0) {
    *state = s;
    reinterpret_cast<volatile unsigned*>(&sync->stop)[0] = 1u;
    __threadfence();
    atomicExch(&sync->gen, ev.gen + 1);
  }
}

// One optimizer stage: GRAD = L-BFGS over K4's sums (K4's launch bounds),
// else Powell over K5's (K5's). `first` starts the ladder (the state from
// args), `last` ends it (the final matrix); vx and wide are the plan's.
template <bool GRAD>
__global__ void __launch_bounds__(kThreads, GRAD ? kResidentGrad : kResidentSums)
reg_stage_kernel(const float* __restrict__ src, const float* __restrict__ tgt, Sync* sync,
                 LadderState* state, double* __restrict__ partials, LadderArgs args,
                 Stage stage, int first, int last, Geo g, int vx, int wide, double* trace,
                 int trace_cap) {
  if (blockIdx.x != 0) {
    worker<GRAD>(vx, wide, src, tgt, sync, partials, g);
  } else {
    drive<GRAD>(src, tgt, sync, state, partials, args, stage, first, last, g, vx, wide,
                trace, trace_cap);
  }
}

using StageFn = void (*)(const float*, const float*, Sync*, LadderState*, double*, LadderArgs,
                         Stage, int, int, Geo, int, int, double*, int);

StageFn stage_fn(bool grad) { return grad ? reg_stage_kernel<true> : reg_stage_kernel<false>; }

int sms_of_device() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

long long work_words(const Plan& p4, const Plan& p5) {
  const long long rows = p4.blocks * 26 > p5.blocks * 2 ? p4.blocks * 26 : p5.blocks * 2;
  return kSyncWords + kStateWords + rows;
}

}  // namespace

extern "C" {

// Doubles of workspace a ladder on a (sz, sy, sx) grid needs on this
// device, and where the state lies in it (out[0] = length, out[1] = the
// state's offset in doubles). Returns a cudaError_t.
int mil_reg_ladder_work(int sz, int sy, int sx, long long* out) {
  if (sz < 1 || sy < 1 || sx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sms_of_device();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  out[0] = work_words(make_plan(sz, sy, sx, true, sms), make_plan(sz, sy, sx, false, sms));
  out[1] = kSyncWords;
  return 0;
}

// Sizes the wrapper's mirrors must match: LadderArgs, LadderState bytes,
// doubles a trace record.
int mil_reg_ladder_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(LadderArgs));
  out[1] = static_cast<int>(sizeof(LadderState));
  out[2] = kTraceWords;
  return 0;
}

// What a stage kernel compiled to: grad 1 = the L-BFGS stage (K4's body),
// 0 = the Powell stage (K5's); vx, wide as the plan gives them. out[0]
// registers, out[1] spilled (local) bytes a thread, out[2] static shared
// bytes, out[3] resident blocks per SM. Returns a cudaError_t.
int mil_reg_ladder_attrs(int grad, int vx, int wide, int* out) {
  if (vx != 1 && vx != 2 && vx != 4) return static_cast<int>(cudaErrorInvalidValue);
  (void)wide;   // one kernel a stage kind takes every instantiation of the body
  const void* fn = reinterpret_cast<const void*>(stage_fn(grad != 0));
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err;
  if ((err = cudaFuncGetAttributes(&a, fn)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0)) !=
          cudaSuccess)
    return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

// The ladder of *args on `stream`: one cooperative launch per stage, no
// sync. `work` holds `work_len` doubles on the device (mil_reg_ladder_work);
// the result is the LadderState at work + kSyncWords, once the stream gets
// there. `trace` (or null) takes up to trace_cap records of kTraceWords
// doubles: kind (1 = K4), the matrix, the sums. n_launches receives the
// stages launched. Returns a cudaError_t: cudaErrorCooperativeLaunchTooLarge
// where the plan's blocks would not be co-resident.
int mil_reg_ladder(const float* src, const float* tgt, int sz, int sy, int sx,
                   const LadderArgs* args, double* work, long long work_len, double* trace,
                   int trace_cap, void* stream, int* n_launches) {
  *n_launches = 0;
  if (sz < 1 || sy < 1 || sx < 1 || args == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Stage stages[mil_reg::kMaxStages];
  const int n = mil_reg::ladder_stages(*args, stages);
  if (n == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sms_of_device();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  int dev = 0, coop = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const Plan plans[2] = {make_plan(sz, sy, sx, false, sms), make_plan(sz, sy, sx, true, sms)};
  if (work_len < work_words(plans[1], plans[0])) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 2; ++i)
    if (plans[i].blocks > kMaxBlocks || plans[i].steps > 2147483647LL)
      return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Sync* sync = reinterpret_cast<Sync*>(work);
  LadderState* state = reinterpret_cast<LadderState*>(work + kSyncWords);
  double* partials = work + kSyncWords + kStateWords;
  LadderArgs a = *args;
  for (int i = 0; i < n; ++i) {
    const Plan& p = plans[stages[i].lbfgs];
    const StageFn fn = stage_fn(stages[i].lbfgs != 0);
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, reinterpret_cast<const void*>(fn), kThreads, 0)) != cudaSuccess)
      return static_cast<int>(err);
    if (static_cast<long long>(per_sm) * sms < p.blocks)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    if ((err = cudaMemsetAsync(sync, 0, sizeof(Sync), st)) != cudaSuccess)
      return static_cast<int>(err);
    Geo g = make_geo(p, sz, sy, sx);
    Stage stage = stages[i];
    int first = i == 0, last = i == n - 1, vx = p.vx, wide = p.wide;
    const float* s_ptr = src;
    const float* t_ptr = tgt;
    void* kargs[] = {&s_ptr, &t_ptr, &sync, &state, &partials, &a,     &stage,
                     &first, &last, &g,     &vx,   &wide,  &trace, &trace_cap};
    if ((err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                           dim3(static_cast<unsigned>(p.blocks)),
                                           dim3(kThreads), kargs, 0, st)) != cudaSuccess)
      return static_cast<int>(err);
    *n_launches += 1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
