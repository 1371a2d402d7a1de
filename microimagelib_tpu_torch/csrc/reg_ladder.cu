// K9: the registration ladder's optimizer stages on the card, for Hopper
// (sm_90a). One cooperative launch runs one optimizer stage, every
// evaluation of its cost included; the host launches the ladder's stages
// one after another on its stream and syncs once, at the end. One launch
// of a line stage runs the hybrid engine's one line minimization.
//
// Replaces the JAX package's jitted ladders, one device program each:
// microimagelib_tpu/models/registration_grad.py:111 (reg_ladder_grad: the
// L-BFGS lax.while_loop of microimagelib_tpu/ops/lbfgs.py:198 over K4, then
// the Powell finisher) and microimagelib_tpu/models/registration_device.py
// :126 (reg_ladder_device: the Powell lax.while_loop of
// microimagelib_tpu/ops/powell_device.py:388, mnbrak :129, brent :200,
// over K5; with batch_ls every line search _linmin_nprobe :219 over the
// N-probe kernel K6), and the jitted line minimization linmin_reg_device
// (microimagelib_tpu/models/registration_device.py:243). The control flow
// is csrc/reg_opt.cuh, the transliteration of the port's host loop
// (ops/lbfgs.py, ops/powell_device.py and the ladder bodies), so the
// evaluation count and the point stay the host loop's.
//
// What bounds it on this card. Each evaluation is a K4, K5 or K6 pass over
// the pair (the sums' bound, ~8 bytes a valid voxel; K6's operations grow
// with its matrices); between evaluations the
// optimizer's step is a few thousand scalar operations in one block, and
// the hand-over between the blocks two barriers in global memory. A traced
// launch stamps each evaluation (publish, the other blocks' latest start
// and last arrival, block 0's own row, the rows seen, the column sum done,
// the next publish), which splits its time into rows, hand-over, column sum
// and step (kernels/reg_ladder.py::trace_split).
//
// The design (redesigned on that split):
//   * The stage kernel takes K4's plan and launch bounds (L-BFGS stages)
//     or K5's (Powell stages, the line stage, and the probe stages of
//     batch_ls, whose body is K6's): at most one wave of resident blocks
//     (corr_body.cuh::make_plan), launched with cudaLaunchCooperativeKernel,
//     which refuses a grid that would not be co-resident; the entry checks
//     the count against cudaOccupancyMaxActiveBlocksPerMultiprocessor first.
//   * One stage kernel an instantiation of K4's, K5's or K6's body (BODY,
//     VX, IDX: MIL_K9_STAGE_KINDS, eighteen), which the host picks from the
//     plan as corr.cu picks K4's, K5's or K6's. The blocks other than 0 run
//     the body inlined there, its operands kernel parameters as in corr.cu,
//     the matrices from shared memory (corr_body.cuh::SharedMat(s): they
//     change each evaluation, so they cannot be constant-bank operands).
//     With six bodies inlined behind a switch in one kernel a kind, or the
//     body behind a call, ptxas spilled hundreds of bytes in it and the
//     rows ran about twice a K4/K5 launch.
//   * Block 0 runs the optimizer (reg_opt.cuh: each of its threads the same
//     values, so every branch is uniform) and computes the plan's last row,
//     usually the lightest (stage_row: a call from inside the optimizer,
//     whose registers ptxas trims, so it spills; the last row leaves it the
//     time). Which block writes which row does not change a bit.
//   * The hand-over. Block 0 publishes each matrix and its generation in
//     kCopies copies (block b polls copy b % kCopies, napping between
//     reads); K4/K5's matrix and the generation share a copy's first
//     128-byte line, K6's up to 8 matrices take three more lines, written
//     by all of block 0 and fenced before any generation is. Every block
//     counts its row in on a line of its own (polled from one line with the
//     matrix, the release and every other part of an evaluation ran
//     slower). K4's 26 columns, and K6's 2 a matrix, are then summed by
//     blocks 1..26 (1..16), each in sum_columns' order for its column (the
//     bits of one block summing them all), and read by block 0; K5's 2 by
//     block 0. Each evaluation's sums equal a standalone K4/K5/K6 launch on
//     the same matrices, bit for bit; the cost and its gradient follow in
//     float64.
//   * The barriers are counters in global memory with __threadfence, valid
//     under the co-residency the cooperative launch guarantees (no
//     grid.sync). Every wait is bounded (kSpinNs): past the bound a block
//     gives up, the stage ends, and the state's error code says so.
//   * Build: the file is relocatable device code (kernels/build.py), so the
//     optimizer (drive, reg_opt.cuh) and block 0's rows are compiled once,
//     shared by a body's six kernels; whole-program compilation compiles
//     each kernel's call graph again, minutes for twelve kernels.
//   * Block 0's row reads the stage's pointers, geometry and instantiation
//     from c_stage (__constant__), written on the stream before each stage; K9's
//     ladders on one device are ordered one after another (an event), so no
//     stage reads another's copy.
//   * No --use_fast_math: cosf, sinf and sqrt round as IEEE says.
//
// The workspace (per device and stream, kernels/reg_ladder.py): kSyncWords
// doubles of control words (zeroed before each stage), kStateWords of
// LadderState (carried from stage to stage), then the block rows.

#include <mutex>

#include "corr_body.cuh"
#include "reg_opt.cuh"

namespace {

using mil_reg::kBodyK4;
using mil_reg::kBodyK5;
using mil_reg::kBodyK6;
using mil_reg::LadderArgs;
using mil_reg::LadderState;
using mil_reg::Stage;

// The stage's control words, zeroed before each launch, one 128-byte line
// per job: the other blocks poll for a new evaluation all the time they are
// not writing rows, so the matrix they read is published in kCopies copies
// (block b polls copy b % kCopies) and the count they add to has a line of
// its own.
constexpr int kLine = 128;
constexpr int kCopies = 32;   // published by the lanes of block 0's warp 0

// One copy of the newest evaluation: four lines, K4/K5's matrix on the
// first beside the generation.
constexpr int kReleaseLines = 4;
constexpr int kTraceProbes = 8;   // K6's matrices a pass (corr_body.cuh kMaxProbes)

struct __align__(128) Release {
  unsigned gen;       // evaluations published (then once more: stop)
  unsigned stop;      // 1: the stage is done
  unsigned n;         // K6's body: the evaluation's matrices
  unsigned pad;
  float m[96];        // the matrices (K4/K5: the first 12 floats)
};

struct __align__(128) Arrivals {
  unsigned arrived;   // rows written (every block's, block 0's too), over the stage
};

// trace only (%globaltimer ns): the newest evaluation's latest row start
// and last row arrival among the blocks other than 0
struct __align__(128) Stamps {
  unsigned long long t_start;
  unsigned long long t_arrive;
};

// K4's columns: column k is summed by block k + 1 (k < the other blocks),
// which counts itself in `summed`; block 0 sums any column left over.
struct __align__(128) Summed {
  unsigned summed;    // columns the other blocks have summed, over the stage
};

struct __align__(128) Columns {
  double v[26];
};

struct Sync {
  Arrivals a;
  Stamps t;
  Summed s;
  Columns col;        // two lines
  Release r[kCopies];
};

constexpr int kSyncWords = (5 + kReleaseLines * kCopies) * kLine / 8;   // doubles
constexpr int kStateWords = 32;
// a trace record: kind (the body: 0 K5, 1 K4, 2 K6), m(12), sums(26: K6's
// ss, st a matrix), the pass's matrices, K6's matrices 1.. (12 each) from
// kMatsAt, then kStamps %globaltimer stamps (ns, the bits of a 64-bit
// integer in a double's slot): publish, latest row start, last row arrival
// among the other blocks, block 0's own row done, block 0 sees the count,
// column sum done, next publish (or the stage's stop)
constexpr int kMatsAt = 40;
constexpr int kStampAt = kMatsAt + 12 * (kTraceProbes - 1);
constexpr int kStamps = 7;
constexpr int kTraceWords = kStampAt + kStamps;
constexpr unsigned long long kSpinNs = 10ull * 1000ull * 1000ull * 1000ull;
// LadderState::error codes (1: an unknown method or engine, reg_opt.cuh)
constexpr int kErrTimeout = 2;
constexpr int kErrKind = 3;

static_assert(sizeof(Release) == kReleaseLines * kLine, "Release and its lines differ");
static_assert(kTraceProbes == kMaxProbes && 12 * kMaxProbes == 96, "K6's matrices a pass");
static_assert(mil_reg::kProbes <= kMaxProbes, "a probe round outgrew K6's pass");
static_assert(sizeof(Sync) == kSyncWords * sizeof(double), "Sync and its words differ");
static_assert(sizeof(LadderState) <= kStateWords * sizeof(double),
              "LadderState outgrew its words");

// Every instantiation of the bodies, (BODY, VX, IDX) as corr.cu
// instantiates K4, K5 and K6 (BODY: reg_opt.cuh kBodyK4 = 1, kBodyK5 = 0,
// kBodyK6 = 2); each stage picks one from its plan. kernels/reg_ladder.py::
// INSTANTIATIONS mirrors this order (a CPU test parses it).
#define MIL_K9_STAGE_KINDS(X)                                                        \
  X(1, 4, int) X(1, 2, int) X(1, 1, int)                                             \
  X(1, 4, long long) X(1, 2, long long) X(1, 1, long long)                           \
  X(0, 4, int) X(0, 2, int) X(0, 1, int)                                             \
  X(0, 4, long long) X(0, 2, long long) X(0, 1, long long)                           \
  X(2, 4, int) X(2, 2, int) X(2, 1, int)                                             \
  X(2, 4, long long) X(2, 2, long long) X(2, 1, long long)

// What block 0's row reads as constant operands: the stage's pointers, its
// geometry and its instantiation. Written on the stream before each stage
// launch; K9's ladders on one device run one after another (mil_reg_ladder
// orders them with an event), so no stage reads another's copy.
struct StageConsts {
  const float* src;
  const float* tgt;
  double* partials;
  Geo g;
  int vx;
  int wide;
};

__constant__ StageConsts c_stage;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ double stamp(unsigned long long t) {
  return __longlong_as_double(static_cast<long long>(t));
}

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// Wait until *count reaches want (or the bound runs out: false).
__device__ __forceinline__ bool wait_count(const unsigned* count, unsigned want) {
  const unsigned long long t0 = now_ns();
  while (load_volatile(count) < want)
    if (now_ns() - t0 > kSpinNs) return false;
  return true;
}

// A poller's naps between reads of its copy: from kNapMinNs, doubling to
// kNapMaxNs (a release waits at most about that long for it).
constexpr unsigned kNapMinNs = 32;
constexpr unsigned kNapMaxNs = 256;

// Publish generation `gen` in one copy: the matrix m (or, with stop = 1, the
// end of the stage), made visible before the generation.
__device__ __forceinline__ void publish(Release& r, const float* m, unsigned gen,
                                       unsigned stop) {
  volatile float* vm = r.m;
  if (m != nullptr)
    for (int k = 0; k < 12; ++k) vm[k] = m[k];
  if (stop) reinterpret_cast<volatile unsigned*>(&r.stop)[0] = 1u;
  __threadfence();
  atomicExch(&r.gen, gen);
}

// Publish K6's n matrices ms (12 n floats) as generation `gen` in every copy:
// all of block 0 writes the copies' matrices and counts, each thread fences
// its writes, and after the block's barrier warp 0 sets the generations.
// Every thread of block 0 must call it.
__device__ __forceinline__ void publish_probes(Sync* sync, const float* ms, int n,
                                              unsigned gen) {
  const int words = 12 * n;
  for (int i = threadIdx.x; i < kCopies * words; i += kThreads) {
    const int c = i / words, k = i - c * words;
    reinterpret_cast<volatile float*>(sync->r[c].m)[k] = ms[k];
  }
  if (threadIdx.x < kCopies)
    reinterpret_cast<volatile unsigned*>(&sync->r[threadIdx.x].n)[0] = static_cast<unsigned>(n);
  __threadfence();
  __syncthreads();
  if (threadIdx.x < kCopies) atomicExch(&sync->r[threadIdx.x].gen, gen);
}

// Block 0's row on one instantiation of the body: corr_block_with (K4,
// K5) or corr_nprobe_block_with (K6, n matrices) with every operand but
// the matrices (shared) read from c_stage. Block 0 calls it from inside the
// optimizer, so it is a function of its own, compiled once (the other
// blocks run the body inlined in their stage kernel).
template <int BODY, int VX, typename IDX>
__device__ __noinline__ void stage_row(const float* sh_m, int n, unsigned block) {
  if constexpr (BODY == kBodyK6) {
    corr_nprobe_block_with<VX, IDX>(c_stage.src, c_stage.tgt, SharedMats{sh_m}, n, c_stage.g,
                                    block, c_stage.partials + block, gridDim.x);
  } else {
    corr_block_with<BODY == kBodyK4, VX, IDX>(c_stage.src, c_stage.tgt, SharedMat{sh_m},
                                              c_stage.g, block, c_stage.partials + block,
                                              gridDim.x);
  }
}

// Block 0's row on the stage's instantiation (c_stage.vx, c_stage.wide).
template <int BODY>
__device__ __forceinline__ void block_row(const float* sh_m, int n, unsigned block) {
#define MIL_K9_ROW(B, V, I)                                                        \
  if constexpr (B == BODY) {                                                        \
    if (c_stage.vx == V && c_stage.wide == (sizeof(I) == 8 ? 1 : 0)) {              \
      stage_row<B, V, I>(sh_m, n, block);                                           \
      return;                                                                       \
    }                                                                               \
  }
  MIL_K9_STAGE_KINDS(MIL_K9_ROW)
#undef MIL_K9_ROW
}

// Block 0's evaluator: one K4, K5 (operator()) or K6 (probes) evaluation
// across the grid, the kind of the stage kernel's BODY (another kind is an
// error). Called by every thread of block 0 with the same matrices.
template <int BODY>
struct DevEval {
  Sync* sync;
  unsigned nb;        // blocks in the grid
  unsigned gen;       // evaluations published
  int err;
  int count;          // evaluations made
  double* trace;      // test hook: one record an evaluation, or null
  int trace_cap;
  int trace_next;     // the record this evaluation takes
  double* last_rec;   // the previous evaluation's record (thread 0), or null
  unsigned summed;    // columns the other blocks summed over the stage, this evaluation's in

  __host__ __device__ __noinline__ void operator()(const float* m, bool grad, double* out) {
#ifdef __CUDA_ARCH__
    if constexpr (BODY == kBodyK6) {
      if (!err) err = kErrKind;
      for (int k = 0; k < 26; ++k) out[k] = 0.0;
    } else {
      if (grad != (BODY == kBodyK4) && !err) err = kErrKind;
      run(m, 1, out);
    }
#endif
  }

  __host__ __device__ __noinline__ void probes(const float* ms, int n, double* out) {
#ifdef __CUDA_ARCH__
    if constexpr (BODY != kBodyK6) {
      if (!err) err = kErrKind;
      for (int k = 0; k < 2 * n; ++k) out[k] = 0.0;
    } else {
      if ((n < 1 || n > kMaxProbes) && !err) err = kErrKind;
      run(ms, n, out);
    }
#endif
  }

  __device__ __forceinline__ void run(const float* ms, int n, double* out) {
    constexpr int NV = BODY == kBodyK4 ? 26 : BODY == kBodyK6 ? 2 * kMaxProbes : 2;
    constexpr int kMats = BODY == kBodyK6 ? kMaxProbes : 1;
    __shared__ __align__(16) float sh_m[16 * kMats];
    __shared__ double sh_res[NV];
    __shared__ int sh_err;
    if (err) {
      for (int k = 0; k < (BODY == kBodyK6 ? 2 * n : NV); ++k) out[k] = 0.0;
      return;
    }
    const int nv = BODY == kBodyK6 ? 2 * n : NV;
    const unsigned tid = threadIdx.x;
    unsigned long long t_pub = 0, t_row0 = 0, t_seen = 0;
    if (tid == 0) {
      sh_err = 0;
      if (trace != nullptr) {
        t_pub = now_ns();
        if (last_rec != nullptr) last_rec[kStampAt + 6] = stamp(t_pub);
      }
    }
    if constexpr (BODY == kBodyK6) {
      if (tid < static_cast<unsigned>(n)) shared_mat_fill(sh_m + 16 * tid, ms + 12 * tid);
      publish_probes(sync, ms, n, gen + 1);
    } else {
      if (tid == 0) shared_mat_fill(sh_m, ms);
      if (tid < kCopies) {   // warp 0: after the publish stamp
        __syncwarp();
        publish(sync->r[tid], ms, gen + 1, 0u);
      }
    }
    gen += 1;
    __syncthreads();
    block_row<BODY>(sh_m, n, nb - 1);
    // the row visible device-wide before block 0 counts itself in: the
    // column sums in the other blocks read it
    __threadfence();
    __syncthreads();
    // K4/K6: the other blocks sum columns 0 .. owned - 1, block 0 the rest
    const unsigned owned = BODY == kBodyK5 ? 0u
                           : (nb - 1 < static_cast<unsigned>(nv) ? nb - 1
                                                                 : static_cast<unsigned>(nv));
    summed += owned;
    if (tid == 0) {
      if (trace != nullptr) t_row0 = now_ns();
      atomicAdd(&sync->a.arrived, 1u);
      bool ok = wait_count(&sync->a.arrived, nb * gen);
      if (trace != nullptr) t_seen = now_ns();
      ok = ok && wait_count(&sync->s.summed, summed);
      if (!ok) sh_err = kErrTimeout;
      __threadfence();
    }
    __syncthreads();
    if (sh_err) {
      err = sh_err;
      for (int k = 0; k < nv; ++k) out[k] = 0.0;
      return;
    }
    if (owned < static_cast<unsigned>(nv))
      sum_columns<NV>(c_stage.partials + static_cast<size_t>(owned) * nb, static_cast<int>(nb),
                      nv - static_cast<int>(owned), sh_res + owned);
    for (int k = 0; k < nv; ++k)
      out[k] = k < static_cast<int>(owned) ? __ldcg(&sync->col.v[k]) : sh_res[k];
    if constexpr (BODY != kBodyK6)
      for (int k = NV; k < 26; ++k) out[k] = 0.0;
    if (trace != nullptr && tid == 0) {
      const unsigned long long t_sum = now_ns();
      last_rec = nullptr;
      if (trace_next < trace_cap) {
        double* r = trace + static_cast<size_t>(trace_next) * kTraceWords;
        r[0] = static_cast<double>(BODY);
        for (int k = 0; k < 12; ++k) r[1 + k] = ms[k];
        for (int k = 0; k < 26; ++k) r[13 + k] = k < nv ? out[k] : 0.0;
        r[39] = static_cast<double>(n);
        for (int k = 12; k < 12 * n; ++k) r[kMatsAt + k - 12] = ms[k];
        const unsigned long long t_arr = *reinterpret_cast<volatile unsigned long long*>(
            &sync->t.t_arrive);
        r[kStampAt + 0] = stamp(t_pub);
        r[kStampAt + 1] = stamp(*reinterpret_cast<volatile unsigned long long*>(
            &sync->t.t_start));
        r[kStampAt + 2] = stamp(t_arr);
        r[kStampAt + 3] = stamp(t_row0);
        r[kStampAt + 4] = stamp(t_seen);
        r[kStampAt + 5] = stamp(t_sum);
        r[kStampAt + 6] = 0.0;
        last_rec = r;
      }
    }
    trace_next += 1;
    count += 1;
    __syncthreads();   // sh_res and sh_m are reused by the next evaluation
  }
};

// Block 0: run the stage's optimizer (every thread, the same values),
// then publish the state and stop the other blocks. Not inlined: one copy
// of the optimizer a body.
template <int BODY>
__device__ __noinline__ void drive(Sync* sync, LadderState* state, const LadderArgs& args,
                                   const Stage& stage, int first, int last, double* trace,
                                   int trace_cap) {
  LadderState s;
  if (first) {
    mil_reg::ladder_init(args, s);
  } else {
    s = *state;
  }
  DevEval<BODY> ev{sync,    gridDim.x, 0u, 0, 0, trace, trace_cap,
                   s.evals[0] + s.evals[1] + s.evals[2], nullptr, 0u};
  if (!s.error) {
    mil_reg::run_stage_kind<BODY>(args, stage, s, ev);
    s.evals[BODY] += ev.count;   // evals[] in the bodies' order
    if (ev.err) s.error = ev.err;
  }
  if (last) mil_reg::ladder_finish(s);
  if (threadIdx.x == 0) {
    *state = s;
    if (ev.last_rec != nullptr) ev.last_rec[kStampAt + 6] = stamp(now_ns());
  }
  if (threadIdx.x < kCopies) publish(sync->r[threadIdx.x], nullptr, ev.gen + 1, 1u);
}

// One optimizer stage: BODY kBodyK4 = L-BFGS over K4's sums (K4's launch
// bounds), kBodyK5 = Powell (or the line) over K5's, kBodyK6 = Powell with
// the probe line search over K6's (both K5's bounds), on one instantiation
// of the body (VX voxels a thread a step, IDX the offset type). `first`
// starts the ladder (the state from args), `last` ends it (the final
// matrix). Block 0 drives; block b > 0 waits for a generation, writes the
// plan's row b - 1 and counts itself in (K4, K6: blocks 1..26 / 1..2n then
// sum a column each), until block 0 says stop (or a wait runs past the
// bound: block 0's own wait then runs out too and reports it).
template <int BODY, int VX, typename IDX>
__global__ void __launch_bounds__(kThreads, BODY == 1 ? kResidentGrad : kResidentSums)
reg_stage_kernel(Sync* sync, LadderState* state, LadderArgs args, Stage stage, int first,
                 int last, double* trace, int trace_cap, const float* __restrict__ src,
                 const float* __restrict__ tgt, double* __restrict__ partials, Geo g) {
  if (blockIdx.x == 0) {
    drive<BODY>(sync, state, args, stage, first, last, trace, trace_cap);
    return;
  }
  constexpr int kMats = BODY == kBodyK6 ? kMaxProbes : 1;
  __shared__ __align__(16) float sh_m[16 * kMats];
  __shared__ unsigned sh_gen;
  __shared__ int sh_quit;
  __shared__ int sh_rows_in;
  __shared__ int sh_n;
  Release* rel = &sync->r[blockIdx.x % kCopies];
  unsigned seen = 0;
  for (;;) {
    if (threadIdx.x == 0) {
      const unsigned long long t0 = now_ns();
      unsigned gnow;
      int quit = 0;
      unsigned nap = kNapMinNs;
      while ((gnow = load_volatile(&rel->gen)) == seen) {
        if (now_ns() - t0 > kSpinNs) {
          quit = 1;
          break;
        }
        __nanosleep(nap);
        if (nap < kNapMaxNs) nap *= 2;
      }
      __threadfence();
      if (!quit && load_volatile(&rel->stop)) quit = 1;
      if (!quit) {
        if constexpr (BODY == kBodyK6) {
          sh_n = static_cast<int>(load_volatile(&rel->n));
        } else {
          const volatile float* vm = rel->m;
          float m[12];
          for (int k = 0; k < 12; ++k) m[k] = vm[k];
          shared_mat_fill(sh_m, m);
          if (trace != nullptr) atomicMax(&sync->t.t_start, now_ns());
        }
      }
      sh_gen = gnow;
      sh_quit = quit;
    }
    __syncthreads();
    if (sh_quit) return;
    seen = sh_gen;
    int ncols = BODY == kBodyK4 ? 26 : 2;
    if constexpr (BODY == kBodyK6) {
      // the n matrices, read after thread 0's fence: thread t < 16 n fills
      // float t of SharedMats (the 12 entries, then m_00, m_10, m_20, 0)
      const int n = sh_n;
      ncols = 2 * n;
      if (threadIdx.x < 16u * n) {
        const int i = threadIdx.x >> 4, q = threadIdx.x & 15;
        const volatile float* vm = rel->m + 12 * i;
        sh_m[threadIdx.x] = q < 12 ? vm[q] : (q == 15 ? 0.f : vm[4 * (q - 12)]);
      }
      __syncthreads();
      if (trace != nullptr && threadIdx.x == 0) atomicMax(&sync->t.t_start, now_ns());
      corr_nprobe_block_with<VX, IDX>(src, tgt, SharedMats{sh_m}, n, g, blockIdx.x - 1,
                                      partials + (blockIdx.x - 1), gridDim.x);
    } else {
      corr_block_with<BODY == kBodyK4, VX, IDX>(src, tgt, SharedMat{sh_m}, g, blockIdx.x - 1,
                                                partials + (blockIdx.x - 1), gridDim.x);
    }
    // the row visible device-wide before the block counts itself in (as
    // corr_body.cuh::last_block orders K4/K5's rows before their ticket)
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      if (trace != nullptr) {
        atomicMax(&sync->t.t_arrive, now_ns());
        __threadfence();
      }
      atomicAdd(&sync->a.arrived, 1u);
    }
    if constexpr (BODY != kBodyK5) {
      // K4, K6: block k + 1 sums column k once every row is in, in
      // sum_columns' order for that column (so with block 0's bits), and
      // counts itself in
      const unsigned k = blockIdx.x - 1;
      if (k < static_cast<unsigned>(ncols)) {
        if (threadIdx.x == 0) {
          sh_rows_in = wait_count(&sync->a.arrived, gridDim.x * seen);
          __threadfence();
        }
        __syncthreads();
        if (sh_rows_in) {
          sum_columns<1>(partials + static_cast<size_t>(k) * gridDim.x,
                         static_cast<int>(gridDim.x), 1, &sync->col.v[k]);
          if (threadIdx.x == 0) {
            __threadfence();
            atomicAdd(&sync->s.summed, 1u);
          }
        }
      }
    }
  }
}

using StageFn = void (*)(Sync*, LadderState*, LadderArgs, Stage, int, int, double*, int,
                         const float*, const float*, double*, Geo);

struct StageKind {
  int body, vx, wide;
  StageFn fn;
};

#define MIL_K9_KIND(B, V, I) {B, V, sizeof(I) == 8 ? 1 : 0, reg_stage_kernel<B, V, I>},
const StageKind kStageKinds[] = {MIL_K9_STAGE_KINDS(MIL_K9_KIND)};
#undef MIL_K9_KIND
constexpr int kNumKinds = sizeof(kStageKinds) / sizeof(kStageKinds[0]);

// The stage kernel of an instantiation, or null.
StageFn stage_fn(int body, int vx, int wide) {
  for (const StageKind& k : kStageKinds)
    if (k.body == body && k.vx == vx && k.wide == (wide != 0)) return k.fn;
  return nullptr;
}

int sms_of_device() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// K4's rows take 26 columns on K4's plan; K5's 2 and K6's 2 a matrix on K5's.
long long work_words(const Plan& p4, const Plan& p5) {
  const long long r4 = p4.blocks * 26, r5 = p5.blocks * 2 * kMaxProbes;
  return kSyncWords + kStateWords + (r4 > r5 ? r4 : r5);
}

// The ladders on one device run one after another, whatever their streams:
// each waits for the previous one's event, since every stage rewrites
// c_stage.
constexpr int kMaxDevices = 64;
std::mutex g_mu;
cudaEvent_t g_done[kMaxDevices] = {};

// The stages of one ladder on `st` (the caller holds g_mu).
int launch_stages(const float* src, const float* tgt, int sz, int sy, int sx,
                  const LadderArgs& a, const Stage* stages, int n, const Plan* plans, int sms,
                  double* work, double* trace, int trace_cap, cudaStream_t st,
                  int* n_launches) {
  cudaError_t err;
  Sync* sync = reinterpret_cast<Sync*>(work);
  LadderState* state = reinterpret_cast<LadderState*>(work + kSyncWords);
  double* partials = work + kSyncWords + kStateWords;
  for (int i = 0; i < n; ++i) {
    const Plan& p = plans[stages[i].body == kBodyK4 ? 1 : 0];
    const StageFn fn = stage_fn(stages[i].body, p.vx, p.wide);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, reinterpret_cast<const void*>(fn), kThreads, 0)) != cudaSuccess)
      return static_cast<int>(err);
    if (static_cast<long long>(per_sm) * sms < p.blocks)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const StageConsts consts{src, tgt, partials, make_geo(p, sz, sy, sx), p.vx, p.wide};
    if ((err = cudaMemsetAsync(sync, 0, sizeof(Sync), st)) != cudaSuccess ||
        (err = cudaMemcpyToSymbolAsync(c_stage, &consts, sizeof(consts), 0,
                                       cudaMemcpyHostToDevice, st)) != cudaSuccess)
      return static_cast<int>(err);
    Stage stage = stages[i];
    LadderArgs args = a;
    int first = i == 0, last = i == n - 1;
    const float* s_ptr = src;
    const float* t_ptr = tgt;
    Geo g = consts.g;
    void* kargs[] = {&sync,  &state, &args,  &stage,    &first, &last,
                     &trace, &trace_cap, &s_ptr, &t_ptr, &partials, &g};
    if ((err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                           dim3(static_cast<unsigned>(p.blocks)),
                                           dim3(kThreads), kargs, 0, st)) != cudaSuccess)
      return static_cast<int>(err);
    *n_launches += 1;
  }
  return static_cast<int>(cudaGetLastError());
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
// doubles a trace record, the first stamp's word, the stage kernels, the
// word of K6's second matrix in a trace record.
int mil_reg_ladder_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(LadderArgs));
  out[1] = static_cast<int>(sizeof(LadderState));
  out[2] = kTraceWords;
  out[3] = kStampAt;
  out[4] = kNumKinds;
  out[5] = kMatsAt;
  return 0;
}

// The bodies' instantiations in MIL_K9_STAGE_KINDS' order: (body, vx, wide)
// each, into out[3 i .. 3 i + 2], for i < the count mil_reg_ladder_sizes
// gives.
int mil_reg_ladder_kinds(int* out) {
  for (int i = 0; i < kNumKinds; ++i) {
    out[3 * i] = kStageKinds[i].body;
    out[3 * i + 1] = kStageKinds[i].vx;
    out[3 * i + 2] = kStageKinds[i].wide;
  }
  return 0;
}

// What the stage kernel of an instantiation compiled to: body 1 = the
// L-BFGS stage (K4's body), 0 = the Powell stage and the line (K5's), 2 =
// the probe stage (K6's); vx, wide as the plan gives them. out[0]
// registers, out[1] local bytes a thread (the optimizer's frame included),
// out[2] static shared bytes, out[3] resident blocks per SM. Returns a
// cudaError_t.
int mil_reg_ladder_attrs(int body, int vx, int wide, int* out) {
  const StageFn fn = stage_fn(body, vx, wide);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err;
  if ((err = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(fn))) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks, reinterpret_cast<const void*>(fn), kThreads, 0)) != cudaSuccess)
    return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

// The ladder (or the line) of *args on `stream`: one cooperative launch per
// stage, no sync. `work` holds `work_len` doubles on the device (mil_reg_ladder_work);
// the result is the LadderState at work + kSyncWords, once the stream gets
// there. `trace` (or null) takes up to trace_cap records of kTraceWords
// doubles: kind (the body), the matrices, the sums, the stamps. n_launches
// receives the stages launched. Returns a cudaError_t:
// cudaErrorCooperativeLaunchTooLarge where the plan's blocks would not be
// co-resident.
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
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan plans[2] = {make_plan(sz, sy, sx, false, sms), make_plan(sz, sy, sx, true, sms)};
  if (work_len < work_words(plans[1], plans[0])) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 2; ++i)
    if (plans[i].blocks > kMaxBlocks || plans[i].steps > 2147483647LL)
      return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_done[dev] == nullptr &&
      (err = cudaEventCreateWithFlags(&g_done[dev], cudaEventDisableTiming)) != cudaSuccess) {
    g_done[dev] = nullptr;
    return static_cast<int>(err);
  }
  if ((err = cudaStreamWaitEvent(st, g_done[dev], 0)) != cudaSuccess)
    return static_cast<int>(err);
  const int rc = launch_stages(src, tgt, sz, sy, sx, *args, stages, n, plans, sms, work, trace,
                               trace_cap, st, n_launches);
  if ((err = cudaEventRecord(g_done[dev], st)) != cudaSuccess && rc == 0)
    return static_cast<int>(err);
  return rc;
}

}  // extern "C"
