// K2: one whole Richardson-Lucy iteration in one launch, for Hopper (sm_90a):
//   out = max(est * bp(img / fwd(est)), smallvalue)
// with fwd and bp two separable compact-PSF circular convolutions planned
// as for K1 (ops/conv_sep.py::SepPlan, no per-tap rolls).
//
// Replaces the JAX package's Pallas TPU kernel
// microimagelib_tpu/ops/conv_sep.py::_rl_kernel (launched by
// _rl_iter_fused). That kernel walks a sequential grid of g + 4 slabs,
// runs the xy convolution as each slab arrives and keeps a three-slab
// tail/prev/cur ring per stage in VMEM, so the ratio never leaves the
// chip. Nothing of that carries over: CUDA blocks run in no order, and the
// back projector needs the ratio on a z and xy halo that other blocks own.
//
// What bounds it on this card: memory traffic and, for long z supports,
// cached loads. The least traffic is est and img read once and out written
// once (3 volume passes; K1 as a ratio/update pair moves ~6 plus its rank
// volumes). The stencils do ~2 x taps fp32 FMAs per voxel and stage, far
// below the 67 TFLOP/s fp32 rate.
//
// What this design does about it, in its first, simple form:
//   * one cooperative launch (cudaLaunchCooperativeKernel) of persistent
//     blocks, as many as the occupancy calculator lets reside at once;
//     stage 1 writes ratio = img / fwd(est) to a scratch volume the wrapper
//     allocates, grid.sync(), stage 2 writes max(est * bp(ratio), smallvalue).
//     The ratio makes one round trip through device memory; K1's rank
//     volumes make none, because each stage fuses the z pass into the xy
//     tile:
//   * a task is one (16 x 64) xy tile of up to Q = 8 consecutive z planes.
//     Per rank, the block first runs the z convolution of the tile plus its
//     y/x halo for the Q planes into shared memory: each thread walks one
//     halo column through the Q + nsteps - 1 planes the Q outputs need and
//     feeds every loaded value to each output it reaches, so a column is
//     loaded (Q + nsteps - 1) / Q times per output plane instead of nsteps
//     times. Loads go out four planes at a time, and the z taps sit in
//     shared memory between zero pads, so the (plane, output) FMAs need no
//     range test (an earlier form with per-FMA range tests was bound by its
//     ~3x more instructions); only a column whose outputs come out inf or
//     NaN is summed again with the tests, so that 0 * inf cannot reach an
//     output the value's taps do not. Then, per plane, the y stencil into a
//     staging row block and the x stencil into registers, summing the ranks
//     there. Q shrinks when the halo is wide, so a block stays within
//     ~110 KB of shared memory (two blocks per SM) or, for the widest taps,
//     within 227 KB (one).
//   * rounding: every z tap, y tap and x tap is an fmaf in K1's order
//     (csrc/conv_sep.cu), the ranks add in K1's order and the epilogues are
//     K1's, so K2 gives the bits of a K1 ratio launch followed by a K1
//     update launch. No atomics: two launches give identical bits.
//   * the ratio written in stage 1 is read in stage 2 through L2 only
//     (__ldcg): the non-coherent L1 path is kept for data no block writes.
// Keeping only a ring of ratio slabs in L2 (one sync per slab group), TMA
// loads and register-blocked stencils are later work.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing: the wrapper (kernels/rl_fused.py) allocates out and
// the ratio scratch. If the cooperative grid cannot be resident, the launch
// reports an error; there is no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRank = 4;
constexpr int kMaxZTaps = 128;
constexpr int kMaxXYTaps = 128;
constexpr int kTX = 64;                      // tile width (= threads along x)
constexpr int kTY = 16;                      // tile height
constexpr int kThreadsY = 4;
constexpr int kThreads = kTX * kThreadsY;    // 256
constexpr int kRowsPerThread = kTY / kThreadsY;
constexpr int kMaxQ = 8;                     // z planes per task
constexpr int kLoadBatch = 4;                // z-pass loads in flight together
// zero taps around each rank's z taps, so that every (plane, output) pair
// of a load batch reads a tap without a range test
constexpr int kPadLo = kMaxQ - 1;
constexpr int kPadHi = kMaxQ + kLoadBatch - 2;
constexpr size_t kTwoPerSmBytes = 110 * 1024;
constexpr size_t kMaxSmemBytes = 227 * 1024;

struct Stage {
  const float* tz;   // (rank, nsteps)
  const float* ty;   // (rank, ly)
  const float* tx;   // (rank, lx)
  int rank, a, nsteps, ly, oy, lx, ox;
  int q;             // z planes per task
};

struct Params {
  const float* est;
  const float* img;
  float* out;
  float* ratio;
  Stage st[2];       // fwd, bp
  int nz, ny, nx;
  float smallvalue;
};

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The z convolution of one halo column for the up to kMaxQ outputs of a
// task: zacc[qq] = sum over t of tzr[t] * col[plane zstart + qq + t]. The
// kLoadBatch planes of a batch are loaded before any of them is used, so
// that many loads are in flight per thread; the FMAs then run in plane
// order, which keeps every output's taps in K1's order. Plane pl feeds
// output qq with tap pl - qq. Untested (TESTED false), a tap out of range
// reads a zero pad, and fmaf(0, v, acc) leaves acc as it is for a finite v;
// TESTED skips those FMAs, for columns that hold an inf or NaN.
template <int STAGE, bool TESTED>
__device__ __forceinline__ void z_column(const float* col, int zstart, int nplanes, int nz,
                                         size_t plane, const float* tzr, int nsteps,
                                         float (&zacc)[kMaxQ]) {
#pragma unroll
  for (int qq = 0; qq < kMaxQ; ++qq) zacc[qq] = 0.f;
  int zi = zstart;
  for (int pl0 = 0; pl0 < nplanes; pl0 += kLoadBatch) {
    float val[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      val[u] = 0.f;
      if (pl0 + u < nplanes) {
        const float* src = col + (size_t)zi * plane;
        val[u] = STAGE == 0 ? __ldg(src) : __ldcg(src);
        zi = (zi + 1 == nz) ? 0 : zi + 1;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
#pragma unroll
      for (int qq = 0; qq < kMaxQ; ++qq) {
        const int t = pl0 + u - qq;
        if (!TESTED || (t >= 0 && t < nsteps)) zacc[qq] = fmaf(tzr[t], val[u], zacc[qq]);
      }
    }
  }
}

// The tested z_column, out of line (it runs only for non-finite columns,
// and must not cost the common path registers), writing output qq < qn to
// dst[qq * stride].
template <int STAGE>
__device__ __noinline__ void z_column_tested(const float* col, int zstart, int nplanes,
                                             int nz, size_t plane, const float* tzr,
                                             int nsteps, int qn, float* dst, int stride) {
  float zacc[kMaxQ];
  z_column<STAGE, true>(col, zstart, nplanes, nz, plane, tzr, nsteps, zacc);
#pragma unroll
  for (int qq = 0; qq < kMaxQ; ++qq)
    if (qq < qn) dst[qq * stride] = zacc[qq];
}

// STAGE 0: ratio = img / fwd(est). STAGE 1: out = max(est * bp(ratio), sv).
template <int STAGE>
__device__ void run_stage(const Params& p, float* smem) {
  const Stage& s = p.st[STAGE];
  const float* in = STAGE == 0 ? p.est : p.ratio;
  const float* aux = STAGE == 0 ? p.img : p.est;
  float* dst = STAGE == 0 ? p.ratio : p.out;
  const int nz = p.nz, ny = p.ny, nx = p.nx;
  const int rank = s.rank, nsteps = s.nsteps, ly = s.ly, lx = s.lx, q = s.q;
  const int hy = kTY + ly - 1, hx = kTX + lx - 1, halo = hy * hx;

  float* s_zs = smem;                          // q x hy x hx: z-convolved halo
  float* s_mid = s_zs + q * halo;              // kTY x hx: after the y stencil
  const int tzrow = kPadLo + nsteps + kPadHi;
  float* s_tz = s_mid + kTY * hx;              // rank x tzrow: padded z taps
  float* s_ty = s_tz + rank * tzrow;
  float* s_tx = s_ty + rank * ly;
  int* s_row = reinterpret_cast<int*>(s_tx + rank * lx);   // hy source rows
  int* s_col = s_row + hy;                                  // hx source columns

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  __syncthreads();   // the previous stage is done with shared memory
  for (int i = tid; i < rank * tzrow; i += kThreads) {
    const int r = i / tzrow, t = i - r * tzrow - kPadLo;
    s_tz[i] = (t >= 0 && t < nsteps) ? s.tz[r * nsteps + t] : 0.f;
  }
  for (int i = tid; i < rank * ly; i += kThreads) s_ty[i] = s.ty[i];
  for (int i = tid; i < rank * lx; i += kThreads) s_tx[i] = s.tx[i];

  const size_t plane = (size_t)ny * nx;
  const int ntx = (nx + kTX - 1) / kTX, nty = (ny + kTY - 1) / kTY;
  const long long ntasks = (long long)ntx * nty * ((nz + q - 1) / q);

  for (long long task = blockIdx.x; task < ntasks; task += gridDim.x) {
    const int bx = (int)(task % ntx);
    const int by = (int)((task / ntx) % nty);
    const int z0 = (int)(task / ((long long)ntx * nty)) * q;
    const int qn = min(q, nz - z0);
    const int x0 = bx * kTX, y0 = by * kTY;
    __syncthreads();   // the previous task is done with the tiles and indices
    // halo (0, 0) is the source of output (y0, x0) under the largest offset
    for (int i = tid; i < hy; i += kThreads) s_row[i] = wrap(y0 - (s.oy + ly - 1) + i, ny);
    for (int i = tid; i < hx; i += kThreads) s_col[i] = wrap(x0 - (s.ox + lx - 1) + i, nx);

    float acc[kMaxQ][kRowsPerThread];
#pragma unroll
    for (int qq = 0; qq < kMaxQ; ++qq)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[qq][j] = 0.f;

    for (int r = 0; r < rank; ++r) {
      __syncthreads();   // indices staged; the previous rank is done with s_zs
      const float* tzr = s_tz + r * tzrow + kPadLo;   // tzr[t], t in [-kPadLo, nsteps + kPadHi)
      // z convolution of the halo, output planes z0 .. z0 + qn - 1: plane
      // z0 - a + pl feeds output qq with tap pl - qq, in K1's tap order
      const int zstart = wrap(z0 - s.a, nz);
      const int nplanes = qn + nsteps - 1;
      for (int e = tid; e < halo; e += kThreads) {
        const int iy = e / hx, ix = e - iy * hx;
        const float* col = in + (size_t)s_row[iy] * nx + s_col[ix];
        float zacc[kMaxQ];
        z_column<STAGE, false>(col, zstart, nplanes, nz, plane, tzr, nsteps, zacc);
        // the untested FMAs turn 0 * inf into NaN in outputs the inf does
        // not reach (a ratio over fwd(est) <= 0 holds such planes): a
        // column with a non-finite output is summed again with range tests
        bool finite = true;
#pragma unroll
        for (int qq = 0; qq < kMaxQ; ++qq)
          finite = finite && (qq >= qn || isfinite(zacc[qq]));
        if (finite) {
#pragma unroll
          for (int qq = 0; qq < kMaxQ; ++qq)
            if (qq < qn) s_zs[qq * halo + e] = zacc[qq];
        } else {
          z_column_tested<STAGE>(col, zstart, nplanes, nz, plane, tzr, nsteps, qn,
                                 s_zs + e, halo);
        }
      }
      const float* kyr = s_ty + r * ly;
      const float* kxr = s_tx + r * lx;
#pragma unroll
      for (int qq = 0; qq < kMaxQ; ++qq) {
        if (qq < qn) {
          __syncthreads();   // s_zs written; the previous plane is done with s_mid
          const float* zt = s_zs + qq * halo;
          for (int t = ty; t < kTY; t += kThreadsY) {
            for (int c = tx; c < hx; c += kTX) {
              float sacc = 0.f;
              for (int k = 0; k < ly; ++k)
                sacc = fmaf(kyr[k], zt[(t + ly - 1 - k) * hx + c], sacc);
              s_mid[t * hx + c] = sacc;
            }
          }
          __syncthreads();
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) {
            const float* row = s_mid + (ty + j * kThreadsY) * hx + tx + lx - 1;
            float sacc = 0.f;
            for (int k = 0; k < lx; ++k) sacc = fmaf(kxr[k], row[-k], sacc);
            acc[qq][j] += sacc;
          }
        }
      }
    }

    const int x = x0 + tx;
#pragma unroll
    for (int qq = 0; qq < kMaxQ; ++qq) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int y = y0 + ty + j * kThreadsY;
        if (qq >= qn || y >= ny || x >= nx) continue;
        const size_t o = (size_t)(z0 + qq) * plane + (size_t)y * nx + x;
        const float val = acc[qq][j];
        if (STAGE == 0)
          dst[o] = __ldg(aux + o) / val;
        else
          dst[o] = fmaxf(__ldg(aux + o) * val, p.smallvalue);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) rl_fused_kernel(Params p) {
  extern __shared__ float smem[];
  run_stage<0>(p, smem);
  cg::this_grid().sync();   // every ratio voxel is written (and visible)
  run_stage<1>(p, smem);
}

size_t stage_smem_bytes(const Stage& s, int q) {
  const size_t hy = kTY + s.ly - 1, hx = kTX + s.lx - 1;
  return ((size_t)q * hy * hx + kTY * hx +
          (size_t)s.rank * (kPadLo + s.nsteps + kPadHi + s.ly + s.lx)) *
             sizeof(float) +
         (hy + hx) * sizeof(int);
}

// The most z planes per task (<= kMaxQ, <= nz) that keep two blocks per
// SM; 1 when even one plane needs more.
int pick_q(const Stage& s, int nz) {
  for (int q = kMaxQ < nz ? kMaxQ : nz; q > 1; --q)
    if (stage_smem_bytes(s, q) <= kTwoPerSmBytes) return q;
  return 1;
}

bool stage_ok(const Stage& s) {
  return s.rank >= 1 && s.rank <= kMaxRank && s.nsteps >= 1 && s.nsteps <= kMaxZTaps &&
         s.a >= 0 && s.a < s.nsteps && s.ly >= 1 && s.ly <= kMaxXYTaps && s.lx >= 1 &&
         s.lx <= kMaxXYTaps;
}

}  // namespace

extern "C" {

// One K2 launch on `stream`: out = max(est * bp(img / fwd(est)), smallvalue).
// `ratio` is scratch of nz * ny * nx floats. Stage 1 is the forward plan
// (tz1, ty1, tx1, ...), stage 2 the back projector's. `info`, when not NULL,
// receives {grid blocks, blocks per SM, z planes per task of stage 1 and 2,
// shared-memory bytes per block}. Returns the cudaError_t of the launch, 0
// on success.
int mil_rl_iter_fused(const float* est, const float* img, float* out, float* ratio,
                      const float* tz1, const float* ty1, const float* tx1, int rank1,
                      int a1, int nsteps1, int ly1, int oy1, int lx1, int ox1,
                      const float* tz2, const float* ty2, const float* tx2, int rank2,
                      int a2, int nsteps2, int ly2, int oy2, int lx2, int ox2,
                      int nz, int ny, int nx, float smallvalue, int* info,
                      void* stream) {
  Params p;
  p.est = est;
  p.img = img;
  p.out = out;
  p.ratio = ratio;
  p.st[0] = Stage{tz1, ty1, tx1, rank1, a1, nsteps1, ly1, oy1, lx1, ox1, 1};
  p.st[1] = Stage{tz2, ty2, tx2, rank2, a2, nsteps2, ly2, oy2, lx2, ox2, 1};
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  p.smallvalue = smallvalue;
  if (nz < 1 || ny < 1 || nx < 1 || !stage_ok(p.st[0]) || !stage_ok(p.st[1]) ||
      p.st[0].nsteps > nz || p.st[1].nsteps > nz)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  long long tasks = 0;
  for (int k = 0; k < 2; ++k) {
    Stage& s = p.st[k];
    s.q = pick_q(s, nz);
    const size_t b = stage_smem_bytes(s, s.q);
    smem = b > smem ? b : smem;
    const long long t = (long long)((nx + kTX - 1) / kTX) * ((ny + kTY - 1) / kTY) *
                        ((nz + s.q - 1) / s.q);
    tasks = t > tasks ? t : tasks;
  }
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = cudaFuncSetAttribute(
      rl_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rl_fused_kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long resident = (long long)per_sm * sms;
  const int grid = static_cast<int>(tasks < resident ? tasks : resident);
  if (info) {
    info[0] = grid;
    info[1] = per_sm;
    info[2] = p.st[0].q;
    info[3] = p.st[1].q;
    info[4] = static_cast<int>(smem);
  }
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rl_fused_kernel), dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
