// The per-block bodies of K4, K5 and K6 (the fused affine resample + NCC
// sums, csrc/corr.cu) and what they need: the launch plan (make_plan,
// mirrored in kernels/corr.py::launch_plan), the task walk, the gather, the
// block's fixed-order float64 reduction and the last block's column sum.
// Included by corr.cu (K4, K5, K6) and reg_ladder.cu (K9), so every K9
// evaluation computes a K4/K5/K6 launch's block rows and column sums bit
// for bit. The design notes are corr.cu's and reg_ladder.cu's.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// resident blocks per SM the launch bounds promise: K5 and K6 at most 80
// registers a thread, K4 at most 128
constexpr int kResidentSums = 6;
constexpr int kResidentGrad = 4;
constexpr int kMinBlocksPerSm = 2;  // the fill the plan aims for
constexpr long long kMaxBlocks = 2147483647;
constexpr int kMaxProbes = 8;       // matrices per K6 pass (the line search's 8)

struct Mat {
  float m[12];
};

// A launch's geometry: the grid, the plan's tasks and steps, and the row
// advance of kWarps tasks, (dseg, dy, dz) = kWarps in (segment, y, z)
// digits of the task index.
struct Geo {
  int sz, sy, sx;
  long long plane;      // sy * sx
  int wsegs;            // warp tasks per row: ceil(sx / (32 VX))
  int steps;            // tasks per warp
  long long tasks;      // rows x wsegs
  int dseg, dy, dz;
};

struct Plan {
  int vx, wsegs, wide;
  long long tasks, steps, blocks;
};

// The launch plan; kernels/corr.py::launch_plan mirrors it.
Plan make_plan(int sz, int sy, int sx, bool grad, int sms) {
  Plan p;
  const long long rows = static_cast<long long>(sz) * sy;
  const long long want = static_cast<long long>(kMinBlocksPerSm) * sms;
  const int vxs[3] = {4, 2, 1};
  for (const int vx : vxs) {
    const int span = 32 * vx;
    p.vx = vx;
    p.wsegs = (sx + span - 1) / span;
    p.tasks = rows * p.wsegs;
    const long long pad = static_cast<long long>(p.wsegs) * span - sx;
    if ((p.tasks + kWarps - 1) / kWarps >= want && 8 * pad <= sx) break;
  }
  const long long wave = static_cast<long long>(grad ? kResidentGrad : kResidentSums) * sms;
  p.steps = (p.tasks + kWarps * wave - 1) / (kWarps * wave);
  p.blocks = (p.tasks + kWarps * p.steps - 1) / (kWarps * p.steps);
  p.wide = rows * sx > 2147483647LL;
  return p;
}

Geo make_geo(const Plan& p, int sz, int sy, int sx) {
  Geo g;
  g.sz = sz;
  g.sy = sy;
  g.sx = sx;
  g.plane = static_cast<long long>(sy) * sx;
  g.wsegs = p.wsegs;
  g.steps = static_cast<int>(p.steps);
  g.tasks = p.tasks;
  g.dseg = kWarps % p.wsegs;
  const int drow = kWarps / p.wsegs;
  g.dy = drow % sy;
  g.dz = drow / sy;
  return g;
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  // a + (b - a) * f, each operation rounded on its own
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

// Reduce NV per-thread values over the block in float64: a shuffle tree
// in each warp, then the warps in order; thread k < ncols writes value k
// to dst[k * stride]. Every thread must call it.
template <int NV>
__device__ __forceinline__ void block_sum(const double (&v)[NV], int ncols, double* dst,
                                          size_t stride) {
  __shared__ double sh[NV][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    double s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) sh[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < ncols) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sh[threadIdx.x][w];
    dst[threadIdx.x * stride] = s;
  }
  __syncthreads();
}

// The last block's sum of the ncols columns of `partials` (column-major,
// nb rows each) into out[0..ncols): thread t sums rows t, t + kThreads, ...
// of each column in order, then block_sum. The order depends on nb alone.
template <int NV>
__device__ void sum_columns(const double* partials, int nb, int ncols, double* out) {
  double s[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) s[k] = 0.0;
  for (int b = threadIdx.x; b < nb; b += kThreads) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (k < ncols) s[k] += __ldcg(partials + static_cast<size_t>(k) * nb + b);
  }
  block_sum<NV>(s, ncols, out, 1);
}

// After the block's partials are written: true in the last block to take a
// ticket. The writes are made visible device-wide before the ticket.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// This warp's first task in block `block` as (z, y, seg), and how many of its `steps`
// tasks exist (the grid's last warps may have fewer); warp-uniform.
__device__ __forceinline__ int first_task(const Geo& g, long long block, int& z, int& y,
                                          int& seg) {
  const long long task = (block * g.steps) * kWarps + (threadIdx.x >> 5);
  const long long row = task / g.wsegs;
  seg = static_cast<int>(task - row * g.wsegs);
  z = static_cast<int>(row / g.sy);
  y = static_cast<int>(row - static_cast<long long>(z) * g.sy);
  const long long left = task < g.tasks ? (g.tasks - task + kWarps - 1) / kWarps : 0;
  return static_cast<int>(left < g.steps ? left : g.steps);
}

// Advance (z, y, seg) by kWarps tasks without dividing.
__device__ __forceinline__ void next_task(const Geo& g, int& z, int& y, int& seg) {
  seg += g.dseg;
  int carry = 0;
  if (seg >= g.wsegs) {
    seg -= g.wsegs;
    carry = 1;
  }
  y += g.dy + carry;
  z += g.dz;
  if (y >= g.sy) {
    y -= g.sy;
    ++z;
  }
}

// The row's part of c_a: (m_a1*y + m_a2*z) + m_a3.
__device__ __forceinline__ void row_coords(const float* m, float yf, float zf, float (&kr)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    kr[a] = __fadd_rn(__fadd_rn(__fmul_rn(m[4 * a + 1], yf), __fmul_rn(m[4 * a + 2], zf)),
                      m[4 * a + 3]);
}

// One voxel's coordinates and box test; where valid, its fractions and its
// 8 corners (issued, not yet used): v[dz*4 + dy*2 + dx]. Where all 8
// corners lie inside the grid (0 <= c < n - 1 on every axis: every voxel
// but the outermost shell of the source) they sit at fixed offsets from
// the first, one pointer and immediate offsets; elsewhere each corner is
// clamped on its own. Both read the same texels. The matrix's x column
// (m_00, m_10, m_20) comes as three values; gather below takes the matrix.
template <typename IDX>
__device__ __forceinline__ bool gather_x(const float* __restrict__ src, float mx, float my,
                                         float mz, const float (&kr)[3], float xf,
                                         const Geo& g, float (&v)[8], float (&fr)[3]) {
  const float cx = __fadd_rn(__fmul_rn(mx, xf), kr[0]);
  const float cy = __fadd_rn(__fmul_rn(my, xf), kr[1]);
  const float cz = __fadd_rn(__fmul_rn(mz, xf), kr[2]);
  const float x0 = floorf(cx), y0 = floorf(cy), z0 = floorf(cz);
  const int xr = static_cast<int>(x0), yr = static_cast<int>(y0), zr = static_cast<int>(z0);
  const IDX sx = g.sx, plane = static_cast<IDX>(g.plane);
  if (cx >= 0.f && cy >= 0.f && cz >= 0.f && cx < g.sx - 1 && cy < g.sy - 1 &&
      cz < g.sz - 1) {
    const float* p = src + ((static_cast<IDX>(zr) * g.sy + yr) * sx + xr);
    v[0] = __ldg(p);
    v[1] = __ldg(p + 1);
    v[2] = __ldg(p + sx);
    v[3] = __ldg(p + sx + 1);
    v[4] = __ldg(p + plane);
    v[5] = __ldg(p + plane + 1);
    v[6] = __ldg(p + plane + sx);
    v[7] = __ldg(p + plane + sx + 1);
  } else {
    if (!(cx > -0.5f && cy > -0.5f && cz > -0.5f && cx < g.sx - 0.5f && cy < g.sy - 0.5f &&
          cz < g.sz - 0.5f))
      return false;   // s = 0: adds nothing to any sum
    // inside the box each floor lies in [-1, n-1]; clamp each corner
    const int x0i = max(xr, 0), x1i = min(xr + 1, g.sx - 1);
    const int y0i = max(yr, 0), y1i = min(yr + 1, g.sy - 1);
    const int z0i = max(zr, 0), z1i = min(zr + 1, g.sz - 1);
    const IDX zb0 = static_cast<IDX>(z0i) * plane, zb1 = static_cast<IDX>(z1i) * plane;
    const IDX yb0 = static_cast<IDX>(y0i) * sx, yb1 = static_cast<IDX>(y1i) * sx;
    const float* r00 = src + (zb0 + yb0);
    const float* r01 = src + (zb0 + yb1);
    const float* r10 = src + (zb1 + yb0);
    const float* r11 = src + (zb1 + yb1);
    v[0] = __ldg(r00 + x0i);
    v[1] = __ldg(r00 + x1i);
    v[2] = __ldg(r01 + x0i);
    v[3] = __ldg(r01 + x1i);
    v[4] = __ldg(r10 + x0i);
    v[5] = __ldg(r10 + x1i);
    v[6] = __ldg(r11 + x0i);
    v[7] = __ldg(r11 + x1i);
  }
  fr[0] = __fsub_rn(cx, x0);
  fr[1] = __fsub_rn(cy, y0);
  fr[2] = __fsub_rn(cz, z0);
  return true;
}

template <typename IDX>
__device__ __forceinline__ bool gather(const float* __restrict__ src, const float* m,
                                       const float (&kr)[3], float xf, const Geo& g,
                                       float (&v)[8], float (&fr)[3]) {
  return gather_x<IDX>(src, m[0], m[4], m[8], kr, xf, g, v, fr);
}

// K9's matrix for corr_block_with: its shared copy of the newest
// evaluation's matrix, 16 floats (the 12 entries, then m_00, m_10, m_20, 0):
// row() reads the 12 entries a step, xcol() the x column a voxel (K4 and K5
// read theirs as constant-bank operands of a kernel parameter). Plain loads:
// volatile ones, which the compiler may not move, made the body slower.
struct SharedMat {
  const float* m;
  __device__ __forceinline__ void row(float (&out)[12]) const {
#pragma unroll
    for (int k = 0; k < 12; ++k) out[k] = m[k];
  }
  __device__ __forceinline__ void xcol(float& a, float& b, float& c) const {
    a = m[12];
    b = m[13];
    c = m[14];
  }
};

// Fill a SharedMat's 16 floats from the 12 entries.
__device__ __forceinline__ void shared_mat_fill(float* dst, const float* m) {
#pragma unroll
  for (int k = 0; k < 12; ++k) dst[k] = m[k];
  dst[12] = m[0];
  dst[13] = m[4];
  dst[14] = m[8];
  dst[15] = 0.f;
}

// One block's share of K5 (GRAD = false: ss, st) or K4 (GRAD = true: and
// the 24 gradient sums) for the matrix `mat`: the block's tasks of the plan
// (block index `block`), per-thread fp32 partials, then the block's
// float64 row, value k to partials[k * stride]. VX voxels a thread a step;
// IDX the voxel offset type (int below 2^31 voxels). MAT is `const float*`
// (K4/K5, corr.cu: a kernel parameter) or SharedMat (K9, reg_ladder.cu);
// the arithmetic is the same, so a K9 evaluation's row equals a K4/K5
// launch's. Every thread of the block must call it.
template <bool GRAD, int VX, typename IDX, class MAT>
__device__ __forceinline__ void corr_block_with(const float* __restrict__ src,
                                                const float* __restrict__ tgt, MAT mat,
                                                const Geo& g, long long block,
                                                double* __restrict__ partials,
                                                size_t stride) {
  constexpr int NV = GRAD ? 26 : 2;
  constexpr bool kShared = !std::is_same<MAT, const float*>::value;
  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;

  const int lane = threadIdx.x & 31;
  int z, y, seg;
  const int nsteps = first_task(g, block, z, y, seg);

  for (int k = 0; k < nsteps; ++k) {
    const float yf = static_cast<float>(y), zf = static_cast<float>(z);
    float kr[3];
    if constexpr (kShared) {
      float m[12];
      mat.row(m);
      row_coords(m, yf, zf, kr);
    } else {
      row_coords(mat, yf, zf, kr);
    }
    const int xb = seg * (32 * VX) + lane;
    // the target of voxel j is tp[32 j] (the row's offset, then the lane's:
    // no offset past the grid in IDX)
    const float* tp = tgt + (static_cast<IDX>(z) * g.sy + y) * static_cast<IDX>(g.sx) + xb;

    // issue every voxel's loads before the first lerp
    float v[VX][8], fr[VX][3], t[VX];
    bool ok[VX];
#pragma unroll
    for (int j = 0; j < VX; ++j) {
      const int x = xb + 32 * j;
      if constexpr (kShared) {
        ok[j] = false;
        if (x < g.sx) {
          float mx, my, mz;
          mat.xcol(mx, my, mz);
          ok[j] = gather_x<IDX>(src, mx, my, mz, kr, static_cast<float>(x), g, v[j], fr[j]);
        }
      } else {
        ok[j] = x < g.sx && gather<IDX>(src, mat, kr, static_cast<float>(x), g, v[j], fr[j]);
      }
      if (ok[j]) t[j] = __ldg(tp + 32 * j);
    }

    // K4's sums within the step: a1 = sum u*x, a0 = sum u, u = s*ds_a (or t*ds_a)
    float a1s[3] = {0.f, 0.f, 0.f}, a0s[3] = {0.f, 0.f, 0.f};
    float a1t[3] = {0.f, 0.f, 0.f}, a0t[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < VX; ++j) {
      if (!ok[j]) continue;
      const float(&c)[8] = v[j];
      const float fx = fr[j][0], fy = fr[j][1], fz = fr[j][2];
      const float c00 = lerp(c[0], c[1], fx), c01 = lerp(c[2], c[3], fx);
      const float c10 = lerp(c[4], c[5], fx), c11 = lerp(c[6], c[7], fx);
      const float c0 = lerp(c00, c01, fy), c1 = lerp(c10, c11, fy);
      const float s = lerp(c0, c1, fz);
      acc[0] = __fmaf_rn(s, s, acc[0]);
      acc[1] = __fmaf_rn(s, t[j], acc[1]);
      if constexpr (GRAD) {
        // ds/dc_a: the lerp of the differences along a
        const float dx0 = lerp(__fsub_rn(c[1], c[0]), __fsub_rn(c[3], c[2]), fy);
        const float dx1 = lerp(__fsub_rn(c[5], c[4]), __fsub_rn(c[7], c[6]), fy);
        const float ds[3] = {lerp(dx0, dx1, fz),
                             lerp(__fsub_rn(c01, c00), __fsub_rn(c11, c10), fz),
                             __fsub_rn(c1, c0)};
        const float xf = static_cast<float>(xb + 32 * j);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float us = __fmul_rn(s, ds[a]), ut = __fmul_rn(t[j], ds[a]);
          a1s[a] = __fmaf_rn(us, xf, a1s[a]);
          a0s[a] = __fadd_rn(a0s[a], us);
          a1t[a] = __fmaf_rn(ut, xf, a1t[a]);
          a0t[a] = __fadd_rn(a0t[a], ut);
        }
      }
    }
    if constexpr (GRAD) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[2 + 4 * a + 0] = __fadd_rn(acc[2 + 4 * a + 0], a1s[a]);
        acc[2 + 4 * a + 1] = __fmaf_rn(yf, a0s[a], acc[2 + 4 * a + 1]);
        acc[2 + 4 * a + 2] = __fmaf_rn(zf, a0s[a], acc[2 + 4 * a + 2]);
        acc[2 + 4 * a + 3] = __fadd_rn(acc[2 + 4 * a + 3], a0s[a]);
        acc[14 + 4 * a + 0] = __fadd_rn(acc[14 + 4 * a + 0], a1t[a]);
        acc[14 + 4 * a + 1] = __fmaf_rn(yf, a0t[a], acc[14 + 4 * a + 1]);
        acc[14 + 4 * a + 2] = __fmaf_rn(zf, a0t[a], acc[14 + 4 * a + 2]);
        acc[14 + 4 * a + 3] = __fadd_rn(acc[14 + 4 * a + 3], a0t[a]);
      }
    }
    next_task(g, z, y, seg);
  }

  double d[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) d[k] = static_cast<double>(acc[k]);
  block_sum<NV>(d, NV, partials, stride);
}

// K9's matrices for corr_nprobe_block_with: up to kMaxProbes matrices of
// SharedMat's 16 floats in shared memory.
struct SharedMats {
  const float* m;
  __device__ __forceinline__ SharedMat at(int i) const { return SharedMat{m + 16 * i}; }
};

// One matrix's step of K6's body: K5's ss and st of the step's VX voxels
// added to acc, the targets t read once for all the matrices.
template <int VX, typename IDX>
__device__ __forceinline__ void nprobe_matrix(const float* __restrict__ src, const float* m,
                                              float yf, float zf, int xb, const float (&t)[VX],
                                              const Geo& g, float (&acc)[2]) {
  float kr[3];
  row_coords(m, yf, zf, kr);
#pragma unroll
  for (int j = 0; j < VX; ++j) {
    const int x = xb + 32 * j;
    float c[8], fr[3];
    if (x >= g.sx || !gather<IDX>(src, m, kr, static_cast<float>(x), g, c, fr)) continue;
    const float s = lerp(lerp(lerp(c[0], c[1], fr[0]), lerp(c[2], c[3], fr[0]), fr[1]),
                         lerp(lerp(c[4], c[5], fr[0]), lerp(c[6], c[7], fr[0]), fr[1]), fr[2]);
    acc[0] = __fmaf_rn(s, s, acc[0]);
    acc[1] = __fmaf_rn(s, t[j], acc[1]);
  }
}

// One block's share of K6: K5's ss and st for each of n <= kMaxProbes
// matrices in one pass, K5's step with an inner loop over the matrices,
// each matrix's operations in K5's order (its voxels one after the other,
// which gives K5's sums: only the load schedule differs); the target voxel
// is read once for all of them. Partial column 2i + k holds matrix i's
// value k (k = 0: ss, 1: st), at partials[(2i + k) * stride]. MATS is
// `const float*` (K6, corr.cu: the kernel parameter, 12 floats a matrix) or
// SharedMats (K9, reg_ladder.cu). Every thread of the block must call it.
template <int VX, typename IDX, class MATS>
__device__ __forceinline__ void corr_nprobe_block_with(const float* __restrict__ src,
                                                       const float* __restrict__ tgt,
                                                       MATS mats, int n, const Geo& g,
                                                       long long block,
                                                       double* __restrict__ partials,
                                                       size_t stride) {
  constexpr bool kShared = !std::is_same<MATS, const float*>::value;
  float acc[kMaxProbes][2];
#pragma unroll
  for (int i = 0; i < kMaxProbes; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int lane = threadIdx.x & 31;
  int z, y, seg;
  const int nsteps = first_task(g, block, z, y, seg);

  for (int k = 0; k < nsteps; ++k) {
    const float yf = static_cast<float>(y), zf = static_cast<float>(z);
    const int xb = seg * (32 * VX) + lane;
    const float* tp = tgt + (static_cast<IDX>(z) * g.sy + y) * static_cast<IDX>(g.sx) + xb;
    float t[VX];
#pragma unroll
    for (int j = 0; j < VX; ++j)
      if (xb + 32 * j < g.sx) t[j] = __ldg(tp + 32 * j);
#pragma unroll
    for (int i = 0; i < kMaxProbes; ++i) {
      if (i >= n) break;
      if constexpr (kShared) {
        float m[12];
        mats.at(i).row(m);
        nprobe_matrix<VX, IDX>(src, m, yf, zf, xb, t, g, acc[i]);
      } else {
        nprobe_matrix<VX, IDX>(src, mats + 12 * i, yf, zf, xb, t, g, acc[i]);
      }
    }
    next_task(g, z, y, seg);
  }

  double d[2 * kMaxProbes];
#pragma unroll
  for (int i = 0; i < kMaxProbes; ++i) {
    d[2 * i] = static_cast<double>(acc[i][0]);
    d[2 * i + 1] = static_cast<double>(acc[i][1]);
  }
  block_sum<2 * kMaxProbes>(d, 2 * n, partials, stride);
}

// K4/K5's body: the matrix a kernel parameter.
template <bool GRAD, int VX, typename IDX>
__device__ __forceinline__ void corr_block(const float* __restrict__ src,
                                           const float* __restrict__ tgt, const float* m,
                                           const Geo& g, long long block,
                                           double* __restrict__ partials, size_t stride) {
  corr_block_with<GRAD, VX, IDX, const float*>(src, tgt, m, g, block, partials, stride);
}

}  // namespace
