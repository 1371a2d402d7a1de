// K5 and K4: the fused affine resample + NCC partial sums of 3-D
// registration, and the same sums with their gradient in the 12 matrix
// entries, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
// microimagelib_tpu/ops/pallas_corr.py::_kernel (K5, the reference's
// corrkernel, reference:include/cukernel.cuh:526-556) and ::_grad_kernel
// (K4). For the target grid (sz, sy, sx), a 12-vector matrix m (row a of
// the 3x4 acts on axis a = x, y, z) and s = trilinear sample of src at
// c = m . [x, y, z, 1], zero outside the strict box -0.5 < c < n - 0.5:
//   K5: ss = sum s^2, st = sum s t
//   K4: ss, st, and for a in {x, y, z}, j in {x, y, z, 1}:
//       Gs[4a+j] = sum s ds/dc_a [x,y,z,1]_j   (= d(ss/2)/dm)
//       Gt[4a+j] = sum t ds/dc_a [x,y,z,1]_j   (= d(st)/dm)
// ds/dc_a is the lerp difference along a between the clamped corners (0
// where clamping makes both corners one texel), the exact a.e. derivative
// the TPU kernel takes with its one-hot difference weights.
//
// What bounds it on this card. Device memory sets the floor: ~8 bytes of
// traffic per valid voxel (target once, source about once: for the
// near-identity matrices of registration the 8 corners of neighbouring
// voxels share lines in L1/L2), 0.147 ms at (256, 512, 512). Above it the
// kernel is bound by issue and latency: ~80 instructions a voxel (K5; ~130
// K4) of coordinates, box test, floors, clamps, corner offsets, 8 gathers
// and 7 lerps, and the gathers' latency. At the pooled pyramid levels,
// where registration launches most (64-65k voxels at (16, 32, 128)),
// what counts is how many SMs get work and how long one thread's chain is.
//
// The design:
//   * A launch plan sized to the grid (make_plan, mirrored in
//     kernels/corr.py::launch_plan). The unit of work is a warp task: 32*VX
//     voxels of one output row (row = z*sy + y), lane l taking
//     x = x0 + l + 32 j, j < VX. So every gather instruction of a warp reads
//     32 consecutive voxels' corners: one or two 128-byte lines, where VX
//     consecutive x a thread would spread each over VX lines and multiply the
//     L1 wavefronts by VX to save VX - 1 of the 9 load instructions a voxel.
//     VX is the widest of 4, 2, 1 that still gives 2 blocks an SM with one
//     task a warp and pads a row by at most 1/8; then each warp takes
//     `steps` consecutive tasks of its block so that the grid is at most
//     one wave of the blocks the launch bounds keep resident (6 an SM for
//     K5 and K6, 4 for K4). (16, 32, 128) gets 512 blocks of one voxel a
//     thread (was 16 blocks of 32 voxels a thread); (256, 512, 512) K5 gets
//     790 blocks of 166 steps.
//   * In a step a thread first computes all VX voxels' coordinates, box
//     tests and corner offsets and issues their 8 VX gathers and VX target
//     loads, then does the lerps: VX voxels' loads are in flight at once.
//   * 32-bit voxel offsets where the grid has fewer than 2^31 voxels (every
//     main-path shape), a 64-bit instantiation beyond. The z-plane and
//     y-row bases of the corners are formed once per corner pair.
//   * The row advance is incremental (no division per task), and the row's
//     part of the coordinates, (m_a1*y + m_a2*z) + m_a3, is formed once a
//     step.
//   * fp32 arithmetic in the order of the JAX package: c = m00*x +
//     ((m01*y + m02*z) + m03) as the Pallas kernel writes it, and the lerps
//     of its gather path, each operation rounded on its own (explicit
//     __f*_rn intrinsics, no FMA contraction), so a numpy transliteration
//     (tests/test_torch_kernels.py::kernel_numpy) reproduces the result bit
//     for bit. No texture filtering: its 8-bit weights are not the fp32
//     lerp. K4's sums over x and 1 within a step are scaled by y and z once
//     a step (the per-row partial sums).
//   * One launch per call, reduced in a fixed order: per thread fp32
//     partials over its voxels; the block reduces them in float64 (warp
//     shuffles, then the warps in order) and writes its row of partials,
//     column-major, to the workspace; a ticket counter (__threadfence, then
//     atomicAdd) finds the last block, which sums each column in an order
//     fixed by the block count alone (thread t over rows t, t+128, ..., then
//     the same shuffle tree), writes `out` and resets the counter. No
//     atomics touch a value: the result repeats bit for bit from run to run,
//     so the optimizers' paths repeat. The last block reads at most one
//     wave's rows (<= 792 x 2 or 528 x 26 doubles from L2, a few
//     microseconds); a second launch costs the host another launch (the
//     pooled levels are host-bound) and the device a kernel boundary of the
//     same order, and needed a second buffer.
//
// K6 (corr_nprobe_kernel): K5's ss and st for N matrices in one launch.
// Replaces microimagelib_tpu/ops/pallas_corr.py::_kernel_nprobe, whose
// union-footprint DMA box, fit flag and K cascade exist because a TPU
// cannot gather; none of it is needed here. It takes K5's plan, task order,
// per-voxel arithmetic, block reduction and column sum, and reads each
// target voxel once for all matrices, so probe i gives K5's bits for
// matrix i.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing: the wrapper passes a workspace (a zeroed ticket, then
// blocks x values doubles) it keeps per device and stream, and `out`.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxProbes = 8;       // matrices per K6 launch (the ladder's 8)
// resident blocks per SM the launch bounds promise: K5 and K6 at most 80
// registers a thread, K4 at most 128
constexpr int kResidentSums = 6;
constexpr int kResidentGrad = 4;
constexpr int kMinBlocksPerSm = 2;  // the fill the plan aims for
constexpr long long kMaxBlocks = 2147483647;

struct Mat {
  float m[12];
};

struct MatN {
  float m[kMaxProbes * 12];
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

// This warp's first task as (z, y, seg), and how many of its `steps`
// tasks exist (the grid's last warps may have fewer); warp-uniform.
__device__ __forceinline__ int first_task(const Geo& g, int& z, int& y, int& seg) {
  const long long task =
      (static_cast<long long>(blockIdx.x) * g.steps) * kWarps + (threadIdx.x >> 5);
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
// clamped on its own. Both read the same texels.
template <typename IDX>
__device__ __forceinline__ bool gather(const float* __restrict__ src, const float* m,
                                       const float (&kr)[3], float xf, const Geo& g,
                                       float (&v)[8], float (&fr)[3]) {
  const float cx = __fadd_rn(__fmul_rn(m[0], xf), kr[0]);
  const float cy = __fadd_rn(__fmul_rn(m[4], xf), kr[1]);
  const float cz = __fadd_rn(__fmul_rn(m[8], xf), kr[2]);
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

// GRAD = false: K5, 2 values. GRAD = true: K4, 26. VX voxels a thread a
// step; IDX the voxel offset type (int below 2^31 voxels).
template <bool GRAD, int VX, typename IDX>
__global__ void __launch_bounds__(kThreads, GRAD ? kResidentGrad : kResidentSums)
corr_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
            unsigned* __restrict__ ticket, double* __restrict__ partials,
            double* __restrict__ out, Mat mat, Geo g) {
  constexpr int NV = GRAD ? 26 : 2;
  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;

  const float* m = mat.m;
  const int lane = threadIdx.x & 31;
  int z, y, seg;
  const int nsteps = first_task(g, z, y, seg);

  for (int k = 0; k < nsteps; ++k) {
    const float yf = static_cast<float>(y), zf = static_cast<float>(z);
    float kr[3];
    row_coords(m, yf, zf, kr);
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
      ok[j] = x < g.sx && gather<IDX>(src, m, kr, static_cast<float>(x), g, v[j], fr[j]);
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
  block_sum<NV>(d, NV, partials + blockIdx.x, gridDim.x);
  if (!last_block(ticket)) return;
  sum_columns<NV>(partials, gridDim.x, NV, out);
  if (threadIdx.x == 0) *ticket = 0u;
}

// K6: K5's step with an inner loop over the n <= kMaxProbes matrices; each
// matrix's operations in K5's order (its voxels one after the other, which
// gives K5's sums: only the load schedule differs). K5's residency, so
// K5's plan is one wave here too. Partial column 2i + k holds probe i's
// value k.
template <int VX, typename IDX>
__global__ void __launch_bounds__(kThreads, kResidentSums)
corr_nprobe_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                   unsigned* __restrict__ ticket, double* __restrict__ partials,
                   double* __restrict__ out, MatN mats, int n, Geo g) {
  float acc[kMaxProbes][2];
#pragma unroll
  for (int i = 0; i < kMaxProbes; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int lane = threadIdx.x & 31;
  int z, y, seg;
  const int nsteps = first_task(g, z, y, seg);

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
      const float* m = mats.m + 12 * i;
      float kr[3];
      row_coords(m, yf, zf, kr);
#pragma unroll
      for (int j = 0; j < VX; ++j) {
        const int x = xb + 32 * j;
        float c[8], fr[3];
        if (x >= g.sx || !gather<IDX>(src, m, kr, static_cast<float>(x), g, c, fr)) continue;
        const float s = lerp(lerp(lerp(c[0], c[1], fr[0]), lerp(c[2], c[3], fr[0]), fr[1]),
                             lerp(lerp(c[4], c[5], fr[0]), lerp(c[6], c[7], fr[0]), fr[1]),
                             fr[2]);
        acc[i][0] = __fmaf_rn(s, s, acc[i][0]);
        acc[i][1] = __fmaf_rn(s, t[j], acc[i][1]);
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
  block_sum<2 * kMaxProbes>(d, 2 * n, partials + blockIdx.x, gridDim.x);
  if (!last_block(ticket)) return;
  sum_columns<2 * kMaxProbes>(partials, gridDim.x, 2 * n, out);
  if (threadIdx.x == 0) *ticket = 0u;
}

using CorrFn = void (*)(const float*, const float*, unsigned*, double*, double*, Mat, Geo);
using NprobeFn = void (*)(const float*, const float*, unsigned*, double*, double*, MatN, int,
                          Geo);

template <bool GRAD, typename IDX>
CorrFn corr_fn_idx(int vx) {
  switch (vx) {
    case 4: return corr_kernel<GRAD, 4, IDX>;
    case 2: return corr_kernel<GRAD, 2, IDX>;
    default: return corr_kernel<GRAD, 1, IDX>;
  }
}

CorrFn corr_fn(bool grad, int vx, int wide) {
  if (grad) return wide ? corr_fn_idx<true, long long>(vx) : corr_fn_idx<true, int>(vx);
  return wide ? corr_fn_idx<false, long long>(vx) : corr_fn_idx<false, int>(vx);
}

template <typename IDX>
NprobeFn nprobe_fn_idx(int vx) {
  switch (vx) {
    case 4: return corr_nprobe_kernel<4, IDX>;
    case 2: return corr_nprobe_kernel<2, IDX>;
    default: return corr_nprobe_kernel<1, IDX>;
  }
}

NprobeFn nprobe_fn(int vx, int wide) {
  return wide ? nprobe_fn_idx<long long>(vx) : nprobe_fn_idx<int>(vx);
}

int device_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

bool valid_grid(int sz, int sy, int sx) { return sz >= 1 && sy >= 1 && sx >= 1; }

// The plan of a launch on this device, or an error: a bad grid, no device,
// a workspace of fewer than 1 + blocks * ncols doubles.
int launch_plan(int sz, int sy, int sx, bool grad, int ncols, long long work_len, Plan* p) {
  if (!valid_grid(sz, sy, sx)) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = device_sms();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  *p = make_plan(sz, sy, sx, grad, sms);
  if (p->blocks > kMaxBlocks || p->steps > 2147483647LL || work_len < 1 + p->blocks * ncols)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// The launch plan of K5 (grad = 0; K6 takes it too) or K4 (grad = 1) for a
// (sz, sy, sx) grid on a card of `sms` SMs: out[0..5] = voxels a thread a
// step (VX), warp tasks per row, tasks, steps (tasks a warp), blocks,
// 64-bit offsets (0/1). Returns 0, or cudaErrorInvalidValue.
int mil_corr3d_plan(int sz, int sy, int sx, int grad, int sms, long long* out) {
  if (!valid_grid(sz, sy, sx) || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(sz, sy, sx, grad != 0, sms);
  const long long vals[6] = {p.vx, p.wsegs, p.tasks, p.steps, p.blocks, p.wide};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

// What an instantiation compiled to: kind 0 = K5, 1 = K4, 2 = K6; `vx`
// and `wide` as the plan gives them. out[0] registers, out[1] spilled
// bytes a thread, out[2] static shared bytes, out[3] resident blocks per
// SM. Returns a cudaError_t, 0 on success.
int mil_corr3d_attrs(int kind, int vx, int wide, int* out) {
  const void* fn = kind == 2 ? reinterpret_cast<const void*>(nprobe_fn(vx, wide))
                             : reinterpret_cast<const void*>(corr_fn(kind == 1, vx, wide));
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

// One K5 (grad = 0) or K4 (grad = 1) launch on `stream`. `m` is a HOST
// pointer to the 12 float32 matrix entries; `work` holds `work_len` >= 1 +
// blocks x (grad ? 26 : 2) doubles on the device, the first zero (the
// ticket; the launch leaves it zero); `out` receives the (grad ? 26 : 2)
// sums. Returns the cudaError_t of the launch, 0 on success.
int mil_corr3d(const float* src, const float* tgt, const float* m, double* work,
               long long work_len, double* out, int sz, int sy, int sx, int grad,
               void* stream) {
  Plan p;
  const int err = launch_plan(sz, sy, sx, grad != 0, grad ? 26 : 2, work_len, &p);
  if (err) return err;
  if (m == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Mat mat;
  for (int k = 0; k < 12; ++k) mat.m[k] = m[k];
  const CorrFn fn = corr_fn(grad != 0, p.vx, p.wide);
  fn<<<dim3(static_cast<unsigned>(p.blocks)), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, reinterpret_cast<unsigned*>(work), work + 1, out, mat, make_geo(p, sz, sy, sx));
  return static_cast<int>(cudaGetLastError());
}

// Matrices one K6 launch takes.
int mil_corr3d_max_probes() { return kMaxProbes; }

// One K6 launch on `stream` for `n` (1..kMaxProbes) matrices, on K5's
// plan. `m` is a HOST pointer to n x 12 float32 entries; `work` as for
// mil_corr3d with room for 1 + blocks x 2 kMaxProbes doubles; `out`
// receives the n x 2 sums (ss, st per matrix). Returns the cudaError_t, 0
// on success.
int mil_corr3d_nprobe(const float* src, const float* tgt, const float* m, int n,
                      double* work, long long work_len, double* out, int sz, int sy, int sx,
                      void* stream) {
  Plan p;
  const int err = launch_plan(sz, sy, sx, false, 2 * kMaxProbes, work_len, &p);
  if (err) return err;
  if (m == nullptr || n < 1 || n > kMaxProbes) return static_cast<int>(cudaErrorInvalidValue);
  MatN mats;
  for (int k = 0; k < kMaxProbes * 12; ++k) mats.m[k] = k < 12 * n ? m[k] : 0.f;
  const NprobeFn fn = nprobe_fn(p.vx, p.wide);
  fn<<<dim3(static_cast<unsigned>(p.blocks)), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, reinterpret_cast<unsigned*>(work), work + 1, out, mats, n,
      make_geo(p, sz, sy, sx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
