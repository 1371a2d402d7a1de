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
// What bounds it on this card: memory. Each voxel reads its target value
// and 8 source corners; for the near-identity matrices of registration
// neighbouring threads read neighbouring corners, so the source comes from
// device memory about once and the rest from L1/L2: ~8 bytes of device
// traffic per voxel against ~30 fp32 operations (K5) or ~80 (K4), far
// under the 67 TFLOP/s fp32 rate. At (256, 512, 512) the bound is
// 537 MB / 3.35 TB/s = 0.16 ms per launch.
//
// What this design does about it, in its first, simple form:
//   * one block of 128 threads per run of `rows` output rows (row = z*sy+y),
//     a thread per x column (strided by 128), so the target loads coalesce
//     and the corner loads (__ldg, read-only path) hit lines the warp's
//     neighbours share. The TPU kernel's per-block source box, DMA double
//     buffer, one-hot MXU contraction and K = 8/16/32/64 cascade with a
//     gather fallback exist because a TPU cannot gather; none is needed
//     here, and the kernel is exact for every matrix.
//   * fp32 arithmetic in the order of the JAX package: c = m00*x +
//     ((m01*y + m02*z) + m03) as the Pallas kernel writes it, and the lerps
//     of its gather path, each operation rounded on its own (no FMA
//     contraction), so a numpy transliteration reproduces a voxel exactly.
//     No texture filtering: its 8-bit weights are not the fp32 lerp.
//   * per thread, fp32 partials over its short run (<= ~32 voxels); the
//     block reduces them in float64 (warp shuffles, then shared memory) and
//     writes one row of partials: 2 (K5) or 26 (K4) doubles per block. The
//     wrapper sums the rows in float64 (kernels/corr.py). No atomics: the
//     result repeats bit for bit from run to run, so the optimizers' paths
//     repeat. Per-voxel fp64 would put K4 on the fp64 rate; fp64 is kept at
//     the block level.
//   * 64-bit source offsets: a clamped z*sy*sx + y*sx + x never wraps.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing: the wrapper allocates the (blocks, 2 or 26) partials.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 2147483647;

struct Mat {
  float m[12];
};

__device__ __forceinline__ float lerp(float a, float b, float f) {
  // a + (b - a) * f, each operation rounded on its own
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

template <int NV>
__device__ __forceinline__ void block_store(const float (&acc)[NV], double* out) {
  __shared__ double sh[NV][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    double v = static_cast<double>(acc[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sh[threadIdx.x][w];
    out[static_cast<size_t>(blockIdx.x) * NV + threadIdx.x] = s;
  }
}

// GRAD = false: K5, 2 partials per block. GRAD = true: K4, 26.
template <bool GRAD>
__global__ void __launch_bounds__(kThreads)
corr_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
            double* __restrict__ partials, Mat mat, int sz, int sy, int sx,
            int rows) {
  constexpr int NV = GRAD ? 26 : 2;
  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;

  const float* m = mat.m;
  const float hx = sx - 0.5f, hy = sy - 0.5f, hz = sz - 0.5f;
  const long long nrows = static_cast<long long>(sz) * sy;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = r0 + rows < nrows ? r0 + rows : nrows;

  for (long long r = r0; r < r1; ++r) {
    const int z = static_cast<int>(r / sy), y = static_cast<int>(r % sy);
    const float yf = static_cast<float>(y), zf = static_cast<float>(z);
    // the row's part of c_a: (m_a1*y + m_a2*z) + m_a3
    float kr[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      kr[a] = __fadd_rn(__fadd_rn(__fmul_rn(m[4 * a + 1], yf),
                                  __fmul_rn(m[4 * a + 2], zf)), m[4 * a + 3]);
    // per-row sums for K4: a1 = sum u*x, a0 = sum u, u = s*ds_a (or t*ds_a)
    float a1s[3] = {0.f, 0.f, 0.f}, a0s[3] = {0.f, 0.f, 0.f};
    float a1t[3] = {0.f, 0.f, 0.f}, a0t[3] = {0.f, 0.f, 0.f};
    const float* trow = tgt + r * sx;

    for (int x = threadIdx.x; x < sx; x += kThreads) {
      const float xf = static_cast<float>(x);
      const float cx = __fadd_rn(__fmul_rn(m[0], xf), kr[0]);
      const float cy = __fadd_rn(__fmul_rn(m[4], xf), kr[1]);
      const float cz = __fadd_rn(__fmul_rn(m[8], xf), kr[2]);
      if (!(cx > -0.5f && cy > -0.5f && cz > -0.5f && cx < hx && cy < hy && cz < hz))
        continue;   // s = 0: adds nothing to any sum
      const float x0 = floorf(cx), y0 = floorf(cy), z0 = floorf(cz);
      const float fx = __fsub_rn(cx, x0), fy = __fsub_rn(cy, y0), fz = __fsub_rn(cz, z0);
      // inside the box each floor lies in [-1, n-1]; clamp each corner
      const int xr = static_cast<int>(x0), yr = static_cast<int>(y0), zr = static_cast<int>(z0);
      const int x0i = max(xr, 0), x1i = min(xr + 1, sx - 1);
      const int y0i = max(yr, 0), y1i = min(yr + 1, sy - 1);
      const int z0i = max(zr, 0), z1i = min(zr + 1, sz - 1);
      const size_t b00 = (static_cast<size_t>(z0i) * sy + y0i) * sx;
      const size_t b01 = (static_cast<size_t>(z0i) * sy + y1i) * sx;
      const size_t b10 = (static_cast<size_t>(z1i) * sy + y0i) * sx;
      const size_t b11 = (static_cast<size_t>(z1i) * sy + y1i) * sx;
      const float v000 = __ldg(src + b00 + x0i), v001 = __ldg(src + b00 + x1i);
      const float v010 = __ldg(src + b01 + x0i), v011 = __ldg(src + b01 + x1i);
      const float v100 = __ldg(src + b10 + x0i), v101 = __ldg(src + b10 + x1i);
      const float v110 = __ldg(src + b11 + x0i), v111 = __ldg(src + b11 + x1i);
      const float c00 = lerp(v000, v001, fx), c01 = lerp(v010, v011, fx);
      const float c10 = lerp(v100, v101, fx), c11 = lerp(v110, v111, fx);
      const float c0 = lerp(c00, c01, fy), c1 = lerp(c10, c11, fy);
      const float s = lerp(c0, c1, fz);
      const float t = __ldg(trow + x);
      acc[0] += s * s;
      acc[1] += s * t;
      if constexpr (GRAD) {
        // ds/dc_a: the lerp of the differences along a
        const float dx0 = lerp(__fsub_rn(v001, v000), __fsub_rn(v011, v010), fy);
        const float dx1 = lerp(__fsub_rn(v101, v100), __fsub_rn(v111, v110), fy);
        const float ds[3] = {lerp(dx0, dx1, fz),
                             lerp(__fsub_rn(c01, c00), __fsub_rn(c11, c10), fz),
                             __fsub_rn(c1, c0)};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float us = s * ds[a], ut = t * ds[a];
          a1s[a] += us * xf;
          a0s[a] += us;
          a1t[a] += ut * xf;
          a0t[a] += ut;
        }
      }
    }
    if constexpr (GRAD) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[2 + 4 * a + 0] += a1s[a];
        acc[2 + 4 * a + 1] += yf * a0s[a];
        acc[2 + 4 * a + 2] += zf * a0s[a];
        acc[2 + 4 * a + 3] += a0s[a];
        acc[14 + 4 * a + 0] += a1t[a];
        acc[14 + 4 * a + 1] += yf * a0t[a];
        acc[14 + 4 * a + 2] += zf * a0t[a];
        acc[14 + 4 * a + 3] += a0t[a];
      }
    }
  }
  block_store<NV>(acc, partials);
}

}  // namespace

extern "C" {

// Number of partial rows (blocks) one launch writes for this grid.
long long mil_corr3d_blocks(int sz, int sy, int rows) {
  if (sz < 1 || sy < 1 || rows < 1) return -1;
  const long long nrows = static_cast<long long>(sz) * sy;
  return (nrows + rows - 1) / rows;
}

// One K5 (grad = 0) or K4 (grad = 1) launch on `stream`. `m` is a HOST
// pointer to the 12 float32 matrix entries; `partials` holds
// mil_corr3d_blocks(...) x (grad ? 26 : 2) doubles on the device. Returns
// the cudaError_t of the launch, 0 on success.
int mil_corr3d(const float* src, const float* tgt, const float* m,
               double* partials, int sz, int sy, int sx, int rows, int grad,
               void* stream) {
  const long long blocks = mil_corr3d_blocks(sz, sy, rows);
  if (sx < 1 || blocks < 1 || blocks > kMaxBlocks || m == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Mat mat;
  for (int k = 0; k < 12; ++k) mat.m[k] = m[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (grad)
    corr_kernel<true><<<grid, kThreads, 0, s>>>(src, tgt, partials, mat, sz, sy, sx, rows);
  else
    corr_kernel<false><<<grid, kThreads, 0, s>>>(src, tgt, partials, mat, sz, sy, sx, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
