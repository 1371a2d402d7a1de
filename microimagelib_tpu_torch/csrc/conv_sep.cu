// K1: separable compact-PSF circular 3-D convolution with the fused RL
// epilogue, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// microimagelib_tpu/ops/conv_sep.py::_kernel (launched by _conv3_sep).
// Semantics, per rank r of the plan (ops/conv_sep.py::SepPlan):
//   zs_r[z,y,x] = sum_s tz[r,s] * v[(z-a+s) mod nz, (y-dy_s) mod ny, (x-dx_s) mod nx]
//   out         = sum_r  x-conv_r( y-conv_r( zs_r ) )
// with 1-D circular convolutions out[w] = sum_j k[j] * in[(w - off_j) mod n],
// off_j = o + j, and the epilogue
//   plain: out;  ratio: aux / out;  update: max(aux * out, smallvalue).
//
// What bounds it on this card: memory traffic. The taps are short stencils
// (9 per axis for a 9^3 Gaussian, up to ~25 for tilted measured PSFs), so a
// launch does ~2 x (taps) fp32 FMAs per voxel against ~2 volume reads plus
// 1 write, plus the R rank volumes written by the z pass and read back by
// the xy pass. At the H100's ~3.35 TB/s and 67 TFLOP/s fp32 the FMAs are
// far below the memory time.
//
// What this design does about it, in its first, simple form:
//   * z pass (zpass_kernel): one thread per x column of one y row and a
//     chunk of 8 z planes, taps outer: each tap's wrapped (y, x) source is
//     computed once and z advances with a conditional wrap, so the integer
//     index work stays off the per-voxel path (with a `%` per tap and
//     voxel it was 68% of K1 at 512^3). Each input value loaded feeds all
//     R ranks. Neighbouring z taps re-read planes that sit in L2 (a 512^2
//     plane is 1 MB, a 9-tap window 9 MB of the 50 MB L2), so the volume
//     is read from device memory about once. The TPU kernel's rolling slab
//     window relied on a sequential grid; CUDA blocks run in no order, so
//     each block reads its own z halo and computes its own wrapped indices.
//   * xy pass (xypass_kernel): one block per (64 x 16) tile of one z plane
//     stages the tile plus its y/x halo of each rank volume in shared
//     memory (wrapped row and column indices computed once per block), runs
//     the y then the x stencil from there, sums the ranks in registers and
//     applies the epilogue: each rank volume is read once (plus the halo),
//     aux once, out written once.
// Fusing the two passes (no rank volumes in device memory), TMA loads and
// register-blocked stencils are later work.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing: the wrapper (kernels/conv_sep.py) allocates out and
// the (R, nz, ny, nx) scratch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxRank = 4;
constexpr int kMaxZTaps = 128;
constexpr int kMaxXYTaps = 128;
constexpr int kZThreads = 128;      // x columns per z-pass block
constexpr int kZChunk = 8;          // z planes per z-pass block
constexpr int kTX = 64;             // xy-pass tile width (= blockDim.x)
constexpr int kTY = 16;             // xy-pass tile height
constexpr int kRowsPerThread = 4;   // blockDim.y = kTY / kRowsPerThread
constexpr int kMaxGridYZ = 65535;

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__global__ void zpass_kernel(const float* __restrict__ v, float* __restrict__ zs,
                             const float* __restrict__ tz, const int* __restrict__ rolls,
                             int nz, int ny, int nx, int rank, int a, int nsteps) {
  __shared__ float s_tz[kMaxRank * kMaxZTaps];
  __shared__ int s_dy[kMaxZTaps];
  __shared__ int s_dx[kMaxZTaps];
  for (int i = threadIdx.x; i < rank * nsteps; i += blockDim.x) s_tz[i] = tz[i];
  for (int i = threadIdx.x; i < nsteps; i += blockDim.x) {
    s_dy[i] = rolls ? rolls[2 * i] : 0;
    s_dx[i] = rolls ? rolls[2 * i + 1] : 0;
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t vol = plane * nz;
  const int z0 = blockIdx.z * kZChunk;
  const int nzc = min(kZChunk, nz - z0);

  // taps outer, the chunk's z planes inner: each tap's wrapped (y, x)
  // column is computed once, and z advances with a conditional wrap.
  // Every output still sums its taps in s order.
  float acc[kZChunk][kMaxRank];
#pragma unroll
  for (int q = 0; q < kZChunk; ++q)
#pragma unroll
    for (int r = 0; r < kMaxRank; ++r) acc[q][r] = 0.f;
  for (int s = 0; s < nsteps; ++s) {
    const float* col = v + (size_t)wrap(y - s_dy[s], ny) * nx + wrap(x - s_dx[s], nx);
    float t[kMaxRank];
#pragma unroll
    for (int r = 0; r < kMaxRank; ++r) t[r] = r < rank ? s_tz[r * nsteps + s] : 0.f;
    int zi = wrap(z0 - a + s, nz);
#pragma unroll
    for (int q = 0; q < kZChunk; ++q) {
      if (q < nzc) {
        const float val = __ldg(col + (size_t)zi * plane);
#pragma unroll
        for (int r = 0; r < kMaxRank; ++r)
          if (r < rank) acc[q][r] = fmaf(t[r], val, acc[q][r]);
        zi = (zi + 1 == nz) ? 0 : zi + 1;
      }
    }
  }
  const size_t o = (size_t)z0 * plane + (size_t)y * nx + x;
#pragma unroll
  for (int q = 0; q < kZChunk; ++q)
#pragma unroll
    for (int r = 0; r < kMaxRank; ++r)
      if (q < nzc && r < rank) zs[r * vol + o + q * plane] = acc[q][r];
}

__global__ void xypass_kernel(const float* __restrict__ zs, const float* __restrict__ aux,
                              float* __restrict__ out, const float* __restrict__ ty,
                              const float* __restrict__ tx, int nz, int ny, int nx,
                              int rank, int ly, int oy, int lx, int ox, int mode,
                              float smallvalue) {
  extern __shared__ float smem[];
  const int hy = kTY + ly - 1;          // halo rows
  const int hx = kTX + lx - 1;          // halo columns
  float* s_tile = smem;                 // hy x hx: one rank's input tile
  float* s_mid = s_tile + hy * hx;      // kTY x hx: after the y stencil
  float* s_ty = s_mid + kTY * hx;       // rank x ly
  float* s_tx = s_ty + rank * ly;       // rank x lx
  int* s_row = reinterpret_cast<int*>(s_tx + rank * lx);  // hy wrapped source rows
  int* s_col = s_row + hy;                                 // hx wrapped source columns

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const int z = blockIdx.z;
  // halo (0, 0) is the source of output (y0, x0) under the largest offset
  const int sy0 = y0 - (oy + ly - 1);
  const int sx0 = x0 - (ox + lx - 1);
  for (int i = tid; i < rank * ly; i += nthr) s_ty[i] = ty[i];
  for (int i = tid; i < rank * lx; i += nthr) s_tx[i] = tx[i];
  for (int i = tid; i < hy; i += nthr) s_row[i] = wrap(sy0 + i, ny);
  for (int i = tid; i < hx; i += nthr) s_col[i] = wrap(sx0 + i, nx);

  const size_t plane = (size_t)ny * nx;
  const size_t vol = plane * nz;

  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.f;

  for (int r = 0; r < rank; ++r) {
    __syncthreads();  // taps and indices staged; the previous rank is done with the tiles
    const float* src = zs + r * vol + (size_t)z * plane;
    for (int iy = threadIdx.y; iy < hy; iy += blockDim.y) {
      const float* row = src + (size_t)s_row[iy] * nx;
      for (int ix = threadIdx.x; ix < hx; ix += blockDim.x)
        s_tile[iy * hx + ix] = __ldg(row + s_col[ix]);
    }
    __syncthreads();
    const float* kyr = s_ty + r * ly;
    for (int t = threadIdx.y; t < kTY; t += blockDim.y) {
      for (int c = threadIdx.x; c < hx; c += blockDim.x) {
        float sacc = 0.f;
        for (int k = 0; k < ly; ++k)
          sacc = fmaf(kyr[k], s_tile[(t + ly - 1 - k) * hx + c], sacc);
        s_mid[t * hx + c] = sacc;
      }
    }
    __syncthreads();
    const float* kxr = s_tx + r * lx;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const float* row = s_mid + (threadIdx.y + q * blockDim.y) * hx + threadIdx.x + lx - 1;
      float sacc = 0.f;
      for (int k = 0; k < lx; ++k) sacc = fmaf(kxr[k], row[-k], sacc);
      acc[q] += sacc;
    }
  }

  const int x = x0 + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int y = y0 + threadIdx.y + q * blockDim.y;
    if (y >= ny || x >= nx) continue;
    const size_t o = (size_t)z * plane + (size_t)y * nx + x;
    float val = acc[q];
    if (mode == 1) {
      val = aux[o] / val;
    } else if (mode == 2) {
      val = fmaxf(aux[o] * val, smallvalue);
    }
    out[o] = val;
  }
}

size_t xypass_smem_bytes(int rank, int ly, int lx) {
  const size_t hy = kTY + ly - 1, hx = kTX + lx - 1;
  return (hy * hx + kTY * hx + (size_t)rank * (ly + lx)) * sizeof(float) +
         (hy + hx) * sizeof(int);
}

}  // namespace

extern "C" {

const char* mil_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One K1 launch (both passes) on `stream`. `rolls` may be NULL (no per-tap
// rolls). `scratch` holds rank * nz * ny * nx floats. Returns the
// cudaError_t of the launches, 0 on success.
int mil_conv3_sep(const float* v, const float* aux, float* out, float* scratch,
                  const float* tz, const int* rolls, const float* ty, const float* tx,
                  int nz, int ny, int nx, int rank, int a, int nsteps,
                  int ly, int oy, int lx, int ox, int mode, float smallvalue,
                  void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || ny > kMaxGridYZ || nz > kMaxGridYZ ||
      rank < 1 || rank > kMaxRank || nsteps < 1 || nsteps > kMaxZTaps ||
      ly < 1 || ly > kMaxXYTaps || lx < 1 || lx > kMaxXYTaps || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const dim3 g1((nx + kZThreads - 1) / kZThreads, ny, (nz + kZChunk - 1) / kZChunk);
  zpass_kernel<<<g1, kZThreads, 0, s>>>(v, scratch, tz, rolls, nz, ny, nx, rank, a, nsteps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = xypass_smem_bytes(rank, ly, lx);
  err = cudaFuncSetAttribute(xypass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, nz);
  const dim3 b2(kTX, kTY / kRowsPerThread);
  xypass_kernel<<<g2, b2, smem, s>>>(scratch, aux, out, ty, tx, nz, ny, nx, rank, ly, oy,
                                     lx, ox, mode, smallvalue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
