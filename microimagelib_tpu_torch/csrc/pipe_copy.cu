// K7: the copy shaped like K1's launches — the device-memory ceiling that
// the separable convolution's access pattern can reach — for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/conv_roofline.py::copy_kernel (launched
// by its pipe_copy): a kernel with the convolution's grid and block structure
// that does no convolution. It computes, on (nz, ny, nx) C-contiguous float32
// volumes,
//   out[z, y, x] = fmaf(v[(z + shift) mod nz, y, x], 1e-6f, aux[z, y, x])
// that is aux + 1e-6 * roll(v, -shift, 0), rounded once (one explicit fmaf,
// never left to the compiler's contraction). On the TPU the shift is the
// conv's slab lookahead lb * zb; the port passes its plan's z reach b.
//
// What bounds it on this card: memory traffic, by construction. Each voxel
// is read once from v and once from aux and written once: 12 bytes for one
// FMA. Its time is the most a launch of K1's shape can get out of the card's
// memory, the yardstick K1's passes are held against.
//
// Design: two geometries, one per K1 launch (csrc/conv_sep.cu), each
// reading and writing in that launch's order:
//   * geometry 0, "z" (zpass_kernel's grid): blocks of 128 threads, one per
//     x column of one y row, for a chunk of 8 z planes; the source plane
//     advances with a conditional wrap; loads through __ldg.
//   * geometry 1, "xy" (xypass_kernel's grid): one (64 x 16) tile of one z
//     plane per block of (64, 4) threads, 4 rows a thread; v's tile is staged
//     in shared memory and read back after a barrier, as the xy pass stages
//     its input. One tile and no halo: the copy has no stencil.
// Ragged edges are masked. The kernel launches on the caller's stream, does
// not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kZThreads = 128;      // x columns per z-geometry block
constexpr int kZChunk = 8;          // z planes per z-geometry block
constexpr int kTX = 64;             // xy tile width (= blockDim.x)
constexpr int kTY = 16;             // xy tile height
constexpr int kRowsPerThread = 4;   // blockDim.y = kTY / kRowsPerThread
constexpr int kMaxGridYZ = 65535;
constexpr float kScale = 1e-6f;

__global__ void pipe_copy_z_kernel(const float* __restrict__ v, const float* __restrict__ aux,
                                   float* __restrict__ out, int nz, int ny, int nx, int shift) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t col = (size_t)blockIdx.y * nx + x;
  const int z0 = blockIdx.z * kZChunk;
  const int nzc = min(kZChunk, nz - z0);
  int zi = z0 + shift;                // shift is in [0, nz)
  if (zi >= nz) zi -= nz;
#pragma unroll
  for (int q = 0; q < kZChunk; ++q) {
    if (q < nzc) {
      const size_t o = (size_t)(z0 + q) * plane + col;
      out[o] = fmaf(__ldg(v + (size_t)zi * plane + col), kScale, __ldg(aux + o));
      zi = (zi + 1 == nz) ? 0 : zi + 1;
    }
  }
}

__global__ void pipe_copy_xy_kernel(const float* __restrict__ v, const float* __restrict__ aux,
                                    float* __restrict__ out, int nz, int ny, int nx, int shift) {
  __shared__ float s_tile[kTY][kTX];
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y0 = blockIdx.y * kTY;
  const int z = blockIdx.z;
  int zs = z + shift;
  if (zs >= nz) zs -= nz;
  const size_t plane = (size_t)ny * nx;
  const float* src = v + (size_t)zs * plane;
  for (int iy = threadIdx.y; iy < kTY; iy += blockDim.y) {
    const int y = y0 + iy;
    if (y < ny && x < nx) s_tile[iy][threadIdx.x] = __ldg(src + (size_t)y * nx + x);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int iy = threadIdx.y + q * blockDim.y;
    const int y = y0 + iy;
    if (y >= ny || x >= nx) continue;
    const size_t o = (size_t)z * plane + (size_t)y * nx + x;
    out[o] = fmaf(s_tile[iy][threadIdx.x], kScale, __ldg(aux + o));
  }
}

}  // namespace

extern "C" {

// One K7 launch on `stream`: geometry 0 = "z", 1 = "xy"; 0 <= shift < nz.
// Returns the cudaError_t of the launch, 0 on success.
int mil_pipe_copy(const float* v, const float* aux, float* out, int nz, int ny, int nx,
                  int shift, int geometry, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || ny > kMaxGridYZ || nz > kMaxGridYZ || shift < 0 ||
      shift >= nz || geometry < 0 || geometry > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geometry == 0) {
    const dim3 grid((nx + kZThreads - 1) / kZThreads, ny, (nz + kZChunk - 1) / kZChunk);
    pipe_copy_z_kernel<<<grid, kZThreads, 0, s>>>(v, aux, out, nz, ny, nx, shift);
  } else {
    const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, nz);
    const dim3 block(kTX, kTY / kRowsPerThread);
    pipe_copy_xy_kernel<<<grid, block, 0, s>>>(v, aux, out, nz, ny, nx, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
