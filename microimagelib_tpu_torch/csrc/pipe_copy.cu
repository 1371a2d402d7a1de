// K7: the copy shaped like K1's launch — the device-memory ceiling that
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
// memory, the yardstick K1's launches are held against.
//
// What the design does about it (the same in both geometries):
//   * 16-byte accesses (float4 along x) where nx % 4 == 0 and the three
//     pointers are 16-byte aligned; 4-byte ones otherwise (the same code on
//     float).
//   * kUnroll independent loads of each input in flight per thread: all of
//     a step's loads are issued before its fmaf's.
//   * Evict-first streaming loads and stores (__ldcs / __stcs): nothing is
//     read twice.
//   * One block a task, every task in the grid: the hardware scheduler
//     keeps every SM fed to the last task. (A persistent grid of one to
//     four waves of resident blocks, walking the tasks grid-stride, ran
//     slower than torch.add at 512^3 on an H100; one block a task matched
//     it.)
//   * The z roll resolved once per plane, as the source plane's base
//     offset: no per-element index arithmetic beyond the plane offset.
// The two geometries differ only in the order the voxels are walked:
//   * geometry 0, "z" (K1's order): a task is an xy chunk of kThreads *
//     kUnroll vectors and a run of kZRun z planes; the block walks the run
//     plane by plane, the source plane advancing with a wrap. (Longer runs
//     fell further behind torch.add on an H100, each doubling by a few
//     tenths of a percent; so did one vector a thread with kUnroll planes
//     in flight, each warp touching planes a megabyte apart.)
//   * geometry 1, "xy": a task is the same chunk of one plane; tasks walk
//     the planes in order.
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // loads of each input in flight a thread
constexpr int kZRun = 2;            // z geometry: planes a task
constexpr float kScale = 1e-6f;

__device__ __forceinline__ float fma_scale(float v, float a) { return fmaf(v, kScale, a); }

__device__ __forceinline__ float4 fma_scale(float4 v, float4 a) {
  return make_float4(fmaf(v.x, kScale, a.x), fmaf(v.y, kScale, a.y), fmaf(v.z, kScale, a.z),
                     fmaf(v.w, kScale, a.w));
}

// One chunk of kThreads * kUnroll T's (from i0, one in kThreads a thread)
// of output plane `base`, its source plane `src`: every load before any fmaf.
template <typename T>
__device__ __forceinline__ void copy_chunk(const T* __restrict__ src, const T* __restrict__ aux,
                                           T* __restrict__ out, long long base, long long i0,
                                           long long plane) {
  T a[kUnroll], b[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + u * kThreads;
    if (i < plane) {
      a[u] = __ldcs(src + i);
      b[u] = __ldcs(aux + base + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + u * kThreads;
    if (i < plane) __stcs(out + base + i, fma_scale(a[u], b[u]));
  }
}

// T: float4 (16-byte accesses) or float. `plane` counts T's; `chunks` is
// the chunks a plane. A block is one chunk of kZRun planes from z0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pipe_copy_z_kernel(const T* __restrict__ v, const T* __restrict__ aux, T* __restrict__ out,
                   int nz, long long plane, int shift, long long chunks) {
  const long long r = blockIdx.x / chunks;
  const long long i0 = (blockIdx.x - r * chunks) * (kThreads * kUnroll) + threadIdx.x;
  const int z0 = static_cast<int>(r) * kZRun;
  const int zn = min(kZRun, nz - z0);
  int zs = z0 + shift;   // shift is in [0, nz)
  if (zs >= nz) zs -= nz;
  for (int q = 0; q < zn; ++q) {
    copy_chunk(v + zs * plane, aux, out, (z0 + q) * plane, i0, plane);
    zs = zs + 1 == nz ? 0 : zs + 1;
  }
}

// A block is one chunk of one plane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pipe_copy_xy_kernel(const T* __restrict__ v, const T* __restrict__ aux, T* __restrict__ out,
                    int nz, long long plane, int shift, long long chunks) {
  const int z = static_cast<int>(blockIdx.x / chunks);
  int zs = z + shift;   // shift is in [0, nz)
  if (zs >= nz) zs -= nz;
  copy_chunk(v + zs * plane, aux, out, z * plane,
             (blockIdx.x - z * chunks) * (kThreads * kUnroll) + threadIdx.x, plane);
}

template <typename T>
cudaError_t launch(const float* v, const float* aux, float* out, int nz, long long plane,
                   int shift, int geometry, cudaStream_t s) {
  const T* tv = reinterpret_cast<const T*>(v);
  const T* ta = reinterpret_cast<const T*>(aux);
  T* to = reinterpret_cast<T*>(out);
  const long long chunks = (plane + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long tasks = chunks * (geometry == 0 ? (nz + kZRun - 1) / kZRun : nz);
  if (tasks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (geometry == 0)
    pipe_copy_z_kernel<T><<<static_cast<unsigned>(tasks), kThreads, 0, s>>>(tv, ta, to, nz,
                                                                            plane, shift, chunks);
  else
    pipe_copy_xy_kernel<T><<<static_cast<unsigned>(tasks), kThreads, 0, s>>>(tv, ta, to, nz,
                                                                             plane, shift, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One K7 launch on `stream`: geometry 0 = "z", 1 = "xy"; 0 <= shift < nz.
// Returns the cudaError_t of the launch, 0 on success.
int mil_pipe_copy(const float* v, const float* aux, float* out, int nz, int ny, int nx,
                  int shift, int geometry, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || shift < 0 || shift >= nz || geometry < 0 || geometry > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = (long long)ny * nx;
  const bool vec = nx % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(aux) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaError_t err = vec ? launch<float4>(v, aux, out, nz, plane / 4, shift, geometry, s)
                              : launch<float>(v, aux, out, nz, plane, shift, geometry, s);
  return static_cast<int>(err);
}

}  // extern "C"
