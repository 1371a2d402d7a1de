// K8: the rotating MIP's factored route for Hopper (sm_90a).
//
// Replaces the JAX package's factored route for the rotating MIP,
// microimagelib_tpu/models/projections.py::_rotate_and_mip_all_factored
// (per-frame 2-tap tables contracted against the volume by two einsums per
// z' chunk on the TPU's matrix unit). It is not a Pallas kernel: XLA runs
// that route there. A rotation about x or y leaves that axis invariant, so
// each frame is one 2-D bilinear resample of the (a, b) plane, the same for
// every invariant row r, followed by a max over the rotated grid's z'. It
// computes, for frame f, row r and output column q,
//   frame[f, r, q] = max(0, max_z' sum_{i,j in {0,1}} wa_i * wb_j * src[a_i, b_j, r])
// with, per axis (as the JAX tap tables), the coordinate
//   cb = (kb[f] * q + kbz[f] * z') + kb0[f],  ca = (ka[f] * q + kaz[f] * z') + ka0[f]
// rounded after each operation, never contracted into an FMA: the gather
// route's order (ops/affine.py `_coords`; kernels/mip_rot.py `coordinate`),
// so both sample at the same points. Valid where
// -0.5 <= c < n - 0.5, i0 = floor(c), both taps clamped into [0, n - 1] and
// weights 1 - (c - i0) and c - i0. A sample outside the joint box is zero:
// the zero that the one-hot tables' validity gives it, which the clip at 0
// absorbs, so the kernel skips it.
//
// The layout. Every invariant row samples the same (a, b) points with the
// same weights, so the rows go across a warp's lanes: the source is laid
// out rows innermost, src[a, b, r] (na, nb, rows) C-contiguous (a rotation
// about x reads the volume as it is; one about y reads it as (z, x, y)).
// One warp serves one (frame f, output column q, group of 32 rows), and
// each of a sample's four taps is one coalesced 128-byte load. Lanes past
// the last row load the last row and store nothing.
//
// The samples. A sample's coordinates, box test, taps and weights are the
// same on every lane, and computing them on every lane (two floors and two
// float-to-int conversions among them, at a quarter of the instruction rate)
// cost more than its four loads. So the warp walks z' in chunks of 32:
// lane l computes sample z0 + l (its tap pixel a0 * nb + b0, whether a1
// and b1 step past a0 and b0 or sit clamped on them, whether it is inside
// the box, fa and fb) into a 512-byte slot of shared memory, and the warp
// then takes the chunk's samples in order, each read as one 16-byte word
// that every lane reads alike (a broadcast), loads its four taps and folds
// the same fmaf / fmaxf expression as before into the max. No branch
// diverges; the inner loop is unrolled 8 deep so that several samples'
// loads are in flight.
//
// The interval. Each rounded coordinate is monotone in z' (every rounded
// step is), so the z' inside the box on one axis form an interval, and so
// do those inside the joint box. A warp finds its interval's ends by
// bisection on the rounded coordinate itself (four searches of
// ceil(log2(zo + 1)) steps, uniform across the warp) and walks only that
// interval; the per-sample box test stays. The samples taken, their
// arithmetic and their order are those of the one-thread-a-column kernel
// this replaces, so every frame is the same to the bit. (A float solve of
// the two linear inequalities, widened by one step, is not enough: where
// kz * z' is near an ulp of k * q, the rounded coordinate moves in steps
// of that ulp and crosses a bound many z' from where the real line does;
// with k * q = 100 and kz = 1e-7 it enters the box at z' = 39, the real
// line at 76.)
//
// The grid. blockIdx.y is the row group, the slowest grid axis, so the
// blocks in flight read one (na, nb, 32-row) slab (13 MB at 320^2) from
// L2 and the volume comes from device memory about once. blockIdx.x is
// (frame, tile of kWarps adjacent q), q fastest: a block's warps walk
// parallel lines one column apart, whose tap lines overlap in L1.
// Frames are written in the final layout: (n, po, rows) about x, where the
// lanes store contiguously, and (n, rows, po) about y, where each lane's
// store is its own sector; the block's kWarps adjacent q fill 32 bytes of
// each row, so L2 merges them into whole sectors (the frames are 21 MB at
// 320^3) and no shared-memory transpose is staged.
//
// What bounds it on this card. The least time is set by operations: at
// (320, 320, 320) about y with 36 frames, 1.18e9 samples inside the box at
// ~10 flops each take 0.18 ms at the fp32 rate, against a 131 MB volume
// read once and 21 MB of frames written once (45 us at 3.35 TB/s). On an
// NVIDIA H100 80GB HBM3 at 700 W (tools/k8_times.py, device time) the
// kernel takes 2.18-2.29 ms there about either axis, 12-13x that bound
// (the one-thread-a-column kernel it replaces: 9.96-10.13 ms in the same
// run), 3.45-3.64 ms at (320, 512, 320) and 0.181 ms at (128, 128, 128),
// with 32 registers, no spill, 4 KB of shared memory and 8 blocks of 256
// threads an SM. Each (frame, row group) reads its slab from L2 (36 x 10 x
// 13 MB = 4.7 GB at 320^3; some 1 ms at an L2 rate of ~5 TB/s, which
// was not measured) plus what L1 misses
// of the 512 bytes a sample's taps span; putting more samples' loads in
// flight was worth more than any block shape, so the kernel is read as
// bound by the latency and rate of those L2 reads.
// Left for a later PR: frames that share a slab tile on one SM (a
// persistent grid, or TMA loads of the slab's tiles into shared memory)
// to cut the L2 traffic below one slab read a frame.
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;                 // warps a block: adjacent q, one frame
constexpr int kThreads = 32 * kWarps;

// One axis's source coordinate, rounded after each operation.
__device__ __forceinline__ float coord(float k, float kz, float k0, float qf, int z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k, qf), __fmul_rn(kz, static_cast<float>(z))), k0);
}

// The first z in [0, zo] at which pred holds, pred false then true in z.
template <typename Pred>
__device__ __forceinline__ int first_true(int zo, Pred pred) {
  int lo = 0, hi = zo;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(mid)) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// [*lo, *hi): the z' at which -0.5 <= coord(k, kz, k0, q, z') < n - 0.5.
// The coordinate is non-decreasing in z' for kz >= 0 and non-increasing
// for kz < 0, each bound a partition point of a monotone predicate.
__device__ __forceinline__ void axis_interval(float k, float kz, float k0, float qf, int n,
                                              int zo, int* lo, int* hi) {
  const float h = n - 0.5f;
  if (kz >= 0.0f) {
    *lo = first_true(zo, [&](int z) { return coord(k, kz, k0, qf, z) >= -0.5f; });
    *hi = first_true(zo, [&](int z) { return coord(k, kz, k0, qf, z) >= h; });
  } else {
    *lo = first_true(zo, [&](int z) { return coord(k, kz, k0, qf, z) < h; });
    *hi = first_true(zo, [&](int z) { return coord(k, kz, k0, qf, z) < -0.5f; });
  }
}

// coef: 6 floats a frame, (kb, kbz, kb0, ka, kaz, ka0).
__global__ void __launch_bounds__(kThreads)
mip_rot_kernel(const float* __restrict__ src, const float* __restrict__ coef,
               float* __restrict__ out, int rows, int na, int nb, int zo, int po, int qtiles,
               int transpose) {
  const int f = blockIdx.x / qtiles;
  const int q = (blockIdx.x - f * qtiles) * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (q >= po) return;                    // the whole warp
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int r = blockIdx.y * 32 + lane;
  const float* __restrict__ s = src + min(r, rows - 1);
  const float* c = coef + 6 * f;
  const float kb = __ldg(c), kbz = __ldg(c + 1), kb0 = __ldg(c + 2);
  const float ka = __ldg(c + 3), kaz = __ldg(c + 4), ka0 = __ldg(c + 5);
  const float qf = static_cast<float>(q);
  int lob, hib, loa, hia;
  axis_interval(kb, kbz, kb0, qf, nb, zo, &lob, &hib);
  axis_interval(ka, kaz, ka0, qf, na, zo, &loa, &hia);
  const int lo = max(lob, loa), hi = min(hib, hia);
  const float hb = nb - 0.5f, ha = na - 0.5f;
  const size_t rs = static_cast<size_t>(rows);
  const size_t as = static_cast<size_t>(nb) * rs;   // one step in a
  // this warp's chunk of 32 samples: (tap pixel a0 * nb + b0, flags, fa, fb)
  __shared__ float4 chunk[kWarps][32];
  float4* mine = chunk[threadIdx.x >> 5];
  float acc = 0.0f;
  for (int z0 = lo; z0 < hi; z0 += 32) {
    {  // lane l: the coordinates, taps and weights of sample z0 + l
      const int z = z0 + lane;
      const float cb = coord(kb, kbz, kb0, qf, z);
      const float ca = coord(ka, kaz, ka0, qf, z);
      const bool valid = z < hi && cb >= -0.5f && cb < hb && ca >= -0.5f && ca < ha;
      const float b0 = floorf(cb), a0 = floorf(ca);
      const float fb = cb - b0, fa = ca - a0;
      const int ib = static_cast<int>(b0), ia = static_cast<int>(a0);
      // inside the box floor(c) is in [-1, n - 1]: one side of each clamp
      // binds (the outer min only bounds an invalid lane's index)
      const int b0i = min(max(ib, 0), nb - 1), b1i = min(ib + 1, nb - 1);
      const int a0i = min(max(ia, 0), na - 1), a1i = min(ia + 1, na - 1);
      const int flags = (a1i != a0i) | ((b1i != b0i) << 1) | (valid << 2);
      mine[lane] = make_float4(__int_as_float(a0i * nb + b0i), __int_as_float(flags), fa, fb);
    }
    __syncwarp();
    const int n = min(32, hi - z0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 e = mine[j];                         // one word, every lane
      const int flags = __float_as_int(e.y);
      if (!(flags & 4)) continue;
      const float fa = e.z, fb = e.w;
      const float* row0 = s + static_cast<size_t>(__float_as_int(e.x)) * rs;
      const float* row1 = row0 + ((flags & 1) ? as : 0);
      const size_t o1 = (flags & 2) ? rs : 0;
      const float wb0 = 1.0f - fb;
      const float v0 = fmaf(fb, __ldg(row0 + o1), wb0 * __ldg(row0));
      const float v1 = fmaf(fb, __ldg(row1 + o1), wb0 * __ldg(row1));
      acc = fmaxf(acc, fmaf(fa, v1, (1.0f - fa) * v0));
    }
    __syncwarp();
  }
  if (r >= rows) return;
  const size_t o = transpose ? (static_cast<size_t>(f) * po + q) * rows + r
                             : (static_cast<size_t>(f) * rows + r) * po + q;
  out[o] = acc;
}

}  // namespace

extern "C" {

// What K8 compiled to: out[0] registers, out[1] spilled (local) bytes a
// thread, out[2] static shared bytes, out[3] resident blocks per SM, out[4]
// threads a block. Returns a cudaError_t, 0 on success.
int mil_mip_rot_attrs(int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err;
  if ((err = cudaFuncGetAttributes(&a, mip_rot_kernel)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mip_rot_kernel, kThreads,
                                                            0)) != cudaSuccess)
    return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  out[4] = kThreads;
  return 0;
}

// One K8 launch on `stream`: `src` the (na, nb, rows) C-contiguous source,
// `coef` 6 x nframes device floats, `out` nframes x rows x po floats
// (transpose = 0) or nframes x po x rows (transpose = 1). Returns the
// cudaError_t of the launch, 0 on success.
int mil_mip_rot(const float* src, const float* coef, float* out, int nframes, int rows, int na,
                int nb, int zo, int po, int transpose, void* stream) {
  if (nframes < 1 || rows < 1 || na < 1 || nb < 1 || zo < 1 || po < 1 || transpose < 0 ||
      transpose > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (rows + 31) / 32;
  const long long qtiles = (po + kWarps - 1) / kWarps;
  if (groups > 65535 || static_cast<long long>(na) * nb > INT_MAX ||
      qtiles * nframes > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(qtiles * nframes), groups);
  mip_rot_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, coef, out, rows, na, nb, zo, po, static_cast<int>(qtiles), transpose);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
