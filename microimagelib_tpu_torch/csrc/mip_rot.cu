// K8: the rotating MIP's factored route for Hopper (sm_90a).
//
// Replaces the JAX package's factored route for the rotating MIP,
// microimagelib_tpu/models/projections.py::_rotate_and_mip_all_factored
// (per-frame 2-tap tables contracted against the volume by two einsums per
// z' chunk on the TPU's matrix unit). It is not a Pallas kernel: XLA runs
// that route there. A rotation about x or y leaves that axis invariant, so
// each frame is one 2-D bilinear resample of the (a, b) plane, the same for
// every invariant row r, followed by a max over the rotated grid's z'. On
// the source made contiguous as src[r, a, b] (rows, na, nb) it computes,
// for frame f, row r and output column q,
//   frame[f, r, q] = max(0, max_z' sum_{i,j in {0,1}} wa_i * wb_j * src[r, a_i, b_j])
// with, per axis (as the JAX tap tables), the coordinate
//   cb = (kb[f] * q + kbz[f] * z') + kb0[f],  ca = (ka[f] * q + kaz[f] * z') + ka0[f]
// rounded after each operation, never contracted into an FMA: the gather
// route's order (ops/affine.py `_coords`; kernels/mip_rot.py `coordinate`),
// so both sample at the same points. Valid where
// -0.5 <= c < n - 0.5, i0 = floor(c), both taps clamped into [0, n - 1] and
// weights 1 - (c - i0) and c - i0. A sample outside the joint box is zero:
// the zero that the one-hot tables' validity gives it, which the clip at 0
// absorbs, so the kernel skips it. Frames are written in the final layout:
// (n, rows, po) for a rotation about y, (n, po, rows) for one about x.
//
// What bounds it on this card: operations. At (320, 320, 320) about y with
// 36 frames it reads a 131 MB volume and writes 21 MB of frames (45 us at
// 3.35 TB/s), against 2.36e9 samples, about half inside the box, at ~10
// flops each (0.2-0.4 ms at the fp32 rate). The one-hot form would do 2 x
// rows x (na x nb) x (zo x po) flops a frame, 1.3e13 at that shape.
//
// What the design does about it, simply:
//   * One block per (row r, tile of kThreads output columns q), the row
//     index the slower grid axis, so the blocks of one row run together and
//     share its plane in L2; the block loops over every frame, so the
//     plane is read from device memory about once for all of them.
//   * One thread per q: it walks z' with the max in a register and reads
//     the four taps through the read-only path (__ldg).
// Skipping the z' outside the box per column, and staging the plane's band
// in shared memory, are left for later.
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

// coef: 6 floats a frame, (kb, kbz, kb0, ka, kaz, ka0).
__global__ void __launch_bounds__(kThreads)
mip_rot_kernel(const float* __restrict__ src, const float* __restrict__ coef,
               float* __restrict__ out, int nframes, int rows, int na, int nb, int zo, int po,
               int transpose) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  if (q >= po) return;
  const float* __restrict__ plane = src + static_cast<size_t>(r) * na * nb;
  const float qf = static_cast<float>(q);
  const float hb = nb - 0.5f, ha = na - 0.5f;
  for (int f = 0; f < nframes; ++f) {
    const float* c = coef + 6 * f;
    const float kb = __ldg(c), kbz = __ldg(c + 1), kb0 = __ldg(c + 2);
    const float ka = __ldg(c + 3), kaz = __ldg(c + 4), ka0 = __ldg(c + 5);
    float acc = 0.0f;
    for (int z = 0; z < zo; ++z) {
      const float zf = static_cast<float>(z);
      const float cb = __fadd_rn(__fadd_rn(__fmul_rn(kb, qf), __fmul_rn(kbz, zf)), kb0);
      const float ca = __fadd_rn(__fadd_rn(__fmul_rn(ka, qf), __fmul_rn(kaz, zf)), ka0);
      if (!(cb >= -0.5f && cb < hb && ca >= -0.5f && ca < ha)) continue;
      const float b0 = floorf(cb), a0 = floorf(ca);
      const float fb = cb - b0, fa = ca - a0;
      const int ib = static_cast<int>(b0), ia = static_cast<int>(a0);
      // inside the box floor(c) is in [-1, n - 1]: one side of each clamp binds
      const int b0i = max(ib, 0), b1i = min(ib + 1, nb - 1);
      const int a0i = max(ia, 0), a1i = min(ia + 1, na - 1);
      const float* row0 = plane + static_cast<size_t>(a0i) * nb;
      const float* row1 = plane + static_cast<size_t>(a1i) * nb;
      const float wb0 = 1.0f - fb;
      const float v0 = fmaf(fb, __ldg(row0 + b1i), wb0 * __ldg(row0 + b0i));
      const float v1 = fmaf(fb, __ldg(row1 + b1i), wb0 * __ldg(row1 + b0i));
      acc = fmaxf(acc, fmaf(fa, v1, (1.0f - fa) * v0));
    }
    const size_t o = transpose ? (static_cast<size_t>(f) * po + q) * rows + r
                               : (static_cast<size_t>(f) * rows + r) * po + q;
    out[o] = acc;
  }
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

// One K8 launch on `stream`: `src` the (rows, na, nb) C-contiguous source,
// `coef` 6 x nframes device floats, `out` nframes x rows x po floats
// (transpose = 0) or nframes x po x rows (transpose = 1). Returns the
// cudaError_t of the launch, 0 on success.
int mil_mip_rot(const float* src, const float* coef, float* out, int nframes, int rows, int na,
                int nb, int zo, int po, int transpose, void* stream) {
  if (nframes < 1 || rows < 1 || rows > 65535 || na < 1 || nb < 1 || zo < 1 || po < 1 ||
      transpose < 0 || transpose > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((po + kThreads - 1) / kThreads, rows);
  mip_rot_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, coef, out, nframes, rows, na, nb, zo, po, transpose);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
