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
//
// The plan, the task walk, the gather, the per-block bodies of K4/K5
// (corr_block) and K6 (corr_nprobe_block_with) and the reductions live in
// corr_body.cuh, which K9 (reg_ladder.cu) includes too: its evaluations run
// the same bodies.

#include "corr_body.cuh"

namespace {

struct MatN {
  float m[kMaxProbes * 12];
};

// K5 (GRAD = false, 2 values) or K4 (GRAD = true, 26): the block's row,
// then the last block's column sum into `out`.
template <bool GRAD, int VX, typename IDX>
__global__ void __launch_bounds__(kThreads, GRAD ? kResidentGrad : kResidentSums)
corr_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
            unsigned* __restrict__ ticket, double* __restrict__ partials,
            double* __restrict__ out, Mat mat, Geo g) {
  constexpr int NV = GRAD ? 26 : 2;
  corr_block<GRAD, VX, IDX>(src, tgt, mat.m, g, blockIdx.x, partials + blockIdx.x, gridDim.x);
  if (!last_block(ticket)) return;
  sum_columns<NV>(partials, gridDim.x, NV, out);
  if (threadIdx.x == 0) *ticket = 0u;
}

// K6: K5's sums for n <= kMaxProbes matrices in one pass
// (corr_body.cuh::corr_nprobe_block_with). K5's residency, so K5's plan is
// one wave here too. Partial column 2i + k holds probe i's value k.
template <int VX, typename IDX>
__global__ void __launch_bounds__(kThreads, kResidentSums)
corr_nprobe_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                   unsigned* __restrict__ ticket, double* __restrict__ partials,
                   double* __restrict__ out, MatN mats, int n, Geo g) {
  corr_nprobe_block_with<VX, IDX, const float*>(src, tgt, mats.m, n, g, blockIdx.x,
                                                partials + blockIdx.x, gridDim.x);
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
