// K1: separable compact-PSF circular 3-D convolution with the fused RL
// epilogue, for Hopper (sm_90a), in one launch.
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
// What bounds it on this card: memory traffic, then shared-memory traffic.
// The work needs v and aux read once and out written once (12 bytes a
// voxel); the taps are short stencils (9 to 25 an axis on the main paths),
// so the fp32 FMAs are far below the memory time. The first version ran
// two launches and wrote R rank volumes of z sums to device memory and read
// them back (5.37 GB against 3.22 GB per 512^3 iteration).
//
// What this design does about it:
//   * One launch; the z sums never leave the SM. A block owns a ty x tx
//     output tile and walks a run of consecutive z planes. Each input plane
//     of the run is loaded once, as its tile plus the y/x halo of the
//     stencils widened by the plan's roll span, into a ring of planes in
//     shared memory; per output plane the block forms every rank's z sum at
//     each halo position from the ring (zs), runs the y stencil (mid), then
//     the x stencil, sums the ranks and applies the epilogue.
//   * Asynchronous loads: the planes `prefetch` steps ahead are in flight
//     (cp.async, one commit group a step, waited per step) while the
//     current step is computed. With circular wrap a TMA box cannot express
//     the wrapped edge tiles (TMA fills out-of-bounds with zeros, not with
//     the other side), so the loads go through the block's wrapped row and
//     column tables, one 4-byte cp.async an element. TMA for the interior
//     tiles is a later step.
//   * Register blocking: a thread forms the y stencil for 4 rows of one
//     column from registers (4 + ly - 1 loads instead of 4 ly) and the x
//     stencil for 4 neighbouring outputs of one row from float4 loads; the
//     z taps of the specialised paths stay in registers. Without a roll
//     span a thread forms the z sums of 4 neighbouring positions from
//     float4 ring reads, and the rank-1 specialised paths compute two
//     output planes a step (ZQ), each ring value feeding both.
//   * Specialisation: the (rank, z, y, x tap counts) of the main paths
//     (kSpecs) compile to fully unrolled stages; every other plan takes the
//     generic instantiation, whose loops run to the plan's counts. Where no
//     ring fits a block's shared memory (z taps and y/x halo up to 128), the
//     generic path reads its z taps straight from device memory (through
//     L2) and may form one rank at a time: still one launch.
//   * Rounding: every output keeps the two-launch version's arithmetic
//     order, so both give the same bits: z taps as fmaf from 0 in ascending
//     s; y taps as fmaf in ascending k; x taps likewise; ranks added with
//     += in ascending r; then the epilogue. Streaming the planes in
//     ascending z hands each output its z taps in ascending s. No atomics:
//     two launches give identical bits.
//
// The tile, run, ring depth and shared bytes are planned on the host
// (make_plan; mirrored in kernels/conv_sep.py::launch_plan, held equal on
// the card through mil_conv3_sep_plan). The kernel launches on the caller's
// stream, does not synchronise and allocates nothing: the wrapper allocates
// out. The plan and the block's stage (sep_stage) live in csrc/sep_stage.cuh,
// which K2 (csrc/rl_fused.cu) runs twice in one launch.

#include "sep_stage.cuh"

namespace {

// R, NS, LY, LX, ZQ: sep_stage's instantiation. A block is one (tile, run).
template <int R, int NS, int LY, int LX, int ZQ>
__global__ void __launch_bounds__(kThreads, R == 4 ? 1 : 2)
conv3_sep_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  int b = blockIdx.x;
  const int x0 = (b % p.tiles_x) * p.tx;
  b /= p.tiles_x;
  const int y0 = (b % p.tiles_y) * p.ty;
  const int z0 = (b / p.tiles_y) * p.run;
  const size_t plane = (size_t)p.ny * p.nx;
  sep_stage<R, NS, LY, LX, ZQ>(p, VolumeIn{p.v, plane}, VolumeOut{p.out, plane}, x0, y0, z0,
                               min(p.run, p.nz - z0), smem);
}

using KernelFn = void (*)(const Params);

template <int I>
KernelFn spec_kernel() {
  return conv3_sep_kernel<kSpecs[I][0], kSpecs[I][1], kSpecs[I][2], kSpecs[I][3], kSpecs[I][4]>;
}

KernelFn kernel_for(int path) {
  switch (path) {
    case 0: return spec_kernel<0>();
    case 1: return spec_kernel<1>();
    case 2: return spec_kernel<2>();
    case 3: return spec_kernel<3>();
    default: return conv3_sep_kernel<0, 0, 0, 0, 1>;
  }
}

}  // namespace

extern "C" {

const char* mil_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for a (nz, ny, nx) grid and a plan of `rank`, `nsteps` z
// taps, ly / lx y / x taps and roll spans ry = max dy - min dy, rx likewise,
// on a card of `sms` SMs, under the switches `flags`: out[0..10] = path
// (kSpecs index, -1 generic), tile rows, tile columns, run, runs, ring depth,
// prefetch, output planes a step, rank group, shared bytes, resident blocks
// per SM by shared memory. Returns 0, or cudaErrorInvalidValue where K1 does not take it.
int mil_conv3_sep_plan(int nz, int ny, int nx, int rank, int nsteps, int ly, int lx,
                       int ry, int rx, int sms, int flags, int* out) {
  Plan pl;
  if (!valid(nz, ny, nx, rank, nsteps, ly, lx, ry, rx) || sms < 1 ||
      !make_plan(nz, ny, nx, rank, nsteps, ly, lx, ry, rx, sms, flags, &pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vals[11] = {pl.path, pl.ty,       pl.tx, pl.run,  pl.nruns,        pl.ring,
                        pl.prefetch, pl.zq, pl.rg, pl.smem, pl.blocks_per_sm};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

// What instantiation `path` (kSpecs index, -1 generic) compiled to, with
// `smem` dynamic shared bytes: out[0] registers, out[1] spilled bytes a
// thread, out[2] static shared bytes, out[3] resident blocks per SM.
// Returns a cudaError_t, 0 on success.
int mil_conv3_sep_attrs(int path, int smem, int* out) {
  const KernelFn fn = kernel_for(path);
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(&a, fn)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

// One K1 launch on `stream`. `rolls` may be NULL (no per-tap rolls);
// dymin..dxmax bound its (dy, dx) (all 0 without rolls). `flags`: the
// switches that force the generic or the ring-less path, 0 for the plan's
// own. Returns the cudaError_t of the
// launch, 0 on success.
int mil_conv3_sep(const float* v, const float* aux, float* out, const float* tz,
                  const int* rolls, const float* ty, const float* tx, int nz, int ny,
                  int nx, int rank, int a, int nsteps, int ly, int oy, int lx, int ox,
                  int dymin, int dymax, int dxmin, int dxmax, int mode, float smallvalue,
                  int flags, void* stream) {
  const int ry = dymax - dymin, rx = dxmax - dxmin;
  if (!valid(nz, ny, nx, rank, nsteps, ly, lx, ry, rx) || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  Plan pl;
  if (!make_plan(nz, ny, nx, rank, nsteps, ly, lx, ry, rx, sms, flags, &pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm = stage_params(pl, v, aux, out, tz, rolls, ty, tx, nz, ny, nx, rank, a,
                                  nsteps, ly, oy, lx, ox, dymax, dxmax, ry, rx, mode,
                                  smallvalue);
  const KernelFn fn = kernel_for(pl.path);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)prm.tiles_y * prm.tiles_x * pl.nruns;
  fn<<<static_cast<unsigned>(blocks), kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"