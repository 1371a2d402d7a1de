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
// out.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 4;
constexpr int kMaxZTaps = 128;
constexpr int kMaxXYTaps = 128;
constexpr int kMaxNyNz = 65535;
constexpr int kSmemPerSM = 233472;      // 228 KB of shared memory an SM
constexpr int kSmemPerBlock = 232448;   // 227 KB a block may use
constexpr int kSmemReserved = 1024;     // the runtime's share per block

// (rank, z taps, y taps, x taps, output planes a step) of the specialised
// instantiations: the bench 9^3 Gaussian, the tilted (17, 9, 25)
// measured-PSF class, and the dual-view / fusion PSFs of views A and B
constexpr int kSpecs[][5] = {
    {1, 9, 9, 9, 2}, {4, 17, 9, 17, 1}, {1, 25, 15, 15, 2}, {1, 15, 15, 25, 2}};
constexpr int kNumSpecs = 4;
// output tiles (rows, columns) in order of preference; at most
// kThreads * 4 outputs, so each thread owns at most one 4-wide x item
constexpr int kTiles[][2] = {{32, 32}, {16, 64}, {16, 32}, {8, 64},
                             {8, 32},  {8, 16},  {4, 16},  {4, 8}};
constexpr int kNumTiles = 8;

// switches that force a path other plans take (0 = the plan's own)
constexpr int kFlagGeneric = 1;   // the generic instantiation
constexpr int kFlagNoRing = 2;    // z taps from device memory, no ring

__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

struct Plan {
  int path;        // index into kSpecs, -1 the generic instantiation
  int ty, tx;      // output tile
  int run, nruns;  // z planes a block walks, runs along z
  int ring;        // ring depth in planes (0: z taps from device memory)
  int prefetch;    // steps in flight ahead of the one computed
  int zq;          // output planes a step
  int rg;          // ranks formed together (rank, or 1)
  int smem;        // dynamic shared bytes a block
  int blocks_per_sm;
};

struct Geometry {
  int hy, hx;   // z-sum tile: the output tile plus the y/x stencil halo
  int iy, ix;   // a ring plane (or, without a ring, the z-sum tile)
  int hxp;      // row pitch of the z-sum tile: hx rounded up to 4
  int ixp;      // row pitch of a ring plane: ix rounded up to 4
  int mp;       // row pitch of the y-stencil tile
};

__host__ __device__ inline Geometry geometry(int ty, int tx, int ly, int lx, int ry,
                                             int rx, bool ring) {
  Geometry g;
  g.hy = ty + ly - 1;
  g.hx = tx + lx - 1;
  g.iy = g.hy + (ring ? ry : 0);
  g.ix = g.hx + (ring ? rx : 0);
  g.hxp = align4(g.hx);
  g.ixp = align4(g.ix);
  g.mp = tx - 4 + 4 * ((lx + 3 + 3) / 4);
  return g;
}

// Shared bytes of a block; the kernel carves its buffer in this order:
// z taps [s][4], y and x taps, ring, z sums and y-stencil tiles for zq
// planes (floats, each section 16-byte aligned, rows of 4-float
// multiples), then row and column tables and two ints a tap.
__host__ __device__ inline int smem_bytes(const Geometry& g, int ty, int ring, int rg, int zq,
                                          int rank, int nsteps, int ly, int lx) {
  const long long floats = 4LL * nsteps + align4(rank * (ly + lx)) +
                           (long long)ring * g.iy * g.ixp +
                           (long long)zq * rg * (g.hy * g.hxp + ty * g.mp);
  const long long ints = g.iy + g.ix + 2LL * nsteps;
  const long long b = 4 * (floats + ints);
  return b > 0x7fffffff ? 0x7fffffff : static_cast<int>(b);
}

int spec_index(int rank, int nsteps, int ly, int lx) {
  for (int i = 0; i < kNumSpecs; ++i)
    if (kSpecs[i][0] == rank && kSpecs[i][1] == nsteps && kSpecs[i][2] == ly &&
        kSpecs[i][3] == lx)
      return i;
  return -1;
}

// The launch plan. The plan's specialised instantiation, if any, fixes the
// output planes a step (zq); the ring holds the z window of a step and
// `prefetch` steps' planes more (nsteps - 1 + zq (prefetch + 1)). Among
// the tiles, prefetch depths (2, then 1) and rank groups that fit a block, take the one with the most outputs in flight per
// SM (tile area x resident blocks, at most 2 by shared memory) times the
// outputs' share of the z-sum tile (the z stage's work grows with the
// halo), ties to more blocks, then to the order of kTiles; a ring before
// none. Then the number of runs along z that minimises waves x (run +
// planes to fill the ring), with slots = SMs x resident blocks. Returns
// false if nothing fits.
bool make_plan(int nz, int ny, int nx, int rank, int nsteps, int ly, int lx, int ry,
               int rx, int sm_count, int flags, Plan* out) {
  const int spec = (flags & kFlagGeneric) ? -1 : spec_index(rank, nsteps, ly, lx);
  bool found = false;
  for (int use_ring = 1; use_ring >= 0 && !found; --use_ring) {
    if (use_ring && (flags & kFlagNoRing)) continue;
    double best_score = 0;
    int best_bps = 0;
    for (int t = 0; t < kNumTiles; ++t) {
      const int ty = kTiles[t][0], tx = kTiles[t][1];
      const Geometry g = geometry(ty, tx, ly, lx, ry, rx, use_ring);
      for (int pf = use_ring ? 2 : 0; pf >= (use_ring ? 1 : 0); --pf) {
        for (int rg = rank; rg >= 1; rg = (rg == 1 ? 0 : 1)) {
          if (use_ring && rg != rank) break;
          const int zq = use_ring && spec >= 0 ? kSpecs[spec][4] : 1;
          const int ring = use_ring ? nsteps - 1 + zq * (pf + 1) : 0;
          const int smem = smem_bytes(g, ty, ring, rg, zq, rank, nsteps, ly, lx);
          if (smem > kSmemPerBlock) continue;
          int bps = kSmemPerSM / (smem + kSmemReserved);
          bps = bps > 2 ? 2 : bps;
          const double score = (double)ty * tx * bps * ty * tx / ((double)g.hy * g.hx);
          if (score > best_score || (score == best_score && bps > best_bps)) {
            best_score = score;
            best_bps = bps;
            *out = Plan{ring > 0 ? spec : -1, ty, tx, 0, 0, ring, pf, zq, rg, smem, bps};
            found = true;
          }
        }
      }
    }
  }
  if (!found) return false;
  const long long tiles =
      (long long)((ny + out->ty - 1) / out->ty) * ((nx + out->tx - 1) / out->tx);
  const long long slots = (long long)sm_count * out->blocks_per_sm;
  const int fill = out->ring > 0 ? nsteps - 1 : 0;
  long long best = -1;
  for (int n = 1; n <= nz; ++n) {
    const int run = (nz + n - 1) / n;
    const int nruns = (nz + run - 1) / run;
    const long long cost = (tiles * nruns + slots - 1) / slots * (run + fill);
    if (best < 0 || cost < best) {
      best = cost;
      out->run = run;
      out->nruns = nruns;
    }
  }
  return true;
}

struct Params {
  const float* v;
  const float* aux;
  float* out;
  const float* tz;
  const int* rolls;
  const float* kty;
  const float* ktx;
  int nz, ny, nx, rank, a, nsteps, ly, oy, lx, ox;
  int dymax, dxmax;
  int mode;
  float smallvalue;
  int ty, tx, run, ring, prefetch, rg, tiles_y, tiles_x;
  Geometry g;
  int vec;        // nx % 4 == 0, aux and out 16-byte aligned: float4 rows
  int zvec;       // no roll span: the z stage reads the ring as float4
  int int_plane;  // ny * nx < 2^31: a thread's load offsets fit an int
};

// a thread's share of a ring plane, kept in registers where it fits
constexpr int kMaxLoads = 8;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R, NS, LY, LX: the plan's rank and tap counts, or 0 for the generic
// instantiation, which reads them from the parameters. ZQ: output planes a
// step (2 on the rank-1 specialised paths: each ring value loaded feeds
// the z sums of both).
template <int R, int NS, int LY, int LX, int ZQ>
__global__ void __launch_bounds__(kThreads, R == 4 ? 1 : 2)
conv3_sep_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const int rank = R ? R : p.rank;
  const int ns = NS ? NS : p.nsteps;
  const int ly = LY ? LY : p.ly;
  const int lx = LX ? LX : p.lx;
  const Geometry& g = p.g;
  const int hy = g.hy, hx = g.hx;
  const int tid = threadIdx.x;
  const int zs_tile = hy * g.hxp, mid_tile = p.ty * g.mp;

  float* s_tz = smem;                       // [ns][4], ranks past `rank` zero
  float* s_ty = s_tz + 4 * ns;              // [rank][ly]
  float* s_tx = s_ty + rank * ly;           // [rank][lx]
  float* s_ring = s_tz + 4 * ns + align4(rank * (ly + lx));   // [ring][iy][ixp]
  float* s_zs = s_ring + p.ring * g.iy * g.ixp;               // [ZQ][rg][hy][hxp]
  float* s_mid = s_zs + ZQ * p.rg * zs_tile;                  // [ZQ][rg][ty][mp]
  int* s_row = reinterpret_cast<int*>(s_mid + ZQ * p.rg * mid_tile);   // [iy]
  int* s_col = s_row + g.iy;                                            // [ix]
  int* s_t0 = s_col + g.ix;   // [ns] ring: the tap's offset in a plane; else dy mod ny
  int* s_t1 = s_t0 + ns;      // [ns] without a ring: dx mod nx

  int b = blockIdx.x;
  const int x0 = (b % p.tiles_x) * p.tx;
  b /= p.tiles_x;
  const int y0 = (b % p.tiles_y) * p.ty;
  const int z0 = (b / p.tiles_y) * p.run;
  const int nzr = min(p.run, p.nz - z0);
  const bool ring = p.ring > 0;
  // z-sum tile position (0, 0) is the source of output (y0, x0) under the
  // largest y/x stencil offsets; a ring plane starts the roll span earlier
  const int sy0 = y0 - (p.oy + ly - 1) - (ring ? p.dymax : 0);
  const int sx0 = x0 - (p.ox + lx - 1) - (ring ? p.dxmax : 0);
  for (int i = tid; i < 4 * ns; i += kThreads) {
    const int s = i >> 2, r = i & 3;
    s_tz[i] = r < rank ? p.tz[r * ns + s] : 0.f;
  }
  for (int i = tid; i < rank * ly; i += kThreads) s_ty[i] = p.kty[i];
  for (int i = tid; i < rank * lx; i += kThreads) s_tx[i] = p.ktx[i];
  for (int i = tid; i < g.iy; i += kThreads) s_row[i] = wrap(sy0 + i, p.ny);
  for (int i = tid; i < g.ix; i += kThreads) s_col[i] = wrap(sx0 + i, p.nx);
  for (int s = tid; s < ns; s += kThreads) {
    const int dy = p.rolls ? p.rolls[2 * s] : 0;
    const int dx = p.rolls ? p.rolls[2 * s + 1] : 0;
    if (ring) {
      s_t0[s] = (p.dymax - dy) * g.ixp + (p.dxmax - dx);
    } else {
      s_t0[s] = wrap(dy, p.ny);
      s_t1[s] = wrap(dx, p.nx);
    }
  }
  __syncthreads();

  const size_t plane = (size_t)p.ny * p.nx;
  const int pstride = g.iy * g.ixp;
  const int nstep = (nzr + ZQ - 1) / ZQ;   // steps of ZQ output planes
  const int total = ZQ * nstep + ns - 1;    // input planes of the run

  // a ring plane's iy x ix elements go to the threads in turn; where a
  // thread's share fits kMaxLoads and the rows are unpadded, its source
  // offsets in the plane are computed once
  const int nload = g.iy * g.ix;
  const int ldr = kThreads / g.ix, ldc = kThreads - ldr * g.ix;
  const bool pre =
      ring && p.int_plane && g.ix == g.ixp && nload <= kMaxLoads * kThreads;
  int goff[kMaxLoads];
  if (pre) {
    int r = tid / g.ix, c = tid - r * g.ix;
#pragma unroll
    for (int k = 0; k < kMaxLoads; ++k) {
      goff[k] = tid + k * kThreads < nload ? s_row[r] * p.nx + s_col[c] : 0;
      r += ldr;
      c += ldc;
      if (c >= g.ix) {
        c -= g.ix;
        ++r;
      }
    }
  }

  // ring: input plane j of the run (z0 - a + j, wrapped) into slot j % ring
  auto load_plane = [&](int j) {
    if (j >= total) return;
    const float* src = p.v + (size_t)wrap(z0 - p.a + j, p.nz) * plane;
    float* dst = s_ring + (j % p.ring) * pstride;
    if (pre) {
#pragma unroll
      for (int k = 0; k < kMaxLoads; ++k) {
        const int i = tid + k * kThreads;
        if (i < nload) cp_async4(dst + i, src + goff[k]);
      }
    } else {
      int r = tid / g.ix, c = tid - r * g.ix;
      for (int i = tid; i < nload; i += kThreads) {
        cp_async4(dst + r * g.ixp + c, src + (size_t)s_row[r] * p.nx + s_col[c]);
        r += ldr;
        c += ldc;
        if (c >= g.ix) {
          c -= g.ix;
          ++r;
        }
      }
    }
  };
  // one commit group a step: the ZQ planes step k adds to the window (the
  // first group also fills it); empty past the run's end
  auto load_step = [&](int k) {
    for (int j = k == 0 ? 0 : ns - 1 + ZQ * k; j < ns - 1 + ZQ * (k + 1); ++j) load_plane(j);
    cp_async_commit();
  };
  if (ring)
    for (int k = 0; k < p.prefetch; ++k) load_step(k);

  // the z taps and ring offsets of the specialised paths, in registers
  constexpr int kR = R ? R : 1, kNS = NS ? NS : 1;
  float wz[kR][kNS];
  int woff[kNS];
  if constexpr (NS > 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int r = 0; r < R; ++r) wz[r][s] = s_tz[4 * s + r];
      woff[s] = s_t0[s];
    }
  }

  // this thread's x item: 4 neighbouring outputs of one row, in each of the
  // step's planes
  const int xq_n = p.tx / 4;
  const int xt = tid / xq_n, xq = tid - xt * xq_n;
  const bool x_item = xt < p.ty;
  const int oy_ = y0 + xt, ox_ = x0 + 4 * xq;
  const bool y_ok = x_item && oy_ < p.ny;

  for (int q = 0; q < nstep; ++q) {
    if (ring) {
      if (p.prefetch == 2)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
    __syncthreads();   // step q's planes landed; the last step is done with zs/mid
    if (ring) load_step(q + p.prefetch);   // into the slots of step q - 1's first planes

    float ax[ZQ][4];
#pragma unroll
    for (int u = 0; u < ZQ; ++u) {
#pragma unroll
      for (int t = 0; t < 4; ++t) ax[u][t] = 0.f;
      const int zu = ZQ * q + u;
      if (p.mode != 0 && y_ok && zu < nzr) {
        const size_t orow = (size_t)(z0 + zu) * plane + (size_t)oy_ * p.nx + ox_;
        if (p.vec && ox_ < p.nx) {
          const float4 a4 = __ldg(reinterpret_cast<const float4*>(p.aux + orow));
          ax[u][0] = a4.x;
          ax[u][1] = a4.y;
          ax[u][2] = a4.z;
          ax[u][3] = a4.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (ox_ + k < p.nx) ax[u][k] = __ldg(p.aux + orow + k);
        }
      }
    }
    float acc[ZQ][4];
#pragma unroll
    for (int u = 0; u < ZQ; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[u][t] = 0.f;

    for (int g0 = 0; g0 < rank; g0 += p.rg) {
      if (g0 > 0) __syncthreads();   // the last group's x stencil is done with mid
      const int rg = min(p.rg, rank - g0);

      // ---- z stage: zs[u][r][hy][hxp] for the step's planes and the group's ranks ----
      {
        const int dr = kThreads / hx, dc = kThreads - dr * hx;
        int r0 = tid / hx, c0 = tid - r0 * hx;
        if (ring) {
          const int slot0 = (ZQ * q) % p.ring;
          if constexpr (NS > 0) {
            // slot offsets of the window's planes ZQ q .. ZQ q + NS + ZQ - 2
            int soff[NS + ZQ - 1];
#pragma unroll
            for (int s = 0; s < NS + ZQ - 1; ++s) {
              const int slot = slot0 + s;
              soff[s] = (slot >= p.ring ? slot - p.ring : slot) * pstride;
            }
            if (p.zvec) {
              // no roll span: 4 neighbouring positions a thread, float4
              // reads, each plane's value feeding every output plane it
              // reaches (taps still in ascending s for each)
              const int ng = g.hxp / 4;
              for (int i = tid; i < hy * ng; i += kThreads) {
                const int rr = i / ng, cc = 4 * (i - rr * ng);
                const float* base = s_ring + rr * g.ixp + cc;
                float za[ZQ][R][4];
#pragma unroll
                for (int u = 0; u < ZQ; ++u)
#pragma unroll
                  for (int r = 0; r < R; ++r)
#pragma unroll
                    for (int t = 0; t < 4; ++t) za[u][r][t] = 0.f;
#pragma unroll
                for (int j = 0; j < NS + ZQ - 1; ++j) {
                  const float4 val = *reinterpret_cast<const float4*>(base + soff[j]);
#pragma unroll
                  for (int u = 0; u < ZQ; ++u) {
                    const int s = j - u;
                    if (s < 0 || s >= NS) continue;
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                      za[u][r][0] = fmaf(wz[r][s], val.x, za[u][r][0]);
                      za[u][r][1] = fmaf(wz[r][s], val.y, za[u][r][1]);
                      za[u][r][2] = fmaf(wz[r][s], val.z, za[u][r][2]);
                      za[u][r][3] = fmaf(wz[r][s], val.w, za[u][r][3]);
                    }
                  }
                }
#pragma unroll
                for (int u = 0; u < ZQ; ++u)
#pragma unroll
                  for (int r = 0; r < R; ++r)
                    *reinterpret_cast<float4*>(s_zs + (u * R + r) * zs_tile + rr * g.hxp + cc) =
                        make_float4(za[u][r][0], za[u][r][1], za[u][r][2], za[u][r][3]);
              }
            } else {
              for (int i = tid; i < hy * hx; i += kThreads) {
                const float* base = s_ring + r0 * g.ixp + c0;
#pragma unroll
                for (int u = 0; u < ZQ; ++u) {
                  float za[R];
#pragma unroll
                  for (int r = 0; r < R; ++r) za[r] = 0.f;
#pragma unroll
                  for (int s = 0; s < NS; ++s) {
                    const float val = base[soff[u + s] + woff[s]];
#pragma unroll
                    for (int r = 0; r < R; ++r) za[r] = fmaf(wz[r][s], val, za[r]);
                  }
#pragma unroll
                  for (int r = 0; r < R; ++r)
                    s_zs[(u * R + r) * zs_tile + r0 * g.hxp + c0] = za[r];
                }
                c0 += dc;
                r0 += dr;
                if (c0 >= hx) {
                  c0 -= hx;
                  ++r0;
                }
              }
            }
          } else {
            // the generic instantiation: ZQ = 1, every rank in one group
            for (int i = tid; i < hy * hx; i += kThreads) {
              const float* base = s_ring + r0 * g.ixp + c0;
              float za[kMaxRank] = {0.f, 0.f, 0.f, 0.f};
              int slot = slot0;
              for (int s = 0; s < ns; ++s) {
                const float val = base[slot * pstride + s_t0[s]];
                const float4 w = reinterpret_cast<const float4*>(s_tz)[s];
                za[0] = fmaf(w.x, val, za[0]);
                za[1] = fmaf(w.y, val, za[1]);
                za[2] = fmaf(w.z, val, za[2]);
                za[3] = fmaf(w.w, val, za[3]);
                slot = slot + 1 == p.ring ? 0 : slot + 1;
              }
#pragma unroll
              for (int r = 0; r < kMaxRank; ++r)
                if (r < rg) s_zs[r * zs_tile + r0 * g.hxp + c0] = za[r];
              c0 += dc;
              r0 += dr;
              if (c0 >= hx) {
                c0 -= hx;
                ++r0;
              }
            }
          }
        } else {
          // no ring: each tap read through L2 with its wrapped (y, x) source
          for (int i = tid; i < hy * hx; i += kThreads) {
            const int row = s_row[r0], col = s_col[c0];
#pragma unroll
            for (int u = 0; u < ZQ; ++u) {
              float za[kMaxRank] = {0.f, 0.f, 0.f, 0.f};
              int zp = wrap(z0 + ZQ * q + u - p.a, p.nz);
              for (int s = 0; s < ns; ++s) {
                int yy = row - s_t0[s], xx = col - s_t1[s];
                yy = yy < 0 ? yy + p.ny : yy;
                xx = xx < 0 ? xx + p.nx : xx;
                const float val = __ldg(p.v + (size_t)zp * plane + (size_t)yy * p.nx + xx);
#pragma unroll
                for (int r = 0; r < kMaxRank; ++r)
                  if (r < rg) za[r] = fmaf(s_tz[4 * s + g0 + r], val, za[r]);
                zp = zp + 1 == p.nz ? 0 : zp + 1;
              }
#pragma unroll
              for (int r = 0; r < kMaxRank; ++r)
                if (r < rg) s_zs[(u * rg + r) * zs_tile + r0 * g.hxp + c0] = za[r];
            }
            c0 += dc;
            r0 += dr;
            if (c0 >= hx) {
              c0 -= hx;
              ++r0;
            }
          }
        }
      }
      __syncthreads();

      // ---- y stage: mid[u][r][t][c] = sum_k ty[r][k] zs[u][r][t + ly-1-k][c] ----
      {
        const int per = (p.ty / 4) * hx;
        for (int i = tid; i < ZQ * per; i += kThreads) {
          const int u = i / per, gq = (i - u * per) / hx, c = i - u * per - gq * hx;
          for (int r = 0; r < rg; ++r) {
            const float* col = s_zs + (u * rg + r) * zs_tile + 4 * gq * g.hxp + c;
            const float* ky = s_ty + (g0 + r) * ly;
            float o[4] = {0.f, 0.f, 0.f, 0.f};
            if constexpr (LY > 0) {
              float vc[LY + 3];
#pragma unroll
              for (int j = 0; j < LY + 3; ++j) vc[j] = col[j * g.hxp];
#pragma unroll
              for (int k = 0; k < LY; ++k) {
                const float w = ky[k];
#pragma unroll
                for (int t = 0; t < 4; ++t) o[t] = fmaf(w, vc[t + LY - 1 - k], o[t]);
              }
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t)
                for (int k = 0; k < ly; ++k)
                  o[t] = fmaf(ky[k], col[(t + ly - 1 - k) * g.hxp], o[t]);
            }
            float* m = s_mid + (u * rg + r) * mid_tile + 4 * gq * g.mp + c;
#pragma unroll
            for (int t = 0; t < 4; ++t) m[t * g.mp] = o[t];
          }
        }
      }
      __syncthreads();

      // ---- x stage: acc += sum_k tx[r][k] mid[u][r][t][x + lx-1-k], r ascending ----
      if (x_item) {
#pragma unroll
        for (int u = 0; u < ZQ; ++u) {
          for (int r = 0; r < rg; ++r) {
            const float* row = s_mid + (u * rg + r) * mid_tile + xt * g.mp + 4 * xq;
            const float* kx = s_tx + (g0 + r) * lx;
            float o[4] = {0.f, 0.f, 0.f, 0.f};
            if constexpr (LX > 0) {
              constexpr int kV = (LX + 3 + 3) / 4;
              float vr[4 * kV];
#pragma unroll
              for (int j = 0; j < kV; ++j) {
                const float4 f = reinterpret_cast<const float4*>(row)[j];
                vr[4 * j] = f.x;
                vr[4 * j + 1] = f.y;
                vr[4 * j + 2] = f.z;
                vr[4 * j + 3] = f.w;
              }
#pragma unroll
              for (int k = 0; k < LX; ++k) {
                const float w = kx[k];
#pragma unroll
                for (int t = 0; t < 4; ++t) o[t] = fmaf(w, vr[t + LX - 1 - k], o[t]);
              }
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t)
                for (int k = 0; k < lx; ++k) o[t] = fmaf(kx[k], row[t + lx - 1 - k], o[t]);
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) acc[u][t] += o[t];
          }
        }
      }
    }

    // ---- epilogue and store ----
#pragma unroll
    for (int u = 0; u < ZQ; ++u) {
      const int zu = ZQ * q + u;
      if (!y_ok || zu >= nzr) continue;
      const size_t orow = (size_t)(z0 + zu) * plane + (size_t)oy_ * p.nx + ox_;
      float o[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float val = acc[u][t];
        if (p.mode == 1) {
          val = ax[u][t] / val;
        } else if (p.mode == 2) {
          val = fmaxf(ax[u][t] * val, p.smallvalue);
        }
        o[t] = val;
      }
      if (p.vec && ox_ < p.nx) {
        *reinterpret_cast<float4*>(p.out + orow) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (ox_ + t < p.nx) p.out[orow + t] = o[t];
      }
    }
  }
  if (ring) cp_async_wait<0>();   // no copy outlives the block
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

bool valid(int nz, int ny, int nx, int rank, int nsteps, int ly, int lx, int ry, int rx) {
  return nz >= 1 && ny >= 1 && nx >= 1 && ny <= kMaxNyNz && nz <= kMaxNyNz && rank >= 1 &&
         rank <= kMaxRank && nsteps >= 1 && nsteps <= kMaxZTaps && ly >= 1 &&
         ly <= kMaxXYTaps && lx >= 1 && lx <= kMaxXYTaps && ry >= 0 && rx >= 0;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
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
  Params prm;
  prm.v = v;
  prm.aux = aux;
  prm.out = out;
  prm.tz = tz;
  prm.rolls = rolls;
  prm.kty = ty;
  prm.ktx = tx;
  prm.nz = nz;
  prm.ny = ny;
  prm.nx = nx;
  prm.rank = rank;
  prm.a = a;
  prm.nsteps = nsteps;
  prm.ly = ly;
  prm.oy = oy;
  prm.lx = lx;
  prm.ox = ox;
  prm.dymax = dymax;
  prm.dxmax = dxmax;
  prm.mode = mode;
  prm.smallvalue = smallvalue;
  prm.ty = pl.ty;
  prm.tx = pl.tx;
  prm.run = pl.run;
  prm.ring = pl.ring;
  prm.prefetch = pl.prefetch;
  prm.rg = pl.rg;
  prm.tiles_y = (ny + pl.ty - 1) / pl.ty;
  prm.tiles_x = (nx + pl.tx - 1) / pl.tx;
  prm.g = geometry(pl.ty, pl.tx, ly, lx, ry, rx, pl.ring > 0);
  prm.vec = nx % 4 == 0 && reinterpret_cast<size_t>(aux) % 16 == 0 &&
            reinterpret_cast<size_t>(out) % 16 == 0;
  prm.zvec = ry == 0 && rx == 0;
  prm.int_plane = (long long)ny * nx < (1LL << 31);
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
