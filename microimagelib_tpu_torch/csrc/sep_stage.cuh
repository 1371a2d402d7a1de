// The separable convolution's block stage, shared by K1 (csrc/conv_sep.cu,
// one stage a launch) and K2 (csrc/rl_fused.cu, both RL stages in one
// launch): the launch plan (make_plan, mirrored in
// kernels/conv_sep.py::launch_plan), the parameters, and sep_stage, which
// computes one output tile for a run of z planes. The design and its
// rounding order are described in csrc/conv_sep.cu.

#pragma once

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

// The parameters of one stage on plan `pl` (mode 0 plain, 1 ratio, 2 update);
// rolls may be NULL, with dymax = dxmax = ry = rx = 0.
inline Params stage_params(const Plan& pl, const float* v, const float* aux, float* out,
                           const float* tz, const int* rolls, const float* ty, const float* tx,
                           int nz, int ny, int nx, int rank, int a, int nsteps, int ly, int oy,
                           int lx, int ox, int dymax, int dxmax, int ry, int rx, int mode,
                           float smallvalue) {
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
  return prm;
}

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

// Plane z of a plain (nz, ny, nx) volume; loads through the read-only path.
struct VolumeIn {
  const float* base;
  size_t plane;
  __device__ __forceinline__ const float* at(int z) const { return base + (size_t)z * plane; }
  static __device__ __forceinline__ float load(const float* q) { return __ldg(q); }
};

struct VolumeOut {
  float* base;
  size_t plane;
  __device__ __forceinline__ float* at(int z) const { return base + (size_t)z * plane; }
};

// Plane z of a store that keeps planes [0, head) in place and every later
// plane in a ring of `ring` slots after them: a plane written in the same
// launch, so loads go through L2 (the coherent path), never the read-only one.
struct RingStore {
  float* base;
  size_t plane;
  int head, ring;
  __device__ __forceinline__ float* at(int z) const {
    return base + (size_t)(z < head ? z : head + (z - head) % ring) * plane;
  }
  static __device__ __forceinline__ float load(const float* q) { return __ldcg(q); }
};

// One block's stage: the output tile (y0, x0) of p's plan for the nzr
// planes z0 .. z0 + nzr - 1, input planes through `in`, output planes
// through `out`, in the block's `smem` (p.smem bytes, 16-byte aligned).
// R, NS, LY, LX: the plan's rank and tap counts, or 0 for the generic
// instantiation, which reads them from the parameters. ZQ: output planes a
// step (2 on the rank-1 specialised paths: each ring value loaded feeds
// the z sums of both). The caller syncs the block before a second call
// reuses `smem`.
template <int R, int NS, int LY, int LX, int ZQ, class In, class Out>
__device__ __forceinline__ void sep_stage(const Params& p, const In& in, const Out& out,
                                          int x0, int y0, int z0, int nzr, float* smem) {
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
    const float* src = in.at(wrap(z0 - p.a + j, p.nz));
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
                const float val = In::load(in.at(zp) + (size_t)yy * p.nx + xx);
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
      float* orow = out.at(z0 + zu) + (size_t)oy_ * p.nx + ox_;
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
        *reinterpret_cast<float4*>(orow) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (ox_ + t < p.nx) orow[t] = o[t];
      }
    }
  }
  if (ring) cp_async_wait<0>();   // no copy outlives the block
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
