// K2: one whole Richardson-Lucy iteration in one launch, for Hopper (sm_90a):
//   out = max(est * bp(img / fwd(est)), smallvalue)
// with fwd and bp two separable compact-PSF circular convolutions planned
// as for K1 (ops/conv_sep.py::SepPlan, no per-tap rolls).
//
// Replaces the JAX package's Pallas TPU kernel
// microimagelib_tpu/ops/conv_sep.py::_rl_kernel (launched by
// _rl_iter_fused). That kernel walks a sequential grid of z slabs and keeps
// a three-slab ring of the ratio per stage in VMEM, so the ratio never
// leaves the chip. CUDA blocks run in no order, and the back projector needs
// the ratio on a z and xy halo that other blocks compute, so here the ratio
// lives in a ring of z planes in device memory.
//
// What bounds it on this card: the stencils' latency and shared-memory
// traffic, as for K1 (a K1 launch reaches ~40% of the copy ceiling); the
// least traffic is est and img read once and out written once (3 volume
// passes against the K1 pair's 6).
//
// What the design does about it:
//   * Each stage is K1's block stage (csrc/sep_stage.cuh: its tile and ring
//     plan, its specialised instantiations, cp.async ring, register-blocked
//     stencils), so K2 gives a K1 ratio launch followed by a K1 update
//     launch bit for bit. Both stages take the same instantiation: the
//     plans' specialised one where they share it, else the generic one.
//   * A task is (stage, group of G z planes, tile). Stage 1 of group k
//     writes ratio = img / fwd(est) into the ratio store; stage 2 of group g
//     reads the ratio of planes gG - a2 .. gG + G - 1 + b2 (the back
//     projector's z reach, wrapped) and writes out = max(est * bp, sv).
//   * The store keeps planes [0, head) in place (the last groups' wrapped
//     reads and the first groups' outputs) and every later plane in a ring
//     of `ring` slots: ring = G (2 + ceil(b2 / G)) + a2 planes, so a
//     slot is rewritten only after every stage-2 task that reads it is done.
//     Stage 2 of groups 0 .. g0 - 1 (g0 = ceil(a2 / G)), which read the
//     last planes, runs last. Where head + ring would reach nz the store is
//     the whole volume.
//   * G is the largest group whose store is at most half a volume (and at
//     least the stages' z window). Each (tile, group) task refills K1's
//     plane ring with a z window of planes before its first output, so
//     fewer, longer groups run faster; a ring small enough to stay in the
//     50 MB L2 (G = 8 at the fusion grid) made K2 twice as slow as the K1
//     pair on an H100.
//   * One persistent launch (one wave of resident blocks) takes the tasks
//     in a fixed order by a global ticket: stage 1 of group k, then stage 2
//     of the group whose reads end a group earlier. Each finished task
//     sets its (group, tile) flag with a release add after a barrier; lanes
//     of warp 0 spin on acquire loads of the flags a task depends on: a
//     stage-2 task on the stage-1 tiles under its y/x halo in the groups it
//     reads, a stage-1 task on the stage-2 tiles whose halo reads the ring
//     slot's old plane under its tile. Every wait is on tasks of earlier
//     tickets, so the launch needs no residency guarantee; and since a
//     task's neighbours sit at the same place of a segment of tickets
//     handed out a group or more before, the flags it needs are almost
//     always set when it looks (per-group counts left blocks idle at every
//     group's tail). Stage 1 of later groups overlaps stage 2 of earlier
//     ones.
//   * The last block to leave resets the counters, so a workspace serves
//     every launch on its stream without a memset.
//   * The ratio is read through L2 (cp.async.ca after the acquire, or
//     __ldcg on K1's ring-less path), never through the read-only path.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing: the wrapper (kernels/rl_fused.py) allocates out, the
// ratio store and the counter workspace. The plan (make_k2_plan) is
// mirrored in kernels/rl_fused.py::launch_plan.

#include "sep_stage.cuh"

namespace {

constexpr int kLag = 1;   // groups stage 2 trails stage 1 by, beyond its reach

struct K2Plan {
  Plan st[2];
  int path;              // kSpecs index both stages take, -1 generic
  int group, ngroups;    // G, NG = ceil(nz / G)
  int deferred;          // g0: stage-2 groups that run after every stage 1
  int lag;               // L = ceil(b2 / G) + kLag: stage 2 of g follows stage 1 of g + L
  int head, ring;        // planes of the store in place, ring slots
  int smem;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The ratio store of groups of g planes: head + ring.
void store_layout(int nz, int a2, int b2, int g, K2Plan* k) {
  const int la = ceil_div(b2, g);
  k->group = g;
  k->ngroups = ceil_div(nz, g);
  const int g0 = ceil_div(a2, g);
  k->deferred = g0 < k->ngroups ? g0 : k->ngroups;
  k->lag = la + kLag;
  k->ring = g * (1 + la + kLag) + a2;
  const int head = k->deferred * g + b2;
  k->head = head < nz ? head : nz;
  if (k->head + k->ring >= nz) {   // the whole volume: no ring
    k->head = nz;
    k->ring = 0;
  }
}

// The K2 plan; group 0 takes the largest
// group whose store holds at most half a volume (every group costs each
// tile's task a z window of warm-up planes, so fewer, longer groups run
// faster), or one group of nz planes where none of at least that window
// (the longer stage's z taps - 1) does. False where a stage's K1 plan does
// not fit.
bool make_k2_plan(int nz, int ny, int nx, const int rank[2], const int nsteps[2],
                  const int a[2], const int ly[2], const int lx[2], int sms, int group,
                  int flags, K2Plan* k) {
  for (int pass = 0; pass < 2; ++pass) {
    for (int s = 0; s < 2; ++s)
      if (!make_plan(nz, ny, nx, rank[s], nsteps[s], ly[s], lx[s], 0, 0, sms, flags, &k->st[s]))
        return false;
    if (k->st[0].path == k->st[1].path) break;
    flags |= kFlagGeneric;   // one instantiation runs both stages
  }
  k->path = k->st[0].path;
  k->smem = k->st[0].smem > k->st[1].smem ? k->st[0].smem : k->st[1].smem;
  const int a2 = a[1], b2 = nsteps[1] - 1 - a[1];
  if (group > 0) {
    store_layout(nz, a2, b2, group < nz ? group : nz, k);
    return true;
  }
  const int window = (nsteps[0] > nsteps[1] ? nsteps[0] : nsteps[1]) - 1;
  for (int g = nz; g >= 1 && g >= window; --g) {
    store_layout(nz, a2, b2, g, k);
    if (2LL * (k->head + k->ring) <= nz) return true;
  }
  store_layout(nz, a2, b2, nz, k);
  return true;
}

struct K2Params {
  Params st[2];
  int* ctr;     // [0] ticket, [1] blocks done, then a flag a (group, tile) of stage 1, of stage 2
  float* store;
  size_t plane;
  int nz, group, ngroups, deferred, lag, head, ring, a2, b2;
  int tiles[2];
  int total;
};

struct Task {
  int stage, group, tile;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// natural stage-2 groups (g >= deferred) whose turn comes by stage 1 of group j
__device__ __forceinline__ long long stage2_by(const K2Params& q, int j) {
  const int n = q.ngroups - q.deferred;
  if (j < 0) return 0;
  if (j >= q.ngroups - 1) return n;
  const int c = j - q.lag - q.deferred + 1;
  return c < 0 ? 0 : (c > n ? n : c);
}

__device__ __forceinline__ long long stage1_ticket(const K2Params& q, int k) {
  return (long long)k * q.tiles[0] + q.tiles[1] * stage2_by(q, k - 1);
}

// Ticket order: stage 1 of group k, then the natural stage-2 groups whose
// turn it is; the deferred stage-2 groups last.
__device__ Task decode(const K2Params& q, int t) {
  const long long t1 = q.tiles[0], t2 = q.tiles[1];
  const long long end1 = q.ngroups * t1 + t2 * (q.ngroups - q.deferred);
  if (t >= end1) {
    const long long off = t - end1;
    return Task{1, static_cast<int>(off / t2), static_cast<int>(off % t2)};
  }
  int lo = 0, hi = q.ngroups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (stage1_ticket(q, mid) <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  long long off = t - stage1_ticket(q, lo);
  if (off < t1) return Task{0, lo, static_cast<int>(off)};
  off -= t1;
  return Task{1, q.deferred + static_cast<int>(stage2_by(q, lo - 1) + off / t2),
              static_cast<int>(off % t2)};
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A wait that outlasts kMaxSpins polls (seconds; a task takes
// microseconds) can only be a broken schedule: it traps, so the launch
// fails with an error instead of hanging the card.
constexpr long long kMaxSpins = 1LL << 25;

// The tiles of `len` rows (or columns) of an axis of n, ntiles of them,
// that rows lo .. hi (cyclic: wrapped modulo n) touch: first tile and count.
__device__ __forceinline__ void tile_span(int lo, int hi, int n, int len, int ntiles,
                                          int* first, int* count) {
  if (hi - lo + 1 + len > n) {   // may reach round to its own start: all
    *first = 0;
    *count = ntiles;
    return;
  }
  const int a = ((lo % n) + n) % n / len, b = ((hi % n) + n) % n / len;
  *first = a;
  *count = (b - a + ntiles) % ntiles + 1;
}

// Lanes of warp 0 spin until every flag of groups k0 + i (i < nk, cyclic
// over ngroups) and tiles (r0 + j, c0 + l) (cyclic over the stage's tile
// rows and columns) is set. flags: the stage's ngroups x tiles flags.
__device__ void wait_flags(const int* flags, const Params& p, int k0, int nk, int ngroups,
                           int r0, int nr, int c0, int nc, int lane) {
  const int n = nk * nr * nc;
  for (int i = lane; i < n; i += 32) {
    const int k = (k0 + i / (nr * nc)) % ngroups;
    const int r = (r0 + i / nc % nr) % p.tiles_y, c = (c0 + i % nc) % p.tiles_x;
    const int* f = flags + ((size_t)k * p.tiles_y + r) * p.tiles_x + c;
    for (long long spins = 0; load_acquire(f) == 0; ++spins) {
      if (spins == kMaxSpins) __trap();
      __nanosleep(64);
    }
  }
}

// Warp 0: wait for what task `t` reads (stage 2: the stage-1 tiles of its
// groups under its y/x halo) or rewrites (stage 1: the stage-2 tiles whose
// halo reads the ring slot's old plane under its tile).
__device__ void wait_for(const K2Params& q, const Task& t, int lane) {
  const Params& p1 = q.st[0];
  const Params& p2 = q.st[1];
  const int g = q.group, z0 = t.group * g, zn = min(g, q.nz - z0);
  int r0, nr, c0, nc;
  if (t.stage == 0) {
    if (q.ring == 0) return;
    // slots of planes z - ring, z in [z0, z0 + zn), where those are ring planes
    const int lo = max(q.head, z0 - q.ring), hi = z0 + zn - 1 - q.ring;
    if (hi < lo) return;
    const int glo = max(q.deferred, floor_div(lo - q.b2 - g + 1, g));
    const int ghi = min(q.ngroups - 1, floor_div(hi + q.a2, g));
    if (ghi < glo) return;
    // stage-2 tiles whose own rows meet [y0 + oy2, y1 + oy2 + ly2 - 1]
    const int y0 = t.tile / p1.tiles_x * p1.ty, x0 = t.tile % p1.tiles_x * p1.tx;
    const int y1 = min(y0 + p1.ty, p1.ny) - 1, x1 = min(x0 + p1.tx, p1.nx) - 1;
    tile_span(y0 + p2.oy, y1 + p2.oy + p2.ly - 1, p2.ny, p2.ty, p2.tiles_y, &r0, &nr);
    tile_span(x0 + p2.ox, x1 + p2.ox + p2.lx - 1, p2.nx, p2.tx, p2.tiles_x, &c0, &nc);
    wait_flags(q.ctr + 2 + (size_t)q.ngroups * q.tiles[0], p2, glo, ghi - glo + 1, q.ngroups,
               r0, nr, c0, nc, lane);
  } else {
    int k0, nk;
    const int lo = z0 - q.a2, hi = z0 + zn - 1 + q.b2;
    if (hi - lo + 1 + g > q.nz) {
      k0 = 0;
      nk = q.ngroups;
    } else {
      k0 = ((lo % q.nz + q.nz) % q.nz) / g;
      nk = ((((hi % q.nz + q.nz) % q.nz) / g) - k0 + q.ngroups) % q.ngroups + 1;
    }
    // stage-1 tiles under rows [y0 - oy2 - ly2 + 1, y0 + ty2 - 1 - oy2]
    const int y0 = t.tile / p2.tiles_x * p2.ty, x0 = t.tile % p2.tiles_x * p2.tx;
    tile_span(y0 - p2.oy - p2.ly + 1, y0 + p2.ty - 1 - p2.oy, p1.ny, p1.ty, p1.tiles_y, &r0,
              &nr);
    tile_span(x0 - p2.ox - p2.lx + 1, x0 + p2.tx - 1 - p2.ox, p1.nx, p1.tx, p1.tiles_x, &c0,
              &nc);
    wait_flags(q.ctr + 2, p1, k0, nk, q.ngroups, r0, nr, c0, nc, lane);
  }
}

// MIN_BLOCKS: the resident blocks an SM the instantiation is compiled for
// (the registers a thread may take): 1 where its plans fill an SM's shared
// memory (the fusion PSFs' 25-tap stages) or take rank 4, else 2.
template <int I>
struct Inst {   // the specialised instantiation kSpecs[I]
  static constexpr int R = kSpecs[I][0], NS = kSpecs[I][1], LY = kSpecs[I][2],
                       LX = kSpecs[I][3], ZQ = kSpecs[I][4];
  static constexpr int MIN_BLOCKS = R == 4 || NS == 25 || LX == 25 ? 1 : 2;
};
template <>
struct Inst<-1> {   // the generic one
  static constexpr int R = 0, NS = 0, LY = 0, LX = 0, ZQ = 1, MIN_BLOCKS = 2;
};

template <int I>
__global__ void __launch_bounds__(kThreads, Inst<I>::MIN_BLOCKS)
rl_fused_kernel(const __grid_constant__ K2Params q) {
  using S = Inst<I>;
  extern __shared__ __align__(16) float smem[];
  int* s_task = reinterpret_cast<int*>(smem);   // broadcast; each stage overwrites it
  const int tid = threadIdx.x;
  const RingStore ratio{q.store, q.plane, q.head, q.ring > 0 ? q.ring : 1};
  int ticket = 0;
  if (tid == 0) ticket = atomicAdd(q.ctr, 1);
  for (;;) {
    if (tid < 32) {
      const int t = __shfl_sync(0xffffffffu, ticket, 0);
      Task task{-1, 0, 0};
      if (t < q.total) {
        task = decode(q, t);
        wait_for(q, task, tid);
      }
      __syncwarp();
      if (tid == 0) {
        s_task[0] = task.stage;
        s_task[1] = task.group;
        s_task[2] = task.tile;
        if (task.stage >= 0) ticket = atomicAdd(q.ctr, 1);   // the next, fetched during this one
      }
    }
    __syncthreads();
    const int stage = s_task[0], group = s_task[1], tile = s_task[2];
    __syncthreads();   // read before the stage overwrites the slot
    if (stage < 0) break;
    const int z0 = group * q.group, nzr = min(q.group, q.nz - z0);
    // each stage names its parameters with a constant index, so that the
    // stage reads them as constant-bank operands, as K1 does
    if (stage == 0) {
      const Params& p = q.st[0];
      sep_stage<S::R, S::NS, S::LY, S::LX, S::ZQ>(p, VolumeIn{p.v, q.plane}, ratio,
                                                  (tile % p.tiles_x) * p.tx,
                                                  (tile / p.tiles_x) * p.ty, z0, nzr, smem);
    } else {
      const Params& p = q.st[1];
      sep_stage<S::R, S::NS, S::LY, S::LX, S::ZQ>(p, ratio, VolumeOut{p.out, q.plane},
                                                  (tile % p.tiles_x) * p.tx,
                                                  (tile / p.tiles_x) * p.ty, z0, nzr, smem);
    }
    __syncthreads();   // every output of the task is written; smem is free
    if (tid == 0)
      add_release(q.ctr + 2 + (size_t)stage * q.ngroups * q.tiles[0] +
                      (size_t)group * q.tiles[stage] + tile,
                  1);
  }
  if (tid == 0) s_task[0] = atomicAdd(q.ctr + 1, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (s_task[0]) {
    // the last block out: every block has taken its last ticket and
    // finished its tasks, so the counters go back to 0 for the next launch
    const int n = 2 + q.ngroups * (q.tiles[0] + q.tiles[1]);
    for (int i = tid; i < n; i += kThreads) q.ctr[i] = 0;
  }
}

using K2Fn = void (*)(const K2Params);

K2Fn k2_kernel_for(int path) {
  switch (path) {
    case 0: return rl_fused_kernel<0>;
    case 1: return rl_fused_kernel<1>;
    case 2: return rl_fused_kernel<2>;
    case 3: return rl_fused_kernel<3>;
    default: return rl_fused_kernel<-1>;
  }
}

constexpr int kPlanValues = 14;

void plan_values(const K2Plan& k, int* out) {
  const int v[kPlanValues] = {k.path,      k.group,      k.ngroups,    k.deferred, k.lag,
                              k.head,      k.ring,       k.smem,       k.st[0].ty, k.st[0].tx,
                              k.st[1].ty,  k.st[1].tx,   k.st[0].ring, k.st[1].ring};
  for (int i = 0; i < kPlanValues; ++i) out[i] = v[i];
}

// make_k2_plan after checking what K2 takes: cudaSuccess or cudaErrorInvalidValue.
cudaError_t checked_plan(int nz, int ny, int nx, const int rank[2], const int ns[2],
                         const int a[2], const int ly[2], const int lx[2], int sms, int group,
                         int flags, K2Plan* k) {
  for (int s = 0; s < 2; ++s)
    if (!valid(nz, ny, nx, rank[s], ns[s], ly[s], lx[s], 0, 0) || a[s] < 0 || a[s] >= ns[s] ||
        ns[s] > nz)
      return cudaErrorInvalidValue;
  if (sms < 1 || group < 0 ||
      !make_k2_plan(nz, ny, nx, rank, ns, a, ly, lx, sms, group, flags, k))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The K2 plan for a (nz, ny, nx) grid and the two stages' (rank, z taps, a,
// y taps, x taps), on a card of `sms` SMs; group 0 = the default;
// flags as K1's. out[0..13] = instantiation (kSpecs index, -1 generic),
// group planes, groups, deferred groups, stage-2 lag in groups, head planes,
// ring planes, shared bytes, stage-1 tile rows and columns, stage-2 tile
// rows and columns, stage-1 and stage-2 K1 ring depths. Returns 0, or
// cudaErrorInvalidValue where K2 does not take it.
int mil_rl_fused_plan(int nz, int ny, int nx, int rank1, int nsteps1, int a1, int ly1, int lx1,
                      int rank2, int nsteps2, int a2, int ly2, int lx2, int sms, int group,
                      int flags, int* out) {
  const int rank[2] = {rank1, rank2}, ns[2] = {nsteps1, nsteps2}, a[2] = {a1, a2},
            ly[2] = {ly1, ly2}, lx[2] = {lx1, lx2};
  K2Plan k;
  const cudaError_t err = checked_plan(nz, ny, nx, rank, ns, a, ly, lx, sms, group, flags, &k);
  if (err == cudaSuccess) plan_values(k, out);
  return static_cast<int>(err);
}

// What K2's instantiation `path` compiled to, with `smem` dynamic shared
// bytes: out[0] registers, out[1] spilled bytes a thread, out[2] resident
// blocks per SM. Returns a cudaError_t, 0 on success.
int mil_rl_fused_attrs(int path, int smem, int* out) {
  const K2Fn fn = k2_kernel_for(path);
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return 0;
}

// One K2 launch on `stream`: out = max(est * bp(img / fwd(est)), smallvalue).
// `store` holds store_planes planes of ny * nx floats (the plan's head +
// ring); `ctr` holds ctr_len >= 2 + groups x (stage-1 + stage-2 tiles) ints,
// all 0 (a launch leaves them 0). Stage 1 is
// the forward plan (tz1, ty1, tx1, ...), stage 2 the back projector's.
// `info`, when not NULL, receives {grid blocks, resident blocks per SM,
// the 14 plan values of mil_rl_fused_plan}. Returns the cudaError_t of the
// launch, 0 on success.
int mil_rl_iter_fused(const float* est, const float* img, float* out, float* store,
                      int store_planes, int* ctr, int ctr_len, const float* tz1,
                      const float* ty1, const float* tx1, int rank1, int a1, int nsteps1,
                      int ly1, int oy1, int lx1, int ox1, const float* tz2, const float* ty2,
                      const float* tx2, int rank2, int a2, int nsteps2, int ly2, int oy2,
                      int lx2, int ox2, int nz, int ny, int nx, float smallvalue, int group,
                      int flags, int* info, void* stream) {
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const int rank[2] = {rank1, rank2}, ns[2] = {nsteps1, nsteps2}, a[2] = {a1, a2},
            ly[2] = {ly1, ly2}, lx[2] = {lx1, lx2};
  K2Plan k;
  cudaError_t err = checked_plan(nz, ny, nx, rank, ns, a, ly, lx, sms, group, flags, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (store_planes < k.head + k.ring)
    return static_cast<int>(cudaErrorInvalidValue);
  K2Params q;
  q.st[0] = stage_params(k.st[0], est, img, store, tz1, nullptr, ty1, tx1, nz, ny, nx, rank1,
                         a1, nsteps1, ly1, oy1, lx1, ox1, 0, 0, 0, 0, 1, smallvalue);
  q.st[1] = stage_params(k.st[1], store, est, out, tz2, nullptr, ty2, tx2, nz, ny, nx, rank2,
                         a2, nsteps2, ly2, oy2, lx2, ox2, 0, 0, 0, 0, 2, smallvalue);
  q.ctr = ctr;
  q.store = store;
  q.plane = (size_t)ny * nx;
  q.nz = nz;
  q.group = k.group;
  q.ngroups = k.ngroups;
  q.deferred = k.deferred;
  q.lag = k.lag;
  q.head = k.head;
  q.ring = k.ring;
  q.a2 = a2;
  q.b2 = nsteps2 - 1 - a2;
  for (int s = 0; s < 2; ++s) q.tiles[s] = q.st[s].tiles_x * q.st[s].tiles_y;
  const long long total = (long long)k.ngroups * (q.tiles[0] + q.tiles[1]);
  if (total > (1LL << 30) || ctr_len < 2 + total) return static_cast<int>(cudaErrorInvalidValue);
  q.total = static_cast<int>(total);

  const K2Fn fn = k2_kernel_for(k.path);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, k.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long slots = (long long)per_sm * sms;
  const int grid = static_cast<int>(total < slots ? total : slots);
  if (info) {
    info[0] = grid;
    info[1] = per_sm;
    plan_values(k, info + 2);
  }
  fn<<<grid, kThreads, k.smem, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
