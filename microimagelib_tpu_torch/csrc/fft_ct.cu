// K3: the FFT circular convolution irfftn(rfftn(v) * otf, s=v.shape) for
// Hopper (sm_90a), with every 1-D transform computed here.
//
// Replaces the JAX package's Pallas TPU kernels
// microimagelib_tpu/ops/fft_pallas.py::_kernel_a, _kernel_b, _kernel_c
// (launched by _phase_a/_b/_c, entry conv3_ct). The split is the TPU's:
//   A  x real-to-complex transform, then the forward y transform
//   B  per (ky, kx) column: forward z transform, x OTF, inverse z transform
//   C  inverse y transform, then the complex-to-real x transform, x 1/(nz ny nx)
// v is float32 (nz, ny, nx); the OTF is complex64 (nz, ny, nx/2+1) in
// natural order, interleaved (re, im) as torch stores complex64. The TPU
// kernels hold a whole (ny, nx) plane in VMEM, so A and C are one launch
// each there; a 512 x 257 complex plane is 1 MB, beyond the 227 KB of shared
// memory a block may use, so here A and C are two launches each (x lines,
// then y lines) and the spectrum goes through device memory between them:
// five launches per convolution.
//
// What bounds it. The five launches must move 3.70 GB at (320, 512, 512):
// x forward 672 MB (v in, spectrum out), y forward 674 MB, z x OTF 1011 MB
// (the OTF read once), y inverse 674 MB, x inverse 672 MB. At the 2.8-2.9
// TB/s a plain copy reaches on an H100 that is ~1.3 ms; the FFT arithmetic
// (~5 n log2 n flops per line and transform) is a tenth of that at the fp32
// rate. So each launch should stream like a copy. The first version of this
// kernel ran its launches at 26-39% of the copy's rate, for four reasons,
// each answered here:
//  1. Spectrum rows of nx/2+1 complex values (2056 bytes at nx = 512) start
//     off the 32-byte sectors. The spectrum scratch is this kernel's own
//     buffer, so its rows get a pitch kxp = nx/2+1 rounded up to 16 complex
//     values (128 bytes); the y and z launches take tiles of 16 columns, one
//     128-byte segment a row, with 16-byte loads and stores, and mask the
//     padding columns so that no byte outside the valid spectrum moves. The
//     OTF keeps its natural layout (8-byte accesses).
//  2. Runtime / and % in the inner loop. For every length the FFT size
//     policy (snap_fft_size) gives from 64 to 1024 -- N in {64, 128, 192,
//     256, 320, 384, 512, 576, 640, 704, 768, 1024} -- the transform is a
//     template on N: every index, stride and radix is a compile-time
//     constant.
//  3. Radix-4 passes through two shared buffers with strided stores (4- to
//     8-way bank conflicts). Here each thread takes whole radix-R
//     butterflies (R = 8, 4, 3, 5, 11) into registers, multiplies the
//     twiddles and runs the butterfly there, and the pass exchanges through
//     one shared buffer: load, barrier, store, barrier. The plans (Len<N>)
//     are 8 x 8 x 8 at 512, 8 x 8 x 5 at 320, 8 x 8 x 11 at 704, and so on:
//     eights first, the odd factor last, which is a register butterfly too
//     (3 and 5 short ones, 11 a dense DFT over its five symmetric pairs), in
//     place of the generic path's O(m^2) dense pass through shared memory. The
//     shared tile is element-major, 16 lines wide: the element e of line p
//     sits at e * 16 + slot, and the 16 threads of a half-warp are the 16
//     lines of one butterfly, so every butterfly load and store touches 16
//     distinct 8-byte slots of one 128-byte row: no bank conflict, whatever
//     the stride in e (the radix-3 and radix-11 strides N/3, N/11 too). The
//     x launches move rows of v with float4 (4 elements of one line per
//     thread) and spectrum rows with 8-byte accesses over consecutive k;
//     there the slot is p ^ ((e ^ (e >> 2)) & 15), which is a permutation
//     of the 16 slots both over 16 aligned consecutive e (the spectrum) and
//     over e = 4 q + i for 16 aligned consecutive q (the float4 rows: every
//     N is a multiple of 64, so 16 aligned q never cross a line), so those
//     are conflict-free too (the mirror read Z[N - k] may pair two threads
//     on one bank).
//  4. Occupancy and loads in flight. One shared buffer of 16 lines is
//     128 N bytes (64 KB at N = 512, 128 KB at 1024). A line has tpl
//     threads (8 at 64, 16 up to 192, 32 up to 512, 64 above), so that a
//     thread holds at most 16 points in registers, bounded to 64 registers
//     a thread: 32 warps stay resident per SM, as two blocks of 512 threads
//     up to N = 512 (four of 256, eight of 128 below) and one block of 1024
//     threads above, where two 16-line tiles no longer fit an SM's 228 KB.
//     A block's load phase must not wait on one load at a time: the y, z
//     and x inverse launches issue all of a thread's loads (16-byte where
//     the layout allows) before storing any to shared memory, and the z
//     launch fetches its OTF tile into shared memory with cp.async while
//     the forward z transform runs (every length but 512 and 1024, where
//     the resident blocks' two tiles would not fit; stage_otf).
// Every other length (1088, 1280, ... up to 8192, and any length off the
// policy's grid) runs the first version's path (fft_lines below:
// mixed-radix Stockham with radix-4/2 passes and one dense pass for the
// odd factor), which is part of this kernel, with the same pitched
// spectrum. The host picks the path per axis (kernels/fft_ct.py
// radix_plan). The plans (Len<N>::plan) and the pitch (spec_pitch) are
// reported by mil_conv3_ct_plan, and the card tests hold them to the
// host's radix_plan and spec_pitch.
//
// Keeping a whole plane on chip across the x and y transforms (a thread
// block cluster's distributed shared memory holds 1 MB) would cut the
// traffic to ~2.4 GB, three launches; it saves at most ~0.5 ms more than
// five launches at copy speed, and is later work.
//
// Numbers. Stockham keeps natural order, so no permutation pass is needed.
// Twiddles between passes are exp(+-2 pi i t / n) from a table of n values
// that the host built in float64 and rounded to float32 (the JAX package
// builds its constants the same way, fft_pallas.py:72-135); the constants
// inside the register butterflies are float32 roundings of
// cos/sin of multiples of 2 pi / 8, 2 pi / 3, 2 pi / 5 and 2 pi / 11. All
// arithmetic is fp32.
// The TPU's bf16 hi/lo matmul splitting existed only because Mosaic has no
// fp32 matmul precision and is not carried over.
//
// Real transforms. Two real rows travel as one complex line z = a + i b:
// after the forward FFT, A[k] = (Z[k] + conj Z[-k]) / 2 and
// B[k] = (Z[k] - conj Z[-k]) / 2i. The inverse builds Z = A + i B from the
// two half spectra by Hermitian symmetry, with the imaginary parts at DC and
// Nyquist dropped as irfft drops them, and reads a and b off the real and
// imaginary parts.
//
// The kernels launch on the caller's stream, do not synchronise and allocate
// nothing: the wrapper (kernels/fft_ct.py) allocates the pitched spectrum
// buffer and the output.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLen = 8192;               // longest line on any axis
constexpr size_t kTileBytes = 64 * 1024;    // target shared memory per block
constexpr int kMaxTile = 8;                 // lines (or line pairs) per block
constexpr int kLines = 16;                  // lines per block, length-specialised path

// Row pitch, in complex values, of the spectrum scratch: nx/2+1 rounded up
// to kLines (128 bytes)
__host__ __device__ constexpr int spec_pitch(int nx) { return (nx / 2 + kLines) / kLines * kLines; }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// exp(sign * 2 pi i e / n) from the table of (cos, sin)(2 pi t / n)
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tab, int e, float sign) {
  const float2 w = __ldg(tab + e);
  return make_float2(w.x, sign * w.y);
}

// ---- generic path: any length ------------------------------------------

// In-place (a holds input and result) unnormalized FFT of `nlines` lines of
// length n in shared memory; element j of line t sits at t * ls + j * es.
// sign -1 forward, +1 inverse. `lines_fast`: neighbouring threads take
// neighbouring lines (interleaved layout) rather than neighbouring elements.
// Every thread of the block must call it; it ends with a barrier.
__device__ void fft_lines(float2*& a, float2*& b, int n, int nlines, int ls, int es,
                          bool lines_fast, float sign, const float2* __restrict__ tab) {
  int ns = 1;  // length of the sub-transforms done so far
  while (ns < n) {
    const int rest = n / ns;
    const int R = (rest % 4 == 0) ? 4 : (rest % 2 == 0) ? 2 : rest;
    const int span = n / R;          // input stride of a butterfly
    const int tstep = n / (ns * R);  // twiddle index per (r * k)
    if (R == 2 || R == 4) {
      const int items = span * nlines;
      for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int t = lines_fast ? it % nlines : it / span;
        const int j = lines_fast ? it / nlines : it % span;
        const int k = j % ns;
        const float2* src = a + t * ls;
        float2* dst = b + t * ls;
        const int o = (j / ns) * ns * R + k;
        if (R == 2) {
          const float2 x0 = src[j * es];
          const float2 x1 = cmul(src[(j + span) * es], twiddle(tab, k * tstep, sign));
          dst[o * es] = cadd(x0, x1);
          dst[(o + ns) * es] = csub(x0, x1);
        } else {
          const float2 x0 = src[j * es];
          const float2 x1 = cmul(src[(j + span) * es], twiddle(tab, k * tstep, sign));
          const float2 x2 = cmul(src[(j + 2 * span) * es], twiddle(tab, 2 * k * tstep, sign));
          const float2 x3 = cmul(src[(j + 3 * span) * es], twiddle(tab, 3 * k * tstep, sign));
          const float2 e = cadd(x0, x2), f = csub(x0, x2);
          const float2 g = cadd(x1, x3), h = csub(x1, x3);
          const float2 ih = make_float2(-sign * h.y, sign * h.x);  // sign * i * h
          dst[o * es] = cadd(e, g);
          dst[(o + ns) * es] = cadd(f, ih);
          dst[(o + 2 * ns) * es] = csub(e, g);
          dst[(o + 3 * ns) * es] = csub(f, ih);
        }
      }
    } else {
      // dense R-point DFT pass (R odd): one output per item
      const int items = n * nlines;
      for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int t = lines_fast ? it % nlines : it / n;
        const int jr = lines_fast ? it / nlines : it % n;
        const int j = jr % span, r = jr / span;
        const int k = j % ns;
        const float2* src = a + t * ls;
        const int step = (k * tstep + r * span) % n;
        float2 acc = make_float2(0.f, 0.f);
        int e = 0;
        for (int q = 0; q < R; ++q) {
          const float2 x = src[(j + q * span) * es];
          const float2 w = twiddle(tab, e, sign);
          acc.x = fmaf(x.x, w.x, fmaf(-x.y, w.y, acc.x));
          acc.y = fmaf(x.x, w.y, fmaf(x.y, w.x, acc.y));
          e += step;
          if (e >= n) e -= n;
        }
        b[t * ls + ((j / ns) * ns * R + k + r * ns) * es] = acc;
      }
    }
    __syncthreads();
    float2* tmp = a;
    a = b;
    b = tmp;
    ns *= R;
  }
}

// Phase A, x: row pairs (2p, 2p+1) of the nrows = nz * ny rows of v -> the
// half spectra of both rows, into spec (nrows, kxp).
__global__ void __launch_bounds__(kThreads)
x_forward_kernel(const float* __restrict__ v, float2* __restrict__ spec,
                 const float2* __restrict__ tab, int nrows, int nx, int pairs, int kxp) {
  extern __shared__ __align__(16) float2 smem[];
  float2* a = smem;
  float2* b = smem + (size_t)pairs * nx;
  const int kx = nx / 2 + 1;
  const long long p0 = (long long)blockIdx.x * pairs;
  for (int i = threadIdx.x; i < pairs * nx; i += blockDim.x) {
    const int t = i / nx, j = i % nx;
    const long long r0 = 2 * (p0 + t);
    float2 z = make_float2(0.f, 0.f);
    if (r0 < nrows) z.x = v[r0 * nx + j];
    if (r0 + 1 < nrows) z.y = v[(r0 + 1) * nx + j];
    a[i] = z;
  }
  __syncthreads();
  fft_lines(a, b, nx, pairs, nx, 1, false, -1.f, tab);
  for (int i = threadIdx.x; i < pairs * kx; i += blockDim.x) {
    const int t = i / kx, k = i % kx;
    const long long r0 = 2 * (p0 + t);
    const float2 zk = a[t * nx + k];
    const float2 zm = a[t * nx + (nx - k) % nx];
    // A = (Z[k] + conj Z[-k]) / 2,  B = (Z[k] - conj Z[-k]) / 2i
    if (r0 < nrows)
      spec[r0 * kxp + k] = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    if (r0 + 1 < nrows)
      spec[(r0 + 1) * kxp + k] = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  }
}

// Phases A and C, y: for plane z = blockIdx.y and the tile of `tile` kx
// columns starting at blockIdx.x * tile, transform along y in place.
__global__ void __launch_bounds__(kThreads)
y_kernel(float2* __restrict__ spec, const float2* __restrict__ tab, int ny, int kx,
         int kxp, int tile, float sign) {
  extern __shared__ __align__(16) float2 smem[];
  float2* a = smem;
  float2* b = smem + (size_t)ny * tile;
  const int c0 = blockIdx.x * tile;
  float2* plane = spec + (size_t)blockIdx.y * ny * kxp;
  for (int i = threadIdx.x; i < ny * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    a[i] = (c0 + t < kx) ? plane[(size_t)j * kxp + c0 + t] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  fft_lines(a, b, ny, tile, 1, tile, true, sign, tab);
  for (int i = threadIdx.x; i < ny * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    if (c0 + t < kx) plane[(size_t)j * kxp + c0 + t] = a[i];
  }
}

// Phase B: for the tile of `tile` flattened (ky, kx) columns of the pitched
// spectrum starting at blockIdx.x * tile (a tile never crosses a ky row:
// kxp is a multiple of 16), forward z transform, times the OTF (natural
// layout, (nz, ny, kx)), inverse z transform, in place.
__global__ void __launch_bounds__(kThreads)
z_kernel(float2* __restrict__ spec, const float2* __restrict__ otf,
         const float2* __restrict__ tab, int nz, long long ncols, int tile, int kx,
         int kxp, int ny) {
  extern __shared__ __align__(16) float2 smem[];
  float2* a = smem;
  float2* b = smem + (size_t)nz * tile;
  const long long c0 = (long long)blockIdx.x * tile;
  const int ky = (int)(c0 / kxp), kc = (int)(c0 % kxp);
  const float2* o = otf + (size_t)ky * kx + kc;
  const size_t ostride = (size_t)ny * kx;
  for (int i = threadIdx.x; i < nz * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    a[i] = (kc + t < kx) ? spec[j * ncols + c0 + t] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  fft_lines(a, b, nz, tile, 1, tile, true, -1.f, tab);
  for (int i = threadIdx.x; i < nz * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    if (kc + t < kx) a[i] = cmul(a[i], __ldg(o + j * ostride + t));
  }
  __syncthreads();
  fft_lines(a, b, nz, tile, 1, tile, true, 1.f, tab);
  for (int i = threadIdx.x; i < nz * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    if (kc + t < kx) spec[j * ncols + c0 + t] = a[i];
  }
}

// Phase C, x: the half spectra of rows 2p and 2p+1 -> both real rows of
// out, times `scale`.
__global__ void __launch_bounds__(kThreads)
x_inverse_kernel(const float2* __restrict__ spec, float* __restrict__ out,
                 const float2* __restrict__ tab, int nrows, int nx, int pairs,
                 int kxp, float scale) {
  extern __shared__ __align__(16) float2 smem[];
  float2* a = smem;
  float2* b = smem + (size_t)pairs * nx;
  const int half = nx / 2;
  const long long p0 = (long long)blockIdx.x * pairs;
  for (int i = threadIdx.x; i < pairs * nx; i += blockDim.x) {
    const int t = i / nx, k = i % nx;
    const long long r0 = 2 * (p0 + t);
    const bool mirror = k > half;
    const int kk = mirror ? nx - k : k;
    float2 fa = make_float2(0.f, 0.f), fb = make_float2(0.f, 0.f);
    if (r0 < nrows) fa = spec[r0 * kxp + kk];
    if (r0 + 1 < nrows) fb = spec[(r0 + 1) * kxp + kk];
    if (kk == 0 || kk == half) {  // irfft reads only the real part here
      fa.y = 0.f;
      fb.y = 0.f;
    }
    if (mirror) {  // Hermitian symmetry: A[-k] = conj A[k]
      fa.y = -fa.y;
      fb.y = -fb.y;
    }
    a[i] = make_float2(fa.x - fb.y, fa.y + fb.x);  // A + i B
  }
  __syncthreads();
  fft_lines(a, b, nx, pairs, nx, 1, false, 1.f, tab);
  for (int i = threadIdx.x; i < pairs * nx; i += blockDim.x) {
    const int t = i / nx, j = i % nx;
    const long long r0 = 2 * (p0 + t);
    const float2 z = a[i];
    if (r0 < nrows) out[r0 * nx + j] = z.x * scale;
    if (r0 + 1 < nrows) out[(r0 + 1) * nx + j] = z.y * scale;
  }
}

// ---- length-specialised path: every length snap_fft_size gives, 64-1024 --

template <int... R> struct Radices {};

// Threads per line (a block is kLines lines of tpl threads) and the radix
// plan, in pass order. tpl keeps a thread's points (N / tpl) at 16 or
// fewer, so that a thread's butterflies fit the 64 registers two blocks
// (32 warps) an SM leave: 16 threads a line up to 192 points, 32 up to
// 512, 64 (one block of 1024 threads an SM) above.
template <int N> struct Len;
template <> struct Len<64> { static constexpr int tpl = 8; using plan = Radices<8, 8>; };
template <> struct Len<128> { static constexpr int tpl = 16; using plan = Radices<8, 4, 4>; };
template <> struct Len<192> { static constexpr int tpl = 16; using plan = Radices<8, 8, 3>; };
template <> struct Len<256> { static constexpr int tpl = 32; using plan = Radices<8, 8, 4>; };
template <> struct Len<320> { static constexpr int tpl = 32; using plan = Radices<8, 8, 5>; };
template <> struct Len<384> { static constexpr int tpl = 32; using plan = Radices<8, 4, 4, 3>; };
template <> struct Len<512> { static constexpr int tpl = 32; using plan = Radices<8, 8, 8>; };
template <> struct Len<576> { static constexpr int tpl = 64; using plan = Radices<8, 8, 3, 3>; };
template <> struct Len<640> { static constexpr int tpl = 64; using plan = Radices<8, 4, 4, 5>; };
template <> struct Len<704> { static constexpr int tpl = 64; using plan = Radices<8, 8, 11>; };
template <> struct Len<768> { static constexpr int tpl = 64; using plan = Radices<8, 8, 4, 3>; };
template <> struct Len<1024> { static constexpr int tpl = 64; using plan = Radices<8, 8, 4, 4>; };

// Calls f(std::integral_constant<int, N>) for a specialised length n;
// false for any other length.
template <class F> bool with_len(int n, F&& f) {
  switch (n) {
#define MIL_LEN(N) \
  case N: f(std::integral_constant<int, N>{}); return true;
    MIL_LEN(64) MIL_LEN(128) MIL_LEN(192) MIL_LEN(256) MIL_LEN(320) MIL_LEN(384)
    MIL_LEN(512) MIL_LEN(576) MIL_LEN(640) MIL_LEN(704) MIL_LEN(768) MIL_LEN(1024)
#undef MIL_LEN
    default: return false;
  }
}

template <int N> __host__ __device__ constexpr int block_threads() { return kLines * Len<N>::tpl; }
// 1024 threads (32 warps) per SM: at most 64 registers a thread
template <int N> __host__ __device__ constexpr int min_blocks() { return 1024 / block_threads<N>(); }
template <int N> __host__ __device__ constexpr size_t tile_bytes() { return sizeof(float2) * N * kLines; }
template <int N> __host__ __device__ constexpr int pitch() { return spec_pitch(N); }

// Shared slot of element e of line p in a tile of kLines lines (see the note
// at the top: SWZ for the x launches).
template <bool SWZ> __device__ __forceinline__ int at(int e, int p) {
  return e * kLines + (SWZ ? (p ^ ((e ^ (e >> 2)) & (kLines - 1))) : p);
}

template <int S> __device__ __forceinline__ float2 mul_i(float2 a) {  // S * i * a
  return S > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// In-register DFTs y[q] = sum_r a[r] exp(S 2 pi i r q / R), in place.
template <int S> __device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                                      float2& a3) {
  const float2 e = cadd(a0, a2), f = csub(a0, a2);
  const float2 g = cadd(a1, a3), h = mul_i<S>(csub(a1, a3));
  a0 = cadd(e, g);
  a1 = cadd(f, h);
  a2 = csub(e, g);
  a3 = csub(f, h);
}

template <int S> __device__ __forceinline__ void dft8(float2* a) {
  dft4<S>(a[0], a[2], a[4], a[6]);  // E[q] now at a[2q]
  dft4<S>(a[1], a[3], a[5], a[7]);  // O[q] now at a[2q+1]
  constexpr float c = 0.70710678118654752f;
  // O[q] * exp(S 2 pi i q / 8): c (1 + S i), S i, c (-1 + S i)
  const float2 o1 = make_float2(c * (a[3].x - S * a[3].y), c * (a[3].y + S * a[3].x));
  const float2 o2 = mul_i<S>(a[5]);
  const float2 o3 = make_float2(c * (-a[7].x - S * a[7].y), c * (S * a[7].x - a[7].y));
  const float2 e0 = a[0], e1 = a[2], e2 = a[4], e3 = a[6], o0 = a[1];
  a[0] = cadd(e0, o0);
  a[4] = csub(e0, o0);
  a[1] = cadd(e1, o1);
  a[5] = csub(e1, o1);
  a[2] = cadd(e2, o2);
  a[6] = csub(e2, o2);
  a[3] = cadd(e3, o3);
  a[7] = csub(e3, o3);
}

template <int S> __device__ __forceinline__ void dft5(float2* a) {
  constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;  // cos 2pi/5, 4pi/5
  constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;   // sin 2pi/5, 4pi/5
  const float2 t1 = cadd(a[1], a[4]), t2 = cadd(a[2], a[3]);
  const float2 t3 = csub(a[1], a[4]), t4 = csub(a[2], a[3]);
  const float2 x0 = a[0];
  const float2 p1 = make_float2(x0.x + c1 * t1.x + c2 * t2.x, x0.y + c1 * t1.y + c2 * t2.y);
  const float2 p2 = make_float2(x0.x + c2 * t1.x + c1 * t2.x, x0.y + c2 * t1.y + c1 * t2.y);
  const float2 q1 = mul_i<S>(make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y));
  const float2 q2 = mul_i<S>(make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y));
  a[0] = cadd(x0, cadd(t1, t2));
  a[1] = cadd(p1, q1);
  a[4] = csub(p1, q1);
  a[2] = cadd(p2, q2);
  a[3] = csub(p2, q2);
}

template <int S> __device__ __forceinline__ void dft3(float2* a) {
  constexpr float s3 = 0.86602540378443865f;  // sin 2pi/3
  const float2 t = cadd(a[1], a[2]);
  const float2 m = make_float2(a[0].x - 0.5f * t.x, a[0].y - 0.5f * t.y);
  const float2 d = mul_i<S>(csub(a[1], a[2]));
  const float2 q = make_float2(s3 * d.x, s3 * d.y);
  a[0] = cadd(a[0], t);
  a[1] = cadd(m, q);
  a[2] = csub(m, q);
}

// cos and sin of 2 pi m / 11, m = 1..5
__host__ __device__ constexpr float cos11(int m) {
  return m == 1 ? 0.84125353283118117f : m == 2 ? 0.41541501300188644f
       : m == 3 ? -0.14231483827328500f : m == 4 ? -0.65486073394528500f
       : -0.95949297361449740f;
}
__host__ __device__ constexpr float sin11(int m) {
  return m == 1 ? 0.54064081745559760f : m == 2 ? 0.90963199535451830f
       : m == 3 ? 0.98982144188093280f : m == 4 ? 0.75574957435425830f
       : 0.28173255684142967f;
}

// The dense 11-point DFT over the symmetric pairs t_k = a_k + a_(11-k),
// u_k = a_k - a_(11-k): y_q = a_0 + sum_k cos(2 pi k q / 11) t_k and
// y_(11-q) its mirror, +-S i sum_k sin(2 pi k q / 11) u_k.
template <int S> __device__ __forceinline__ void dft11(float2* a) {
  float2 t[5], u[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    t[k] = cadd(a[k + 1], a[10 - k]);
    u[k] = csub(a[k + 1], a[10 - k]);
  }
  const float2 x0 = a[0];
  float2 sum = x0;
#pragma unroll
  for (int k = 0; k < 5; ++k) sum = cadd(sum, t[k]);
#pragma unroll
  for (int q = 1; q <= 5; ++q) {
    float2 p = x0, r = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 1; k <= 5; ++k) {
      const int m = k * q % 11;
      const float c = cos11(m <= 5 ? m : 11 - m);
      const float s = m <= 5 ? sin11(m) : -sin11(11 - m);
      p = make_float2(fmaf(c, t[k - 1].x, p.x), fmaf(c, t[k - 1].y, p.y));
      r = make_float2(fmaf(s, u[k - 1].x, r.x), fmaf(s, u[k - 1].y, r.y));
    }
    const float2 iq = mul_i<S>(r);
    a[q] = cadd(p, iq);
    a[11 - q] = csub(p, iq);
  }
  a[0] = sum;
}

template <int R, int S> __device__ __forceinline__ void dft(float2* a) {
  if constexpr (R == 3) {
    dft3<S>(a);
  } else if constexpr (R == 4) {
    dft4<S>(a[0], a[1], a[2], a[3]);
  } else if constexpr (R == 5) {
    dft5<S>(a);
  } else if constexpr (R == 11) {
    dft11<S>(a);
  } else {
    static_assert(R == 8, "radix 3, 4, 5, 8 or 11");
    dft8<S>(a);
  }
}

struct NoPre {
  __device__ __forceinline__ float2 operator()(float2 x, int) const { return x; }
};

// times the OTF of this thread's column (line p of the z tile)
struct OtfPre {
  const float2* otf;               // this line's column, z = 0
  size_t stride;                   // ny * kx
  bool valid;                      // this line is a spectrum column, not padding
  __device__ __forceinline__ float2 operator()(float2 x, int e) const {
    return valid ? cmul(x, __ldg(otf + e * stride)) : x;
  }
};

// One radix-R Stockham pass over the tile's kLines lines of length N, the
// sub-transforms so far of length NS. Thread (p, t) takes butterflies
// j = t, t + tpl, ... of line p: loads its R inputs j + r N/R, barrier,
// twiddles and the butterfly in registers, stores the R outputs at
// (j / NS) NS R + j % NS + q NS, barrier. `pre` acts on each loaded value.
template <int N, bool SWZ, int S, int NS, int R, class Pre>
__device__ __forceinline__ void pass(float2* sm, const float2* __restrict__ tab, int p, int t,
                                     const Pre& pre) {
  constexpr int TPL = Len<N>::tpl, SPAN = N / R, B = (SPAN + TPL - 1) / TPL;
  constexpr int TSTEP = N / (NS * R);
  float2 x[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + b * TPL;
    if (SPAN % TPL == 0 || j < SPAN) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[b][r] = pre(sm[at<SWZ>(j + r * SPAN, p)], j + r * SPAN);
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + b * TPL;
    if (SPAN % TPL == 0 || j < SPAN) {
      const int k = j % NS;
      if constexpr (NS > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r)
          x[b][r] = cmul(x[b][r], twiddle(tab, r * k * TSTEP, (float)S));
      }
      dft<R, S>(x[b]);
      const int o = (j / NS) * NS * R + k;
#pragma unroll
      for (int q = 0; q < R; ++q) sm[at<SWZ>(o + q * NS, p)] = x[b][q];
    }
  }
  __syncthreads();
}

template <int N, bool SWZ, int S, int NS, class Pre, int R, int... Rest>
__device__ __forceinline__ void passes(float2* sm, const float2* __restrict__ tab, int p,
                                       int t, const Pre& pre) {
  pass<N, SWZ, S, NS, R>(sm, tab, p, t, pre);
  if constexpr (sizeof...(Rest) > 0)
    passes<N, SWZ, S, NS * R, NoPre, Rest...>(sm, tab, p, t, NoPre());
}

template <int N, bool SWZ, int S, class Pre, int... R>
__device__ __forceinline__ void run_plan(float2* sm, const float2* __restrict__ tab, int p,
                                         int t, const Pre& pre, Radices<R...>) {
  static_assert((R * ...) == N, "the plan's radices multiply to N");
  passes<N, SWZ, S, 1, Pre, R...>(sm, tab, p, t, pre);
}

// Unnormalized FFT (S = -1 forward, +1 inverse) of the tile's lines, in
// place, natural order in and out, by the passes of Len<N>::plan.
template <int N, bool SWZ, int S, class Pre>
__device__ __forceinline__ void fft_tile(float2* sm, const float2* __restrict__ tab, int p,
                                         int t, const Pre& pre) {
  run_plan<N, SWZ, S>(sm, tab, p, t, pre, typename Len<N>::plan{});
}

// Phase A, x, length N: the kLines row pairs (2p, 2p+1) from row
// 2 kLines blockIdx.x -> both half spectra, into spec (nrows, pitch<N>()).
template <int N>
__global__ void __launch_bounds__(block_threads<N>(), min_blocks<N>())
x_forward_len(const float* __restrict__ v, float2* __restrict__ spec,
              const float2* __restrict__ tab, int nrows) {
  extern __shared__ __align__(16) float2 smem[];
  constexpr int NT = block_threads<N>(), Q = N / 4, KX = N / 2 + 1, KXP = pitch<N>();
  const int p = threadIdx.x % kLines, t = threadIdx.x / kLines;
  const long long row0 = 2LL * kLines * blockIdx.x;
  // (a plain loop: on an H100 it streams v at a copy's rate, faster than
  // loading all of a thread's rows first)
  for (int i = threadIdx.x; i < kLines * Q; i += NT) {
    const int lp = i / Q, q = i % Q;
    const long long r = row0 + 2 * lp;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < nrows) a = __ldg(reinterpret_cast<const float4*>(v + r * N) + q);
    if (r + 1 < nrows) b = __ldg(reinterpret_cast<const float4*>(v + (r + 1) * N) + q);
    smem[at<true>(4 * q, lp)] = make_float2(a.x, b.x);
    smem[at<true>(4 * q + 1, lp)] = make_float2(a.y, b.y);
    smem[at<true>(4 * q + 2, lp)] = make_float2(a.z, b.z);
    smem[at<true>(4 * q + 3, lp)] = make_float2(a.w, b.w);
  }
  __syncthreads();
  fft_tile<N, true, -1>(smem, tab, p, t, NoPre());
  for (int i = threadIdx.x; i < kLines * KXP; i += NT) {
    const int lp = i / KXP, k = i % KXP;
    const long long r = row0 + 2 * lp;
    if (k < KX) {
      const float2 zk = smem[at<true>(k, lp)];
      const float2 zm = smem[at<true>(k == 0 ? 0 : N - k, lp)];
      // A = (Z[k] + conj Z[-k]) / 2,  B = (Z[k] - conj Z[-k]) / 2i
      if (r < nrows)
        spec[r * KXP + k] = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
      if (r + 1 < nrows)
        spec[(r + 1) * KXP + k] = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
    }
  }
}

// Phase C, x, length N: the half spectra of the kLines row pairs -> both
// real rows of out, times `scale`.
template <int N>
__global__ void __launch_bounds__(block_threads<N>(), min_blocks<N>())
x_inverse_len(const float2* __restrict__ spec, float* __restrict__ out,
              const float2* __restrict__ tab, int nrows, float scale) {
  extern __shared__ __align__(16) float2 smem[];
  constexpr int NT = block_threads<N>(), Q = N / 4, KX = N / 2 + 1, KXP = pitch<N>();
  // all of a thread's loads first, (k, k+1) 16 bytes at a time, then the
  // stores to shared memory
  constexpr int K2 = KXP / 2, IT = (kLines * K2 + NT - 1) / NT;
  const int p = threadIdx.x % kLines, t = threadIdx.x / kLines;
  const long long row0 = 2LL * kLines * blockIdx.x;
  float4 f[IT][2];  // rows 2p and 2p+1 at (k, k+1)
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    const int i = threadIdx.x + u * NT, lp = i / K2, k = 2 * (i % K2);
    const long long r = row0 + 2 * lp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f[u][h] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i >= kLines * K2 || k >= KX || r + h >= nrows) continue;
      const float2* src = spec + (r + h) * KXP + k;
      if (k + 1 < KX) {
        f[u][h] = __ldg(reinterpret_cast<const float4*>(src));
      } else {  // k = nx/2 alone: its neighbour is padding
        const float2 x = __ldg(src);
        f[u][h].x = x.x;
        f[u][h].y = x.y;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    const int i = threadIdx.x + u * NT, lp = i / K2, k0 = 2 * (i % K2);
    if (i >= kLines * K2) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + h;
      if (k >= KX) continue;
      float2 a = h ? make_float2(f[u][0].z, f[u][0].w) : make_float2(f[u][0].x, f[u][0].y);
      float2 b = h ? make_float2(f[u][1].z, f[u][1].w) : make_float2(f[u][1].x, f[u][1].y);
      if (k == 0 || k == N / 2) {  // irfft reads only the real part here
        a.y = 0.f;
        b.y = 0.f;
      }
      smem[at<true>(k, lp)] = make_float2(a.x - b.y, a.y + b.x);  // A + i B
      // Hermitian symmetry: Z[N - k] = conj A[k] + i conj B[k]
      if (k > 0 && k < N / 2) smem[at<true>(N - k, lp)] = make_float2(a.x + b.y, b.x - a.y);
    }
  }
  __syncthreads();
  fft_tile<N, true, 1>(smem, tab, p, t, NoPre());
  for (int i = threadIdx.x; i < kLines * Q; i += NT) {
    const int lp = i / Q, q = i % Q;
    const long long r = row0 + 2 * lp;
    const float2 z0 = smem[at<true>(4 * q, lp)], z1 = smem[at<true>(4 * q + 1, lp)];
    const float2 z2 = smem[at<true>(4 * q + 2, lp)], z3 = smem[at<true>(4 * q + 3, lp)];
    if (r < nrows)
      reinterpret_cast<float4*>(out + r * N)[q] =
          make_float4(z0.x * scale, z1.x * scale, z2.x * scale, z3.x * scale);
    if (r + 1 < nrows)
      reinterpret_cast<float4*>(out + (r + 1) * N)[q] =
          make_float4(z0.y * scale, z1.y * scale, z2.y * scale, z3.y * scale);
  }
}

// A tile of N rows x kLines complex columns (one 128-byte segment a row,
// `stride` complex values apart, `valid` columns of them spectrum, the rest
// pitch padding) from device memory into the shared tile, two columns (16
// bytes) a load, all of a thread's loads before its stores; padding is not
// read and holds zeros in shared memory.
template <int N>
__device__ __forceinline__ void load_tile(float2* sm, const float2* g, size_t stride,
                                          int valid) {
  constexpr int NT = block_threads<N>(), C2 = kLines / 2, IT = (N * C2 + NT - 1) / NT;
  constexpr bool WHOLE = N * C2 % NT == 0;  // else the last round is partial
  float4 w[IT];
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    const int i = threadIdx.x + u * NT, j = i / C2, c = 2 * (i % C2);
    const float2* src = g + j * stride + c;
    w[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!WHOLE && i >= N * C2) continue;
    if (c + 1 < valid) {
      w[u] = *reinterpret_cast<const float4*>(src);
    } else if (c < valid) {
      const float2 x = *src;
      w[u].x = x.x;
      w[u].y = x.y;
    }
  }
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    const int i = threadIdx.x + u * NT, j = i / C2, c = 2 * (i % C2);
    if (WHOLE || i < N * C2) *reinterpret_cast<float4*>(sm + at<false>(j, c)) = w[u];
  }
}

// The shared tile back to device memory, the valid columns only.
template <int N>
__device__ __forceinline__ void store_tile(const float2* sm, float2* g, size_t stride,
                                           int valid) {
  constexpr int NT = block_threads<N>(), C2 = kLines / 2;
  for (int i = threadIdx.x; i < N * C2; i += NT) {
    const int j = i / C2, c = 2 * (i % C2);
    float2* dst = g + j * stride + c;
    const float4 w = *reinterpret_cast<const float4*>(sm + at<false>(j, c));
    if (c + 1 < valid)
      *reinterpret_cast<float4*>(dst) = w;
    else if (c < valid)
      *dst = make_float2(w.x, w.y);
  }
}

// Phases A and C, y, length N: the tile of kLines kx columns from
// kLines blockIdx.x of plane blockIdx.y, transformed along y in place.
template <int N, int S>
__device__ __forceinline__ void y_tile(float2* sm, float2* spec, const float2* __restrict__ tab,
                                       int kx, int kxp) {
  const int c0 = blockIdx.x * kLines;
  float2* g = spec + (size_t)blockIdx.y * N * kxp + c0;
  const int valid = min(kLines, kx - c0);
  load_tile<N>(sm, g, kxp, valid);
  __syncthreads();
  fft_tile<N, false, S>(sm, tab, threadIdx.x % kLines, threadIdx.x / kLines, NoPre());
  store_tile<N>(sm, g, kxp, valid);
}

template <int N>
__global__ void __launch_bounds__(block_threads<N>(), min_blocks<N>())
y_forward_len(float2* __restrict__ spec, const float2* __restrict__ tab, int kx, int kxp) {
  extern __shared__ __align__(16) float2 smem[];
  y_tile<N, -1>(smem, spec, tab, kx, kxp);
}

template <int N>
__global__ void __launch_bounds__(block_threads<N>(), min_blocks<N>())
y_inverse_len(float2* __restrict__ spec, const float2* __restrict__ tab, int kx, int kxp) {
  extern __shared__ __align__(16) float2 smem[];
  y_tile<N, 1>(smem, spec, tab, kx, kxp);
}

// The z launch stages the tile's OTF in shared memory beside the spectrum
// tile, fetched with cp.async while the forward transform runs, where the
// min_blocks<N>() resident blocks with both tiles (and the 1 KB the card
// reserves for each block) still fit an SM's 228 KB: every length but 512
// (two blocks of 128 KB) and 1024 (one of 256 KB), whose inverse
// transform's first pass reads the OTF from device memory (OtfPre).
template <int N> __host__ __device__ constexpr bool stage_otf() {
  return min_blocks<N>() * (2 * tile_bytes<N>() + 1024) <= 228 * 1024;
}

// times the staged OTF of this thread's column
struct SmemOtfPre {
  const float2* ot;
  int p;
  bool valid;
  __device__ __forceinline__ float2 operator()(float2 x, int e) const {
    return valid ? cmul(x, ot[e * kLines + p]) : x;
  }
};

// Phase B, length N: the tile of kLines flattened (ky, kx) columns of the
// pitched spectrum from kLines blockIdx.x (never across a ky row: kxp is a
// multiple of kLines): forward z transform, times the OTF (natural layout
// (nz, ny, kx), applied as the inverse's first pass loads), inverse z
// transform, in place.
template <int N>
__global__ void __launch_bounds__(block_threads<N>(), min_blocks<N>())
z_kernel_len(float2* __restrict__ spec, const float2* __restrict__ otf,
             const float2* __restrict__ tab, int kx, int kxp, int ny) {
  extern __shared__ __align__(16) float2 smem[];
  const long long c0 = (long long)blockIdx.x * kLines;
  const int ky = (int)(c0 / kxp), kc = (int)(c0 % kxp);
  const int valid = min(kLines, kx - kc);
  const size_t ncols = (size_t)ny * kxp;
  const int p = threadIdx.x % kLines, t = threadIdx.x / kLines;
  const float2* o = otf + (size_t)ky * kx + kc;
  const size_t ostride = (size_t)ny * kx;
  float2* g = spec + c0;
  float2* ot = smem + N * kLines;
  if constexpr (stage_otf<N>()) {
    for (int i = threadIdx.x; i < N * kLines; i += block_threads<N>()) {
      const int j = i / kLines, c = i % kLines;
      if (c < valid) {
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(ot + i));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                     "l"(o + j * ostride + c));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  load_tile<N>(smem, g, ncols, valid);
  __syncthreads();
  fft_tile<N, false, -1>(smem, tab, p, t, NoPre());
  if constexpr (stage_otf<N>()) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    fft_tile<N, false, 1>(smem, tab, p, t, SmemOtfPre{ot, p, p < valid});
  } else {
    fft_tile<N, false, 1>(smem, tab, p, t, OtfPre{o + p, ostride, p < valid});
  }
  store_tile<N>(smem, g, ncols, valid);
}

// ---- host side -----------------------------------------------------------

// Lines per block on the generic path: the largest power of two <= kMaxTile
// whose two shared buffers fit kTileBytes (at least 1).
int tile_for(int n) {
  int t = kMaxTile;
  while (t > 1 && 2 * sizeof(float2) * (size_t)n * t > kTileBytes) t /= 2;
  return t;
}

size_t smem_bytes(int n, int tile) { return 2 * sizeof(float2) * (size_t)n * tile; }

// One convolution's operands and sizes; the launches' arguments point here.
struct Conv {
  const float* v;
  const float2* otf;
  float2* spec;
  float* out;
  const float2* tab_x;
  const float2* tab_y;
  const float2* tab_z;
  int nz, ny, nx, kx, kxp, nrows;
  int px, ty, tz;   // generic path: lines (pairs) per block
  long long ncols;  // ny * kxp
  float scale;
  float minus = -1.f, plus = 1.f;
};

// One launch: kernel, grid, block, dynamic shared bytes, arguments.
struct Step {
  const void* fn;
  dim3 grid;
  unsigned threads;
  size_t smem;
  void* args[10];
};

// steps[0..4]: x forward, y forward, z, y inverse, x inverse
template <int N> void x_steps(Conv& c, Step* st) {
  const dim3 grid((c.nrows + 2 * kLines - 1) / (2 * kLines));
  st[0] = {reinterpret_cast<const void*>(&x_forward_len<N>), grid, block_threads<N>(),
           tile_bytes<N>(), {&c.v, &c.spec, &c.tab_x, &c.nrows}};
  st[4] = {reinterpret_cast<const void*>(&x_inverse_len<N>), grid, block_threads<N>(),
           tile_bytes<N>(), {&c.spec, &c.out, &c.tab_x, &c.nrows, &c.scale}};
}

template <int N> void y_steps(Conv& c, Step* st) {
  const dim3 grid(c.kxp / kLines, c.nz);
  st[1] = {reinterpret_cast<const void*>(&y_forward_len<N>), grid, block_threads<N>(),
           tile_bytes<N>(), {&c.spec, &c.tab_y, &c.kx, &c.kxp}};
  st[3] = {reinterpret_cast<const void*>(&y_inverse_len<N>), grid, block_threads<N>(),
           tile_bytes<N>(), {&c.spec, &c.tab_y, &c.kx, &c.kxp}};
}

template <int N> void z_steps(Conv& c, Step* st) {
  st[2] = {reinterpret_cast<const void*>(&z_kernel_len<N>),
           dim3(static_cast<unsigned>(c.ncols / kLines)), block_threads<N>(),
           (stage_otf<N>() ? 2 : 1) * tile_bytes<N>(),
           {&c.spec, &c.otf, &c.tab_z, &c.kx, &c.kxp, &c.ny}};
}

template <int N> void len_steps(int axis, Conv& c, Step* st) {
  if (axis == 0)
    x_steps<N>(c, st);
  else if (axis == 1)
    y_steps<N>(c, st);
  else
    z_steps<N>(c, st);
}

void generic_steps(int axis, Conv& c, Step* st) {
  if (axis == 0) {
    c.px = tile_for(c.nx);
    const dim3 grid(((c.nrows + 1) / 2 + c.px - 1) / c.px);
    const size_t sm = smem_bytes(c.nx, c.px);
    st[0] = {reinterpret_cast<const void*>(&x_forward_kernel), grid, kThreads, sm,
             {&c.v, &c.spec, &c.tab_x, &c.nrows, &c.nx, &c.px, &c.kxp}};
    st[4] = {reinterpret_cast<const void*>(&x_inverse_kernel), grid, kThreads, sm,
             {&c.spec, &c.out, &c.tab_x, &c.nrows, &c.nx, &c.px, &c.kxp, &c.scale}};
  } else if (axis == 1) {
    c.ty = tile_for(c.ny);
    const dim3 grid((c.kx + c.ty - 1) / c.ty, c.nz);
    const size_t sm = smem_bytes(c.ny, c.ty);
    st[1] = {reinterpret_cast<const void*>(&y_kernel), grid, kThreads, sm,
             {&c.spec, &c.tab_y, &c.ny, &c.kx, &c.kxp, &c.ty, &c.minus}};
    st[3] = {reinterpret_cast<const void*>(&y_kernel), grid, kThreads, sm,
             {&c.spec, &c.tab_y, &c.ny, &c.kx, &c.kxp, &c.ty, &c.plus}};
  } else {
    c.tz = tile_for(c.nz);
    st[2] = {reinterpret_cast<const void*>(&z_kernel),
             dim3(static_cast<unsigned>((c.ncols + c.tz - 1) / c.tz)), kThreads,
             smem_bytes(c.nz, c.tz),
             {&c.spec, &c.otf, &c.tab_z, &c.nz, &c.ncols, &c.tz, &c.kx, &c.kxp, &c.ny}};
  }
}

// The five launches for a (nz, ny, nx) grid; bit a of len_mask (0 x, 1 y,
// 2 z) takes that axis's length-specialised transform. Refuses a grid the
// kernel does not take, or a specialised bit on another length.
cudaError_t plan(Conv& c, int nz, int ny, int nx, int len_mask, Step* st) {
  if (nz < 1 || ny < 1 || nx < 2 || nx % 2 != 0 || nz > kMaxLen || ny > kMaxLen ||
      nx > kMaxLen)
    return cudaErrorInvalidValue;
  c.nz = nz;
  c.ny = ny;
  c.nx = nx;
  c.kx = nx / 2 + 1;
  c.kxp = spec_pitch(nx);
  c.nrows = nz * ny;
  c.ncols = (long long)ny * c.kxp;
  c.scale = 1.0f / ((float)nz * (float)ny * (float)nx);
  const int lens[3] = {nx, ny, nz};
  for (int axis = 0; axis < 3; ++axis) {
    if (!(len_mask & (1 << axis))) {
      generic_steps(axis, c, st);
      continue;
    }
    if (!with_len(lens[axis], [&](auto len) { len_steps<decltype(len)::value>(axis, c, st); }))
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <int... R> int write_plan(Radices<R...>, int* out) {
  const int r[] = {R...};
  for (int i = 0; i < static_cast<int>(sizeof...(R)); ++i) out[i] = r[i];
  return static_cast<int>(sizeof...(R));
}

cudaError_t allow_smem(const Step& st) {
  return cudaFuncSetAttribute(st.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(st.smem));
}

}  // namespace

extern "C" {

// One K3 convolution (five launches) on `stream`: out = irfftn(rfftn(v) *
// otf). `spec` holds nz * ny * kxp complex values of scratch, kxp = nx/2+1
// rounded up to 16; tab_* are the (cos, sin)(2 pi t / n) tables of each
// axis length; len_mask as in plan(). Returns the cudaError_t of the
// launches, 0 on success.
int mil_conv3_ct(const float* v, const float2* otf, float2* spec, float* out,
                 const float2* tab_x, const float2* tab_y, const float2* tab_z,
                 int nz, int ny, int nx, int len_mask, void* stream) {
  Conv c{};
  c.v = v;
  c.otf = otf;
  c.spec = spec;
  c.out = out;
  c.tab_x = tab_x;
  c.tab_y = tab_y;
  c.tab_z = tab_z;
  Step st[5];
  cudaError_t err = plan(c, nz, ny, nx, len_mask, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (const Step& step : st) {
    if ((err = allow_smem(step)) != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernel(step.fn, step.grid, dim3(step.threads),
                           const_cast<void**>(step.args), step.smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the five launches of a (nz, ny, nx) grid compile to, 6 ints each
// into out[30], in launch order: registers a thread, local (spilled) bytes
// a thread, static and dynamic shared bytes a block, threads a block,
// resident blocks per SM. Returns a cudaError_t, 0 on success.
int mil_conv3_ct_attrs(int nz, int ny, int nx, int len_mask, int* out) {
  Conv c{};
  Step st[5];
  cudaError_t err = plan(c, nz, ny, nx, len_mask, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < 5; ++i) {
    cudaFuncAttributes a;
    int blocks = 0;
    if ((err = allow_smem(st[i])) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&a, st[i].fn)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, st[i].fn, static_cast<int>(st[i].threads), st[i].smem)) != cudaSuccess)
      return static_cast<int>(err);
    int* o = out + 6 * i;
    o[0] = a.numRegs;
    o[1] = static_cast<int>(a.localSizeBytes);
    o[2] = static_cast<int>(a.sharedSizeBytes);
    o[3] = static_cast<int>(st[i].smem);
    o[4] = static_cast<int>(st[i].threads);
    o[5] = blocks;
  }
  return 0;
}

// What the kernel does with an axis of length n: out[0] the spectrum's row
// pitch where n is nx, out[1..] the radices of its length-specialised
// transform in pass order (at most 7). Returns their count, 0 where n takes
// the generic path.
int mil_conv3_ct_plan(int n, int* out) {
  out[0] = spec_pitch(n);
  int count = 0;
  with_len(n, [&](auto len) {
    count = write_plan(typename Len<decltype(len)::value>::plan{}, out + 1);
  });
  return count;
}

}  // extern "C"
