// K3: the FFT circular convolution irfftn(rfftn(v) * otf, s=v.shape) for
// Hopper (sm_90a), with every 1-D transform computed here.
//
// Replaces the JAX package's Pallas TPU kernels
// microimagelib_tpu/ops/fft_pallas.py::_kernel_a, _kernel_b, _kernel_c
// (launched by _phase_a/_b/_c, entry conv3_ct). The split is the TPU's:
//   A  x real-to-complex transform, then the forward y transform
//   B  per (ky, kx) column: forward z transform, x OTF, inverse z transform
//   C  inverse y transform, then the complex-to-real x transform, x 1/(nz ny nx)
// v is float32 (nz, ny, nx); the OTF and the spectrum buffer are complex64
// (nz, ny, nx/2+1) in natural order, interleaved (re, im) as torch stores
// complex64. The TPU kernels hold a whole (ny, nx) plane in VMEM, so A and C
// are one launch each there; a 512 x 257 complex plane is 1 MB, beyond the
// 227 KB of shared memory a block may use, so here A and C are two launches
// each (x lines, then y lines) and the spectrum goes through device memory
// between them: five launches per convolution.
//
// Transforms. Each block loads a tile of whole lines into shared memory and
// runs a mixed-radix Stockham FFT over them: radix-4 passes, one radix-2
// pass if needed, and one dense m-point DFT pass for the odd factor m of the
// length (snap_fft_size gives 2^k and 64 * {5, 7, 11, ...}; any odd m
// works, at m multiply-adds per point). Stockham keeps natural order, so no
// permutation pass is needed; each pass ping-pongs between two shared
// buffers. Twiddles are exp(+-2 pi i t / n) from a table of n values that the
// host built in float64 and rounded to float32 (the JAX package builds its
// constants the same way, fft_pallas.py:72-135); all arithmetic is fp32.
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
// Layout and coalescing. x lines are rows (contiguous). y and z lines are
// strided; a block takes a tile of T adjacent kx (or flattened (ky, kx))
// columns, so each line element it loads is T contiguous complex values
// (T = 8: 64 bytes, two full 32-byte sectors).
//
// Cost. Per convolution the five launches read and write ~11 volume-sized
// float32 arrays (the complex half spectrum counts as ~one volume), ~3.7 GB
// at (320, 512, 512), ~1.3 ms at the card's copy bandwidth; the FFT
// arithmetic (~5 n log2 n flops per line per transform) is well under the
// fp32 rate. This first version takes ~4 ms there on an H100: its passes
// move data at about a third of the copy bandwidth, and splitting A and C
// in two adds two spectrum round trips. Keeping a plane on chip (a thread
// block cluster's distributed shared memory holds 1 MB) is later work.
//
// The kernels launch on the caller's stream, do not synchronise and allocate
// nothing: the wrapper (kernels/fft_ct.py) allocates the spectrum buffer and
// the output.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLen = 8192;               // longest line on any axis
constexpr size_t kTileBytes = 64 * 1024;    // target shared memory per block
constexpr int kMaxTile = 8;                 // lines (or line pairs) per block

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
// half spectra of both rows, into spec (nrows, nx/2+1).
__global__ void __launch_bounds__(kThreads)
x_forward_kernel(const float* __restrict__ v, float2* __restrict__ spec,
                 const float2* __restrict__ tab, int nrows, int nx, int pairs) {
  extern __shared__ float2 smem[];
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
      spec[r0 * kx + k] = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    if (r0 + 1 < nrows)
      spec[(r0 + 1) * kx + k] = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  }
}

// Phases A and C, y: for plane z = blockIdx.y and the tile of `tile` kx
// columns starting at blockIdx.x * tile, transform along y in place.
__global__ void __launch_bounds__(kThreads)
y_kernel(float2* __restrict__ spec, const float2* __restrict__ tab, int ny, int kx,
         int tile, float sign) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + (size_t)ny * tile;
  const int c0 = blockIdx.x * tile;
  float2* plane = spec + (size_t)blockIdx.y * ny * kx;
  for (int i = threadIdx.x; i < ny * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    a[i] = (c0 + t < kx) ? plane[(size_t)j * kx + c0 + t] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  fft_lines(a, b, ny, tile, 1, tile, true, sign, tab);
  for (int i = threadIdx.x; i < ny * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    if (c0 + t < kx) plane[(size_t)j * kx + c0 + t] = a[i];
  }
}

// Phase B: for the tile of `tile` flattened (ky, kx) columns starting at
// blockIdx.x * tile, forward z transform, times the OTF, inverse z
// transform, in place.
__global__ void __launch_bounds__(kThreads)
z_kernel(float2* __restrict__ spec, const float2* __restrict__ otf,
         const float2* __restrict__ tab, int nz, long long ncols, int tile) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + (size_t)nz * tile;
  const long long c0 = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < nz * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    a[i] = (c0 + t < ncols) ? spec[j * ncols + c0 + t] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  fft_lines(a, b, nz, tile, 1, tile, true, -1.f, tab);
  for (int i = threadIdx.x; i < nz * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    if (c0 + t < ncols) a[i] = cmul(a[i], __ldg(otf + j * ncols + c0 + t));
  }
  __syncthreads();
  fft_lines(a, b, nz, tile, 1, tile, true, 1.f, tab);
  for (int i = threadIdx.x; i < nz * tile; i += blockDim.x) {
    const int t = i % tile, j = i / tile;
    if (c0 + t < ncols) spec[j * ncols + c0 + t] = a[i];
  }
}

// Phase C, x: the half spectra of rows 2p and 2p+1 -> both real rows of
// out, times `scale`.
__global__ void __launch_bounds__(kThreads)
x_inverse_kernel(const float2* __restrict__ spec, float* __restrict__ out,
                 const float2* __restrict__ tab, int nrows, int nx, int pairs,
                 float scale) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + (size_t)pairs * nx;
  const int kx = nx / 2 + 1, half = nx / 2;
  const long long p0 = (long long)blockIdx.x * pairs;
  for (int i = threadIdx.x; i < pairs * nx; i += blockDim.x) {
    const int t = i / nx, k = i % nx;
    const long long r0 = 2 * (p0 + t);
    const bool mirror = k > half;
    const int kk = mirror ? nx - k : k;
    float2 fa = make_float2(0.f, 0.f), fb = make_float2(0.f, 0.f);
    if (r0 < nrows) fa = spec[r0 * kx + kk];
    if (r0 + 1 < nrows) fb = spec[(r0 + 1) * kx + kk];
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

// Lines per block: the largest power of two <= kMaxTile whose two shared
// buffers fit kTileBytes (at least 1).
int tile_for(int n) {
  int t = kMaxTile;
  while (t > 1 && 2 * sizeof(float2) * (size_t)n * t > kTileBytes) t /= 2;
  return t;
}

size_t smem_bytes(int n, int tile) { return 2 * sizeof(float2) * (size_t)n * tile; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// One K3 convolution (five launches) on `stream`: out = irfftn(rfftn(v) *
// otf). `spec` holds nz * ny * (nx/2+1) complex values of scratch; tab_* are
// the (cos, sin)(2 pi t / n) tables of each axis length. Returns the
// cudaError_t of the launches, 0 on success.
int mil_conv3_ct(const float* v, const float2* otf, float2* spec, float* out,
                 const float2* tab_x, const float2* tab_y, const float2* tab_z,
                 int nz, int ny, int nx, void* stream) {
  if (nz < 1 || ny < 1 || nx < 2 || nx % 2 != 0 || nz > kMaxLen || ny > kMaxLen ||
      nx > kMaxLen)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kx = nx / 2 + 1;
  const int nrows = nz * ny;
  cudaError_t err;

  const int px = tile_for(nx);
  const size_t sx = smem_bytes(nx, px);
  const int xblocks = ((nrows + 1) / 2 + px - 1) / px;
  const int ty = tile_for(ny);
  const size_t sy = smem_bytes(ny, ty);
  const dim3 yblocks((kx + ty - 1) / ty, nz);
  const int tz = tile_for(nz);
  const size_t sz = smem_bytes(nz, tz);
  const long long ncols = (long long)ny * kx;
  const unsigned zblocks = static_cast<unsigned>((ncols + tz - 1) / tz);
  const float scale = 1.0f / ((float)nz * (float)ny * (float)nx);

  if ((err = allow_smem(x_forward_kernel, sx)) != cudaSuccess) return err;
  if ((err = allow_smem(y_kernel, sy)) != cudaSuccess) return err;
  if ((err = allow_smem(z_kernel, sz)) != cudaSuccess) return err;
  if ((err = allow_smem(x_inverse_kernel, sx)) != cudaSuccess) return err;

  x_forward_kernel<<<xblocks, kThreads, sx, s>>>(v, spec, tab_x, nrows, nx, px);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  y_kernel<<<yblocks, kThreads, sy, s>>>(spec, tab_y, ny, kx, ty, -1.f);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  z_kernel<<<zblocks, kThreads, sz, s>>>(spec, otf, tab_z, nz, ncols, tz);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  y_kernel<<<yblocks, kThreads, sy, s>>>(spec, tab_y, ny, kx, ty, 1.f);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  x_inverse_kernel<<<xblocks, kThreads, sx, s>>>(spec, out, tab_x, nrows, nx, px, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
