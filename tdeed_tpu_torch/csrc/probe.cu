// Access-pattern probe kernels for Hopper (sm_90a).
//
// Replaces: tools/profile_pallas_probe.py:run, the Pallas TPU
// microbenchmark, with its three bodies. Each reads x, (H, W, C, N) bf16
// with the batch N minor (the layout of the trunk's early activations on
// the TPU), and writes an array of the same shape:
//   stream  (stream_kernel :96):  o = bf16(x * 1.03125);
//   perpix  (perpix_kernel :100): o[h, w] = bf16(Wt @ x[h, w]) for a
//           (C, C) bf16 weight, fp32 accumulation: the conv1-dx pattern;
//   outerp  (outerp_kernel :113): the stream output, plus
//           acc (C, C) fp32 = sum over (h, w) of x[h, w] @ x[h, w]^T: the
//           conv1-dW pattern (a contraction of length N per pixel).
// Each computes what its Pallas body computes; none is carried over block
// by block.
//
// What bounds them on an H100: memory bytes. At the tool's shape
// (112, 112, 24, 800) each must read 482 MB and write 482 MB, 0.288 ms at
// the published 3.35 TB/s. perpix and outerp do 11.56 GFLOP there (23.12 at
// the stacked (112, 56, 48, 800)): 0.012 ms on the bf16 tensor cores, but
// these kernels run on the fp32 CUDA cores (67 TFLOP/s published, FMA on),
// where 11.56 GFLOP take 0.17 ms and 23.12 take 0.35 ms. So perpix at
// C = 48 sits at the crossing of the two bounds; the rest are bound by
// bytes.
//
// Design, the first simple version:
//   stream: elementwise, 16-byte vector loads and stores when both
//           pointers are 16-byte aligned, a scalar tail.
//   perpix: one block per pixel (h, w); Wt staged in shared memory as fp32,
//           transposed so that one 16-byte broadcast load feeds 8 FMAs.
//           Each thread owns a pair of columns n (N is minor: neighbouring
//           threads read neighbouring addresses) and keeps C x 2 fp32 sums
//           in registers, with k in order. C <= 64, compiled for
//           C in {8, 16, 24, 32, 48, 64} and run at the next size up (the
//           extra rows of the staged weight are zero).
//   outerp: the TPU body keeps one (C, C) accumulator resident across its
//           sequential grid. CUDA blocks run in no set order, so the sum is
//           two passes with no atomics, deterministic: pass 1 gives each of
//           a fixed number of blocks (nparts, 512 or fewer) a contiguous
//           range of pixels; the block stages each pixel's (C, N) slice in
//           shared memory, 256 columns at a time, writes the scaled
//           pass-through, and accumulates x x^T as 4x4 register tiles, the
//           columns split among thread groups; it then sums the groups in a
//           fixed order into its (C, C) partial. Pass 2 sums the partials
//           per entry in a fixed order.
//
// Numerics: bf16 in, fp32 products and sums, one rounding to bf16 out.
// 1.03125 is exact in bf16 and a bf16 x bf16 product is exact in fp32, so
// stream and the pass-through are bit-exact against x * bf16(1.03125).
// Built with FMA on (kernels/build.py): the probe is held to 1 bf16 ulp,
// not to a bit-exact fp32 chain, and a separate multiply and add would
// double the CUDA-core instructions of the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kScale = 1.03125f;
constexpr int kMaxC = 64;
constexpr int kStreamThreads = 256;
constexpr int kPerpixThreads = 256;
constexpr int kKChunk = 8;  // rows of x a perpix thread loads before use
constexpr int kOuterThreads = 256;
constexpr int kChunkPairs = 128;  // column pairs staged per outerp chunk
constexpr int kRowWords = kChunkPairs + 1;  // odd: rows fall in distinct banks
constexpr int kReduceX = 32;
constexpr int kReduceY = 16;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float scaled(float v) { return v * kScale; }

__global__ void __launch_bounds__(kStreamThreads)
    stream_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                  long long n, long long nvec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long i = tid; i < nvec; i += stride) {
    uint4 v = xv[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(scaled(f.x), scaled(f.y));
    }
    yv[i] = v;
  }
  for (long long i = nvec * 8 + tid; i < n; i += stride)
    y[i] = __float2bfloat16_rn(scaled(__bfloat162float(x[i])));
}

template <int CMAX>
__global__ void __launch_bounds__(kPerpixThreads)
    perpix_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                  bf16* __restrict__ o, int C, int N) {
  // ws[k * CMAX + c] = Wt[c, k]; rows and columns from C up are zero
  __shared__ __align__(16) float ws[CMAX * CMAX];
  for (int i = threadIdx.x; i < CMAX * CMAX; i += blockDim.x) {
    const int k = i / CMAX, c = i % CMAX;
    ws[i] = (k < C && c < C) ? __bfloat162float(wt[c * C + k]) : 0.0f;
  }
  __syncthreads();

  const size_t base = (size_t)blockIdx.x * C * N;
  const bf16* xs = x + base;
  bf16* os = o + base;
  for (int n0 = 2 * threadIdx.x; n0 < N; n0 += 2 * blockDim.x) {
    const bool two = n0 + 1 < N;
    float acc[CMAX][2];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) acc[c][0] = acc[c][1] = 0.0f;
    for (int k0 = 0; k0 < C; k0 += kKChunk) {
      float xv[kKChunk][2];
#pragma unroll
      for (int j = 0; j < kKChunk; ++j) {
        const int k = k0 + j;
        const bf16* row = xs + (size_t)k * N + n0;
        xv[j][0] = k < C ? __bfloat162float(row[0]) : 0.0f;
        xv[j][1] = (k < C && two) ? __bfloat162float(row[1]) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kKChunk; ++j) {
        // k0 + j < CMAX: CMAX is a multiple of kKChunk and k0 < C <= CMAX
        const float4* wk = reinterpret_cast<const float4*>(ws + (k0 + j) * CMAX);
#pragma unroll
        for (int c4 = 0; c4 < CMAX / 4; ++c4) {
          const float4 w = wk[c4];
          acc[4 * c4 + 0][0] += w.x * xv[j][0];
          acc[4 * c4 + 0][1] += w.x * xv[j][1];
          acc[4 * c4 + 1][0] += w.y * xv[j][0];
          acc[4 * c4 + 1][1] += w.y * xv[j][1];
          acc[4 * c4 + 2][0] += w.z * xv[j][0];
          acc[4 * c4 + 2][1] += w.z * xv[j][1];
          acc[4 * c4 + 3][0] += w.w * xv[j][0];
          acc[4 * c4 + 3][1] += w.w * xv[j][1];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        bf16* row = os + (size_t)c * N + n0;
        row[0] = __float2bfloat16_rn(acc[c][0]);
        if (two) row[1] = __float2bfloat16_rn(acc[c][1]);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack(bf16 a, bf16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

__global__ void __launch_bounds__(kOuterThreads)
    outerp_partials(const bf16* __restrict__ x, bf16* __restrict__ o,
                    float* __restrict__ partial, long long npix, int C, int N) {
  // bf16 column pairs of one pixel's rows; reused for the group sums
  __shared__ uint32_t tile[kMaxC * kRowWords];
  const int ct = (C + 3) / 4;  // 4x4 output tiles per side
  const int rows = 4 * ct;     // rows from C up stay zero
  const int tiles = ct * ct;
  const int groups = max(1, kOuterThreads / tiles);
  const int tid = threadIdx.x;
  const int my_tile = tid % tiles, g = tid / tiles;
  const bool computes = g < groups;
  const int ra = 4 * (my_tile / ct), rb = 4 * (my_tile % ct);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;

  const long long p_begin = npix * blockIdx.x / gridDim.x;
  const long long p_end = npix * (blockIdx.x + 1) / gridDim.x;
  for (long long pix = p_begin; pix < p_end; ++pix) {
    const bf16* xs = x + (size_t)pix * C * N;
    bf16* os = o + (size_t)pix * C * N;
    for (int n0 = 0; n0 < N; n0 += 2 * kChunkPairs) {
      const int np = min(kChunkPairs, (N - n0 + 1) / 2);
      for (int i = tid; i < rows * np; i += kOuterThreads) {
        const int row = i / np, p = i % np, n = n0 + 2 * p;
        bf16 v0 = __float2bfloat16_rn(0.0f), v1 = v0;
        if (row < C) {
          const size_t at = (size_t)row * N + n;
          v0 = xs[at];
          os[at] = __float2bfloat16_rn(scaled(__bfloat162float(v0)));
          if (n + 1 < N) {
            v1 = xs[at + 1];
            os[at + 1] = __float2bfloat16_rn(scaled(__bfloat162float(v1)));
          }
        }
        tile[row * kRowWords + p] = pack(v0, v1);
      }
      __syncthreads();
      if (computes) {
        for (int p = g; p < np; p += groups) {
          float2 a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[r] = unpack(tile[(ra + r) * kRowWords + p]);
            b[r] = unpack(tile[(rb + r) * kRowWords + p]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              acc[r][s] += a[r].x * b[s].x + a[r].y * b[s].y;
        }
      }
      __syncthreads();
    }
  }

  // the groups' sums, added in group order
  float* red = reinterpret_cast<float*>(tile);  // groups * tiles * 16 <= 4096
  if (computes) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        red[(g * tiles + my_tile) * 16 + r * 4 + s] = acc[r][s];
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * C * C;
  for (int e = tid; e < C * C; e += kOuterThreads) {
    const int c = e / C, d = e % C;
    const int at = ((c / 4) * ct + d / 4) * 16 + (c % 4) * 4 + d % 4;
    float sum = 0.0f;
    for (int k = 0; k < groups; ++k) sum += red[k * tiles * 16 + at];
    out[e] = sum;
  }
}

// acc[e] = sum over the nparts partials, in a fixed order
__global__ void __launch_bounds__(kReduceX * kReduceY)
    outerp_reduce(const float* __restrict__ partial, float* __restrict__ acc,
                  int nparts, int cc) {
  __shared__ float red[kReduceY][kReduceX + 1];
  const int e = blockIdx.x * kReduceX + threadIdx.x;
  float sum = 0.0f;
  if (e < cc)
    for (int p = threadIdx.y; p < nparts; p += kReduceY)
      sum += partial[(size_t)p * cc + e];
  red[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && e < cc) {
    float total = 0.0f;
    for (int y = 0; y < kReduceY; ++y) total += red[y][threadIdx.x];
    acc[e] = total;
  }
}

template <int CMAX>
int launch_perpix(const bf16* x, const bf16* wt, bf16* o, long long npix,
                  int C, int N, cudaStream_t stream) {
  // as few column-pair rounds as 256 threads allow, then as few threads
  // as those rounds need (N = 800: 2 rounds of 224 threads)
  const int pairs = (N + 1) / 2;
  const int rounds = (pairs + kPerpixThreads - 1) / kPerpixThreads;
  const int per_round = (pairs + rounds - 1) / rounds;
  const int threads = (per_round + 31) / 32 * 32;
  perpix_kernel<CMAX><<<(unsigned)npix, threads, 0, stream>>>(x, wt, o, C, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: n bf16 values, contiguous on the current device. y = x * 1.03125.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int tdeed_probe_stream(const void* x, void* y, long long n,
                                  void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long nvec = aligned ? n / 8 : 0;
  const long long work = nvec > n - 8 * nvec ? nvec : n - 8 * nvec;
  const long long blocks = (work + kStreamThreads - 1) / kStreamThreads;
  stream_kernel<<<(unsigned)(blocks < INT_MAX ? blocks : INT_MAX),
                  kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), n, nvec);
  return (int)cudaGetLastError();
}

// x, o: (npix, C, N) bf16; wt: (C, C) bf16; all contiguous on the current
// device, 1 <= C <= 64. o[p] = bf16(wt @ x[p]) with fp32 sums.
extern "C" int tdeed_probe_perpix(const void* x, const void* wt, void* o,
                                  long long npix, int C, int N, void* stream) {
  if (npix <= 0 || npix > INT_MAX || C < 1 || C > kMaxC || N < 1)
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wt);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 8) return launch_perpix<8>(xp, wp, op, npix, C, N, s);
  if (C <= 16) return launch_perpix<16>(xp, wp, op, npix, C, N, s);
  if (C <= 24) return launch_perpix<24>(xp, wp, op, npix, C, N, s);
  if (C <= 32) return launch_perpix<32>(xp, wp, op, npix, C, N, s);
  if (C <= 48) return launch_perpix<48>(xp, wp, op, npix, C, N, s);
  return launch_perpix<64>(xp, wp, op, npix, C, N, s);
}

// x, o: (npix, C, N) bf16; partial: (nparts, C, C) fp32 scratch; acc:
// (C, C) fp32; all contiguous on the current device, 1 <= C <= 64,
// 1 <= nparts <= npix. o = x * 1.03125; acc = sum over p of x[p] @ x[p]^T.
extern "C" int tdeed_probe_outerp(const void* x, void* o, float* partial,
                                  float* acc, long long npix, int C, int N,
                                  int nparts, void* stream) {
  if (npix <= 0 || C < 1 || C > kMaxC || N < 1 || nparts < 1 || nparts > npix)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  outerp_partials<<<nparts, kOuterThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(o), partial, npix, C, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cc = C * C;
  dim3 block(kReduceX, kReduceY);
  outerp_reduce<<<(cc + kReduceX - 1) / kReduceX, block, 0, s>>>(partial, acc,
                                                                  nparts, cc);
  return (int)cudaGetLastError();
}
