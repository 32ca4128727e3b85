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
// the stacked (112, 56, 48, 800)): 0.012 ms on the bf16 tensor cores
// (989 TFLOP/s), but 0.17 and 0.35 ms on the fp32 CUDA cores (67 TFLOP/s).
// At 24 FLOP a byte (C = 48) the CUDA cores cannot keep pace with the
// memory; the tensor cores can, many times over. Both run on the tensor
// cores.
//
// Design:
//   stream: elementwise, 16-byte vector loads and stores when both
//           pointers are 16-byte aligned, a scalar tail.
//   perpix: warp-level bf16 mma.sync (m16n8k16, fp32 sums) fed by cp.async,
//           one instantiation per C padded up to CPAD in {16, 32, 48, 64}.
//           A work item is C rows x bn columns of one pixel (bn a multiple
//           of 16); a block walks a contiguous range of items through a
//           ring of kPerpixStages = 3 tiles in shared memory, so that the
//           copies of the next two items are in flight while one is
//           multiplied and stored. One block per SM (grid = min(items,
//           SMs)); kernels/probe.py:perpix_plan picks CPAD and the widest
//           tiles whose ring fits the block's 227 KB (at N = 800 a whole
//           pixel at C = 24, half of one at C = 48): long contiguous rows
//           are what the memory rewards.
//           - Padding: the (C, C) weight is staged once per block as a
//             zero-padded (CPAD, CPAD) bf16 tile, and each warp keeps all
//             its A fragments in registers ((CPAD / 16)^2 x 4: 36 at
//             C = 48). Rows C..CPAD-1 of every stage tile are zeroed once
//             and never written by a copy; columns past N in a ragged
//             tile are zero-filled by cp.async's src-size operand.
//           - Product: a warp takes 16-column strips; per strip it loads
//             the B fragments of all k with ldmatrix.x4.trans (the tile is
//             row major, N minor) and runs (CPAD / 16)^2 x 2 MMAs.
//           - Epilogue: bf16 pairs into an output tile in shared memory,
//             then 16-byte coalesced stores of rows c < C, columns n < N.
//           - The row stride of a tile is bn + 8 elements: ldmatrix rows
//             and the epilogue's stores fall in distinct banks, and every
//             row stays 16-byte aligned.
//           - Alignment: the 16-byte copies and stores need x and o
//             16-byte aligned and N % 8 == 0. Otherwise the same kernel
//             copies and stores element by element through the same tiles
//             and the same MMAs.
//   outerp: the TPU body keeps one (C, C) accumulator resident across its
//           sequential grid. CUDA blocks run in no set order, so the sum is
//           two passes with no atomics, deterministic. Pass 1 is perpix's
//           shape: the same items, plan (kernels/probe.py:outerp_plan, at
//           N = 800 a whole pixel a tile up to C = 32), ring of kOuterStages
//           = 3 cp.async tiles, padding rows and zero-filled columns, one
//           block per SM.
//           - Product: the Gram x x^T of a tile of rows c, columns n takes
//             the tile as stored for both operands: A (c, n) row major,
//             and B (n, d) in mma's .col layout is x's rows again. So a
//             16-column strip is CPAD / 16 plain ldmatrix.x4 loads, and a
//             warp runs 2 MMAs for each 16x16 block of the sum on or above
//             the diagonal (3 blocks at CPAD 32, 10 at 64), its fp32 sums
//             held in registers across all its items (24 at CPAD 32, 80
//             at 64).
//           - Pass-through: each thread takes 16 bytes of the staged tile,
//             scales them, and stores 16 bytes of o: x is read once.
//           - The block adds its warps' sums in warp order in shared
//             memory and writes its (C, C) partial, mirrored below the
//             diagonal; pass 2 (outerp_reduce) adds the grid's partials
//             per entry in a fixed order.
//
// Numerics: bf16 in, fp32 products and sums, one rounding to bf16 out.
// 1.03125 is exact in bf16 and a bf16 x bf16 product is exact in fp32, so
// stream and the pass-through are bit-exact against x * bf16(1.03125).
// The tensor cores add the products of one k16 step in their own order:
// perpix is held to 1 bf16 ulp of the fp32 einsum, outerp's sum to 1e-5
// of its largest entry against a float64 sum, and two calls give the same
// bits. Built with FMA on (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kScale = 1.03125f;
constexpr int kMaxC = 64;
constexpr int kStreamThreads = 256;
constexpr int kPerpixThreads = 256;
constexpr int kPerpixWarps = kPerpixThreads / 32;
constexpr int kPerpixStages = 3;  // perpix's ring of tiles
constexpr int kStaticSmem = 48 * 1024;  // more needs the opt-in attribute
constexpr int kMaxBlockSmem = 232448;   // 227 KB, a block's most on sm_90
constexpr int kOuterThreads = 256;
constexpr int kOuterWarps = kOuterThreads / 32;
constexpr int kOuterStages = 3;  // outerp's ring of tiles
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

// shared memory of a perpix block: the (CPAD, CPAD) weight, the ring of
// kPerpixStages tiles and one output tile, each (CPAD, bn + 8)
constexpr long long perpix_smem(int cpad, int bn) {
  return 2LL * cpad * cpad + 2LL * (kPerpixStages + 1) * cpad * (bn + 8);
}

// shared memory of an outerp block: the ring of kOuterStages tiles, each
// (CPAD, bn + 8) bf16, and the block's (CPAD, CPAD) fp32 sum
constexpr long long outerp_smem(int cpad, int bn) {
  return 2LL * kOuterStages * cpad * (bn + 8) + 4LL * cpad * cpad;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `bytes` 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's copy groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// four 8x8 bf16 tiles, transposed: the B fragments of a 16 (k) x 16 (n)
// block of a row-major tile, n-columns 0-7 in r[0], r[1], 8-15 in r[2], r[3]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// four 8x8 bf16 tiles as stored: of a 16 (rows) x 16 (columns) block of a
// row-major tile, rows 0-7 | 8-15 of columns 0-7 in r[0] | r[1], of
// columns 8-15 in r[2] | r[3]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a (16x16 bf16, row major) @ b (16x8 bf16), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// o[p] = bf16(wt @ x[p]) for (npix, C, N) x and o. Items are (pixel, column
// tile) in order, `tiles` tiles of bn columns per pixel; block b takes items
// [items * b / grid, items * (b + 1) / grid). Built for one block per SM,
// so no register cap forces a spill.
template <int CPAD>
__global__ void __launch_bounds__(kPerpixThreads, 1)
    perpix_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                  bf16* __restrict__ o, int C, int N, int bn, int tiles,
                  int items, bool vec) {
  constexpr int KT = CPAD / 16;  // 16-wide tiles of the weight, each way
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bn + 8;
  const int tile_elems = CPAD * ld;
  bf16* ws = reinterpret_cast<bf16*>(smem);  // (CPAD, CPAD)
  bf16* ring = ws + CPAD * CPAD;             // kPerpixStages x (CPAD, ld)
  bf16* ot = ring + kPerpixStages * tile_elems;  // (CPAD, ld)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  for (int i = tid; i < CPAD * CPAD; i += kPerpixThreads) {
    const int c = i / CPAD, k = i % CPAD;
    ws[i] = (c < C && k < C) ? wt[c * C + k] : zero;
  }
  for (int s = 0; s < kPerpixStages; ++s)  // rows C..CPAD-1: no copy writes them
    for (int i = tid; i < (CPAD - C) * ld; i += kPerpixThreads)
      ring[s * tile_elems + C * ld + i] = zero;
  __syncthreads();

  // A fragments (m16n8k16, row major): a[m][k] holds rows 16m + g and
  // 16m + g + 8, columns 16k + 2t + {0, 1} and 16k + 2t + 8 + {0, 1}
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[KT][KT][4];
#pragma unroll
  for (int m = 0; m < KT; ++m)
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const bf16* p = ws + (16 * m + g) * CPAD + 16 * k + 2 * t;
      a[m][k][0] = *reinterpret_cast<const uint32_t*>(p);
      a[m][k][1] = *reinterpret_cast<const uint32_t*>(p + 8 * CPAD);
      a[m][k][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[m][k][3] = *reinterpret_cast<const uint32_t*>(p + 8 * CPAD + 8);
    }

  // x[pix][:, tile columns] -> dst (C rows of the tile; columns past N zero)
  auto load = [&](bf16* dst, int pix, int tile) {
    const int n0 = tile * bn, valid = min(bn, N - n0);
    const bf16* src = x + (size_t)pix * C * N + n0;
    if (vec) {
      const int cpr = bn >> 3, full = valid >> 3;  // 16-byte chunks per row
      for (int i = tid; i < C * cpr; i += kPerpixThreads) {
        const int r = i / cpr, j = i - r * cpr;
        const bf16* row = src + (size_t)r * N;
        cp_async16(smem_u32(dst + r * ld + 8 * j), j < full ? row + 8 * j : row,
                   j < full ? 16 : 0);
      }
    } else {
      for (int i = tid; i < C * bn; i += kPerpixThreads) {
        const int r = i / bn, j = i - r * bn;
        dst[r * ld + j] = j < valid ? src[(size_t)r * N + j] : zero;
      }
    }
  };
  // the output tile's rows c < C, columns n < N -> o[pix]
  auto store = [&](int pix, int tile) {
    const int n0 = tile * bn, valid = min(bn, N - n0);
    bf16* dst = o + (size_t)pix * C * N + n0;
    if (vec) {
      const int cpr = valid >> 3;
      for (int i = tid; i < C * cpr; i += kPerpixThreads) {
        const int r = i / cpr, j = i - r * cpr;
        *reinterpret_cast<uint4*>(dst + (size_t)r * N + 8 * j) =
            *reinterpret_cast<const uint4*>(ot + r * ld + 8 * j);
      }
    } else {
      for (int i = tid; i < C * valid; i += kPerpixThreads) {
        const int r = i / valid, j = i - r * valid;
        dst[(size_t)r * N + j] = ot[r * ld + j];
      }
    }
  };

  const int first = (int)((long long)items * blockIdx.x / gridDim.x);
  const int count = (int)((long long)items * (blockIdx.x + 1) / gridDim.x) - first;
  constexpr int pending = kPerpixStages - 1;  // copy groups in flight behind the item in use
  int load_pix = first / tiles, pix = load_pix;
  int load_tile = first % tiles, tile = load_tile;
  int load_buf = 0, buf = 0;
  auto load_next = [&]() {
    load(ring + load_buf * tile_elems, load_pix, load_tile);
    if (++load_buf == kPerpixStages) load_buf = 0;
    if (++load_tile == tiles) load_tile = 0, ++load_pix;
  };

  for (int s = 0; s < pending; ++s) {
    if (s < count) load_next();
    cp_async_commit();  // empty groups keep the count of groups regular
  }
  for (int i = 0; i < count; ++i) {
    // the buffer it fills was last read before the previous item's second sync
    if (i + pending < count) load_next();
    cp_async_commit();
    cp_async_wait<pending>();  // item i's group has landed
    __syncthreads();

    const bf16* xs = ring + buf * tile_elems;
    const int strips = (min(bn, N - tile * bn) + 15) >> 4;
    for (int s = warp; s < strips; s += kPerpixWarps) {
      const int n0 = 16 * s;
      uint32_t b[KT][4];
#pragma unroll
      for (int k = 0; k < KT; ++k)
        ldmatrix_x4_trans(b[k], smem_u32(xs + (16 * k + (lane & 15)) * ld + n0 + (lane >> 4) * 8));
#pragma unroll
      for (int m = 0; m < KT; ++m) {
        float d[2][4] = {};
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          mma_bf16(d[0], a[m][k], b[k][0], b[k][1]);
          mma_bf16(d[1], a[m][k], b[k][2], b[k][3]);
        }
        // accumulator: rows 16m + g (d[h][0..1]) and + 8 (d[h][2..3]),
        // columns n0 + 8h + 2t + {0, 1}
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bf16* p = ot + (16 * m + g) * ld + n0 + 8 * h + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(d[h][0], d[h][1]);
          *reinterpret_cast<__nv_bfloat162*>(p + 8 * ld) =
              __floats2bfloat162_rn(d[h][2], d[h][3]);
        }
      }
    }
    __syncthreads();
    store(pix, tile);
    if (++buf == kPerpixStages) buf = 0;
    if (++tile == tiles) tile = 0, ++pix;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// o[p] = bf16(x[p] * 1.03125) for (npix, C, N) x and o, and partial[b] =
// the (C, C) fp32 sum over block b's items of x[p][:, tile] @ x[p][:, tile]^T.
// Items, tiles and the blocks' ranges as perpix_kernel's. Each warp keeps
// the 16x16 blocks on and above the diagonal of a (CPAD, CPAD) sum in
// registers across all its items; the block adds its warps' sums in warp
// order and mirrors them below the diagonal.
template <int CPAD>
__global__ void __launch_bounds__(kOuterThreads, 1)
    outerp_kernel(const bf16* __restrict__ x, bf16* __restrict__ o,
                  float* __restrict__ partial, int C, int N, int bn, int tiles,
                  int items, bool vec) {
  constexpr int KT = CPAD / 16;              // 16-row blocks of a tile
  constexpr int NB = KT * (KT + 1) / 2;      // 16x16 blocks of the sum on and above the diagonal
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bn + 8;
  const int tile_elems = CPAD * ld;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // kOuterStages x (CPAD, ld)
  float* sum = reinterpret_cast<float*>(ring + kOuterStages * tile_elems);  // (CPAD, CPAD)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // rows C..CPAD-1: no copy writes them; the first item's barrier orders
  // these stores before any read
  for (int s = 0; s < kOuterStages; ++s)
    for (int i = tid; i < (CPAD - C) * ld; i += kOuterThreads)
      ring[s * tile_elems + C * ld + i] = zero;

  // x[pix][:, tile columns] -> dst (C rows of the tile; columns past N zero)
  auto load = [&](bf16* dst, int pix, int tile) {
    const int n0 = tile * bn, valid = min(bn, N - n0);
    const bf16* src = x + (size_t)pix * C * N + n0;
    if (vec) {
      const int cpr = bn >> 3, full = valid >> 3;  // 16-byte chunks per row
      for (int i = tid; i < C * cpr; i += kOuterThreads) {
        const int r = i / cpr, j = i - r * cpr;
        const bf16* row = src + (size_t)r * N;
        cp_async16(smem_u32(dst + r * ld + 8 * j), j < full ? row + 8 * j : row,
                   j < full ? 16 : 0);
      }
    } else {
      for (int i = tid; i < C * bn; i += kOuterThreads) {
        const int r = i / bn, j = i - r * bn;
        dst[r * ld + j] = j < valid ? src[(size_t)r * N + j] : zero;
      }
    }
  };
  // the scaled tile, rows c < C and columns n < N -> o[pix]
  auto pass_through = [&](const bf16* xs, int pix, int tile) {
    const int n0 = tile * bn, valid = min(bn, N - n0);
    bf16* dst = o + (size_t)pix * C * N + n0;
    if (vec) {
      const int cpr = valid >> 3;
      for (int i = tid; i < C * cpr; i += kOuterThreads) {
        const int r = i / cpr, j = i - r * cpr;
        uint4 v = *reinterpret_cast<const uint4*>(xs + r * ld + 8 * j);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h[k]);
          h[k] = __floats2bfloat162_rn(scaled(f.x), scaled(f.y));
        }
        *reinterpret_cast<uint4*>(dst + (size_t)r * N + 8 * j) = v;
      }
    } else {
      for (int i = tid; i < C * valid; i += kOuterThreads) {
        const int r = i / valid, j = i - r * valid;
        dst[(size_t)r * N + j] = __float2bfloat16_rn(scaled(__bfloat162float(xs[r * ld + j])));
      }
    }
  };

  // acc[b][h]: block b = (i, j), i <= j, in row order; n8 half h. The
  // m16n8 accumulator holds rows 16i + g (acc[b][h][0..1]) and + 8
  // ([2..3]), columns 16j + 8h + 2t + {0, 1}
  float acc[NB][2][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][h][e] = 0.0f;

  const int first = (int)((long long)items * blockIdx.x / gridDim.x);
  const int count = (int)((long long)items * (blockIdx.x + 1) / gridDim.x) - first;
  constexpr int pending = kOuterStages - 1;  // copy groups in flight ahead of the item in use
  int load_pix = first / tiles, pix = load_pix;
  int load_tile = first % tiles, tile = load_tile;
  int load_buf = 0, buf = 0;
  auto load_next = [&]() {
    load(ring + load_buf * tile_elems, load_pix, load_tile);
    if (++load_buf == kOuterStages) load_buf = 0;
    if (++load_tile == tiles) load_tile = 0, ++load_pix;
  };

  for (int s = 0; s < pending; ++s) {
    if (s < count) load_next();
    cp_async_commit();  // empty groups keep the count of groups regular
  }
  for (int it = 0; it < count; ++it) {
    cp_async_wait<pending - 1>();  // item it's group has landed
    // every thread's copies of item it have landed, and every thread is
    // done with item it - 1, whose buffer the next copy fills
    __syncthreads();
    if (it + pending < count) load_next();
    cp_async_commit();

    const bf16* xs = ring + buf * tile_elems;
    const int strips = (min(bn, N - tile * bn) + 15) >> 4;
    for (int s = warp; s < strips; s += kOuterWarps) {
      // the strip's 16 columns of every 16-row block: the A operand of
      // block row i and, as stored, the .col B operand of block column j
      uint32_t f[KT][4];
#pragma unroll
      for (int k = 0; k < KT; ++k)
        ldmatrix_x4(f[k], smem_u32(xs + (16 * k + (lane & 15)) * ld + 16 * s + (lane >> 4) * 8));
      int b = 0;
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int j = i; j < KT; ++j, ++b) {
          mma_bf16(acc[b][0], f[i], f[j][0], f[j][2]);
          mma_bf16(acc[b][1], f[i], f[j][1], f[j][3]);
        }
    }
    pass_through(xs, pix, tile);
    if (++buf == kOuterStages) buf = 0;
    if (++tile == tiles) tile = 0, ++pix;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the warps' sums, added in warp order
  const int g = lane >> 2, t = lane & 3;
  for (int w = 0; w < kOuterWarps; ++w) {
    if (warp == w) {
      int b = 0;
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int j = i; j < KT; ++j, ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* p = sum + (16 * i + g) * CPAD + 16 * j + 8 * h + 2 * t;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* at = p + (e >> 1) * 8 * CPAD + (e & 1);
              *at = w == 0 ? acc[b][h][e] : *at + acc[b][h][e];
            }
          }
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.x * C * C;
  for (int e = tid; e < C * C; e += kOuterThreads) {
    const int c = e / C, d = e - c * C;
    out[e] = (c >> 4) <= (d >> 4) ? sum[c * CPAD + d] : sum[d * CPAD + c];
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

// lets `kernel` take a block's most shared memory on the current device;
// the attribute is set once per device, `done` keeps a bit per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ULL << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBlockSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int CPAD>
int launch_perpix(const bf16* x, const bf16* wt, bf16* o, long long npix, int C,
                  int N, int bn, int smem_bytes, int grid, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  if (smem_bytes > kStaticSmem) {
    const cudaError_t err = allow_smem(perpix_kernel<CPAD>, done);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)o % 16 == 0 && N % 8 == 0;
  const int tiles = (N + bn - 1) / bn;
  perpix_kernel<CPAD><<<grid, kPerpixThreads, smem_bytes, stream>>>(
      x, wt, o, C, N, bn, tiles, (int)(npix * tiles), vec);
  return (int)cudaGetLastError();
}

template <int CPAD>
int launch_outerp(const bf16* x, bf16* o, float* partial, float* acc, long long npix,
                  int C, int N, int bn, int smem_bytes, int grid, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  if (smem_bytes > kStaticSmem) {
    const cudaError_t err = allow_smem(outerp_kernel<CPAD>, done);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)o % 16 == 0 && N % 8 == 0;
  const int tiles = (N + bn - 1) / bn;
  outerp_kernel<CPAD><<<grid, kOuterThreads, smem_bytes, stream>>>(
      x, o, partial, C, N, bn, tiles, (int)(npix * tiles), vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cc = C * C;
  outerp_reduce<<<(cc + kReduceX - 1) / kReduceX, dim3(kReduceX, kReduceY), 0, stream>>>(
      partial, acc, grid, cc);
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
// device, 1 <= C <= 64. o[p] = bf16(wt @ x[p]) with fp32 sums. The launch
// plan (kernels/probe.py:perpix_plan): c_pad in {16, 32, 48, 64}, at least
// C; bn a multiple of 16; smem_bytes at least what the tiles take, at most
// 227 KB; 1 <= grid <= items = npix * ceil(N / bn) <= INT_MAX.
extern "C" int tdeed_probe_perpix(const void* x, const void* wt, void* o,
                                  long long npix, int C, int N, int c_pad,
                                  int bn, int smem_bytes, int grid, void* stream) {
  if (npix <= 0 || npix > INT_MAX || C < 1 || C > kMaxC || N < 1 ||
      c_pad < C || c_pad % 16 != 0 || c_pad > kMaxC || bn < 16 || bn % 16 != 0 ||
      smem_bytes < perpix_smem(c_pad, bn) || smem_bytes > kMaxBlockSmem)
    return (int)cudaErrorInvalidValue;
  const long long items = npix * ((N + (long long)bn - 1) / bn);
  if (items > INT_MAX || grid < 1 || grid > items) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wt);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c_pad) {
    case 16: return launch_perpix<16>(xp, wp, op, npix, C, N, bn, smem_bytes, grid, s);
    case 32: return launch_perpix<32>(xp, wp, op, npix, C, N, bn, smem_bytes, grid, s);
    case 48: return launch_perpix<48>(xp, wp, op, npix, C, N, bn, smem_bytes, grid, s);
    default: return launch_perpix<64>(xp, wp, op, npix, C, N, bn, smem_bytes, grid, s);
  }
}

// x, o: (npix, C, N) bf16; partial: (grid, C, C) fp32 scratch; acc:
// (C, C) fp32; all contiguous on the current device, 1 <= C <= 64.
// o = x * 1.03125; acc = sum over p of x[p] @ x[p]^T, fp32 sums. The launch
// plan (kernels/probe.py:outerp_plan): c_pad in {16, 32, 48, 64}, at least
// C; bn a multiple of 16; smem_bytes at least what the ring and the sum
// take, at most 227 KB; 1 <= grid <= items = npix * ceil(N / bn) <= INT_MAX.
extern "C" int tdeed_probe_outerp(const void* x, void* o, float* partial, float* acc,
                                  long long npix, int C, int N, int c_pad, int bn,
                                  int smem_bytes, int grid, void* stream) {
  if (npix <= 0 || npix > INT_MAX || C < 1 || C > kMaxC || N < 1 ||
      c_pad < C || c_pad % 16 != 0 || c_pad > kMaxC || bn < 16 || bn % 16 != 0 ||
      smem_bytes < outerp_smem(c_pad, bn) || smem_bytes > kMaxBlockSmem)
    return (int)cudaErrorInvalidValue;
  const long long items = npix * ((N + (long long)bn - 1) / bn);
  if (items > INT_MAX || grid < 1 || grid > items) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c_pad) {
    case 16: return launch_outerp<16>(xp, op, partial, acc, npix, C, N, bn, smem_bytes, grid, s);
    case 32: return launch_outerp<32>(xp, op, partial, acc, npix, C, N, bn, smem_bytes, grid, s);
    case 48: return launch_outerp<48>(xp, op, partial, acc, npix, C, N, bn, smem_bytes, grid, s);
    default: return launch_outerp<64>(xp, op, partial, acc, npix, C, N, bn, smem_bytes, grid, s);
  }
}
