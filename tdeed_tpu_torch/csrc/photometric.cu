// Fused photometric augmentation for Hopper (sm_90a), kernel K1.
//
// Replaces: tdeed_tpu/kernels/augment.py:photometric_planar, the Pallas TPU
// kernel of the training step's input augmentation. Same function, read
// from and written to the (B, T, H, W, 3) layout the model consumes:
//   /255 -> gated hflip (param 14) -> gated hue shift (rgb->hsv->rgb)
//   -> saturation -> brightness -> contrast toward the frame's gray mean,
//   each clamped to [0, 1] -> gated separable 5-tap reflect-padded blur
//   -> ImageNet standardization -> bf16.
// Per-clip parameters are a (B, 16) fp32 array; layout in
// tdeed_tpu_torch/kernels/augment.py. A gate is on when its value > 0.5.
//
// What bounds it on an H100: memory bytes. At the flagship shape
// (8 x 100 x 224 x 224 x 3, bf16 mixup blend in) the kernel must read 241 MB
// and write 241 MB, 0.144 ms at 3.35 TB/s; the chain is at most ~150 fp32
// operations a pixel (every gate on), 0.09 ms on the CUDA cores.
//
// Design: one launch. Each frame is a thread-block cluster of bands x
// segments CTAs (kernels/augment.py:photometric_plan; 4 x 1 at 224^2). CTA
// r of the cluster owns the band of rows [b * rows, min(H, (b + 1) * rows))
// for b = r / segments, across the column segment [s * seg_w, min(W, (s +
// 1) * seg_w)) for s = r % segments, and walks it in chunks of `chunk`
// rows. One segment, the whole width, whenever a one-row chunk of it fits
// a block's shared memory (frames up to 1,843 bf16 or 2,419 uint8 pixels
// wide); wider frames take the fewest segments that fit, up to 8.
//   - I/O: with one segment a chunk's input rows are one contiguous range,
//     copied to shared memory with 16-byte cp.async (the misaligned head
//     and tail element by element), several stages deep so that the next
//     chunks' copies are in flight while this one is computed: 4 for
//     sweeps without the blur, which take the blur's ring's room, 2 with
//     it. Outputs go to a shared tile laid out with the destination's
//     alignment and leave as 16-byte stores. With segments each row's piece
//     is such a range of its own, in a 16-byte slot at its own alignment
//     (the SEG instantiation), and the blur's stage also holds the 2
//     columns on each side of the segment (reflected at the frame's edges;
//     under the flip, the source columns that mirror them).
//   - Contrast mean (clips with contrast on; the gate is the cluster's):
//     each CTA sweeps its band and segment once for a partial gray sum; after
//     cluster.sync() every CTA adds all partials through distributed shared
//     memory in rank order, so all agree and two calls give the same bits.
//     No atomics, no scratch. The output sweep then reads the band again,
//     mostly from L2 (a band is ~75 KB of bf16 at 224^2). Clips without
//     contrast sweep once.
//   - Blur: a ring of chunk + 4 rows of post-contrast fp32 values in shared
//     memory; a chunk computes the chain on its new rows only, so a band
//     recomputes 2 rows above and 2 below it. The horizontal pass goes
//     first: a lane owns a column in every chunk and walks it down the
//     chunk's new rows, taking the 5-tap sum from its neighbour lanes by
//     warp shuffles (a warp blurs 28 columns; its 2 lanes at each end
//     compute their columns only for their neighbours), into the ring. The
//     vertical pass then walks the lane's own ring column (its own writes,
//     so no barrier) with its 5-row window in registers, straight to the
//     output tile. Row and column indices and reflections are worked out
//     once per row or column, not per element. (The plain chain blurs
//     vertically first; the order changes fp32 rounding only.)
// The hflip is a reversed source column (the chain commutes with the
// flip). Gates are uniform per clip, hence per cluster: no divergence.
//
// Numerics: fp32 throughout, FMA on, no fast math. Divisions by constants
// are multiplies by reciprocals, hue's three divisions by `safe` one
// reciprocal and three multiplies; within 1 bf16 ulp of the plain chain
// (chip_smoke.py, tests/test_torch_kernel_gpu.py). Hue uses x - floor(x)
// for Python's floor-mod (h can be negative).
//
// Time: see PERF.md (NVIDIA H100 80GB HBM3, 700 W).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kNumParams = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // per SM: a register cap of 85
constexpr int kHalo = 2;
constexpr int kOwned = 32 - 2 * kHalo;  // columns a warp blurs in a pass
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kMaxChunk = 8;
constexpr int kDeep = 4;  // stages of the sweeps without the blur
constexpr int kStaticSmem = 48 * 1024;  // more needs the opt-in attribute
constexpr int kMaxBlockSmem = 232448;   // 227 KB, a block's most on sm_90
constexpr int kHeader = 128;  // params, warp sums and the band's partial sum

__host__ __device__ constexpr long long up16(long long b) { return (b + 15) / 16 * 16; }

// Shared memory of one block, all dynamic, as kernels/augment.py:
// photometric_smem: a header, the ring of chunk + 4 fp32 rows, two input
// stages of chunk + 4 rows, the output tile of chunk rows, each row
// seg_w pixels wide (the whole width w with one segment). With one segment
// the rows of a chunk are one contiguous range, staged as one with 16
// bytes for a misaligned head; with several, each row is a range of its
// own in a 16-byte slot with room for its head (`per_row`), and an input
// row also holds the blur's 2 + 2 halo columns.
__host__ __device__ constexpr long long rows_bytes(int n, int px, int bytes, bool per_row) {
  return per_row ? n * up16(3LL * px * bytes + 16) : up16(3LL * n * px * bytes + 16);
}
__host__ __device__ constexpr long long ring_bytes(int seg_w, int chunk) {
  return up16(4LL * (chunk + 2 * kHalo) * 3 * seg_w);
}
__host__ __device__ constexpr long long stage_bytes(int seg_w, int in_bytes, int chunk,
                                                    bool per_row) {
  return rows_bytes(chunk + 2 * kHalo, per_row ? seg_w + 2 * kHalo : seg_w, in_bytes, per_row);
}
__host__ __device__ constexpr long long tile_bytes(int seg_w, int chunk, bool per_row) {
  return rows_bytes(chunk, seg_w, 2, per_row);
}
// a stage of the sweeps without the blur: chunk rows, no halo
__host__ __device__ constexpr long long deep_stage_bytes(int seg_w, int in_bytes, int chunk,
                                                         bool per_row) {
  return rows_bytes(chunk, seg_w, in_bytes, per_row);
}
__host__ __device__ constexpr long long photometric_smem(int seg_w, int in_bytes, int chunk,
                                                         bool per_row) {
  return kHeader + ring_bytes(seg_w, chunk) + 2 * stage_bytes(seg_w, in_bytes, chunk, per_row) +
         tile_bytes(seg_w, chunk, per_row);
}
// elements of one row's slot in a per-row layout
__host__ __device__ constexpr int slot_elems(int px, int bytes) {
  return (int)(up16(3LL * px * bytes + 16) / bytes);
}

__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Python's x % 1.0 for the range hue takes here
__device__ __forceinline__ float wrap01(float x) { return x - floorf(x); }

// rgb->hsv, shift h, hsv->rgb (torchvision adjust_hue math, as in
// tdeed_tpu/kernels/augment.py:_hue_shift)
__device__ __forceinline__ void hue_shift(float& r, float& g, float& b, float shift) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = maxc - minc;
  const float inv = __frcp_rn(delta > 0.0f ? delta : 1.0f);
  const float rc = (maxc - r) * inv;
  const float gc = (maxc - g) * inv;
  const float bc = (maxc - b) * inv;
  float h = maxc == r ? bc - gc : (maxc == g ? 2.0f + rc - bc : 4.0f + gc - rc);
  h = delta > 0.0f ? h : 0.0f;
  h = wrap01(h * (1.0f / 6.0f));
  const float s = maxc > 0.0f ? delta * __frcp_rn(maxc) : 0.0f;
  const float v = maxc;

  h = wrap01(h + shift);
  const float h6 = h * 6.0f;
  const float i = floorf(h6);
  const float f = h6 - i;
  const float pp = v * (1.0f - s);
  const float q = v * (1.0f - s * f);
  const float t = v * (1.0f - s * (1.0f - f));
  // the sector's (r, g, b): 0 (v, t, pp), 1 (q, v, pp), 2 (pp, v, t),
  // 3 (pp, q, v), 4 (t, pp, v), 5 (v, pp, q); selects, not a switch, so
  // that a warp's lanes in different sectors do not diverge
  const int i6 = ((int)i) % 6;  // h6 can round up to 6.0
  r = (i6 == 0 || i6 == 5) ? v : (i6 == 1 ? q : (i6 == 4 ? t : pp));
  g = (i6 == 1 || i6 == 2) ? v : (i6 == 0 ? t : (i6 == 3 ? q : pp));
  b = (i6 == 3 || i6 == 4) ? v : (i6 == 2 ? t : (i6 == 5 ? q : pp));
}

__device__ __forceinline__ float gray(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

// a clip's gates and factors, held in registers; a stage whose gate is off
// is skipped, which gives the same bits as the reference's factor of 1
struct Gates {
  bool hue, sat, bri, con;
  float shift, sat_f, bri_f, con_f, mean;
};

// /255, hue, saturation, brightness: everything before the contrast mean
template <typename T>
__device__ __forceinline__ void pointwise(const T* px, const Gates& q, float& r,
                                          float& g, float& b) {
  constexpr float k = 1.0f / 255.0f;
  r = to_float(px[0]) * k;
  g = to_float(px[1]) * k;
  b = to_float(px[2]) * k;
  if (q.hue) hue_shift(r, g, b, q.shift);
  if (q.sat) {
    const float gy = gray(r, g, b);
    r = clamp01(q.sat_f * r + (1.0f - q.sat_f) * gy);
    g = clamp01(q.sat_f * g + (1.0f - q.sat_f) * gy);
    b = clamp01(q.sat_f * b + (1.0f - q.sat_f) * gy);
  }
  if (q.bri) {
    r = clamp01(r * q.bri_f);
    g = clamp01(g * q.bri_f);
    b = clamp01(b * q.bri_f);
  }
}

// the chain up to the blur: pointwise, then contrast toward the mean
template <typename T>
__device__ __forceinline__ void chain(const T* px, const Gates& q, float (&c)[3]) {
  pointwise(px, q, c[0], c[1], c[2]);
  if (q.con) {
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = clamp01(q.con_f * c[k] + (1.0f - q.con_f) * q.mean);
  }
}

__device__ __forceinline__ bf16 standardize(float v, int c) {
  const float m = c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
  const float inv_s = c == 0 ? 1.0f / 0.229f : (c == 1 ? 1.0f / 0.224f : 1.0f / 0.225f);
  return __float2bfloat16_rn((v - m) * inv_s);
}

// width-2 reflect padding: [x2, x1 | x0 ... x_{n-1} | x_{n-2}, x_{n-3}];
// the clamp only guards slots no valid output reads
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's copy groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// the element offset that gives a buffer of T the alignment of p mod 16
template <typename T>
__device__ __forceinline__ int pad_of(const void* p) {
  return (int)(((uintptr_t)p & 15) / sizeof(T));
}

// src[0, n) -> buf[pad_of(src) + i]: 16-byte cp.async for the aligned
// middle, element copies for the head and the tail
template <typename T>
__device__ void stage(const T* src, int n, T* buf) {
  constexpr int V = 16 / sizeof(T);
  const int pad = pad_of<T>(src);
  const int head = pad ? min(V - pad, n) : 0;
  const int nvec = (n - head) / V;
  T* dst = buf + pad;
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  for (int i = threadIdx.x; i < nvec; i += kThreads)
    cp_async16(smem_u32(dst + head + i * V), src + head + i * V);
  for (int i = head + nvec * V + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// tile[pad_of(dst) + i] -> dst[0, n), 16-byte stores for the aligned middle
__device__ void store(const bf16* tile, bf16* dst, int n) {
  const int pad = pad_of<bf16>(dst);
  const int head = pad ? min(8 - pad, n) : 0;
  const int nvec = (n - head) / 8;
  const bf16* src = tile + pad;
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  for (int i = threadIdx.x; i < nvec; i += kThreads)
    *reinterpret_cast<uint4*>(dst + head + i * 8) =
        *reinterpret_cast<const uint4*>(src + head + i * 8);
  for (int i = head + nvec * 8 + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Chunks k = 0..nk-1: rows(k, a, b) names the frame rows [a, b) chunk k
// stages; fetch(s, a, b) copies them into stage s; work(k, s, a, b) runs
// once they have landed, and ends with a barrier after its last read of
// stage s (chunk k + S's copy overwrites it). S stages: the copies of
// chunks k + 1 .. k + S - 1 are in flight during work(k).
template <int S, typename Rows, typename Fetch, typename Work>
__device__ void sweep(int nk, Rows rows, Fetch fetch, Work work) {
  auto go = [&](int k) {
    int a, b;
    rows(k, a, b);
    fetch(k % S, a, b);
  };
  for (int k = 0; k < S - 1; ++k) {
    if (k < nk) go(k);
    cp_async_commit();  // empty groups keep the count regular
  }
  for (int k = 0; k < nk; ++k) {
    if (k + S - 1 < nk) go(k + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();  // chunk k's group has landed
    __syncthreads();
    int a, b;
    rows(k, a, b);
    work(k, k % S, a, b);
  }
}

// SEG: the CTAs of a frame's cluster are bands x column segments, and
// staged rows and tile rows lie in slots of their own; without it a CTA's
// band is the frame's whole width and a chunk's rows are one range. The
// segmented instantiation is capped at 2 blocks per SM, 128 registers: its
// segments are at least half of what a block's shared memory takes, so a
// third block never fits beside them.
template <typename T, bool SEG>
__global__ void __launch_bounds__(kThreads, SEG ? 2 : kMinBlocks)
    photometric_kernel(const T* __restrict__ x, const float* __restrict__ params,
                       bf16* __restrict__ out, int t_len, int h, int w, int rows,
                       int segments, int seg_w, int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int band = SEG ? rank / segments : rank;
  const int seg = SEG ? rank - band * segments : 0;
  const long long frame = blockIdx.x / cs;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p = reinterpret_cast<float*>(smem);  // kNumParams
  float* warp_sums = p + kNumParams;          // kWarps
  float& partial = warp_sums[kWarps];
  const int we = 3 * w;
  const int span = SEG ? seg_w : w;  // pixels of a segment's row, the last one's at most
  const int rw = SEG ? 3 * seg_w : we;  // elements of a ring row
  const int K = chunk + 2 * kHalo;  // ring rows
  float* ring = reinterpret_cast<float*>(smem + kHeader);
  const long long sbytes = stage_bytes(span, sizeof(T), chunk, SEG);
  T* stages = reinterpret_cast<T*>(smem + kHeader + ring_bytes(span, chunk));
  const int stage_elems = (int)(sbytes / sizeof(T));
  bf16* tile = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(stages) + 2 * sbytes);
  // sweeps without the blur take the ring's and the stages' room for
  // kDeep stages of chunk rows (photometric_smem's layout leaves
  // room for them at any width and chunk)
  T* deep = reinterpret_cast<T*>(smem + kHeader);
  const int deep_elems = (int)(deep_stage_bytes(span, sizeof(T), chunk, SEG) / sizeof(T));
  // SEG: elements of a row's slot in a blur stage, a deep stage, the tile
  const int in_slot = slot_elems(span + 2 * kHalo, sizeof(T));
  const int deep_slot = slot_elems(span, sizeof(T));
  const int tile_slot = slot_elems(span, 2);

  const int tid = threadIdx.x;
  if (tid < kNumParams) p[tid] = params[(frame / t_len) * kNumParams + tid];
  __syncthreads();
  const T* src = x + frame * h * we;
  bf16* dst = out + frame * h * we;
  const bool flip = p[14] > 0.5f;
  Gates q{p[0] > 0.5f, p[2] > 0.5f, p[4] > 0.5f, p[6] > 0.5f,
          p[1], p[3], p[5], p[7], 0.0f};
  const int r0 = band * rows, r1 = min(h, r0 + rows);
  const int nk = (r1 - r0 + chunk - 1) / chunk;
  // the output columns [s0, s0 + sw) of this CTA's segment; their pixels
  // come from the source columns [c0, c0 + sw) (mirrored under the flip),
  // their blur from [h0, h1): 2 more on each side that lie in the frame
  const int s0 = seg * span;
  const int sw = SEG ? min(w - s0, seg_w) : w;
  const int c0 = flip ? w - s0 - sw : s0;
  const int h0 = max(0, c0 - kHalo), h1 = min(w, c0 + sw + kHalo);
  auto own_rows = [&](int k, int& a, int& b) {
    a = r0 + k * chunk;
    b = min(r1, a + chunk);
  };
  // frame rows [a, b), source columns [lo, hi) -> buf: one range, or (SEG)
  // a range a row, row y - a in the slot of `slot` elements at its offset
  auto stage_rows = [&](T* buf, int slot, int a, int b, int lo, int hi) {
    if constexpr (SEG) {
      for (int y = a; y < b; ++y)
        stage(src + (long long)y * we + 3 * lo, 3 * (hi - lo), buf + (y - a) * slot);
    } else {
      stage(src + (long long)a * we, (b - a) * we, buf);
    }
  };
  // where stage_rows put frame row y, source column lo
  auto staged = [&](const T* buf, int slot, int a, int y, int lo) -> const T* {
    if constexpr (SEG) return buf + (y - a) * slot + pad_of<T>(src + (long long)y * we + 3 * lo);
    else return buf + pad_of<T>(src + (long long)a * we) + (y - a) * we;
  };
  // the output tile's frame row y, column s0, in a tile that starts at row a
  auto tile_row = [&](int a, int y) -> bf16* {
    if constexpr (SEG)
      return tile + (y - a) * tile_slot + pad_of<bf16>(dst + (long long)y * we + 3 * s0);
    else return tile + pad_of<bf16>(dst + (long long)a * we) + (y - a) * we;
  };
  // the tile -> frame rows [a, b), the segment's columns
  auto store_rows = [&](int a, int b) {
    if constexpr (SEG) {
      for (int y = a; y < b; ++y)
        store(tile + (y - a) * tile_slot, dst + (long long)y * we + 3 * s0, 3 * sw);
    } else {
      store(tile, dst + (long long)a * we, (b - a) * we);
    }
  };
  auto fetch_deep = [&](int st, int a, int b) {
    stage_rows(deep + st * deep_elems, deep_slot, a, b, c0, c0 + sw);
  };
  // this thread's pixels of a chunk, i = tid + kThreads * n, as (row, column)
  const int dy = kThreads / sw, dx = kThreads % sw;
  auto each_pixel = [&](int npx, auto fn) {
    int y = tid / sw, xo = tid % sw;
    for (int i = tid; i < npx; i += kThreads) {
      fn(i, y, xo);
      xo += dx;
      y += dy;
      if (xo >= sw) xo -= sw, ++y;
    }
  };

  if (q.con) {  // the frame's gray mean after hue, saturation, brightness
    float acc = 0.0f;
    sweep<kDeep>(nk, own_rows, fetch_deep, [&](int, int st, int a, int end) {
      const T* buf = deep + st * deep_elems;
      if constexpr (SEG) {
        each_pixel((end - a) * sw, [&](int, int y, int xo) {
          float r, g, b;
          pointwise(staged(buf, deep_slot, a, a + y, c0) + 3 * xo, q, r, g, b);
          acc += gray(r, g, b);
        });
      } else {
        const T* in = staged(buf, 0, a, a, 0);
        const int npx = (end - a) * w;
        for (int i = tid; i < npx; i += kThreads) {
          float r, g, b;
          pointwise(in + 3 * i, q, r, g, b);
          acc += gray(r, g, b);
        }
      }
      __syncthreads();
    });
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((tid & 31) == 0) warp_sums[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int k = 0; k < kWarps; ++k) s += warp_sums[k];
      partial = s;
    }
    cluster.sync();
    float s = 0.0f;
    for (int k = 0; k < cs; ++k) s += *cluster.map_shared_rank(&partial, k);
    q.mean = s / (float)(h * w);
    cluster.sync();  // no CTA leaves while another reads its partial
  }

  if (!(p[8] > 0.5f)) {  // no blur: one pixel per thread
    sweep<kDeep>(nk, own_rows, fetch_deep, [&](int, int st, int a, int end) {
      const T* buf = deep + st * deep_elems;
      const T* in = staged(buf, deep_slot, a, a, c0);
      bf16* ot = tile_row(a, a);
      each_pixel((end - a) * sw, [&](int i, int y, int xo) {
        const int sx = flip ? sw - 1 - xo : xo;
        float c[3];
        if constexpr (SEG) {
          chain(staged(buf, deep_slot, a, a + y, c0) + 3 * sx, q, c);
          bf16* o = tile_row(a, a + y) + 3 * xo;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) o[ch] = standardize(c[ch], ch);
        } else {
          chain(in + (y * w + sx) * 3, q, c);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) ot[3 * i + ch] = standardize(c[ch], ch);
        }
      });
      __syncthreads();
      store_rows(a, end);
    });
    return;
  }

  // blur, horizontal pass first: warp g of a pass over the columns takes
  // columns [b0 + 28 g - 2, b0 + 28 g + 30), one a lane, the 2 at each end
  // only to give their neighbours the reflected 5-tap window; a lane
  // computes the chain of its column down the chunk's new rows, takes the
  // horizontal sum from its neighbours' lanes, and keeps it in the ring
  // (row y in slot y % K). The vertical pass then walks the lane's own
  // column of the ring (its own writes: no barrier), its 5-row window in
  // registers. A segment's passes cover its own columns; its halo columns
  // are staged beside them.
  const float k0 = p[9], k1 = p[10], k2 = p[11], k3 = p[12], k4 = p[13];
  auto new_rows = [&](int k, int& a, int& b) {
    const int y = r0 + k * chunk;
    a = k == 0 ? max(0, y - kHalo) : min(h, y + kHalo);
    b = min(h, min(r1, y + chunk) + kHalo);
  };
  const int lane = tid & 31;
  const int lane_col = (tid >> 5) * kOwned + lane - kHalo;  // in a pass
  const bool inner = lane >= kHalo && lane < 32 - kHalo;
  auto fetch_blur = [&](int st, int a, int b) {
    stage_rows(stages + st * stage_elems, in_slot, a, b, h0, h1);
  };
  sweep<2>(nk, new_rows, fetch_blur, [&](int k, int st, int a, int end) {
    const T* buf = stages + st * stage_elems;
    const int y0 = r0 + k * chunk;
    const int nrow = min(r1, y0 + chunk) - y0;
    // ring row of frame row y in [y0 - 2, y0 + nrow + 2), reflected: y % K
    // from y0 % K without a division per row
    const int y0_slot = y0 % K;
    auto row = [&](int y) {
      int sl = y0_slot + reflect(y, h) - y0;
      sl += sl < 0 ? K : 0;
      sl -= sl >= K ? K : 0;
      return ring + sl * rw;
    };
    for (int b0 = s0; b0 < s0 + sw; b0 += kWarps * kOwned) {
      const int col = b0 + lane_col;
      const int rc = col - s0;  // its column in the ring and the tile
      const bool owned = inner && col < s0 + sw;
      const int pc = reflect(col, w);
      // the source column; past a segment's halo, a lane whose value no
      // owned lane reads stays inside the staged columns
      const int fc = flip ? w - 1 - pc : pc;
      const int sc = SEG ? min(max(fc, h0), h1 - 1) : fc;
      const T* px = staged(buf, in_slot, a, a, h0) + (sc - h0) * 3;
      int slot = a % K;
      for (int y = a; y < end; ++y) {
        if constexpr (SEG) px = staged(buf, in_slot, a, y, h0) + (sc - h0) * 3;
        float c[3];
        chain(px, q, c);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float l2 = __shfl_up_sync(0xffffffffu, c[ch], 2);
          const float l1 = __shfl_up_sync(0xffffffffu, c[ch], 1);
          const float u1 = __shfl_down_sync(0xffffffffu, c[ch], 1);
          const float u2 = __shfl_down_sync(0xffffffffu, c[ch], 2);
          float s = k0 * l2;
          s = s + k1 * l1;
          s = s + k2 * c[ch];
          s = s + k3 * u1;
          s = s + k4 * u2;
          if (owned) ring[slot * rw + 3 * rc + ch] = s;
        }
        slot = slot + 1 == K ? 0 : slot + 1;
        if constexpr (!SEG) px += we;
      }
      if (!owned) continue;
      float win[4][3];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) win[i][ch] = row(y0 + i - kHalo)[3 * rc + ch];
#pragma unroll
      for (int r = 0; r < kMaxChunk; ++r) {
        if (r == nrow) break;
        const float* next = row(y0 + r + kHalo) + 3 * rc;
        bf16* o = tile_row(y0, y0 + r) + 3 * rc;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float w4 = next[ch];
          float s = k0 * win[0][ch];
          s = s + k1 * win[1][ch];
          s = s + k2 * win[2][ch];
          s = s + k3 * win[3][ch];
          s = s + k4 * w4;
          o[ch] = standardize(s, ch);
          win[0][ch] = win[1][ch], win[1][ch] = win[2][ch], win[2][ch] = win[3][ch];
          win[3][ch] = w4;
        }
      }
    }
    __syncthreads();
    store_rows(y0, y0 + nrow);
  });
}

// lets photometric_kernel<T, SEG> take a block's most shared memory on the
// current device; the attribute is set once per device
template <typename T, bool SEG>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ULL << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(photometric_kernel<T, SEG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBlockSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, bool SEG>
int launch(const void* frames, const float* params, void* out, int n_frames,
           int t_len, int h, int w, int bands, int rows, int segments, int seg_w,
           int chunk, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > kStaticSmem) {
    const cudaError_t err = allow_smem<T, SEG>();
    if (err != cudaSuccess) return (int)err;
  }
  const int cluster = bands * segments;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_frames * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the launch's own error: the runtime's last error may be an earlier call's
  return (int)cudaLaunchKernelEx(&cfg, photometric_kernel<T, SEG>,
                                 static_cast<const T*>(frames), params,
                                 static_cast<bf16*>(out), t_len, h, w, rows, segments,
                                 seg_w, chunk);
}

template <typename T>
int launch_for(const void* frames, const float* params, void* out, int n_frames,
               int t_len, int h, int w, int bands, int rows, int segments, int seg_w,
               int chunk, int smem_bytes, cudaStream_t stream) {
  auto go = segments > 1 ? launch<T, true> : launch<T, false>;
  return go(frames, params, out, n_frames, t_len, h, w, bands, rows, segments, seg_w, chunk,
            smem_bytes, stream);
}

}  // namespace

// frames: (B, T, H, W, 3) uint8 (in_kind 0) or bf16 (in_kind 1), values
// 0..255; params: (B, 16) fp32; out: (B, T, H, W, 3) bf16; all contiguous
// on the current device, H, W >= 3. The launch plan
// (kernels/augment.py:photometric_plan): a cluster of bands x segments
// CTAs per frame, at most 8; `bands` bands of `rows` rows, every band
// non-empty and together exactly H rows; `segments` column segments of
// seg_w pixels, every one non-empty and together exactly W columns (one
// segment: seg_w = W); 1 <= chunk <= min(8, rows); smem_bytes at least
// what the layout takes, at most 227 KB. Returns the CUDA error code of
// the launch (0 on success); a plan that does not match is refused with
// cudaErrorInvalidValue and nothing runs.
extern "C" int tdeed_photometric(const void* frames, int in_kind, const float* params,
                                 void* out, int batch, int t_len, int h, int w, int bands,
                                 int rows, int segments, int seg_w, int chunk,
                                 int smem_bytes, void* stream) {
  const bool per_row = segments > 1;
  if ((in_kind != 0 && in_kind != 1) || batch < 1 || t_len < 1 || h < 3 || w < 3 ||
      bands < 1 || segments < 1 || bands > kMaxCluster || segments > kMaxCluster ||
      bands * segments > kMaxCluster || rows < 1 ||
      (long long)(bands - 1) * rows >= h || (long long)bands * rows < h || seg_w < 1 ||
      (long long)(segments - 1) * seg_w >= w || (long long)segments * seg_w < w ||
      (!per_row && seg_w != w) || chunk < 1 || chunk > kMaxChunk || chunk > rows ||
      smem_bytes < photometric_smem(seg_w, in_kind == 0 ? 1 : 2, chunk, per_row) ||
      smem_bytes > kMaxBlockSmem || (long long)batch * t_len * bands * segments > INT_MAX ||
      (long long)h * 3 * w > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_frames = batch * t_len;
  if (in_kind == 0)
    return launch_for<uint8_t>(frames, params, out, n_frames, t_len, h, w, bands, rows,
                               segments, seg_w, chunk, smem_bytes, s);
  return launch_for<bf16>(frames, params, out, n_frames, t_len, h, w, bands, rows, segments,
                          seg_w, chunk, smem_bytes, s);
}
