// Fused photometric augmentation for Hopper (sm_90a).
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
// and write 241 MB; the pointwise chain is ~100 fp32 operations per pixel,
// far below the card's ratio of operations to bytes.
//
// Design. The TPU kernel kept a whole frame in VMEM (up to 110 MB); a block
// here has 227 KB of shared memory, and one 448x796 fp32 frame is 4.3 MB,
// so the frame is tiled and the contrast mean (a whole-frame reduction) is
// a separate first pass:
//   pass 1: one block per frame reduces the gray mean after hue,
//           saturation and brightness (skipped when contrast is off);
//   pass 2: one thread per output pixel over (frame, 8-row x 32-column
//           tiles). With blur on, the block recomputes the pointwise chain
//           on its tile plus a 2-pixel reflected halo into shared memory,
//           then runs the vertical and the horizontal 5-tap pass there.
// The hflip is a reversed source column (the chain commutes with the flip,
// so flipping the input equals the reference's flip at the end). Gates are
// uniform per clip, hence per block: no divergence. It allocates nothing
// and never synchronizes; the caller gives the per-frame mean scratch.
// This is the first, simple version: no vectorized loads, no TMA. On an
// H100 80GB HBM3 at 700 W it takes 0.73 ms at the flagship shape, 664 GB/s
// or 20% of the card's 3.35 TB/s; the plain PyTorch chain takes 31 ms.
//
// Numerics: fp32 throughout, compiled with --fmad=false and without fast
// math so every multiply and add rounds as in the fp32 reference chain;
// hue uses x - floor(x) for Python's floor-mod (h can be negative).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNumParams = 16;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHalo = 2;
constexpr int kThreads = kTileW * kTileH;
constexpr int kPass1Threads = 256;

__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Python's x % 1.0 for the range hue takes here
__device__ __forceinline__ float wrap01(float x) { return x - floorf(x); }

// rgb->hsv, shift h, hsv->rgb (torchvision adjust_hue math, as in
// tdeed_tpu/kernels/augment.py:_hue_shift)
__device__ void hue_shift(float& r, float& g, float& b, float shift) {
  float maxc = fmaxf(fmaxf(r, g), b);
  float minc = fminf(fminf(r, g), b);
  float delta = maxc - minc;
  float safe = delta > 0.0f ? delta : 1.0f;
  float rc = (maxc - r) / safe;
  float gc = (maxc - g) / safe;
  float bc = (maxc - b) / safe;
  float h = maxc == r ? bc - gc
                      : (maxc == g ? 2.0f + rc - bc : 4.0f + gc - rc);
  h = delta > 0.0f ? h : 0.0f;
  h = wrap01(h / 6.0f);
  float s = maxc > 0.0f ? delta / maxc : 0.0f;
  float v = maxc;

  h = wrap01(h + shift);
  float h6 = h * 6.0f;
  float i = floorf(h6);
  float f = h6 - i;
  float pp = v * (1.0f - s);
  float q = v * (1.0f - s * f);
  float t = v * (1.0f - s * (1.0f - f));
  int i6 = ((int)i) % 6;  // h6 can round up to 6.0
  switch (i6) {
    case 0: r = v; g = t; b = pp; break;
    case 1: r = q; g = v; b = pp; break;
    case 2: r = pp; g = v; b = t; break;
    case 3: r = pp; g = q; b = v; break;
    case 4: r = t; g = pp; b = v; break;
    default: r = v; g = pp; b = q; break;
  }
}

__device__ __forceinline__ float gray(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

// /255, hue, saturation, brightness: everything before the contrast mean
template <typename T>
__device__ __forceinline__ void pointwise(const T* px, const float* p,
                                          float& r, float& g, float& b) {
  r = to_float(px[0]) / 255.0f;
  g = to_float(px[1]) / 255.0f;
  b = to_float(px[2]) / 255.0f;
  if (p[0] > 0.5f) hue_shift(r, g, b, p[1]);
  float sat = p[2] > 0.5f ? p[3] : 1.0f;
  float gy = gray(r, g, b);
  r = clamp01(sat * r + (1.0f - sat) * gy);
  g = clamp01(sat * g + (1.0f - sat) * gy);
  b = clamp01(sat * b + (1.0f - sat) * gy);
  float bri = p[4] > 0.5f ? p[5] : 1.0f;
  r = clamp01(r * bri);
  g = clamp01(g * bri);
  b = clamp01(b * bri);
}

// pointwise chain + contrast at logical (flipped) pixel (y, x)
template <typename T>
__device__ __forceinline__ void chain(const T* frame, const float* p, int w,
                                      bool flip, float con, float mean, int y,
                                      int x, float& r, float& g, float& b) {
  int sx = flip ? w - 1 - x : x;
  pointwise(frame + ((size_t)y * w + sx) * 3, p, r, g, b);
  r = clamp01(con * r + (1.0f - con) * mean);
  g = clamp01(con * g + (1.0f - con) * mean);
  b = clamp01(con * b + (1.0f - con) * mean);
}

// width-2 reflect padding: [x2, x1 | x0 ... x_{n-1} | x_{n-2}, x_{n-3}];
// the clamp only guards halo cells no valid output reads
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ void store(__nv_bfloat16* o, float r, float g,
                                      float b) {
  o[0] = __float2bfloat16_rn((r - 0.485f) / 0.229f);
  o[1] = __float2bfloat16_rn((g - 0.456f) / 0.224f);
  o[2] = __float2bfloat16_rn((b - 0.406f) / 0.225f);
}

template <typename T>
__global__ void __launch_bounds__(kPass1Threads)
    frame_means(const T* __restrict__ x, const float* __restrict__ params,
                float* __restrict__ means, int t_len, int hw) {
  const int frame = blockIdx.x;
  const float* p = params + (size_t)(frame / t_len) * kNumParams;
  if (!(p[6] > 0.5f)) return;  // contrast off: the mean is never read
  const T* src = x + (size_t)frame * hw * 3;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < hw; i += kPass1Threads) {
    float r, g, b;
    pointwise(src + (size_t)i * 3, p, r, g, b);
    acc += gray(r, g, b);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ float warp_sums[kPass1Threads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < kPass1Threads / 32; ++k) s += warp_sums[k];
    means[frame] = s / (float)hw;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    photometric_out(const T* __restrict__ x, const float* __restrict__ params,
                    const float* __restrict__ means,
                    __nv_bfloat16* __restrict__ out, int t_len, int h, int w) {
  constexpr int SW = kTileW + 2 * kHalo;
  constexpr int SH = kTileH + 2 * kHalo;
  __shared__ float p[kNumParams];
  __shared__ float tile[3][SH][SW];
  __shared__ float vert[3][kTileH][SW];

  const int frame = blockIdx.z;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  if (tid < kNumParams) p[tid] = params[(size_t)(frame / t_len) * kNumParams + tid];
  __syncthreads();

  const T* src = x + (size_t)frame * h * w * 3;
  __nv_bfloat16* dst = out + (size_t)frame * h * w * 3;
  const bool flip = p[14] > 0.5f;
  const bool con_on = p[6] > 0.5f;
  const float con = con_on ? p[7] : 1.0f;
  const float mean = con_on ? means[frame] : 0.0f;
  const int ox = blockIdx.x * kTileW + threadIdx.x;
  const int oy = blockIdx.y * kTileH + threadIdx.y;

  if (!(p[8] > 0.5f)) {  // no blur: one pixel per thread
    if (ox < w && oy < h) {
      float r, g, b;
      chain(src, p, w, flip, con, mean, oy, ox, r, g, b);
      store(dst + ((size_t)oy * w + ox) * 3, r, g, b);
    }
    return;
  }

  // blur: tile + reflected halo of post-contrast values
  const int x0 = blockIdx.x * kTileW - kHalo;
  const int y0 = blockIdx.y * kTileH - kHalo;
  for (int i = tid; i < SH * SW; i += kThreads) {
    int ty = i / SW, tx = i % SW;
    float r, g, b;
    chain(src, p, w, flip, con, mean, reflect(y0 + ty, h),
          reflect(x0 + tx, w), r, g, b);
    tile[0][ty][tx] = r;
    tile[1][ty][tx] = g;
    tile[2][ty][tx] = b;
  }
  __syncthreads();
  const float k0 = p[9], k1 = p[10], k2 = p[11], k3 = p[12], k4 = p[13];
  for (int i = tid; i < kTileH * SW; i += kThreads) {  // along H
    int ty = i / SW, tx = i % SW;
    for (int c = 0; c < 3; ++c) {
      float v = k0 * tile[c][ty][tx];
      v = v + k1 * tile[c][ty + 1][tx];
      v = v + k2 * tile[c][ty + 2][tx];
      v = v + k3 * tile[c][ty + 3][tx];
      v = v + k4 * tile[c][ty + 4][tx];
      vert[c][ty][tx] = v;
    }
  }
  __syncthreads();
  if (ox < w && oy < h) {  // along W
    float rgb[3];
    const int ty = threadIdx.y, tx = threadIdx.x;
    for (int c = 0; c < 3; ++c) {
      float v = k0 * vert[c][ty][tx];
      v = v + k1 * vert[c][ty][tx + 1];
      v = v + k2 * vert[c][ty][tx + 2];
      v = v + k3 * vert[c][ty][tx + 3];
      v = v + k4 * vert[c][ty][tx + 4];
      rgb[c] = v;
    }
    store(dst + ((size_t)oy * w + ox) * 3, rgb[0], rgb[1], rgb[2]);
  }
}

template <typename T>
int launch(const void* frames, const float* params, float* means, void* out,
           int batch, int t_len, int h, int w, cudaStream_t stream) {
  const T* x = static_cast<const T*>(frames);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const int n_frames = batch * t_len;
  frame_means<T><<<n_frames, kPass1Threads, 0, stream>>>(x, params, means,
                                                         t_len, h * w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n_frames);
  dim3 block(kTileW, kTileH);
  photometric_out<T><<<grid, block, 0, stream>>>(x, params, means, o, t_len,
                                                  h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// frames: (B, T, H, W, 3) uint8 (in_kind 0) or bf16 (in_kind 1), values
// 0..255; params: (B, 16) fp32; means: (B*T,) fp32 scratch; out: (B, T, H,
// W, 3) bf16. All contiguous on the current device. Returns the CUDA error
// code of the launches (0 on success).
extern "C" int tdeed_photometric(const void* frames, int in_kind,
                                 const float* params, float* means, void* out,
                                 int batch, int t_len, int h, int w,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == 0)
    return launch<uint8_t>(frames, params, means, out, batch, t_len, h, w, s);
  if (in_kind == 1)
    return launch<__nv_bfloat16>(frames, params, means, out, batch, t_len, h,
                                 w, s);
  return (int)cudaErrorInvalidValue;
}
