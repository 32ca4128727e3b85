// The SGP-Mixer's linear align-corners upsample along time, forward and
// backward, as two kernels (the wrapper is tdeed_tpu_torch/kernels/upsample.py).
//
// Replaces no TPU kernel: the JAX package multiplies by a fixed (T_out,
// T_in) matrix that XLA runs as a small GEMM. Eager PyTorch ran ATen's
// upsample_linear1d, which launches one thread per output time step (50 or
// 100 threads) that loops over every (batch, channel) row, its backward
// with two bf16 atomic adds a row: ~3.4 ms a call for under 1 MB moved.
//
// Bound: the launch. A call reads its input once and writes its output
// once, (B, C, T_in) and (B, C, T_out): at most 0.9 MB at the mixer's
// shapes, 0.3 us at 3.35 TB/s.
//
// Design. A block owns ct consecutive channels of one batch row, whole in
// time. It stages its (ct, T) slab of the input (forward) or of the output
// gradient (backward) in shared memory as fp32, reading along the tensor's
// unit-stride axis: across channels when channels are innermost (the
// mixer's LayerNorm output), else along time, 16 bytes a load where the
// strides and the address allow. Beside it the block tabulates each
// output step's source (and, backward, each input step's window) once,
// then computes each element of its result slab with one thread into
// shared memory, and writes the slab of the dense (B, C, T) result, whose
// rows lie back to back, as one flat run of elements, 16 bytes a store
// where they allow.
//
// The source index is ATen's for align_corners: rwidth = (T_in - 1) /
// (T_out - 1) in fp32 (0 for T_out == 1, computed by the wrapper), w1r =
// rwidth * i, w1 = floor(w1r), w1p = (w1 < T_in - 1), lambda1 = w1r - w1,
// lambda0 = 1 - lambda1, with __fmul_rn and __fsub_rn so that no
// multiply-add is contracted into the index. Equal lengths copy, as ATen's
// do. The forward blends in fp32 and rounds once. The backward is a
// gather: the thread of input element j adds lambda0 * dy[i] over the
// outputs i with w1 == j and lambda1 * dy[i] over those with w1 + w1p ==
// j, scanning i over [floor((j - 1) / rwidth) - 1, floor((j + 1) / rwidth)
// + 1] (every i when rwidth is 0), in fp32 and in ascending i, and rounds
// once: no atomics and no zero fill, so a run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_SMEM = 227 * 1024;  // kernels/upsample.py: SMEM_BYTES

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Source {
  int w1, w1p;
  float l0, l1;
};

// ATen's align-corners source index of output step i
__device__ __forceinline__ Source source(int i, int t_in, float rwidth) {
  const float w1r = __fmul_rn(rwidth, (float)i);
  Source s;
  s.w1 = (int)w1r;
  s.w1p = s.w1 < t_in - 1 ? 1 : 0;
  s.l1 = __fsub_rn(w1r, (float)s.w1);
  s.l0 = __fsub_rn(1.f, s.l1);
  return s;
}

// Stage the block's (n, t_len) slab of src (at its (b, c0, 0), strides sc
// and st in elements) into s[c * pitch + t] as fp32. ALONG_C: loads walk
// channels, V a load (sc == 1 when V > 1); else they walk the slab's
// elements in (c, t) order, V a load when the slab is dense.
template <typename T, int V, bool ALONG_C>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long sc, long long st,
                                      int n, int t_len, int pitch, float* s) {
  if (ALONG_C) {
    const int lanes = n / V, items = lanes * t_len;
    for (int k = threadIdx.x; k < items; k += blockDim.x) {
      const int cv = k % lanes, t = k / lanes;
      const T* p = src + t * st + (long long)cv * V * sc;
      if (V > 1) {
        const Pack<T, V> v = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
        for (int j = 0; j < V; ++j) s[(cv * V + j) * pitch + t] = to_f(v.v[j]);
      } else {
        s[cv * pitch + t] = to_f(*p);
      }
    }
  } else {
    const int items = n * t_len / V;
    for (int k = threadIdx.x; k < items; k += blockDim.x) {
      const int f = k * V;
      if (V > 1) {
        const Pack<T, V> v = *reinterpret_cast<const Pack<T, V>*>(src + f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = (f + j) / t_len, t = f + j - c * t_len;
          s[c * pitch + t] = to_f(v.v[j]);
        }
      } else {
        const int c = f / t_len, t = f - c * t_len;
        s[c * pitch + t] = to_f(src[c * sc + t * st]);
      }
    }
  }
}

// Bytes of dynamic shared memory a block takes (kernels/upsample.py
// upsample_plan's smem_bytes): the result slab (ct x t_write of T, rounded
// up to 16 bytes), the staged slab (ct x pitch floats), the source table
// (w1, w1 + w1p, lambda0, lambda1 of each output step) and, backward, each
// input step's window (lo, hi).
__host__ __device__ __forceinline__ size_t smem_bytes(int ct, int pitch, int t_in, int t_out,
                                                      int itemsize, bool backward) {
  const size_t out = ((size_t)ct * (backward ? t_in : t_out) * itemsize + 15) / 16 * 16;
  return out + 4 * ((size_t)ct * pitch + 4 * (size_t)t_out + (backward ? 2 * (size_t)t_in : 0));
}

// One block over ct channels of one batch row: the source table (and the
// backward's windows), the staged slab, then each result element by one
// thread into shared memory, then the slab's rows back to back, W a store.
template <typename T, int V, bool ALONG_C, int W, bool BACKWARD>
__global__ void __launch_bounds__(MAX_THREADS)
tdeed_upsample(const T* __restrict__ src, long long sb, long long sc, long long st,
               T* __restrict__ out, int C, int t_in, int t_out, float rwidth, int ct,
               int pitch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.x * ct, n = min(ct, C - c0);
  const int t_read = BACKWARD ? t_out : t_in, t_write = BACKWARD ? t_in : t_out;
  const bool same = t_in == t_out;  // ATen copies, forward and backward
  T* s_out = reinterpret_cast<T*>(smem);
  float* s_in = reinterpret_cast<float*>(
      smem + ((size_t)ct * t_write * sizeof(T) + 15) / 16 * 16);
  int* s_w1 = reinterpret_cast<int*>(s_in + ct * pitch);
  int* s_w2 = s_w1 + t_out;
  float* s_l0 = reinterpret_cast<float*>(s_w2 + t_out);
  float* s_l1 = s_l0 + t_out;
  int* s_lo = reinterpret_cast<int*>(s_l1 + t_out);
  int* s_hi = s_lo + t_in;

  if (!same) {
    for (int i = threadIdx.x; i < t_out; i += blockDim.x) {
      const Source q = source(i, t_in, rwidth);
      s_w1[i] = q.w1;
      s_w2[i] = q.w1 + q.w1p;
      s_l0[i] = q.l0;
      s_l1[i] = q.l1;
    }
    if (BACKWARD) {
      for (int j = threadIdx.x; j < t_in; j += blockDim.x) {
        int lo = 0, hi = t_out - 1;
        if (rwidth > 0.f) {
          const float a = floorf(__fdiv_rn((float)(j - 1), rwidth));
          const float b = floorf(__fdiv_rn((float)(j + 1), rwidth));
          lo = max(lo, (int)fmaxf(a, -1.f) - 1);
          hi = min(hi, (int)fminf(b, (float)t_out) + 1);
        }
        s_lo[j] = lo;
        s_hi[j] = hi;
      }
    }
  }
  stage<T, V, ALONG_C>(src + blockIdx.y * sb + c0 * sc, sc, st, n, t_read, pitch, s_in);
  __syncthreads();

  const int elems = n * t_write;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int c = e / t_write, t = e - c * t_write;
    const float* row = s_in + c * pitch;
    float v;
    if (same) {
      v = row[t];
    } else if (!BACKWARD) {
      v = s_l0[t] * row[s_w1[t]] + s_l1[t] * row[s_w2[t]];
    } else {
      v = 0.f;
      for (int i = s_lo[t]; i <= s_hi[t]; ++i) {
        if (s_w1[i] == t) v += s_l0[i] * row[i];
        if (s_w2[i] == t) v += s_l1[i] * row[i];
      }
    }
    s_out[e] = from_f<T>(v);
  }
  __syncthreads();

  T* dst = out + ((long long)blockIdx.y * C + c0) * t_write;
  for (int k = threadIdx.x; k < elems / W; k += blockDim.x)
    *reinterpret_cast<Pack<T, W>*>(dst + k * W) =
        *reinterpret_cast<const Pack<T, W>*>(s_out + k * W);
}

template <typename T_, int V_, bool C_, int W_>
struct Tag {
  using T = T_;
  static constexpr int V = V_;
  static constexpr bool ALONG_C = C_;
  static constexpr int W = W_;
};

template <typename T, int N, typename F>
int dispatch_vec(int vec_read, int along_c, int vec_write, F&& f) {
  const bool vr = vec_read == N, vw = vec_write == N;
  if ((vec_read != 1 && !vr) || (vec_write != 1 && !vw)) return (int)cudaErrorInvalidValue;
  if (along_c) {
    if (vr) return vw ? f(Tag<T, N, true, N>{}) : f(Tag<T, N, true, 1>{});
    return vw ? f(Tag<T, 1, true, N>{}) : f(Tag<T, 1, true, 1>{});
  }
  if (vr) return vw ? f(Tag<T, N, false, N>{}) : f(Tag<T, N, false, 1>{});
  return vw ? f(Tag<T, 1, false, N>{}) : f(Tag<T, 1, false, 1>{});
}

// f(Tag) for dtype 0 (bf16) or 1 (fp32); each access 1 element or 16 bytes
template <typename F>
int dispatch(int dtype, int vec_read, int along_c, int vec_write, F&& f) {
  if (dtype == 0) return dispatch_vec<__nv_bfloat16, 8>(vec_read, along_c, vec_write, f);
  if (dtype == 1) return dispatch_vec<float, 4>(vec_read, along_c, vec_write, f);
  return (int)cudaErrorInvalidValue;
}

// the launch is the wrapper's plan (kernels/upsample.py upsample_plan);
// refuse one the kernels cannot run
template <bool BACKWARD>
int launch(const void* src, long long sb, long long sc, long long st, void* out, int dtype,
           int batch, int channels, int t_in, int t_out, float rwidth, int ct, int threads,
           int pitch, int vec_read, int along_c, int vec_write, void* stream) {
  const int t_read = BACKWARD ? t_out : t_in, t_write = BACKWARD ? t_in : t_out;
  const size_t smem =
      smem_bytes(ct, pitch, t_in, t_out, dtype == 0 ? 2 : 4, BACKWARD);
  if (batch <= 0 || batch > 65535 || channels <= 0 || t_in <= 0 || t_out <= 0 || ct <= 0 ||
      threads <= 0 || threads > MAX_THREADS || pitch < t_read || smem > MAX_SMEM ||
      (along_c && ct % vec_read) || channels % (along_c ? vec_read : 1) ||
      (ct * t_write) % vec_write || ((long long)channels * t_write) % vec_write ||
      (!along_c && vec_read > 1 &&
       (st != 1 || (sc != t_read && ct != 1) || (ct * t_read) % vec_read ||
        ((long long)channels * t_read) % vec_read)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((channels + ct - 1) / ct, batch);
  return dispatch(dtype, vec_read, along_c, vec_write, [&](auto tag) {
    using Tg = decltype(tag);
    using T = typename Tg::T;
    auto kernel = tdeed_upsample<T, Tg::V, Tg::ALONG_C, Tg::W, BACKWARD>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const T*)src, sb, sc, st, (T*)out, channels, t_in, t_out, rwidth, ct, pitch);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// y (B, C, t_out) dense from x (B, C, t_in) at strides (sb, sc, st)
int tdeed_upsample_fwd_launch(const void* x, long long sb, long long sc, long long st, void* y,
                              int dtype, int batch, int channels, int t_in, int t_out,
                              float rwidth, int ct, int threads, int pitch, int vec_read,
                              int along_c, int vec_write, void* stream) {
  return launch<false>(x, sb, sc, st, y, dtype, batch, channels, t_in, t_out, rwidth, ct,
                       threads, pitch, vec_read, along_c, vec_write, stream);
}

// dx (B, C, t_in) dense from dy (B, C, t_out) at strides (sb, sc, st)
int tdeed_upsample_bwd_launch(const void* dy, long long sb, long long sc, long long st,
                              void* dx, int dtype, int batch, int channels, int t_in,
                              int t_out, float rwidth, int ct, int threads, int pitch,
                              int vec_read, int along_c, int vec_write, void* stream) {
  return launch<true>(dy, sb, sc, st, dx, dtype, batch, channels, t_in, t_out, rwidth, ct,
                      threads, pitch, vec_read, along_c, vec_write, stream);
}

}  // extern "C"
