// Training-mode BatchNorm (+ optional ReLU) of the RegNet-Y GSF trunk in
// four kernels: the moments, the normalisation, the gradient's two sums and
// the input gradient (the wrapper is tdeed_tpu_torch/kernels/batchnorm.py).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it into about two passes. Eager PyTorch ran it as ~18 full-tensor
// passes and ~50 launches a BatchNorm a step (fp32 moments, bn_fold,
// x * a + b and relu, differentiated by autograd).
//
// Bound: bytes. The work reads x once for the moments, x once and writes y
// once for the normalisation (6 bytes an element in bf16), reads x and the
// output gradient g once for the sums, and x and g once and writes dx once
// for the input gradient (10 bytes): 16 bytes an element at 3.35 TB/s.
//
// Design. The input is channel-innermost: an (M, C) array whose rows lie a
// fixed pitch apart (NCHW in channels_last memory, pitch C; or the GSF
// gate's (B, C, T, H, W) view of the first C channels of a (B, T, H, W,
// C') activation, pitch C'); the outputs are dense. A thread owns V consecutive channels of a row
// (16-byte accesses where C allows, 8 or less otherwise) and walks the rows
// of its block's contiguous slab R rows at a time, so a block's R x C/V
// threads read R whole rows, coalesced. The two reductions keep fp32 sums
// in registers, add them across the block in shared memory and write one
// partial row a block; the last block of each group of GROUP blocks adds
// its group's rows, and the last group to finish adds the group sums
// (__threadfence and atomic tickets). Every sum is taken in an order fixed
// by the launch's shape alone and no float atomics are used, so a run
// repeats bit for bit. The elementwise kernels round where the plain chain
// rounds (each product and each sum to the compute dtype, __fmul_rn and
// __fadd_rn so no multiply-add is contracted), so with the same statistics
// the normalisation gives the plain chain's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 16;        // kernels/batchnorm.py: GROUP
constexpr int MAX_THREADS = 512;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

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

// x rounded to the compute dtype T, as a float
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// SplitBatchNorm's fold (kernels/batchnorm.py bn_fold): inv = w / sqrt(var
// + eps), a = inv and b = bias - mean * inv, each rounded to T
template <typename T>
__device__ __forceinline__ void fold(float mean, float var, float w, float bias, float eps,
                                     float* a, float* b) {
  const float inv = __fmul_rn(w, rsqrtf(__fadd_rn(var, eps)));
  *a = rnd<T>(inv);
  *b = rnd<T>(__fsub_rn(bias, __fmul_rn(mean, inv)));
}

// z = x * a + b with the plain chain's roundings, then ReLU's
template <typename T, bool RELU>
__device__ __forceinline__ float normalise(float x, float a, float b) {
  const float z = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, a)), b));
  return (RELU && z < 0.f) ? 0.f : z;
}

// The cotangent of the pre-ReLU value: ReLU's backward masks g where the
// forward's rounded output was <= 0 (threshold_backward)
template <typename T, bool RELU>
__device__ __forceinline__ float masked(float g, float x, float a, float b) {
  if (!RELU) return g;
  const float z = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, a)), b));
  return z <= 0.f ? 0.f : g;
}

// dx = dz * a + cast(x * k1 + k0) with the roundings of
// kernels/batchnorm.py's _bn_bwd_coeffs, dz the masked cotangent
template <typename T, bool RELU>
__device__ __forceinline__ float input_grad(float g, float x, float a, float b, float k0,
                                            float k1) {
  const float dz = masked<T, RELU>(g, x, a, b);
  const float lin = rnd<T>(__fadd_rn(__fmul_rn(x, k1), k0));
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(dz, a)), lin));
}

// Column sums of the row-major [nrows][ncols] src, times scale, into out,
// in an order fixed by nrows, ncols and blockDim alone: thread t adds rows
// j, j + J, ... of column t % ncols (j = t / ncols, J = blockDim / ncols),
// then the J sums of a column are added in order. tmp holds blockDim
// floats. Every thread of the block calls it.
template <bool GLOBAL>
__device__ void column_sums(const float* src, int nrows, int ncols, float scale, float* tmp,
                            float* out) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (ncols >= nt) {
    for (int c = t; c < ncols; c += nt) {
      float acc = 0.f;
      for (int r = 0; r < nrows; ++r) {
        const float* p = src + (size_t)r * ncols + c;
        acc += GLOBAL ? __ldcg(p) : *p;
      }
      out[c] = acc * scale;
    }
    return;
  }
  const int J = nt / ncols;
  if (t < J * ncols) {
    const int c = t % ncols, j = t / ncols;
    float acc = 0.f;
    for (int r = j; r < nrows; r += J) {
      const float* p = src + (size_t)r * ncols + c;
      acc += GLOBAL ? __ldcg(p) : *p;
    }
    tmp[j * ncols + c] = acc;
  }
  __syncthreads();
  if (t < ncols) {
    float acc = 0.f;
    for (int j = 0; j < J; ++j) acc += tmp[j * ncols + t];
    out[t] = acc * scale;
  }
}

// After each block has written its row of partial ([gridDim][P]): the last
// block of each group of GROUP blocks adds its group's rows into
// group_sums[group], and the last group to finish adds the group sums,
// times scale, into out. Each ticket counts the blocks (or groups) done
// and is set back to 0 by the block that takes the last one, so the next
// launch on the stream finds it at 0. Every thread of the block calls it.
__device__ void finish_sums(const float* partial, int P, float* group_sums, unsigned* tickets,
                            float scale, float* tmp, float* out) {
  __shared__ bool last;
  const int G = gridDim.x, ngroups = (G + GROUP - 1) / GROUP;
  const int g = blockIdx.x / GROUP, first = g * GROUP, n = min(GROUP, G - first);
  __threadfence();  // this block's partial row before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[g], 1u) == (unsigned)(n - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  column_sums<true>(partial + (size_t)first * P, n, P, 1.f, tmp, group_sums + (size_t)g * P);
  if (threadIdx.x == 0) tickets[g] = 0;
  __threadfence();  // this group's sums before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[ngroups], 1u) == (unsigned)(ngroups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  column_sums<true>(group_sums, ngroups, P, scale, tmp, out);
  if (threadIdx.x == 0) tickets[ngroups] = 0;
}

// This thread's V sums of each of two quantities (s, q) into the block's
// partial row [s over C | q over C], then the cross-block sums into out
template <int V>
__device__ void block_partials(const float* s, const float* q, int C, float* smem,
                               float* partial, float* group_sums, unsigned* tickets,
                               float scale, float* out) {
  const int L = C / V, R = blockDim.x / L;
  const int lane = threadIdx.x % L, ry = threadIdx.x / L;
  float* rows = smem;                   // [R][2C]
  float* tmp = smem + (size_t)R * 2 * C;  // blockDim floats
#pragma unroll
  for (int k = 0; k < V; ++k) {
    rows[(size_t)ry * 2 * C + lane * V + k] = s[k];
    rows[(size_t)ry * 2 * C + C + lane * V + k] = q[k];
  }
  __syncthreads();
  column_sums<false>(rows, R, 2 * C, 1.f, tmp, partial + (size_t)blockIdx.x * 2 * C);
  finish_sums(partial, 2 * C, group_sums, tickets, scale, tmp, out);
}

// E[x] and E[x^2] of each channel into moments [2][C]
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS, 2)
tdeed_bn_stats(const T* __restrict__ x, long long ldx, long long M, int C, long long rows_per_block,
               float inv_rows, float* __restrict__ partial, float* __restrict__ group_sums,
               unsigned* __restrict__ tickets, float* __restrict__ moments) {
  extern __shared__ float smem[];
  const int L = C / V, R = blockDim.x / L;
  const int lane = threadIdx.x % L, ry = threadIdx.x / L;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  const size_t stride = (size_t)R * ldx;
  long long r = r0 + ry;
  const T* p = x + (size_t)r * ldx + lane * V;
  for (; r + 3 * R < r1; r += 4 * R, p += 4 * stride) {
    const Pack<T, V> a0 = load<T, V>(p), a1 = load<T, V>(p + stride);
    const Pack<T, V> a2 = load<T, V>(p + 2 * stride), a3 = load<T, V>(p + 3 * stride);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v0 = to_f(a0.v[k]), v1 = to_f(a1.v[k]);
      const float v2 = to_f(a2.v[k]), v3 = to_f(a3.v[k]);
      s[k] += (v0 + v1) + (v2 + v3);
      q[k] += (v0 * v0 + v1 * v1) + (v2 * v2 + v3 * v3);
    }
  }
  for (; r < r1; r += R, p += stride) {
    const Pack<T, V> a0 = load<T, V>(p);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v0 = to_f(a0.v[k]);
      s[k] += v0;
      q[k] += v0 * v0;
    }
  }
  block_partials<V>(s, q, C, smem, partial, group_sums, tickets, inv_rows, moments);
}

// y = relu?(x * a + b) from moments [E[x] | E[x^2]]; block 0 writes stats
// [mean | biased var] and, with update, the running statistics (momentum
// on the old value, flax's convention) and the batch count
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS, 2)
tdeed_bn_apply(const T* __restrict__ x, long long ldx, T* __restrict__ y, long long M, int C,
               long long rows_per_block, const float* __restrict__ moments,
               const float* __restrict__ weight, const float* __restrict__ bias, float eps,
               float* __restrict__ stats, float* __restrict__ running_mean,
               float* __restrict__ running_var, long long* __restrict__ batches, int update,
               float momentum, float one_minus_momentum) {
  extern __shared__ float smem[];  // a[C], b[C]
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float mean = moments[c];
    const float var = __fsub_rn(moments[C + c], __fmul_rn(mean, mean));
    fold<T>(mean, var, weight[c], bias[c], eps, &smem[c], &smem[C + c]);
    if (blockIdx.x == 0) {
      stats[c] = mean;
      stats[C + c] = var;
      if (update) {
        running_mean[c] = __fadd_rn(__fmul_rn(momentum, running_mean[c]),
                                    __fmul_rn(one_minus_momentum, mean));
        running_var[c] = __fadd_rn(__fmul_rn(momentum, running_var[c]),
                                   __fmul_rn(one_minus_momentum, var));
      }
    }
  }
  if (update && blockIdx.x == 0 && threadIdx.x == 0) *batches += 1;
  __syncthreads();
  const int L = C / V, R = blockDim.x / L;
  const int lane = threadIdx.x % L, ry = threadIdx.x / L;
  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = smem[lane * V + k];
    b[k] = smem[C + lane * V + k];
  }
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  const size_t xstride = (size_t)R * ldx, stride = (size_t)R * C;
  long long r = r0 + ry;
  size_t xoff = (size_t)r * ldx + lane * V, off = (size_t)r * C + lane * V;
  for (; r + R < r1; r += 2 * R, xoff += 2 * xstride, off += 2 * stride) {
    const Pack<T, V> x0 = load<T, V>(x + xoff), x1 = load<T, V>(x + xoff + xstride);
    Pack<T, V> y0, y1;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      y0.v[k] = from_f<T>(normalise<T, RELU>(to_f(x0.v[k]), a[k], b[k]));
      y1.v[k] = from_f<T>(normalise<T, RELU>(to_f(x1.v[k]), a[k], b[k]));
    }
    *reinterpret_cast<Pack<T, V>*>(y + off) = y0;
    *reinterpret_cast<Pack<T, V>*>(y + off + stride) = y1;
  }
  if (r < r1) {
    const Pack<T, V> x0 = load<T, V>(x + xoff);
    Pack<T, V> y0;
#pragma unroll
    for (int k = 0; k < V; ++k)
      y0.v[k] = from_f<T>(normalise<T, RELU>(to_f(x0.v[k]), a[k], b[k]));
    *reinterpret_cast<Pack<T, V>*>(y + off) = y0;
  }
}

// Of the pre-ReLU cotangent dz: sums [sum dz | sum dz * x] (fp32)
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS, 2)
tdeed_bn_grad_sums(const T* __restrict__ x, long long ldx, const T* __restrict__ g,
                   long long ldg, long long M, int C,
                   long long rows_per_block, const float* __restrict__ stats,
                   const float* __restrict__ weight, const float* __restrict__ bias, float eps,
                   float* __restrict__ partial, float* __restrict__ group_sums,
                   unsigned* __restrict__ tickets, float* __restrict__ sums) {
  extern __shared__ float smem[];  // a[C], b[C], then block_partials' rows and tmp
  if (RELU) {
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      fold<T>(stats[c], stats[C + c], weight[c], bias[c], eps, &smem[c], &smem[C + c]);
    __syncthreads();
  }
  const int L = C / V, R = blockDim.x / L;
  const int lane = threadIdx.x % L, ry = threadIdx.x / L;
  float a[V], b[V], s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = RELU ? smem[lane * V + k] : 0.f;
    b[k] = RELU ? smem[C + lane * V + k] : 0.f;
    s[k] = q[k] = 0.f;
  }
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  const size_t xstride = (size_t)R * ldx, gstride = (size_t)R * ldg;
  long long r = r0 + ry;
  size_t xoff = (size_t)r * ldx + lane * V, goff = (size_t)r * ldg + lane * V;
  for (; r + R < r1; r += 2 * R, xoff += 2 * xstride, goff += 2 * gstride) {
    const Pack<T, V> x0 = load<T, V>(x + xoff), x1 = load<T, V>(x + xoff + xstride);
    const Pack<T, V> g0 = load<T, V>(g + goff), g1 = load<T, V>(g + goff + gstride);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v0 = to_f(x0.v[k]), v1 = to_f(x1.v[k]);
      const float d0 = masked<T, RELU>(to_f(g0.v[k]), v0, a[k], b[k]);
      const float d1 = masked<T, RELU>(to_f(g1.v[k]), v1, a[k], b[k]);
      s[k] += d0 + d1;
      q[k] += d0 * v0 + d1 * v1;
    }
  }
  if (r < r1) {
    const Pack<T, V> x0 = load<T, V>(x + xoff), g0 = load<T, V>(g + goff);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v0 = to_f(x0.v[k]);
      const float d0 = masked<T, RELU>(to_f(g0.v[k]), v0, a[k], b[k]);
      s[k] += d0;
      q[k] += d0 * v0;
    }
  }
  block_partials<V>(s, q, C, smem + 2 * C, partial, group_sums, tickets, 1.f, sums);
}

// dx = dz * a + cast(x * k1 + k0), k0 and k1 from the global sums and the
// global row count (kernels/batchnorm.py _bn_bwd_coeffs); block 0 writes
// dweight and dbias from this rank's own sums
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(MAX_THREADS, 2)
tdeed_bn_grad_apply(const T* __restrict__ x, long long ldx, const T* __restrict__ g,
                    long long ldg, T* __restrict__ dx, long long M, int C,
                    long long rows_per_block,
                    const float* __restrict__ stats, const float* __restrict__ weight,
                    const float* __restrict__ bias, float eps, const float* __restrict__ sums,
                    const float* __restrict__ global_sums, float n_rows,
                    float* __restrict__ dweight, float* __restrict__ dbias) {
  extern __shared__ float smem[];  // a[C], b[C], k0[C], k1[C]
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float m = stats[c], var = stats[C + c], w = weight[c];
    fold<T>(m, var, w, bias[c], eps, &smem[c], &smem[C + c]);
    const float r = rsqrtf(__fadd_rn(var, eps));
    const float inv = __fmul_rn(w, r);
    const float s0 = global_sums[c], s1 = global_sums[C + c];
    const float d_inv = __fsub_rn(s1, __fmul_rn(m, s0));
    const float d_var =
        __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(w, d_inv), -0.5f), r), r), r);
    const float d_mean = __fsub_rn(__fmul_rn(-inv, s0), __fmul_rn(__fmul_rn(2.f, m), d_var));
    smem[2 * C + c] = __fdiv_rn(d_mean, n_rows);
    smem[3 * C + c] = __fdiv_rn(__fmul_rn(2.f, d_var), n_rows);
    if (blockIdx.x == 0) {
      dweight[c] = __fmul_rn(__fsub_rn(sums[C + c], __fmul_rn(m, sums[c])), r);
      dbias[c] = sums[c];
    }
  }
  __syncthreads();
  const int L = C / V, R = blockDim.x / L;
  const int lane = threadIdx.x % L, ry = threadIdx.x / L;
  float a[V], b[V], k0[V], k1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = smem[lane * V + k];
    b[k] = smem[C + lane * V + k];
    k0[k] = smem[2 * C + lane * V + k];
    k1[k] = smem[3 * C + lane * V + k];
  }
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  const size_t xstride = (size_t)R * ldx, gstride = (size_t)R * ldg, stride = (size_t)R * C;
  long long r = r0 + ry;
  size_t xoff = (size_t)r * ldx + lane * V, goff = (size_t)r * ldg + lane * V;
  size_t off = (size_t)r * C + lane * V;
  for (; r + R < r1; r += 2 * R, xoff += 2 * xstride, goff += 2 * gstride, off += 2 * stride) {
    const Pack<T, V> x0 = load<T, V>(x + xoff), x1 = load<T, V>(x + xoff + xstride);
    const Pack<T, V> g0 = load<T, V>(g + goff), g1 = load<T, V>(g + goff + gstride);
    Pack<T, V> o0, o1;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      o0.v[k] = from_f<T>(
          input_grad<T, RELU>(to_f(g0.v[k]), to_f(x0.v[k]), a[k], b[k], k0[k], k1[k]));
      o1.v[k] = from_f<T>(
          input_grad<T, RELU>(to_f(g1.v[k]), to_f(x1.v[k]), a[k], b[k], k0[k], k1[k]));
    }
    *reinterpret_cast<Pack<T, V>*>(dx + off) = o0;
    *reinterpret_cast<Pack<T, V>*>(dx + off + stride) = o1;
  }
  if (r < r1) {
    const Pack<T, V> x0 = load<T, V>(x + xoff), g0 = load<T, V>(g + goff);
    Pack<T, V> o0;
#pragma unroll
    for (int k = 0; k < V; ++k)
      o0.v[k] = from_f<T>(
          input_grad<T, RELU>(to_f(g0.v[k]), to_f(x0.v[k]), a[k], b[k], k0[k], k1[k]));
    *reinterpret_cast<Pack<T, V>*>(dx + off) = o0;
  }
}

template <typename T_, int V_>
struct Tag {
  using T = T_;
  static constexpr int V = V_;
};

// f(Tag<T, V>) for dtype 0 (bf16) or 1 (fp32) and V elements an access
template <typename F>
int dispatch(int dtype, int vec, F&& f) {
  if (dtype == 0) {
    switch (vec) {
      case 8: return f(Tag<__nv_bfloat16, 8>{});
      case 4: return f(Tag<__nv_bfloat16, 4>{});
      case 2: return f(Tag<__nv_bfloat16, 2>{});
      case 1: return f(Tag<__nv_bfloat16, 1>{});
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 4: return f(Tag<float, 4>{});
      case 2: return f(Tag<float, 2>{});
      case 1: return f(Tag<float, 1>{});
    }
  }
  return (int)cudaErrorInvalidValue;
}

// the launch's shape is the wrapper's plan (kernels/batchnorm.py bn_plan);
// refuse one the kernels cannot run
bool bad_shape(int channels, int vec, int threads, int blocks) {
  if (channels <= 0 || vec <= 0 || channels % vec) return true;
  const int lanes = channels / vec;
  return threads <= 0 || threads > MAX_THREADS || threads % lanes || blocks <= 0;
}

size_t reduce_smem(int channels, int vec, int threads) {
  const int rows = threads / (channels / vec);
  return sizeof(float) * ((size_t)rows * 2 * channels + threads);
}

}  // namespace

extern "C" {

// x, g: rows ldx, ldg elements apart (>= channels); y, dx: channels apart
int tdeed_bn_stats_launch(const void* x, long long ldx, int dtype, long long rows,
                          int channels, int vec, int threads, int blocks,
                          long long rows_per_block, void* partial, void* group_sums,
                          void* tickets, void* moments, void* stream) {
  if (bad_shape(channels, vec, threads, blocks) || ldx < channels)
    return (int)cudaErrorInvalidValue;
  const size_t smem = reduce_smem(channels, vec, threads);
  const float inv_rows = (float)(1.0 / (double)rows);
  return dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    tdeed_bn_stats<T, V><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const T*)x, ldx, rows, channels, rows_per_block, inv_rows, (float*)partial,
        (float*)group_sums, (unsigned*)tickets, (float*)moments);
    return (int)cudaGetLastError();
  });
}

int tdeed_bn_apply_launch(const void* x, long long ldx, void* y, int dtype, long long rows,
                          int channels, int vec, int threads, int blocks,
                          long long rows_per_block, const void* moments, const void* weight,
                          const void* bias, float eps, int relu, void* stats,
                          void* running_mean, void* running_var, void* batches, int update,
                          float momentum, float one_minus_momentum, void* stream) {
  if (bad_shape(channels, vec, threads, blocks) || ldx < channels)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * channels;
  return dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    auto kernel = relu ? tdeed_bn_apply<T, V, true> : tdeed_bn_apply<T, V, false>;
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const T*)x, ldx, (T*)y, rows, channels, rows_per_block, (const float*)moments,
        (const float*)weight, (const float*)bias, eps, (float*)stats, (float*)running_mean,
        (float*)running_var, (long long*)batches, update, momentum, one_minus_momentum);
    return (int)cudaGetLastError();
  });
}

int tdeed_bn_grad_sums_launch(const void* x, long long ldx, const void* g, long long ldg,
                              int dtype, long long rows, int channels, int vec, int threads,
                              int blocks, long long rows_per_block, const void* stats,
                              const void* weight, const void* bias, float eps, int relu,
                              void* partial, void* group_sums, void* tickets, void* sums,
                              void* stream) {
  if (bad_shape(channels, vec, threads, blocks) || ldx < channels || ldg < channels)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * channels + reduce_smem(channels, vec, threads);
  return dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    auto kernel = relu ? tdeed_bn_grad_sums<T, V, true> : tdeed_bn_grad_sums<T, V, false>;
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const T*)x, ldx, (const T*)g, ldg, rows, channels, rows_per_block,
        (const float*)stats, (const float*)weight, (const float*)bias, eps, (float*)partial,
        (float*)group_sums, (unsigned*)tickets, (float*)sums);
    return (int)cudaGetLastError();
  });
}

int tdeed_bn_grad_apply_launch(const void* x, long long ldx, const void* g, long long ldg,
                               void* dx, int dtype, long long rows, int channels, int vec,
                               int threads, int blocks, long long rows_per_block,
                               const void* stats, const void* weight, const void* bias,
                               float eps, int relu, const void* sums, const void* global_sums,
                               double n_rows, void* dweight, void* dbias, void* stream) {
  if (bad_shape(channels, vec, threads, blocks) || ldx < channels || ldg < channels)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 4 * channels;
  return dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    auto kernel = relu ? tdeed_bn_grad_apply<T, V, true> : tdeed_bn_grad_apply<T, V, false>;
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const T*)x, ldx, (const T*)g, ldg, (T*)dx, rows, channels, rows_per_block,
        (const float*)stats, (const float*)weight, (const float*)bias, eps,
        (const float*)sums, (const float*)global_sums, (float)n_rows, (float*)dweight,
        (float*)dbias);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
