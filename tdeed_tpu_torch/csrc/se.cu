// The RegNet-Y blocks' squeeze-and-excitation: the gate's product and the
// backward as three kernels (the wrapper is tdeed_tpu_torch/kernels/se.py).
//
// Replaces no TPU kernel: the JAX package leaves the SE to XLA, which fuses
// the mean, the gate's product and their gradients. Eager PyTorch ran it as
// 13 passes over the block's tensor a training step: the mean (1) and the
// gate's product (2) forward; backward g*x (3) and its sum (1), g*s (2),
// the mean's gradient broadcast to an NCHW-contiguous tensor and divided
// (1), and autograd's add of that tensor into the product's channels_last
// gradient (3). That add mixes two layouts, so ATen runs it in its
// unvectorised elementwise kernel, reading the NCHW operand HW elements
// apart; the products broadcast an (N, C, 1, 1) operand and are
// unvectorised too.
//
// Bound: bytes. The work is 7 passes over the (N, HW, C) tensor: the mean
// reads x (1, ATen's, whose bits the wrapper keeps), the excite reads x and
// writes y (2); backward one reduction reads g and x (2), one apply reads
// g and writes dx (2). At the benchmark's shapes one pass over a step's SE
// tensors is 0.58-3.08 GB.
//
//   tdeed_se_excite      y[n, hw, c] = cast(x * s[n, c])
//   tdeed_se_grad_sums   S[n, c]  = sum_hw g[n, hw, c] * x[n, hw, c]   (fp32)
//   tdeed_se_grad_apply  dx[n, hw, c] = cast(g * s[n, c] + dm[n, c] / HW)
//
// s is the gate sigmoid(fc2(relu(fc1(mean_hw(x))))) and dm the gradient the
// fc chain gives the mean; the mean and the chain, on (N, C) vectors, stay
// in stock ops in the wrapper. The excite rounds x * s from fp32 once, as
// ATen's product does, so the forward gives the stock ops' bits, which an
// exported program (ATen's ops) reproduces.
//
// Design. Activations are NCHW in channels_last memory: sample n is a dense
// (HW, C) slab of rows C elements long. A thread owns V consecutive
// channels (16 bytes where C and the addresses allow) of every rows-th row
// of its unit's rows, so a warp reads or writes 32 consecutive 16-byte
// pieces and the thread's gate, gradient and sums stay in registers, with
// no broadcast operand and no mixed-layout pass; UNROLL loads are in
// flight a thread. The launch (kernels/se.py se_plan) adapts to the shape:
// a block takes as many row groups as leave each thread 16 rows or more
// (its sums through shared memory cost the same whatever its rows), and
// packs `units` samples where one sample's rows would leave it small; a
// block covers whole samples. Sums are fp32 in an order fixed by the
// launch: each thread over its rows in ascending order, then the block's
// row groups in shared memory in two fixed passes. No float atomics, so
// two runs give the same bits, which a CUDA graph's replay and a
// checkpointed block's recompute rely on. The apply computes g * s + dm /
// HW in fp32 and rounds once, so x's whole gradient is written by one
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;  // kernels/se.py: THREADS
constexpr int UNROLL = 4;         // row loads a thread has in flight (grad_sums: 2 of each)

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

// The launch's shape (kernels/se.py SEPlan)
struct Shape {
  int n, hw, c;  // samples, rows a sample, channels
  int units;     // samples a block
  int rows;      // rows a unit's threads cover at once
};

// Where a thread works: sample n (n >= shape.n: none), rows [lo, hi) of it
// stepped by shape.rows, channels [lane * V, lane * V + V)
struct Tile {
  int n, lo, hi, lane;
};

template <int V>
__device__ __forceinline__ Tile tile(const Shape& sh) {
  const int lanes = sh.c / V, per_unit = sh.rows * lanes;
  const int unit = threadIdx.x / per_unit, k = threadIdx.x - unit * per_unit;
  const int r = k / lanes;
  Tile t;
  t.n = blockIdx.x * sh.units + unit;
  t.lane = k - r * lanes;
  t.lo = r;
  t.hi = t.n < sh.n ? sh.hw : t.lo;
  return t;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

// Each channel's fp32 sum over the sample's rows of g * x, into sums (N, C)
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
tdeed_se_grad_sums(const T* __restrict__ g, const T* __restrict__ x, float* __restrict__ sums,
                   const Shape sh) {
  extern __shared__ __align__(16) float red[];  // smem_floats()
  const Tile t = tile<V>(sh);
  const size_t base = (size_t)t.n * sh.hw * sh.c + (size_t)t.lane * V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  constexpr int U = UNROLL / 2;  // two streams: as many loads in flight
  for (int row = t.lo; row < t.hi; row += sh.rows * U) {
    Pack<T, V> pg[U], px[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int rr = row + i * sh.rows;
      if (rr < t.hi) {
        pg[i] = load<T, V>(g + base + (size_t)rr * sh.c);
        px[i] = load<T, V>(x + base + (size_t)rr * sh.c);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (row + i * sh.rows < t.hi) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += to_f(pg[i].v[j]) * to_f(px[i].v[j]);
      }
    }
  }
  // thread k's partials land at red[k * V + j]: unit u's row group r at
  // red[(u * rows + r) * C + channel]. Each (unit, channel) sum is taken in
  // `parts` parts, part p adding row groups p, p + parts, ... in order,
  // then the parts in order: two barriers, whatever the rows.
#pragma unroll
  for (int j = 0; j < V; ++j) red[threadIdx.x * V + j] = acc[j];
  __syncthreads();
  const int items = sh.units * sh.c, parts = max(1, (int)blockDim.x / items);
  float* part = red + blockDim.x * V;  // parts * items floats
  for (int k = threadIdx.x; k < parts * items; k += blockDim.x) {
    const int p = k / items, it = k - p * items, u = it / sh.c, ch = it - u * sh.c;
    const float* col = red + u * sh.rows * sh.c + ch;
    float v = 0.f;
    for (int r = p; r < sh.rows; r += parts) v += col[r * sh.c];
    part[k] = v;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    float v = part[it];
    for (int p = 1; p < parts; ++p) v += part[p * items + it];
    if (blockIdx.x * sh.units + it / sh.c < sh.n) sums[(size_t)blockIdx.x * items + it] = v;
  }
}

// The elementwise passes: out = cast(a * s + d) with s and d a
// channel's gate and, backward, dm / HW (0 forward), held in registers
template <typename T, int V, bool BACKWARD>
__device__ __forceinline__ void scale_rows(const T* __restrict__ a, const T* __restrict__ s,
                                           const T* __restrict__ dm, T* __restrict__ out,
                                           const Shape sh) {
  const Tile t = tile<V>(sh);
  if (t.n >= sh.n) return;
  const size_t base = (size_t)t.n * sh.hw * sh.c + (size_t)t.lane * V;
  const size_t vec = (size_t)t.n * sh.c + (size_t)t.lane * V;
  float sv[V], dv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sv[j] = to_f(s[vec + j]);
    dv[j] = BACKWARD ? __fdiv_rn(to_f(dm[vec + j]), (float)sh.hw) : 0.f;
  }
  for (int row = t.lo; row < t.hi; row += sh.rows * UNROLL) {
    Pack<T, V> pa[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int rr = row + i * sh.rows;
      if (rr < t.hi) pa[i] = load<T, V>(a + base + (size_t)rr * sh.c);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int rr = row + i * sh.rows;
      if (rr < t.hi) {
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j)
          o.v[j] = from_f<T>(BACKWARD ? __fmaf_rn(to_f(pa[i].v[j]), sv[j], dv[j])
                                      : __fmul_rn(to_f(pa[i].v[j]), sv[j]));
        *reinterpret_cast<Pack<T, V>*>(out + base + (size_t)rr * sh.c) = o;
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
tdeed_se_excite(const T* __restrict__ x, const T* __restrict__ s, T* __restrict__ y,
                const Shape sh) {
  scale_rows<T, V, false>(x, s, nullptr, y, sh);
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
tdeed_se_grad_apply(const T* __restrict__ g, const T* __restrict__ s, const T* __restrict__ dm,
                    T* __restrict__ dx, const Shape sh) {
  scale_rows<T, V, true>(g, s, dm, dx, sh);
}

template <typename T_, int V_>
struct Tag {
  using T = T_;
  static constexpr int V = V_;
};

// f(Tag) for dtype 0 (bf16: V 8, 4, 2 or 1) or 1 (fp32: V 4, 2 or 1)
template <typename F>
int dispatch(int dtype, int vec, F&& f) {
  if (dtype == 0) {
    if (vec == 8) return f(Tag<__nv_bfloat16, 8>{});
    if (vec == 4) return f(Tag<__nv_bfloat16, 4>{});
    if (vec == 2) return f(Tag<__nv_bfloat16, 2>{});
    if (vec == 1) return f(Tag<__nv_bfloat16, 1>{});
  } else if (dtype == 1) {
    if (vec == 4) return f(Tag<float, 4>{});
    if (vec == 2) return f(Tag<float, 2>{});
    if (vec == 1) return f(Tag<float, 1>{});
  }
  return (int)cudaErrorInvalidValue;
}

// the launch is the wrapper's plan (kernels/se.py se_plan); refuse one the
// kernels cannot run
bool valid(const Shape& sh, int vec, int threads) {
  if (sh.n <= 0 || sh.hw <= 0 || sh.c <= 0 || vec <= 0 || sh.c % vec || sh.units <= 0 ||
      sh.rows <= 0)
    return false;
  return threads > 0 && threads <= MAX_THREADS &&
         (long long)sh.units * sh.rows * (sh.c / vec) == threads;
}

// floats of grad_sums' shared memory: V partial sums a thread, then
// the parts of each (unit, channel) sum (at most max(threads, units * C))
size_t smem_floats(const Shape& sh, int vec, int threads) {
  return (size_t)threads * vec + (size_t)(threads > sh.units * sh.c ? threads : sh.units * sh.c);
}

// one block for each `units` whole samples
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Shape& sh, int threads, size_t smem, void* stream,
           Args... args) {
  kernel<<<(sh.n + sh.units - 1) / sh.units, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

Shape shape(int n, int hw, int c, int units, int rows) {
  Shape sh;
  sh.n = n;
  sh.hw = hw;
  sh.c = c;
  sh.units = units;
  sh.rows = rows;
  return sh;
}

}  // namespace

extern "C" {

// y (N, HW, C) dense from x (N, HW, C) dense and the gate s (N, C)
int tdeed_se_excite_launch(const void* x, const void* s, void* y, int dtype, int n, int hw,
                           int c, int vec, int units, int rows, int threads, void* stream) {
  const Shape sh = shape(n, hw, c, units, rows);
  if (!valid(sh, vec, threads)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, [&](auto tag) {
    using Tg = decltype(tag);
    using T = typename Tg::T;
    return launch(tdeed_se_excite<T, Tg::V>, sh, threads, 0, stream, (const T*)x,
                  (const T*)s, (T*)y, sh);
  });
}

// sums (N, C) fp32 from g and x (N, HW, C) dense
int tdeed_se_grad_sums_launch(const void* g, const void* x, void* sums, int dtype, int n,
                              int hw, int c, int vec, int units, int rows, int threads,
                              void* stream) {
  const Shape sh = shape(n, hw, c, units, rows);
  if (!valid(sh, vec, threads)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, [&](auto tag) {
    using Tg = decltype(tag);
    using T = typename Tg::T;
    return launch(tdeed_se_grad_sums<T, Tg::V>, sh, threads, 4 * smem_floats(sh, Tg::V, threads),
                  stream, (const T*)g, (const T*)x, (float*)sums, sh);
  });
}

// dx (N, HW, C) dense from g (N, HW, C) dense, the gate s and dm (N, C)
int tdeed_se_grad_apply_launch(const void* g, const void* s, const void* dm, void* dx, int dtype,
                               int n, int hw, int c, int vec, int units, int rows,
                               int threads, void* stream) {
  const Shape sh = shape(n, hw, c, units, rows);
  if (!valid(sh, vec, threads)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, vec, [&](auto tag) {
    using Tg = decltype(tag);
    using T = typename Tg::T;
    return launch(tdeed_se_grad_apply<T, Tg::V>, sh, threads, 0, stream, (const T*)g,
                  (const T*)s, (const T*)dm, (T*)dx, sh);
  });
}

}  // extern "C"
