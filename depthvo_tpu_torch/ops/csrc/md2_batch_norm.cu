// Single-card train-mode BatchNorm of NCHW activations, with an optional
// ReLU epilogue, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (depthvo_tpu_torch/ops/_build.py, wrapped by
// depthvo_tpu_torch/ops/md2_batch_norm.py).
//
// What it replaces: PyTorch's F.batch_norm (its NCHW kernels, one block per
// channel) and the F.relu after it in Monodepth2's ResNet18 encoders
// (models/monodepth2.py). Four kernels, one launch each:
//
//   stats      per (chunk, channel) block the count, mean and M2 (the sum
//              of squared deviations) of its share of the channel's N x HW
//              values, into a float32 partial.
//   normalize  each block merges its channel's partials by Chan's formula
//              in a fixed order (so every block, and every replay, gets the
//              same bits), var = M2 / n (biased), rstd = 1 / sqrt(var +
//              eps); y = (x - mean) * (rstd * weight) + bias in float32,
//              then relu(y) = (y < 0 ? 0 : y) if asked, cast to x's type.
//              Block 0 of a channel saves [mean | rstd] for the backward and
//              moves the running averages, prev * (1 - m) + stat * m with
//              the biased variance, unless the call is a remat recompute.
//   bwd_reduce per block the sums of g' and g' * xhat, xhat = (x - mean) *
//              rstd, where g' is g, or with the ReLU g where the
//              recomputed pre-activation (the forward's very operations on
//              the saved mean and rstd) is > 0, else 0.
//   bwd_elemt  each block sums its channel's partials in a fixed order;
//              dx = (weight * rstd) * ((g' - Sg'/n) - xhat * Sg'xhat/n);
//              block 0 of a channel writes dweight = Sg'xhat and dbias =
//              Sg'.
//
// Bound: bytes. x read by stats, x read and y written by normalize, g and
// x read by bwd_reduce, g and x read and dx written by bwd_elemt: 8 values
// an element, 16 bytes in bf16, against a few float32 flops each.
//
// Design. A channel of NCHW x is N runs of HW contiguous values; its
// N * HW values (in 16-byte vectors where HW and every pointer allow)
// are cut into `chunks` equal spans, one block each: grid (chunks, C).
// The wrapper picks chunks so that the grid fills the card about once at
// four blocks an SM (C = 64 channels of 983,040 values get 8 blocks each,
// C = 512 of 3,840 one), and __launch_bounds__(256, 4) lets every block
// of the grid be resident at once. A vector's run and column come from a
// multiply-high division (no hardware divide in the loop). Each thread
// keeps several 16-byte loads in flight. The statistics are of x less the
// channel's first value, exact per group of loads (two passes over
// registers) and merged by Chan's formula, so a channel whose mean is far
// from its standard deviation loses nothing to cancellation.
// normalize and bwd_elemt walk each span backwards: stats and bwd_reduce
// walked it forwards, so the span's last values are the likeliest still in
// L2. No float atomics anywhere; merges and sums run in a fixed order.
// The elementwise arithmetic is written with __fsub_rn / __fmul_rn /
// __fadd_rn / __fdiv_rn / __fsqrt_rn, so nvcc contracts nothing into an FMA
// and, given the same statistics and sums, y and dx round as the plain
// versions' separate PyTorch ops do; the backward's ReLU mask is the
// forward's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // resident blocks an SM (the wrapper's grid)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values at p, as one 16-byte load where VEC * sizeof(T) == 16.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_float(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_float(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_float<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_float<T>(v[j]);
  }
}

// Where a block's vectors lie: channel c's vector v is column j = v mod hwv
// of run n = v / hwv, at ((n C + c) hwv + j) VEC. The division is
// (umulhi(v, magic) + v) >> shift (Granlund and Montgomery; exact for v <
// 2^31), with magic and shift from the host.
struct Geo {
  int C, hwv, lv, span;  // channels, vectors a run, vectors a channel, a block's
  unsigned magic;
  int shift;
};

template <int VEC>
__device__ __forceinline__ size_t offset(const Geo& g, int c, int v) {
  const int n = static_cast<int>((__umulhi(static_cast<unsigned>(v), g.magic) +
                                  static_cast<unsigned>(v)) >> g.shift);
  const int j = v - n * g.hwv;
  return ((static_cast<size_t>(n) * g.C + c) * g.hwv + j) * VEC;
}

// Chan's merge of (nb, mb, qb) into (n, mean, q): counts, means and sums of
// squared deviations. An empty side (count 0, mean 0, q 0) changes nothing.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& q, float nb, float mb,
                                           float qb) {
  const float nt = n + nb;
  if (nt == 0.f) return;
  const float d = mb - mean;
  const float f = __fdiv_rn(nb, nt);
  q = q + qb + d * d * n * f;
  mean = mean + d * f;
  n = nt;
}

// The warp's statistics into lane 0, by a fixed xor tree.
__device__ __forceinline__ void warp_chan(float& n, float& mean, float& q) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, o);
    const float qb = __shfl_xor_sync(0xffffffffu, q, o);
    chan_merge(n, mean, q, nb, mb, qb);
  }
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// A block's first and last vector of its channel: [v0, v1).
__device__ __forceinline__ void block_range(const Geo& g, int& v0, int& v1) {
  v0 = blockIdx.x * g.span;
  v1 = min(v0 + g.span, g.lv);
}

// The channel's first value. The statistics are taken of x - pivot, so that
// a channel whose mean is far from zero keeps its digits: the running mean
// stays near zero and the differences are exact where x is near the pivot.
template <typename T, int VEC>
__device__ __forceinline__ float pivot_of(const T* __restrict__ x, const Geo& g, int c) {
  return to_float(x[offset<VEC>(g, c, 0)]);
}

// ---------------------------------------------------------------------------
// stats: partial[(c chunks + k) 3 + {0, 1, 2}] = count, mean, M2 of x - pivot.
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
md2_batch_norm_stats_kernel(const T* __restrict__ x, Geo g, float* __restrict__ partial) {
  constexpr int U = 4;  // loads in flight a thread
  const int c = blockIdx.y;
  const float pivot = pivot_of<T, VEC>(x, g, c);
  int v0, v1;
  block_range(g, v0, v1);
  float n = 0.f, mean = 0.f, q = 0.f;  // of x - pivot
  for (int v = v0 + threadIdx.x; v < v1; v += kThreads * U) {
    float val[U][VEC];
    int live = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = v + u * kThreads;
      if (w < v1) {
        load_vec<T, VEC>(x + offset<VEC>(g, c, w), val[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) val[u][j] -= pivot;
        live = u + 1;
      }
    }
    // The group's exact two-pass statistics, then one merge.
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < live) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += val[u][j];
      }
    }
    const float nb = static_cast<float>(live * VEC);
    const float mb = __fdiv_rn(s, nb);
    float qb = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < live) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = val[u][j] - mb;
          qb = fmaf(d, d, qb);
        }
      }
    }
    chan_merge(n, mean, q, nb, mb, qb);
  }
  warp_chan(n, mean, q);
  __shared__ float sh[3][kWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[0][warp] = n;
    sh[1][warp] = mean;
    sh[2][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) chan_merge(n, mean, q, sh[0][w], sh[1][w], sh[2][w]);
    float* p = partial + (static_cast<size_t>(c) * gridDim.x + blockIdx.x) * 3;
    p[0] = n;
    p[1] = mean;
    p[2] = q;
  }
}

// Channel c's statistics from its `chunks` partials, the same in every block:
// lane l merges partials l, l + 32, ... in order, then the fixed xor tree;
// the mean is the pivot's plus the partials'. Into *out_mean, *out_var and
// *out_rstd (shared) for the whole block.
__device__ __forceinline__ void merge_stats(const float* __restrict__ partial, int c, int chunks,
                                            float pivot, float eps, float* out_mean,
                                            float* out_var, float* out_rstd) {
  if (threadIdx.x < 32) {
    float n = 0.f, mean = 0.f, q = 0.f;
    const float* p = partial + static_cast<size_t>(c) * chunks * 3;
    for (int k = threadIdx.x; k < chunks; k += 32) chan_merge(n, mean, q, p[3 * k], p[3 * k + 1],
                                                              p[3 * k + 2]);
    warp_chan(n, mean, q);
    if (threadIdx.x == 0) {
      const float var = __fdiv_rn(q, n);
      *out_mean = __fadd_rn(pivot, mean);
      *out_var = var;
      *out_rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float relu(float y) { return y < 0.f ? 0.f : y; }

// ---------------------------------------------------------------------------
// normalize: y, save = [mean | rstd], the running averages.
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
md2_batch_norm_normalize_kernel(const T* __restrict__ x, Geo g, const float* __restrict__ partial,
                                const float* __restrict__ weight, const float* __restrict__ bias,
                                float eps, float momentum, float keep, int update, int use_relu,
                                T* __restrict__ y, float* __restrict__ save,
                                float* __restrict__ running_mean,
                                float* __restrict__ running_var) {
  constexpr int U = 4;
  const int c = blockIdx.y;
  __shared__ float stat[3];
  merge_stats(partial, c, gridDim.x, pivot_of<T, VEC>(x, g, c), eps, &stat[0], &stat[1],
              &stat[2]);
  const float mean = stat[0], rstd = stat[2];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    save[c] = mean;
    save[g.C + c] = rstd;
    if (update) {
      running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep), __fmul_rn(mean, momentum));
      running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep), __fmul_rn(stat[1], momentum));
    }
  }
  const float mul = __fmul_rn(rstd, weight[c]);
  const float beta = bias[c];
  int v0, v1;
  block_range(g, v0, v1);
  for (int v = v1 - 1 - threadIdx.x; v >= v0; v -= kThreads * U) {
    float val[U][VEC];
    size_t at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = v - u * kThreads;
      if (w >= v0) {
        at[u] = offset<VEC>(g, c, w);
        load_vec<T, VEC>(x + at[u], val[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v - u * kThreads >= v0) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float t = __fadd_rn(__fmul_rn(__fsub_rn(val[u][j], mean), mul), beta);
          val[u][j] = use_relu ? relu(t) : t;
        }
        store_vec<T, VEC>(y + at[u], val[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_reduce: partial[(c chunks + k) 2 + {0, 1}] = sum g', sum g' xhat.
// ---------------------------------------------------------------------------

// g' and xhat of one value: the forward's pre-activation, bit for bit, for
// the mask.
__device__ __forceinline__ void grad_in(float gv, float xv, float mean, float rstd, float mul,
                                        float beta, int use_relu, float& gp, float& xhat) {
  const float d = __fsub_rn(xv, mean);
  gp = (!use_relu || __fadd_rn(__fmul_rn(d, mul), beta) > 0.f) ? gv : 0.f;
  xhat = __fmul_rn(d, rstd);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
md2_batch_norm_bwd_reduce_kernel(const T* __restrict__ gr, const T* __restrict__ x, Geo g,
                                 const float* __restrict__ save, const float* __restrict__ weight,
                                 const float* __restrict__ bias, int use_relu,
                                 float* __restrict__ partial) {
  constexpr int U = 2;
  const int c = blockIdx.y;
  const float mean = save[c], rstd = save[g.C + c];
  const float mul = __fmul_rn(rstd, weight[c]);
  const float beta = bias[c];
  int v0, v1;
  block_range(g, v0, v1);
  float sg = 0.f, sgx = 0.f;
  for (int v = v0 + threadIdx.x; v < v1; v += kThreads * U) {
    float gv[U][VEC], xv[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = v + u * kThreads;
      if (w < v1) {
        const size_t at = offset<VEC>(g, c, w);
        load_vec<T, VEC>(gr + at, gv[u]);
        load_vec<T, VEC>(x + at, xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v + u * kThreads < v1) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float gp, xhat;
          grad_in(gv[u][j], xv[u][j], mean, rstd, mul, beta, use_relu, gp, xhat);
          sg += gp;
          sgx = fmaf(gp, xhat, sgx);
        }
      }
    }
  }
  warp_sum2(sg, sgx);
  __shared__ float sh[2][kWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[0][warp] = sg;
    sh[1][warp] = sgx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      sg += sh[0][w];
      sgx += sh[1][w];
    }
    float* p = partial + (static_cast<size_t>(c) * gridDim.x + blockIdx.x) * 2;
    p[0] = sg;
    p[1] = sgx;
  }
}

// ---------------------------------------------------------------------------
// bwd_elemt: dx; dwb = [dweight | dbias].
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
md2_batch_norm_bwd_elemt_kernel(const T* __restrict__ gr, const T* __restrict__ x, Geo g,
                                const float* __restrict__ save, const float* __restrict__ weight,
                                const float* __restrict__ bias,
                                const float* __restrict__ partial, float count, int use_relu,
                                T* __restrict__ dx, float* __restrict__ dwb) {
  constexpr int U = 2;
  const int c = blockIdx.y;
  __shared__ float sums[2];
  if (threadIdx.x < 32) {
    float sg = 0.f, sgx = 0.f;
    const float* p = partial + static_cast<size_t>(c) * gridDim.x * 2;
    for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += 32) {
      sg += p[2 * k];
      sgx += p[2 * k + 1];
    }
    warp_sum2(sg, sgx);
    if (threadIdx.x == 0) {
      sums[0] = sg;
      sums[1] = sgx;
      if (blockIdx.x == 0) {
        dwb[c] = sgx;
        dwb[g.C + c] = sg;
      }
    }
  }
  __syncthreads();
  const float mean = save[c], rstd = save[g.C + c];
  const float mul = __fmul_rn(rstd, weight[c]);
  const float beta = bias[c];
  const float a = __fdiv_rn(sums[0], count);
  const float b = __fdiv_rn(sums[1], count);
  const float k = __fmul_rn(weight[c], rstd);
  int v0, v1;
  block_range(g, v0, v1);
  for (int v = v1 - 1 - threadIdx.x; v >= v0; v -= kThreads * U) {
    float gv[U][VEC], xv[U][VEC];
    size_t at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = v - u * kThreads;
      if (w >= v0) {
        at[u] = offset<VEC>(g, c, w);
        load_vec<T, VEC>(gr + at[u], gv[u]);
        load_vec<T, VEC>(x + at[u], xv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v - u * kThreads >= v0) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float gp, xhat;
          grad_in(gv[u][j], xv[u][j], mean, rstd, mul, beta, use_relu, gp, xhat);
          gv[u][j] = __fmul_rn(k, __fsub_rn(__fsub_rn(gp, a), __fmul_rn(xhat, b)));
        }
        store_vec<T, VEC>(dx + at[u], gv[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side. Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); the Python wrapper raises otherwise.
// dtype: 0 float32, 1 bfloat16. chunks: the grid's first dimension, which
// sized the caller's partial buffer (C * chunks * 3 floats forward, C *
// chunks * 2 backward).
// ---------------------------------------------------------------------------

struct Shape {
  int N, C, HW, chunks;
};

static bool valid(const Shape& s) {
  return s.N > 0 && s.C > 0 && s.C <= 65535 && s.HW > 0 && s.chunks > 0 &&
         s.chunks <= 65535 && static_cast<long long>(s.N) * s.C * s.HW < (1LL << 31);
}

// 0 float32 scalar, 1 float32 x4, 2 bf16 scalar, 3 bf16 x8; the vectors need
// HW a multiple of their width and every pointer 16-byte aligned. -1: a
// dtype the kernels do not take.
static int variant(int dtype, const Shape& s, const void* const* ptrs, int n_ptrs) {
  if (dtype != 0 && dtype != 1) return -1;
  bool vec = s.HW % (dtype == 0 ? 4 : 8) == 0;
  for (int i = 0; i < n_ptrs; ++i) vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return 2 * dtype + (vec ? 1 : 0);
}

template <int VEC>
static Geo geo_of(const Shape& s) {
  Geo g;
  g.C = s.C;
  g.hwv = s.HW / VEC;
  g.lv = s.N * g.hwv;
  g.span = (g.lv + s.chunks - 1) / s.chunks;
  int shift = 0;
  while (shift < 32 && (1u << shift) < static_cast<unsigned>(g.hwv)) ++shift;
  const uint64_t one = 1;
  g.magic = static_cast<unsigned>(((one << 32) * ((one << shift) - g.hwv)) / g.hwv + 1);
  g.shift = shift;
  return g;
}

#define MD2_BN_INSTANCES(IMPL, ...)                                         \
  switch (variant(dtype, s, ptrs, sizeof(ptrs) / sizeof(ptrs[0]))) {      \
    case 0: err = IMPL<float, 1>(__VA_ARGS__); break;                      \
    case 1: err = IMPL<float, 4>(__VA_ARGS__); break;                      \
    case 2: err = IMPL<__nv_bfloat16, 1>(__VA_ARGS__); break;              \
    case 3: err = IMPL<__nv_bfloat16, 8>(__VA_ARGS__); break;              \
    default: err = static_cast<int>(cudaErrorInvalidValue);                \
  }

template <typename T, int VEC>
static int stats(const void* x, const Shape& s, float* partial, cudaStream_t st) {
  md2_batch_norm_stats_kernel<T, VEC><<<dim3(s.chunks, s.C), kThreads, 0, st>>>(
      static_cast<const T*>(x), geo_of<VEC>(s), partial);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int normalize(const void* x, const Shape& s, const float* partial, const float* weight,
              const float* bias, float eps, float momentum, int update, int use_relu, void* y,
              float* save, float* running_mean, float* running_var, cudaStream_t st) {
  md2_batch_norm_normalize_kernel<T, VEC><<<dim3(s.chunks, s.C), kThreads, 0, st>>>(
      static_cast<const T*>(x), geo_of<VEC>(s), partial, weight, bias, eps, momentum,
      1.f - momentum, update, use_relu, static_cast<T*>(y), save, running_mean, running_var);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int bwd_reduce(const void* gr, const void* x, const Shape& s, const float* save,
               const float* weight, const float* bias, int use_relu, float* partial,
               cudaStream_t st) {
  md2_batch_norm_bwd_reduce_kernel<T, VEC><<<dim3(s.chunks, s.C), kThreads, 0, st>>>(
      static_cast<const T*>(gr), static_cast<const T*>(x), geo_of<VEC>(s), save, weight, bias,
      use_relu, partial);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int bwd_elemt(const void* gr, const void* x, const Shape& s, const float* save,
              const float* weight, const float* bias, const float* partial, int use_relu,
              void* dx, float* dwb, cudaStream_t st) {
  md2_batch_norm_bwd_elemt_kernel<T, VEC><<<dim3(s.chunks, s.C), kThreads, 0, st>>>(
      static_cast<const T*>(gr), static_cast<const T*>(x), geo_of<VEC>(s), save, weight, bias,
      partial, static_cast<float>(s.N) * s.HW, use_relu, static_cast<T*>(dx), dwb);
  return static_cast<int>(cudaGetLastError());
}

// partial (C * chunks * 3) of x.
extern "C" int depthvo_md2_bn_stats(const void* x, int dtype, int N, int C, int HW, int chunks,
                                    float* partial, void* stream) {
  const Shape s{N, C, HW, chunks};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x};
  int err;
  MD2_BN_INSTANCES(stats, x, s, partial, static_cast<cudaStream_t>(stream))
  return err;
}

// y and save (2C) from the partials of depthvo_md2_bn_stats; the running
// averages move when update is nonzero.
extern "C" int depthvo_md2_bn_normalize(const void* x, int dtype, int N, int C, int HW,
                                        int chunks, const float* partial, const float* weight,
                                        const float* bias, float eps, float momentum,
                                        int update, int use_relu, void* y, float* save,
                                        float* running_mean, float* running_var, void* stream) {
  const Shape s{N, C, HW, chunks};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x, y};
  int err;
  MD2_BN_INSTANCES(normalize, x, s, partial, weight, bias, eps, momentum, update, use_relu, y,
                   save, running_mean, running_var, static_cast<cudaStream_t>(stream))
  return err;
}

// partial (C * chunks * 2) of g and x under the saved statistics.
extern "C" int depthvo_md2_bn_bwd_reduce(const void* g, const void* x, int dtype, int N, int C,
                                         int HW, int chunks, const float* save,
                                         const float* weight, const float* bias, int use_relu,
                                         float* partial, void* stream) {
  const Shape s{N, C, HW, chunks};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {g, x};
  int err;
  MD2_BN_INSTANCES(bwd_reduce, g, x, s, save, weight, bias, use_relu, partial,
                   static_cast<cudaStream_t>(stream))
  return err;
}

// dx and dwb (2C: dweight, dbias) from the partials of
// depthvo_md2_bn_bwd_reduce.
extern "C" int depthvo_md2_bn_bwd_elemt(const void* g, const void* x, int dtype, int N, int C,
                                        int HW, int chunks, const float* save,
                                        const float* weight, const float* bias,
                                        const float* partial, int use_relu, void* dx,
                                        float* dwb, void* stream) {
  const Shape s{N, C, HW, chunks};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {g, x, dx};
  int err;
  MD2_BN_INSTANCES(bwd_elemt, g, x, s, save, weight, bias, partial, use_relu, dx, dwb,
                   static_cast<cudaStream_t>(stream))
  return err;
}
