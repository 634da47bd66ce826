// Train-mode BatchNorm over a data-parallel mesh for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (depthvo_tpu_torch/ops/_build.py,
// wrapped by depthvo_tpu_torch/ops/batch_norm.py).
//
// What it replaces: flax nn.BatchNorm(use_running_average=False,
// momentum=0.95, epsilon=1e-5) in depthvo_tpu/models/layers.py:156-162
// under a jit whose batch is sharded over a mesh. XLA reduces its
// statistics over the global batch; this is not a Pallas kernel. The port
// reduces them explicitly, one all-reduce of each layer's sums forward and
// one of the cotangent's sums backward (torch.distributed, between the
// kernels below), and these four kernels do the rest:
//
//   bn_stats      per channel the local sum and sum of squares of x, and
//                 the element count: one float32 buffer of 2C + 1, the
//                 buffer that is all-reduced.
//   bn_normalize  from the reduced buffer: mean = S/n, var = max(Q/n -
//                 mean^2, 0) (flax's use_fast_variance), rstd =
//                 1/sqrt(var + eps), y = (x - mean) * (rstd * scale) +
//                 bias in float32, cast to x's type; the running averages
//                 move as prev * (1 - m) + stat * m unless the call is a
//                 remat recompute; mean, rstd, whether the clamp was off
//                 (1) or on (0) and n are saved for the backward (3C + 1).
//   bn_bwd_reduce per channel the local sum of g and of g * xhat, xhat =
//                 (x - mean) * rstd, written twice (4C): the first 2C are
//                 all-reduced in place, the last 2C stay this rank's dbias
//                 and dscale.
//   bn_bwd_elemt  dx = (scale * rstd) * ((g - SG/n) - xhat * SGX/n) from
//                 the reduced sums; where the clamp was on, the xhat term
//                 is dropped, as autograd through the clamp drops it.
//
// Bound: bytes. Each kernel does a few flops per element (about 3 for the
// statistics, 3 for the normalisation, 4 and 5 backward) against 2 or 4
// bytes read, far under the card's ~20 float32 flops per byte, so the
// floor is x read once per statistic pass, x read and y written by the
// normalisation, g and x read twice and dx written once backward, at
// 3.35 TB/s. For the full_feat step (53 layers, 43,095,040 elements per
// step) that is ~0.13 ms in bf16.
//
// Design. The inputs are NCHW: a channel is N runs of HW contiguous
// values. Per-channel element counts run from 97,280 (4 x 32 x 80 x 304)
// down to 380 (4 x 1024 x 5 x 19), so a block per channel would leave most
// of the 132 SMs idle at C = 32; the grid is (chunks, C) instead, and
// block (k, c) takes columns [k span, (k + 1) span) of each of channel c's
// N runs. The wrapper picks chunks so that about kTargetBlocks blocks run;
// span is a multiple of the vector width, so where HW is a multiple of it
// every thread moves 16 bytes per load and store. Reductions are
// deterministic, with no float atomics: each block sums its elements in a
// fixed order (per thread, then a fixed xor-shuffle tree, then the warps
// in order) into its own slot of a scratch buffer, and a second kernel
// sums each channel's slots in chunk order. The arithmetic that a plain
// PyTorch version writes as separate ops (the normalisation, the running
// averages, dx) is written with __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn, so nvcc contracts nothing into an FMA and, given
// the same statistics, the kernels round as the plain versions do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// VEC values at p: one 16-byte load where VEC * sizeof(T) == 16 (p is then
// 16-byte aligned, which the host checks), else VEC scalar loads.
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

// The block's two sums, in a fixed order, into thread 0's a and b.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sh[2][kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[0][warp] = a;
    sh[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = sh[0][0];
    b = sh[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      a += sh[0][w];
      b += sh[1][w];
    }
  }
}

// A block's columns of its channel's runs: [s0, s1) of each of N runs.
struct Span {
  int s0, s1;
};

__device__ __forceinline__ Span block_span(int HW, int span) {
  const int s0 = blockIdx.x * span;
  return {s0, min(s0 + span, HW)};
}

// Per (chunk, channel) block: the sum and the sum of squares of its
// values, into partial[(c * chunks + k) * 2 + {0, 1}].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, int N, int C, int HW, int span,
                        float* __restrict__ partial) {
  const int c = blockIdx.y;
  const Span sp = block_span(HW, span);
  float s = 0.f, q = 0.f;
  for (int n = 0; n < N; ++n) {
    const T* row = x + (static_cast<size_t>(n) * C + c) * HW;
    for (int i = sp.s0 + threadIdx.x * VEC; i < sp.s1; i += kThreads * VEC) {
      float v[VEC];
      load_vec<T, VEC>(row + i, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s += v[j];
        q = fmaf(v[j], v[j], q);
      }
    }
  }
  block_sum2(s, q);
  if (threadIdx.x == 0) {
    float* p = partial + (static_cast<size_t>(c) * gridDim.x + blockIdx.x) * 2;
    p[0] = s;
    p[1] = q;
  }
}

// out[j C + c] = sum over k in order of partial[(c chunks + k) 2 + j] for
// j = 0, 1; the same 2C values again at copy (if not null); count at
// out[2C] (if count >= 0).
__global__ void __launch_bounds__(kThreads)
bn_sum_partials_kernel(const float* __restrict__ partial, int C, int chunks,
                       float* __restrict__ out, float* __restrict__ copy, float count) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < 2 * C) {
    const int j = t / C, c = t - j * C;
    const float* p = partial + static_cast<size_t>(c) * chunks * 2 + j;
    float acc = 0.f;
    for (int k = 0; k < chunks; ++k) acc += p[2 * k];
    out[t] = acc;
    if (copy != nullptr) copy[t] = acc;
  }
  if (t == 0 && count >= 0.f) out[2 * C] = count;
}

// y from the reduced statistics; block (0, c)'s thread 0 also writes the
// saved values and moves the running averages.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_normalize_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    int N, int C, int HW, int span, float eps, float momentum, float keep,
                    int update, T* __restrict__ y, float* __restrict__ save,
                    float* __restrict__ running_mean, float* __restrict__ running_var) {
  const int c = blockIdx.y;
  const float n = stats[2 * C];
  const float mean = __fdiv_rn(stats[c], n);
  const float var_raw = __fsub_rn(__fdiv_rn(stats[C + c], n), __fmul_rn(mean, mean));
  const float var = var_raw < 0.f ? 0.f : var_raw;  // a NaN stays NaN
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  const float mul = __fmul_rn(rstd, scale[c]);
  const float beta = bias[c];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    save[c] = mean;
    save[C + c] = rstd;
    save[2 * C + c] = var_raw < 0.f ? 0.f : 1.f;
    if (c == 0) save[3 * C] = n;
    if (update) {
      running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep), __fmul_rn(mean, momentum));
      running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep), __fmul_rn(var, momentum));
    }
  }
  const Span sp = block_span(HW, span);
  for (int n_i = 0; n_i < N; ++n_i) {
    const size_t base = (static_cast<size_t>(n_i) * C + c) * HW;
    for (int i = sp.s0 + threadIdx.x * VEC; i < sp.s1; i += kThreads * VEC) {
      float v[VEC];
      load_vec<T, VEC>(x + base + i, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mean), mul), beta);
      store_vec<T, VEC>(y + base + i, v);
    }
  }
}

// Per (chunk, channel) block: the sum of g and of g * xhat.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_partial_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      const float* __restrict__ save, int N, int C, int HW, int span,
                      float* __restrict__ partial) {
  const int c = blockIdx.y;
  const float mean = save[c], rstd = save[C + c];
  const Span sp = block_span(HW, span);
  float sg = 0.f, sgx = 0.f;
  for (int n = 0; n < N; ++n) {
    const size_t base = (static_cast<size_t>(n) * C + c) * HW;
    for (int i = sp.s0 + threadIdx.x * VEC; i < sp.s1; i += kThreads * VEC) {
      float gv[VEC], xv[VEC];
      load_vec<T, VEC>(g + base + i, gv);
      load_vec<T, VEC>(x + base + i, xv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sg += gv[j];
        sgx = fmaf(gv[j], __fmul_rn(__fsub_rn(xv[j], mean), rstd), sgx);
      }
    }
  }
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) {
    float* p = partial + (static_cast<size_t>(c) * gridDim.x + blockIdx.x) * 2;
    p[0] = sg;
    p[1] = sgx;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_elemt_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const float* __restrict__ scale, const float* __restrict__ save,
                    const float* __restrict__ sums, int N, int C, int HW, int span,
                    T* __restrict__ dx) {
  const int c = blockIdx.y;
  const float mean = save[c], rstd = save[C + c], n = save[3 * C];
  const float a = __fdiv_rn(sums[c], n);
  const float b = save[2 * C + c] != 0.f ? __fdiv_rn(sums[C + c], n) : 0.f;
  const float k = __fmul_rn(scale[c], rstd);
  const Span sp = block_span(HW, span);
  for (int n_i = 0; n_i < N; ++n_i) {
    const size_t base = (static_cast<size_t>(n_i) * C + c) * HW;
    for (int i = sp.s0 + threadIdx.x * VEC; i < sp.s1; i += kThreads * VEC) {
      float gv[VEC], xv[VEC];
      load_vec<T, VEC>(g + base + i, gv);
      load_vec<T, VEC>(x + base + i, xv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(xv[j], mean), rstd);
        gv[j] = __fmul_rn(k, __fsub_rn(__fsub_rn(gv[j], a), __fmul_rn(xhat, b)));
      }
      store_vec<T, VEC>(dx + base + i, gv);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side. Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); the Python wrapper raises otherwise.
// dtype: 0 float32, 1 bfloat16. chunks: the grid's first dimension, which
// sized the caller's partial buffer (C * chunks * 2 floats).
// ---------------------------------------------------------------------------

struct Shape {
  int N, C, HW, chunks;
};

static bool valid(const Shape& s) {
  return s.N > 0 && s.C > 0 && s.C <= 65535 && s.HW > 0 && s.chunks > 0 && s.chunks <= 65535;
}

// Which instance runs: 0 float32 scalar, 1 float32 x4, 2 bf16 scalar,
// 3 bf16 x8. The vector width needs HW a multiple of it and every pointer
// 16-byte aligned (then every run starts 16-byte aligned); -1: a dtype the
// kernels do not take.
static int variant(int dtype, const Shape& s, const void* const* ptrs, int n_ptrs) {
  if (dtype != 0 && dtype != 1) return -1;
  bool vec = s.HW % (dtype == 0 ? 4 : 8) == 0;
  for (int i = 0; i < n_ptrs; ++i) vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return 2 * dtype + (vec ? 1 : 0);
}

// Columns per block: HW over chunks, rounded up to the vector width.
static int span_of(const Shape& s, int vec) {
  const int per = (s.HW + s.chunks - 1) / s.chunks;
  return (per + vec - 1) / vec * vec;
}

#define BN_INSTANCES(IMPL, ...)                                             \
  switch (variant(dtype, s, ptrs, sizeof(ptrs) / sizeof(ptrs[0]))) {       \
    case 0: err = IMPL<float, 1>(__VA_ARGS__); break;                       \
    case 1: err = IMPL<float, 4>(__VA_ARGS__); break;                       \
    case 2: err = IMPL<__nv_bfloat16, 1>(__VA_ARGS__); break;               \
    case 3: err = IMPL<__nv_bfloat16, 8>(__VA_ARGS__); break;               \
    default: err = static_cast<int>(cudaErrorInvalidValue);                 \
  }

template <typename T, int VEC>
static int stats_partial(const void* x, const Shape& s, float* partial, cudaStream_t st) {
  bn_stats_partial_kernel<T, VEC><<<dim3(s.chunks, s.C), kThreads, 0, st>>>(
      static_cast<const T*>(x), s.N, s.C, s.HW, span_of(s, VEC), partial);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int normalize(const void* x, const Shape& s, const float* stats, const float* scale,
                     const float* bias, float eps, float momentum, float keep, int update,
                     void* y, float* save, float* running_mean, float* running_var,
                     cudaStream_t st) {
  bn_normalize_kernel<T, VEC><<<dim3(s.chunks, s.C), kThreads, 0, st>>>(
      static_cast<const T*>(x), stats, scale, bias, s.N, s.C, s.HW, span_of(s, VEC), eps,
      momentum, keep, update, static_cast<T*>(y), save, running_mean, running_var);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int bwd_partial(const void* g, const void* x, const Shape& s, const float* save,
                       float* partial, cudaStream_t st) {
  bn_bwd_partial_kernel<T, VEC><<<dim3(s.chunks, s.C), kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), save, s.N, s.C, s.HW,
      span_of(s, VEC), partial);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int bwd_elemt(const void* g, const void* x, const Shape& s, const float* scale,
                     const float* save, const float* sums, void* dx, cudaStream_t st) {
  bn_bwd_elemt_kernel<T, VEC><<<dim3(s.chunks, s.C), kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), scale, save, sums, s.N, s.C, s.HW,
      span_of(s, VEC), static_cast<T*>(dx));
  return static_cast<int>(cudaGetLastError());
}

static int sum_partials(const float* partial, const Shape& s, float* out, float* copy,
                        float count, cudaStream_t st) {
  bn_sum_partials_kernel<<<(2 * s.C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partial, s.C, s.chunks, out, copy, count);
  return static_cast<int>(cudaGetLastError());
}

// stats (2C + 1) of x; partial: C * chunks * 2 floats of scratch.
extern "C" int depthvo_bn_stats(const void* x, int dtype, int N, int C, int HW, int chunks,
                                float* partial, float* stats, void* stream) {
  const Shape s{N, C, HW, chunks};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {x};
  int err;
  BN_INSTANCES(stats_partial, x, s, partial, st)
  if (err) return err;
  return sum_partials(partial, s, stats, nullptr, static_cast<float>(N) * HW, st);
}

// y and save (3C + 1) from the reduced stats; the running averages move
// when update is nonzero.
extern "C" int depthvo_bn_normalize(const void* x, int dtype, int N, int C, int HW, int chunks,
                                    const float* stats, const float* scale, const float* bias,
                                    float eps, float momentum, float keep, int update,
                                    void* y, float* save, float* running_mean,
                                    float* running_var, void* stream) {
  const Shape s{N, C, HW, chunks};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {x, y};
  int err;
  BN_INSTANCES(normalize, x, s, stats, scale, bias, eps, momentum, keep, update, y, save,
               running_mean, running_var, st)
  return err;
}

// sums (4C): [sum g | sum g xhat] twice; partial as for depthvo_bn_stats.
extern "C" int depthvo_bn_bwd_reduce(const void* g, const void* x, int dtype, int N, int C,
                                     int HW, int chunks, const float* save, float* partial,
                                     float* sums, void* stream) {
  const Shape s{N, C, HW, chunks};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {g, x};
  int err;
  BN_INSTANCES(bwd_partial, g, x, s, save, partial, st)
  if (err) return err;
  return sum_partials(partial, s, sums, sums + 2 * C, -1.f, st);
}

// dx from g, x, the saved values and the reduced sums (the first 2C).
extern "C" int depthvo_bn_bwd_elemt(const void* g, const void* x, int dtype, int N, int C,
                                    int HW, int chunks, const float* scale, const float* save,
                                    const float* sums, void* dx, void* stream) {
  const Shape s{N, C, HW, chunks};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {g, x, dx};
  int err;
  BN_INSTANCES(bwd_elemt, g, x, s, scale, save, sums, dx, st)
  return err;
}
