// Inverse-warp kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (depthvo_tpu_torch/ops/_build.py).
//
// They replace the Pallas kernels of depthvo_tpu/ops/warp_pallas.py:
//   stereo_fwd     <- _stereo_fwd_kernel (launched by _stereo_sample_chw_impl)
//   stereo_bwd_u   <- _stereo_bwd_u_kernel (launched by _stereo_sample_chw_bwd)
//   stereo_bwd_src <- _stereo_bwd_src_kernel (launched by _stereo_sample_chw_bwd)
//   gen_fwd        <- _gen_fwd_kernel with _gen_row_candidates (launched by
//                     _gen_sample_chw_impl), including its emit_grad_aux mode.
//
// What bounds them on this card: bytes. All are gathers with a handful of
// flops per value (about 3 per value for stereo_fwd and stereo_bwd_u, 9
// for gen_fwd, 17 with the gradient factors, 4 per cotangent value for
// stereo_bwd_src), far below the H100's ~20 flops per byte of float32
// balance, so the floor is reading the inputs and writing the output once
// at 3.35 TB/s.
//
// Design. The TPU kernels are shaped by Mosaic's one-axis in-vreg gather:
// 128-lane blocks, 8-row tiles, a source-row window and per-row candidate
// enumeration with rolls. None of that is carried over; only the function
// is. One thread computes one output pixel:
//   * threadIdx.x runs along W, so the loads of u/v and the stores of out
//     are coalesced;
//   * the thread computes its clipped coordinates, tap indices and weights
//     once, then loops over the C channels (the TPU kernel hoists the same
//     channel-independent work out of its channel loop);
//   * the source taps are gathers, served mostly from the 50 MB L2: the
//     taps of neighbouring threads lie in the same or adjacent rows.
// (H <= 65535 and B <= 65535: grid y/z limits.)
// The window limits of the TPU kernel (|v - row| within the tile window,
// |u - col| <= 127) are part of the caller's `valid` mask, not a limit on
// what this kernel can read.
//
// The stereo backwards follow the same one-thread-per-pixel rule:
//   * stereo_bwd_u: one thread per output pixel recomputes the forward's
//     taps and sums g * (s1 - s0) over the channels in channel order.
//   * stereo_bwd_src: the gather form of the scatter, as on the TPU, and
//     no atomics: one thread per SOURCE pixel x sums the cotangent of the
//     output pixels j = x + s, s in [0, n_shifts), whose taps land on x.
//     The block owns one image row; the row's u0/au and one channel's
//     cotangent row are staged in shared memory, so the n_shifts reads
//     per thread are shared-memory reads. n_shifts = min(dmax + 2, W) is
//     the TPU kernel's shift range, so the same out-of-range taps drop.
//     The sum order is fixed (s ascending), so the result is
//     deterministic.
//
// Rounding. Every lerp is evaluated as (1 - a) * s0 + a * s1 with each
// operation rounded on its own (__fmul_rn / __fadd_rn forbid FMA
// contraction), and every sum in the order of the plain PyTorch versions
// in warp_kernels.py, so kernel and plain version agree bit for bit on
// the same inputs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float lerp_rn(float a, float s0, float s1) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, a), s0), __fmul_rn(a, s1));
}

// out[b,c,i,j] = (1-au) src[b,c,i,u0] + au src[b,c,i,min(u0+1,W-1)],
// u clipped to [0, W-1]. src (B,C,H,W), u (B,H,W), out (B,C,H,W).
__global__ void __launch_bounds__(kThreads)
stereo_fwd_kernel(const float* __restrict__ src, const float* __restrict__ u,
                  float* __restrict__ out, int C, int H, int W) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= W) return;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(b) * C * HW + static_cast<size_t>(i) * W;

  const float uc = fminf(fmaxf(u[(static_cast<size_t>(b) * H + i) * W + j], 0.0f),
                         static_cast<float>(W - 1));
  const float u0f = floorf(uc);
  const float au = __fsub_rn(uc, u0f);
  const int x0 = static_cast<int>(u0f);
  const int x1 = min(x0 + 1, W - 1);

  for (int c = 0; c < C; ++c) {
    const float* r = src + row + c * HW;
    out[row + c * HW + j] = lerp_rn(au, __ldg(r + x0), __ldg(r + x1));
  }
}

// 2-D bilinear sample of a frozen source at (clip(u,0,W-1), clip(v,0,H-1)).
// With kAux it also writes the gradient factors
//   S = d out / d u = (1-av) (s01 - s00) + av (s11 - s10)
//   D = d out / d v = h1 - h0
// (the TPU kernel's emit_grad_aux outputs), at (B,C,H,W) without padding.
template <bool kAux>
__global__ void __launch_bounds__(kThreads)
gen_fwd_kernel(const float* __restrict__ src, const float* __restrict__ u,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ s_aux, float* __restrict__ d_aux,
               int C, int H, int W) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= W) return;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t pix = (static_cast<size_t>(b) * H + i) * W + j;
  const size_t batch = static_cast<size_t>(b) * C * HW;
  const size_t opix = static_cast<size_t>(i) * W + j;

  const float uc = fminf(fmaxf(u[pix], 0.0f), static_cast<float>(W - 1));
  const float vc = fminf(fmaxf(v[pix], 0.0f), static_cast<float>(H - 1));
  const float u0f = floorf(uc);
  const float v0f = floorf(vc);
  const float au = __fsub_rn(uc, u0f);
  const float av = __fsub_rn(vc, v0f);
  const int x0 = static_cast<int>(u0f);
  const int y0 = static_cast<int>(v0f);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const size_t t00 = static_cast<size_t>(y0) * W + x0;
  const size_t t01 = static_cast<size_t>(y0) * W + x1;
  const size_t t10 = static_cast<size_t>(y1) * W + x0;
  const size_t t11 = static_cast<size_t>(y1) * W + x1;

  for (int c = 0; c < C; ++c) {
    const float* p = src + batch + c * HW;
    const float s00 = __ldg(p + t00);
    const float s01 = __ldg(p + t01);
    const float s10 = __ldg(p + t10);
    const float s11 = __ldg(p + t11);
    const float h0 = lerp_rn(au, s00, s01);
    const float h1 = lerp_rn(au, s10, s11);
    const size_t o = batch + c * HW + opix;
    out[o] = lerp_rn(av, h0, h1);
    if (kAux) {
      s_aux[o] = lerp_rn(av, __fsub_rn(s01, s00), __fsub_rn(s11, s10));
      d_aux[o] = __fsub_rn(h1, h0);
    }
  }
}

// d_u[b,i,j] = sum_c g[b,c,i,j] * (s1 - s0), with the taps of
// stereo_fwd_kernel. src, g (B,C,H,W), u (B,H,W), d_u (B,H,W).
__global__ void __launch_bounds__(kThreads)
stereo_bwd_u_kernel(const float* __restrict__ src, const float* __restrict__ g,
                    const float* __restrict__ u, float* __restrict__ d_u,
                    int C, int H, int W) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= W) return;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(b) * C * HW + static_cast<size_t>(i) * W;
  const size_t pix = (static_cast<size_t>(b) * H + i) * W + j;

  const float uc = fminf(fmaxf(u[pix], 0.0f), static_cast<float>(W - 1));
  const int x0 = static_cast<int>(floorf(uc));
  const int x1 = min(x0 + 1, W - 1);

  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float* r = src + row + c * HW;
    const float slope = __fsub_rn(__ldg(r + x1), __ldg(r + x0));
    acc = __fadd_rn(acc, __fmul_rn(__ldg(g + row + c * HW + j), slope));
  }
  d_u[pix] = acc;
}

constexpr int kRowThreads = 256;

// d_src[b,c,i,x] = sum_{s < n_shifts, x+s < W} g[b,c,i,x+s] * w_s, with
// w_s = (1-au) if u0[x+s] == x, au if u0[x+s] == x-1, else 0 (u clipped
// to [0, W-1], u0 = floor(u), au = u - u0). One block per (row i, batch
// b); dynamic shared memory holds u0, au and one cotangent row (3 W
// words).
__global__ void __launch_bounds__(kRowThreads)
stereo_bwd_src_kernel(const float* __restrict__ g, const float* __restrict__ u,
                      float* __restrict__ d_src, int C, int H, int W,
                      int n_shifts) {
  extern __shared__ float smem[];
  int* s_u0 = reinterpret_cast<int*>(smem);
  float* s_au = smem + W;
  float* s_g = smem + 2 * W;
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t urow = (static_cast<size_t>(b) * H + i) * W;
  const size_t row = static_cast<size_t>(b) * C * HW + static_cast<size_t>(i) * W;

  for (int j = threadIdx.x; j < W; j += kRowThreads) {
    const float uc = fminf(fmaxf(u[urow + j], 0.0f), static_cast<float>(W - 1));
    const float u0f = floorf(uc);
    s_u0[j] = static_cast<int>(u0f);
    s_au[j] = __fsub_rn(uc, u0f);
  }
  for (int c = 0; c < C; ++c) {
    __syncthreads();  // s_u0/s_au written; the previous channel's s_g read
    for (int j = threadIdx.x; j < W; j += kRowThreads) {
      s_g[j] = g[row + c * HW + j];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < W; x += kRowThreads) {
      const int s_end = min(n_shifts, W - x);
      float acc = 0.0f;
      for (int s = 0; s < s_end; ++s) {
        const int j = x + s;
        const int u0 = s_u0[j];
        const float a = s_au[j];
        const float w = __fadd_rn(u0 == x ? __fsub_rn(1.0f, a) : 0.0f,
                                  u0 == x - 1 ? a : 0.0f);
        acc = __fadd_rn(acc, __fmul_rn(s_g[j], w));
      }
      d_src[row + c * HW + x] = acc;
    }
  }
}

dim3 pixel_grid(int B, int H, int W) {
  return dim3((W + kThreads - 1) / kThreads, H, B);
}

}  // namespace

// Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); the Python wrapper raises otherwise.
extern "C" int depthvo_stereo_fwd(const float* src, const float* u, float* out,
                                  int B, int C, int H, int W, void* stream) {
  stereo_fwd_kernel<<<pixel_grid(B, H, W), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(src, u, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int depthvo_stereo_bwd_u(const float* src, const float* g,
                                    const float* u, float* d_u, int B, int C,
                                    int H, int W, void* stream) {
  stereo_bwd_u_kernel<<<pixel_grid(B, H, W), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(src, g, u, d_u,
                                                             C, H, W);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory: 3 W words per block; the wrapper keeps it under the
// default 48 KB (W <= 4096).
extern "C" int depthvo_stereo_bwd_src(const float* g, const float* u,
                                      float* d_src, int B, int C, int H, int W,
                                      int n_shifts, void* stream) {
  const size_t smem = 3 * static_cast<size_t>(W) * sizeof(float);
  stereo_bwd_src_kernel<<<dim3(H, B), kRowThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      g, u, d_src, C, H, W, n_shifts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int depthvo_gen_fwd(const float* src, const float* u, const float* v,
                               float* out, float* s_aux, float* d_aux,
                               int B, int C, int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_aux != nullptr && d_aux != nullptr) {
    gen_fwd_kernel<true><<<pixel_grid(B, H, W), kThreads, 0, st>>>(
        src, u, v, out, s_aux, d_aux, C, H, W);
  } else {
    gen_fwd_kernel<false><<<pixel_grid(B, H, W), kThreads, 0, st>>>(
        src, u, v, out, nullptr, nullptr, C, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
