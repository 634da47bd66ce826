// Inverse-warp forward kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (depthvo_tpu_torch/ops/_build.py).
//
// They replace the forward Pallas kernels of depthvo_tpu/ops/warp_pallas.py:
//   stereo_fwd  <- _stereo_fwd_kernel (launched by _stereo_sample_chw_impl)
//   gen_fwd     <- _gen_fwd_kernel with _gen_row_candidates (launched by
//                  _gen_sample_chw_impl), including its emit_grad_aux mode.
//
// What bounds them on this card: bytes. Both are gathers with a handful of
// flops per output value (about 3 per value for stereo_fwd, 9 for gen_fwd,
// 17 with the gradient factors), far below the H100's ~20 flops per byte
// of float32 balance, so the floor is reading src/u/v and writing out once
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
// The window limits of the TPU kernel (|v - row| within the tile window,
// |u - col| <= 127) are part of the caller's `valid` mask, not a limit on
// what this kernel can read.
//
// Rounding. Every lerp is evaluated as (1 - a) * s0 + a * s1 with each
// operation rounded on its own (__fmul_rn / __fadd_rn forbid FMA
// contraction), the order in which the plain PyTorch versions in
// warp_kernels.py evaluate it, so kernel and plain version agree bit for
// bit on the same inputs.

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
