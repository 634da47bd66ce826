// Inverse-warp kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (depthvo_tpu_torch/ops/_build.py).
//
// They replace the Pallas kernels of depthvo_tpu/ops/warp_pallas.py:
//   stereo_fwd     <- _stereo_fwd_kernel (launched by _stereo_sample_chw_impl)
//   stereo_bwd_u   <- _stereo_bwd_u_kernel (launched by _stereo_sample_chw_bwd)
//   stereo_bwd_src <- _stereo_bwd_src_kernel (launched by _stereo_sample_chw_bwd)
//   gen_fwd        <- _gen_fwd_kernel with _gen_row_candidates (launched by
//                     _gen_sample_chw_impl), including its emit_grad_aux mode.
//   gen_bwd_uv     <- _gen_sample_chw_bwd, which contracts the emit_grad_aux
//                     factors: d_u = sum_c g * S, d_v = sum_c g * D. Here
//                     the factors are recomputed from the source, not stored.
//
// What bounds them on this card: bytes. All are gathers with a handful of
// flops per value (about 3 per value for stereo_fwd and stereo_bwd_u, 9
// for gen_fwd, 17 with the gradient factors, about 19 for gen_bwd_uv, 4
// per nonzero tap for stereo_bwd_src), far below the H100's ~20 flops per
// byte of float32 balance, so the floor is reading the inputs and writing
// the outputs once at 3.35 TB/s.
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
// The backwards:
//   * stereo_bwd_u: one thread per output pixel recomputes the forward's
//     taps and sums g * (s1 - s0) over the channels in channel order.
//   * gen_bwd_uv: the same for the general warp. On the TPU the forward
//     emitted S and D because its gather was bound by the vector
//     instructions it spent on every candidate; here two stored (B,C,H,W)
//     factor tensors cost more bytes to write and read back than the
//     4-tap gather costs to redo, so one thread per output pixel
//     recomputes the taps, forms S_c and D_c per channel and keeps d_u,
//     d_v in registers: g and src are read once, only the two (B,H,W)
//     gradients are written. The channel loop is unrolled so that two
//     channels' loads are in flight.
//   * stereo_bwd_src: the scatter of each output's two taps, (1-au) g to
//     u0 and au g to u0+1, restricted to 0 <= j - x < n_shifts =
//     min(dmax + 2, W), the TPU kernel's shift range. The TPU gathers it
//     as a shift-select sum over all n_shifts candidates of every source
//     pixel (82 at the finest full_feat scale), of which at most two are
//     nonzero on smooth disparities. Here a block owns one or more image
//     rows. It copies the row's u and its first cotangent channels into
//     shared memory with cp.async; then, once for all channels, one thread
//     per output computes the taps and appends each tap of nonzero weight
//     to its source pixel's slots (shared-memory atomics; kSrcSlots slots
//     per pixel, further taps only counted); then one thread per source
//     pixel sorts its slots by j in registers and sums them for every
//     channel, writing d_src coalesced. A pixel with more taps than slots
//     (outputs clipped at the left edge, runs of outputs sharing one u0)
//     runs the shift sum over its n_shifts candidates instead. Every sum
//     runs in ascending j, the order of the shift sum, and there is no
//     global atomic, so the result is deterministic; with finite g every
//     skipped term is g * 0, which changes no partial sum (acc + 0 = acc,
//     +0 + -0 = +0), so it is bit-exact with the shift sum. Bound: bytes,
//     reading g and u once and writing d_src (3.3 us at the finest
//     full_feat shape). What holds it above (PERF.md): each block loads,
//     fills and sums in turn, so the block's time is the sum of those
//     latencies, set by its slowest thread: every row has a left-edge
//     pixel that sums one tap per output clipped there.
//
// Rounding. Every lerp is evaluated as (1 - a) * s0 + a * s1 with each
// operation rounded on its own (__fmul_rn / __fadd_rn forbid FMA
// contraction), and every sum in the order of the plain PyTorch versions
// in warp_kernels.py, so kernel and plain version agree bit for bit on
// the same inputs.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float lerp_rn(float a, float s0, float s1) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, a), s0), __fmul_rn(a, s1));
}

// The stereo taps of one output: u clipped to [0, W-1], x0 = floor(u),
// au = u - x0 (the second tap is min(x0 + 1, W - 1)).
__device__ __forceinline__ void stereo_tap(float u, int W, int& x0, float& au) {
  const float uc = fminf(fmaxf(u, 0.0f), static_cast<float>(W - 1));
  const float u0f = floorf(uc);
  x0 = static_cast<int>(u0f);
  au = __fsub_rn(uc, u0f);
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

  int x0;
  float au;
  stereo_tap(u[(static_cast<size_t>(b) * H + i) * W + j], W, x0, au);
  const int x1 = min(x0 + 1, W - 1);

  for (int c = 0; c < C; ++c) {
    const float* r = src + row + c * HW;
    out[row + c * HW + j] = lerp_rn(au, __ldg(r + x0), __ldg(r + x1));
  }
}

// The four taps of a 2-D bilinear sample at (clip(u,0,W-1), clip(v,0,H-1)):
// offsets within one (H,W) plane and the fractional weights.
struct GenTaps {
  size_t t00, t01, t10, t11;
  float au, av;
};

__device__ __forceinline__ GenTaps gen_taps(float u, float v, int H, int W) {
  const float uc = fminf(fmaxf(u, 0.0f), static_cast<float>(W - 1));
  const float vc = fminf(fmaxf(v, 0.0f), static_cast<float>(H - 1));
  const float u0f = floorf(uc);
  const float v0f = floorf(vc);
  const int x0 = static_cast<int>(u0f);
  const int y0 = static_cast<int>(v0f);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  GenTaps t;
  t.au = __fsub_rn(uc, u0f);
  t.av = __fsub_rn(vc, v0f);
  t.t00 = static_cast<size_t>(y0) * W + x0;
  t.t01 = static_cast<size_t>(y0) * W + x1;
  t.t10 = static_cast<size_t>(y1) * W + x0;
  t.t11 = static_cast<size_t>(y1) * W + x1;
  return t;
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
  const GenTaps t = gen_taps(u[pix], v[pix], H, W);

  for (int c = 0; c < C; ++c) {
    const float* p = src + batch + c * HW;
    const float s00 = __ldg(p + t.t00);
    const float s01 = __ldg(p + t.t01);
    const float s10 = __ldg(p + t.t10);
    const float s11 = __ldg(p + t.t11);
    const float h0 = lerp_rn(t.au, s00, s01);
    const float h1 = lerp_rn(t.au, s10, s11);
    const size_t o = batch + c * HW + opix;
    out[o] = lerp_rn(t.av, h0, h1);
    if (kAux) {
      s_aux[o] = lerp_rn(t.av, __fsub_rn(s01, s00), __fsub_rn(s11, s10));
      d_aux[o] = __fsub_rn(h1, h0);
    }
  }
}

constexpr int kBwdThreads = 64;  // threads of a gen_bwd_uv block

// d_u[b,i,j] = sum_c g[b,c,i,j] * S_c and d_v[b,i,j] = sum_c g[b,c,i,j] *
// D_c, with the taps of gen_fwd_kernel and its factors S_c, D_c recomputed
// per channel, summed in channel order. src, g (B,C,H,W); u, v, d_u, d_v
// (B,H,W). Threads past the ragged edge of the row compute the last pixel
// again and store nothing: an early return there kept the compiler from
// hoisting the unrolled channels' loads (46 against 31 us at the finest
// full_feat shape, PERF.md).
__global__ void __launch_bounds__(kBwdThreads, 1)
gen_bwd_uv_kernel(const float* __restrict__ src, const float* __restrict__ g,
                  const float* __restrict__ u, const float* __restrict__ v,
                  float* __restrict__ d_u, float* __restrict__ d_v,
                  int C, int H, int W) {
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t batch = static_cast<size_t>(b) * C * HW;
  const int j = blockIdx.x * kBwdThreads + threadIdx.x;
  const bool in_row = j < W;
  const int jc = in_row ? j : W - 1;
  const size_t pix = (static_cast<size_t>(b) * H + i) * W + jc;
  const GenTaps t = gen_taps(u[pix], v[pix], H, W);
  const size_t opix = static_cast<size_t>(i) * W + jc;

  float acc_u = 0.0f;
  float acc_v = 0.0f;
#pragma unroll 2
  for (int c = 0; c < C; ++c) {
    const float* p = src + batch + c * HW;
    const float s00 = __ldg(p + t.t00);
    const float s01 = __ldg(p + t.t01);
    const float s10 = __ldg(p + t.t10);
    const float s11 = __ldg(p + t.t11);
    const float gc = __ldg(g + batch + c * HW + opix);
    const float s_c = lerp_rn(t.av, __fsub_rn(s01, s00), __fsub_rn(s11, s10));
    const float d_c = __fsub_rn(lerp_rn(t.au, s10, s11), lerp_rn(t.au, s00, s01));
    acc_u = __fadd_rn(acc_u, __fmul_rn(gc, s_c));
    acc_v = __fadd_rn(acc_v, __fmul_rn(gc, d_c));
  }
  if (in_row) {
    const size_t out = (static_cast<size_t>(b) * H + i) * W + j;
    d_u[out] = acc_u;
    d_v[out] = acc_v;
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

  int x0;
  float au;
  stereo_tap(u[pix], W, x0, au);
  const int x1 = min(x0 + 1, W - 1);

  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float* r = src + row + c * HW;
    const float slope = __fsub_rn(__ldg(r + x1), __ldg(r + x0));
    acc = __fadd_rn(acc, __fmul_rn(__ldg(g + row + c * HW + j), slope));
  }
  d_u[pix] = acc;
}

constexpr int kSrcThreads = 256;  // threads of a stereo_bwd_src block
constexpr int kSrcStage = 4;      // cotangent channels staged per pass
constexpr int kSrcSlots = 4;      // taps a source pixel keeps in slots

// Shared-memory words per image row of stereo_bwd_src: the tap counts, the
// taps (x0 of each output, u before that), au, kSrcSlots slots and
// kSrcStage cotangent rows.
constexpr int kSrcRowWords = 3 + kSrcSlots + kSrcStage;

// Whether output j's tap at source pixel x is within the shift range.
__device__ __forceinline__ bool tap_in_range(int j, int x, int W, int n_shifts) {
  const int s = j - x;
  return x < W && s >= 0 && s < n_shifts;
}

__device__ __forceinline__ void order2(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// d_src[b,c,i,x] = sum over outputs j with 0 <= j - x < n_shifts of
// g[b,c,i,j] * ((1-au[j]) [u0[j] == x] + au[j] [u0[j] == x-1]) (u clipped
// to [0, W-1], u0 = floor(u), au = u - u0), summed in ascending j. Taps of
// weight 0 (au = 0) are left out: g * 0 changes no partial sum.
// blockDim = (T, R): R image rows per block, T threads per row (a multiple
// of 32). Dynamic shared memory: kSrcRowWords * W words per row.
__global__ void __launch_bounds__(kSrcThreads)
stereo_bwd_src_kernel(const float* __restrict__ g, const float* __restrict__ u,
                      float* __restrict__ d_src, int B, int C, int H, int W,
                      int n_shifts) {
  static_assert(kSrcSlots == 4, "the slot sort below is a 4-element network");
  extern __shared__ int smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;  // b * H + i
  const bool active = row < B * H;
  int* s_cnt = smem + threadIdx.y * kSrcRowWords * W;
  int* s_x0 = s_cnt + W;
  float* s_au = reinterpret_cast<float*>(s_x0 + W);
  int* s_slot = s_x0 + 2 * W;  // slot p of source pixel x: s_slot[p * W + x]
  float* s_g = reinterpret_cast<float*>(s_slot + kSrcSlots * W);
  const int b = active ? row / H : 0;
  const int i = active ? row - b * H : 0;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t base = static_cast<size_t>(b) * C * HW + static_cast<size_t>(i) * W;

  // 0. Copy the row's u, then its first cotangent channels, asynchronously
  // into shared memory: the cotangent lands while the slots are filled.
  if (active) {
    const float* urow = u + static_cast<size_t>(row) * W;
    for (int j = t; j < W; j += T) __pipeline_memcpy_async(s_x0 + j, urow + j, sizeof(float));
  }
  __pipeline_commit();
  if (active) {
    for (int k = 0; k < kSrcStage && k < C; ++k) {
      for (int j = t; j < W; j += T) {
        __pipeline_memcpy_async(s_g + k * W + j, g + base + k * HW + j, sizeof(float));
      }
    }
  }
  __pipeline_commit();
  for (int x = t; x < W; x += T) s_cnt[x] = 0;
  __pipeline_wait_prior(1);
  __syncthreads();

  // 1. Each output's taps (x0 replaces u in place). Each tap of nonzero
  // weight within the shift range takes the next slot of its source
  // pixel, as (j << 1 | tap); past kSrcSlots it is only counted.
  if (active) {
    for (int j = t; j < W; j += T) {
      int x0;
      float au;
      stereo_tap(reinterpret_cast<const float*>(s_x0)[j], W, x0, au);
      s_x0[j] = x0;
      s_au[j] = au;
      if (tap_in_range(j, x0, W, n_shifts)) {
        const int p = atomicAdd(&s_cnt[x0], 1);
        if (p < kSrcSlots) s_slot[p * W + x0] = j << 1;
      }
      if (au != 0.0f && tap_in_range(j, x0 + 1, W, n_shifts)) {
        const int p = atomicAdd(&s_cnt[x0 + 1], 1);
        if (p < kSrcSlots) s_slot[p * W + x0 + 1] = (j << 1) | 1;
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. kSrcStage channels at a time, one thread per source pixel. A pixel
  // whose taps fit its slots sorts them by j (the atomics' order is not
  // fixed) and sums them; one with more taps (outputs clipped at the left
  // edge, runs sharing one u0) scans its shift range in ascending j.
  for (int c0 = 0; c0 < C; c0 += kSrcStage) {
    if (c0 > 0) {
      __syncthreads();  // the previous channels' rows are read
      if (active) {
        for (int k = 0; k < kSrcStage && c0 + k < C; ++k) {
          for (int j = t; j < W; j += T) s_g[k * W + j] = __ldg(g + base + (c0 + k) * HW + j);
        }
      }
      __syncthreads();
    }
    if (!active) continue;
    const int nk = min(kSrcStage, C - c0);
    for (int x = t; x < W; x += T) {
      float acc[kSrcStage];
#pragma unroll
      for (int k = 0; k < kSrcStage; ++k) acc[k] = 0.0f;
      const int n = s_cnt[x];
      if (n <= kSrcSlots) {
        int e[kSrcSlots];
#pragma unroll
        for (int p = 0; p < kSrcSlots; ++p) e[p] = p < n ? s_slot[p * W + x] : INT_MAX;
        order2(e[0], e[1]);
        order2(e[2], e[3]);
        order2(e[0], e[2]);
        order2(e[1], e[3]);
        order2(e[1], e[2]);
#pragma unroll
        for (int p = 0; p < kSrcSlots; ++p) {
          if (p < n) {
            const int j = e[p] >> 1;
            const float w = (e[p] & 1) ? s_au[j] : __fsub_rn(1.0f, s_au[j]);
#pragma unroll
            for (int k = 0; k < kSrcStage; ++k) {
              if (k < nk) acc[k] = __fadd_rn(acc[k], __fmul_rn(s_g[k * W + j], w));
            }
          }
        }
      } else {
        // The shift sum itself: outputs whose taps miss x add g * 0.
        const int end = min(W, x + n_shifts);
#pragma unroll 8
        for (int j = x; j < end; ++j) {
          const int x0 = s_x0[j];
          const float a = s_au[j];
          const float w = x0 == x ? __fsub_rn(1.0f, a) : (x0 == x - 1 ? a : 0.0f);
#pragma unroll
          for (int k = 0; k < kSrcStage; ++k) {
            if (k < nk) acc[k] = __fadd_rn(acc[k], __fmul_rn(s_g[k * W + j], w));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kSrcStage; ++k) {
        if (k < nk) d_src[base + (c0 + k) * HW + x] = acc[k];
      }
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

// Rows of kSrcThreads threads at W >= 256; narrower rows get a multiple of
// 32 threads each and share a block. Shared memory: 4 kSrcRowWords W bytes
// per row, above the default 48 KB only after opting in (the wrapper keeps
// W <= MAX_BWD_SRC_WIDTH, under the 227 KB a block can have).
extern "C" int depthvo_stereo_bwd_src(const float* g, const float* u,
                                      float* d_src, int B, int C, int H, int W,
                                      int n_shifts, void* stream) {
  const int threads = min(kSrcThreads, (W + 31) / 32 * 32);
  const int rows = kSrcThreads / threads;
  const size_t smem = static_cast<size_t>(rows) * kSrcRowWords * W * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stereo_bwd_src_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stereo_bwd_src_kernel<<<(B * H + rows - 1) / rows, dim3(threads, rows), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      g, u, d_src, B, C, H, W, n_shifts);
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

extern "C" int depthvo_gen_bwd_uv(const float* src, const float* g,
                                  const float* u, const float* v, float* d_u,
                                  float* d_v, int B, int C, int H, int W,
                                  void* stream) {
  gen_bwd_uv_kernel<<<dim3((W + kBwdThreads - 1) / kBwdThreads, H, B),
                      kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, g, u, v, d_u, d_v, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
