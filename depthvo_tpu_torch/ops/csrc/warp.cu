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
// The TPU kernels are shaped by Mosaic's one-axis in-vreg gather: 128-lane
// blocks, 8-row tiles, a source-row window and per-row candidate
// enumeration with rolls. None of that is carried over; only the function
// is. The window limits of the TPU kernel (|v - row| within the tile
// window, |u - col| <= 127) are part of the caller's `valid` mask, not a
// limit on what these kernels can read.
//
// The forwards (stereo_fwd, gen_fwd) and stereo_bwd_u. The loss warps
// every scale of its pyramid, and all scales' inputs exist before the
// first warp, so one launch takes a table of up to kMaxSegments segments:
// each segment is one (src, u[, v], out) (for stereo_bwd_u: src, u, g,
// d_u) with its own B, C, H, W, passed by value as a __grid_constant__
// kernel parameter. The grid is one 1-D run of blocks
// over all segments' pixels; a block finds its segment by comparing its
// index with the segments' block ends. What held the one-launch-per-scale
// design back (PERF.md): each launch cost ~3 us at the coarse scales
// whatever its size (six of the eight forward launches of a step), an
// early `return` at the ragged row edge, and one channel's gathers in
// flight at a time. So:
//   * the pixels of a segment are indexed flat over B H W, kPix per
//     thread, pixel k of a lane kWarp k pixels after its first, so every
//     load, gather row and store of a warp is coalesced and the only
//     ragged edge is the end of a segment, where threads compute the last
//     pixel again and store nothing (no early return);
//   * the taps of kChan channels are loaded before any is combined or
//     stored: 12 (stereo) or 16 (general) gathers of a thread in flight;
//   * a pixel keeps at most 6 registers (out offset, first tap, tap steps,
//     weights), so a thread fits 64 registers without spilling.
// Alternatives tried (PERF.md, Findings): 4 adjacent pixels per thread with
// float4 maps, and 4 lane-strided pixels, were no faster at the general
// warp's finest (C=19) segment, or spilled registers. The grouped launch
// runs at about the rate of a device copy moving the same bytes
// (chip_smoke.py's copy_ms), below the 3.35 TB/s of the bound.
//
// The backwards:
//   * stereo_bwd_u: the forward's table and pixel layout; a thread
//     recomputes the taps of its kPix pixels, loads g and both taps of
//     kStereoChan channels (all of them at C = 3) before summing any, and
//     sums g * (s1 - s0) in channel order. A backward launch can run only
//     once every one of its scales has its cotangent, so the finest scale,
//     whose cotangent comes first, keeps a launch of its own, and the
//     coarse scales, each 2.4-2.7 us alone whatever its size (PERF.md),
//     share one (warp_kernels.StereoSample).
//   * gen_bwd_uv: the general warp's. On the TPU the forward
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
//   * gen_bwd_uv and stereo_bwd_src launch once per (B,C,H,W) problem
//     (the caller loops over the pyramid's scales), one thread per output
//     pixel or, for stereo_bwd_src, per source pixel (H <= 65535 and
//     B <= 65535: grid y/z limits).
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

constexpr int kWarp = 32;
// The layout of the launches over a segment table (the forwards and
// stereo_bwd_u); depthvo_fwd_layout reports it, and the Python side
// refuses to load a library whose layout its packing does not match.
constexpr int kMaxSegments = 8;
constexpr int kFwdThreads = 128;
constexpr int kPix = 2;  // pixels per forward thread
constexpr int kFwdMinBlocks = 8;  // resident forward blocks per SM (64 registers)
constexpr int kStereoChan = 3;  // stereo channels whose taps are loaded together
constexpr int kGenChan = 2;  // general-warp channels whose taps are loaded together

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

// One segment of a launch over a table: src, out (and the factors s_aux,
// d_aux of gen_fwd's aux mode) (B,C,H,W), u and v (B,H,W); for
// stereo_bwd_u, src and the cotangent g (B,C,H,W), u, and d_u (B,H,W) in
// `out`. Fields a kernel does not use are null. `pixels` = B H W.
struct Segment {
  const float* src;
  const float* u;
  const float* v;
  const float* g;
  float* out;
  float* s_aux;
  float* d_aux;
  int C, H, W;
  int pixels;
};

// The launch's segments and, for each, one past its last block; the
// blocks of segment s are [block_end[s-1], block_end[s]) (from 0 for s=0).
struct SegmentTable {
  Segment seg[kMaxSegments];
  int block_end[kMaxSegments];
  int n;
};

// The segment of this block, and the thread's first pixel q0 in the
// segment's flat run of B H W pixels (b H W + p, p within the H W plane):
// a warp takes kPix kWarp consecutive pixels, pixel k of a thread is
// q0 + k kWarp, so each load and store of a warp is coalesced.
__device__ __forceinline__ int segment_of(const SegmentTable& t, int& q0) {
  const int blk = blockIdx.x;
  int s = 0;
#pragma unroll
  for (int k = 0; k + 1 < kMaxSegments; ++k) s += (k + 1 < t.n && blk >= t.block_end[k]) ? 1 : 0;
  const int first = s == 0 ? 0 : t.block_end[s - 1];
  const int g = (blk - first) * kFwdThreads + static_cast<int>(threadIdx.x);
  const int lane = g % kWarp;
  q0 = (g - lane) * kPix + lane;
  return s;
}

// Pixel k of the thread: its flat index clamped to the segment, the
// offset b C H W of its image, p, its index in the H W plane, and `out`,
// its offset in channel 0 of out (-1 past the segment's end: such a pixel
// is computed again and not stored).
struct Pixel {
  int q;
  int image;
  int p;
  int out;
};

__device__ __forceinline__ Pixel pixel_at(const Segment& sg, int HW, int q) {
  Pixel px;
  px.q = min(q, sg.pixels - 1);
  const int b = px.q / HW;
  px.image = b * sg.C * HW;
  px.p = px.q - b * HW;
  px.out = q < sg.pixels ? px.image + px.p : -1;
  return px;
}

// For every segment: out[b,c,i,j] = (1-au) src[b,c,i,u0] + au
// src[b,c,i,min(u0+1,W-1)], u clipped to [0, W-1]. A thread takes kPix
// pixels (segment_of; row i = p / W of each) and the taps of kChan
// channels at a time. Offsets are ints: the wrapper keeps every tensor
// under 2**31 elements.
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
stereo_fwd_pyramid_kernel(const __grid_constant__ SegmentTable table) {
  constexpr int kChan = kStereoChan;
  int q0;
  const Segment& sg = table.seg[segment_of(table, q0)];
  const int C = sg.C;
  const int W = sg.W;
  const int HW = sg.H * W;

  // Channel 0's out offset and first tap; the second tap is dx (0 or 1)
  // further on.
  int o[kPix], t0[kPix], dx[kPix];
  float au[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const Pixel px = pixel_at(sg, HW, q0 + k * kWarp);
    int x0;
    stereo_tap(__ldg(sg.u + px.q), W, x0, au[k]);
    o[k] = px.out;
    t0[k] = px.image + px.p - px.p % W + x0;
    dx[k] = x0 + 1 < W ? 1 : 0;
  }

  for (int c0 = 0; c0 < C; c0 += kChan) {
    float s0[kChan][kPix], s1[kChan][kPix];
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
      const float* plane = sg.src + min(c0 + c, C - 1) * HW;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        s0[c][k] = __ldg(plane + t0[k]);
        s1[c][k] = __ldg(plane + t0[k] + dx[k]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (o[k] >= 0 && c0 + c < C) {
          sg.out[o[k] + (c0 + c) * HW] = lerp_rn(au[k], s0[c][k], s1[c][k]);
        }
      }
    }
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

// For every segment: the 2-D bilinear sample of a frozen source at
// (clip(u,0,W-1), clip(v,0,H-1)). With kAux it also writes the gradient
// factors
//   S = d out / d u = (1-av) (s01 - s00) + av (s11 - s10)
//   D = d out / d v = h1 - h0
// (the TPU kernel's emit_grad_aux outputs), at (B,C,H,W) without padding.
// A thread takes kPix pixels (segment_of) and the four taps of kChan
// channels at a time.
template <bool kAux>
__global__ void __launch_bounds__(kFwdThreads, kAux ? kFwdMinBlocks / 2
                                                    : kFwdMinBlocks)
gen_fwd_pyramid_kernel(const __grid_constant__ SegmentTable table) {
  constexpr int kChan = kGenChan;
  int q0;
  const Segment& sg = table.seg[segment_of(table, q0)];
  const int C = sg.C;
  const int H = sg.H;
  const int W = sg.W;
  const int HW = H * W;

  // Channel 0's out offset and tap (y0, x0); the other taps are dx (0 or
  // 1) and dy (0 or W) further on.
  int o[kPix], t00[kPix], dx[kPix], dy[kPix];
  float au[kPix], av[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const Pixel px = pixel_at(sg, HW, q0 + k * kWarp);
    const GenTaps t = gen_taps(__ldg(sg.u + px.q), __ldg(sg.v + px.q), H, W);
    o[k] = px.out;
    t00[k] = px.image + static_cast<int>(t.t00);
    dx[k] = static_cast<int>(t.t01 - t.t00);
    dy[k] = static_cast<int>(t.t10 - t.t00);
    au[k] = t.au;
    av[k] = t.av;
  }

  for (int c0 = 0; c0 < C; c0 += kChan) {
    float s00[kChan][kPix], s01[kChan][kPix], s10[kChan][kPix], s11[kChan][kPix];
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
      const float* plane = sg.src + min(c0 + c, C - 1) * HW;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float* p = plane + t00[k];
        s00[c][k] = __ldg(p);
        s01[c][k] = __ldg(p + dx[k]);
        s10[c][k] = __ldg(p + dy[k]);
        s11[c][k] = __ldg(p + dy[k] + dx[k]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
      const int plane = (c0 + c) * HW;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (o[k] < 0 || c0 + c >= C) continue;
        const float h0 = lerp_rn(au[k], s00[c][k], s01[c][k]);
        const float h1 = lerp_rn(au[k], s10[c][k], s11[c][k]);
        sg.out[o[k] + plane] = lerp_rn(av[k], h0, h1);
        if (kAux) {
          sg.s_aux[o[k] + plane] =
              lerp_rn(av[k], __fsub_rn(s01[c][k], s00[c][k]), __fsub_rn(s11[c][k], s10[c][k]));
          sg.d_aux[o[k] + plane] = __fsub_rn(h1, h0);
        }
      }
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

// For every segment: d_u[b,i,j] = sum_c g[b,c,i,j] * (s1 - s0), with the
// taps of stereo_fwd_pyramid_kernel (s0 at x0, s1 at min(x0 + 1, W - 1)),
// summed in channel order. The layout of stereo_fwd_pyramid_kernel: kPix
// pixels per thread (segment_of), each pixel's g and both taps of kChan
// channels loaded before any is summed; past the segment's end a thread
// computes its last pixel again and stores nothing.
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
stereo_bwd_u_pyramid_kernel(const __grid_constant__ SegmentTable table) {
  constexpr int kChan = kStereoChan;
  int q0;
  const Segment& sg = table.seg[segment_of(table, q0)];
  const int C = sg.C;
  const int W = sg.W;
  const int HW = sg.H * W;

  // The pixel's d_u offset (-1: not stored), its offset in channel 0 of
  // g, its first tap there and the step (0 or 1) to the second.
  int o[kPix], gp[kPix], t0[kPix], dx[kPix];
  float acc[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const Pixel px = pixel_at(sg, HW, q0 + k * kWarp);
    int x0;
    float au;
    stereo_tap(__ldg(sg.u + px.q), W, x0, au);
    o[k] = px.out < 0 ? -1 : px.q;
    gp[k] = px.image + px.p;
    t0[k] = gp[k] - px.p % W + x0;
    dx[k] = x0 + 1 < W ? 1 : 0;
    acc[k] = 0.0f;
  }

  for (int c0 = 0; c0 < C; c0 += kChan) {
    float gv[kChan][kPix], s0[kChan][kPix], s1[kChan][kPix];
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
      const int plane = min(c0 + c, C - 1) * HW;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        gv[c][k] = __ldg(sg.g + plane + gp[k]);
        s0[c][k] = __ldg(sg.src + plane + t0[k]);
        s1[c][k] = __ldg(sg.src + plane + t0[k] + dx[k]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (c0 + c < C) {
          acc[k] = __fadd_rn(acc[k], __fmul_rn(gv[c][k], __fsub_rn(s1[c][k], s0[c][k])));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (o[k] >= 0) sg.out[o[k]] = acc[k];
  }
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

// The fields of one segment in a table launch's host arrays: pointers
// (src, u, v, g, out, s_aux, d_aux; warp_kernels.TABLE_FIELDS) and ints
// (B, C, H, W, block_end), the latter from warp_kernels.pack_segments.
constexpr int kPtrFields = 7;
constexpr int kIntFields = 5;

// Copies n segments from the host arrays into a launch's table; false
// when n is out of range or the blocks do not run on from 0 in order.
bool fill_table(int n, const void* const* ptrs, const int* ints, SegmentTable& t) {
  if (n < 1 || n > kMaxSegments) return false;
  t = SegmentTable{};
  t.n = n;
  int end = 0;
  for (int s = 0; s < n; ++s) {
    const void* const* p = ptrs + s * kPtrFields;
    const int* q = ints + s * kIntFields;
    Segment& sg = t.seg[s];
    sg.src = static_cast<const float*>(p[0]);
    sg.u = static_cast<const float*>(p[1]);
    sg.v = static_cast<const float*>(p[2]);
    sg.g = static_cast<const float*>(p[3]);
    sg.out = static_cast<float*>(const_cast<void*>(p[4]));
    sg.s_aux = static_cast<float*>(const_cast<void*>(p[5]));
    sg.d_aux = static_cast<float*>(const_cast<void*>(p[6]));
    sg.C = q[1];
    sg.H = q[2];
    sg.W = q[3];
    sg.pixels = q[0] * q[2] * q[3];
    if (q[4] <= end) return false;
    end = t.block_end[s] = q[4];
  }
  return true;
}

}  // namespace

// The layout of the table launches (the forwards and stereo_bwd_u):
// (kMaxSegments, kFwdThreads, kPix), which warp_kernels.pack_segments must
// use for the block ends it passes.
extern "C" void depthvo_fwd_layout(int* out) {
  out[0] = kMaxSegments;
  out[1] = kFwdThreads;
  out[2] = kPix;
}

// Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); the Python wrapper raises otherwise.

// One launch over n segments (1 <= n <= kMaxSegments), laid out as
// fill_table reads them.
extern "C" int depthvo_stereo_fwd(int n, const void* const* ptrs, const int* ints,
                                  void* stream) {
  SegmentTable t;
  if (!fill_table(n, ptrs, ints, t)) return static_cast<int>(cudaErrorInvalidValue);
  stereo_fwd_pyramid_kernel<<<t.block_end[n - 1], kFwdThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// As depthvo_stereo_fwd: d_u of n segments (src, u, g, d_u) in one launch.
extern "C" int depthvo_stereo_bwd_u(int n, const void* const* ptrs, const int* ints,
                                    void* stream) {
  SegmentTable t;
  if (!fill_table(n, ptrs, ints, t)) return static_cast<int>(cudaErrorInvalidValue);
  stereo_bwd_u_pyramid_kernel<<<t.block_end[n - 1], kFwdThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(t);
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

// As depthvo_stereo_fwd; `aux` nonzero also writes the factors S and D.
extern "C" int depthvo_gen_fwd(int n, const void* const* ptrs, const int* ints, int aux,
                               void* stream) {
  SegmentTable t;
  if (!fill_table(n, ptrs, ints, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aux) {
    gen_fwd_pyramid_kernel<true><<<t.block_end[n - 1], kFwdThreads, 0, st>>>(t);
  } else {
    gen_fwd_pyramid_kernel<false><<<t.block_end[n - 1], kFwdThreads, 0, st>>>(t);
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
