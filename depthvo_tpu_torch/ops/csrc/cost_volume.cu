// ManyDepth's plane-sweep cost volume for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (depthvo_tpu_torch/ops/_build.py,
// wrapped by depthvo_tpu_torch/ops/cost_volume.py).
//
// It replaces no TPU kernel: the JAX package has no ManyDepth. It replaces
// ResnetEncoderMatching.match_features, compute_confidence_mask and the
// lowest-cost argmin of the public code (github.com/nianticlabs/manydepth,
// networks/resnet_encoder.py), which loops over the batch on the host and
// runs grid_sample on 96 repeated copies of each row's lookup features
// (503 MB of float32 a row at 64 x 80 x 256), and reads the host twice a
// step. For each pixel p of the current features (B, 64, H, W) and each
// depth bin d:
//
//   q      = project(P_b [d * ray_p; 1])             // ray_p = K^-1 [x, y, 1]
//   cost   = edge(p, q) ? mean_c |bilinear_c(F-1, q) - F0_c(p)| : 0
//   v      = cost / ((cost > 0) + 1e-7)
//   missing where v == 0; conf_p = no bin missing
//   volume = conf_p ? v : 0                           // missing-to-max, then x conf
//   lowest = 1 / bin[argmin_d (v missing-to-max, 0 -> 100)]
//
// with the bilinear sample zero-padded and align_corners=True
// (grid_sample's), edge() keeping samples within [2, W - 2] x [2, H - 2]
// and current pixels at least 2 from the border, and a row whose
// matching pose is zero (valid_b == 0) adding nothing: all its bins are
// missing. Missing-to-max survives only in lowest: the confidence zeroes
// every pixel with a missing bin.
//
//   cost_volume_fwd_kernel<T>   T = float or __nv_bfloat16 (the features'
//                               compute dtype; arithmetic in float32)
//
// Design. One thread takes one pixel and walks the bins: the current
// pixel's 64 channels are read once (NCHW, coalesced over x) into
// registers, and the bin's four corners are read from the lookup features
// in NHWC (the wrapper's one copy), so each corner is 64 contiguous
// channels (128 B in bfloat16), loaded 8 channels at a time in 16-byte
// loads. Adjacent threads sample adjacent points of their epipolar lines,
// so a warp's corners share cache lines; a row's lookup map (2.6 MB in
// bfloat16) stays in L2. Each bin's cost is written once, as it is made
// (coalesced over x); a pixel found not confident writes its 96 zeros
// after the walk. Nothing but the outputs is written.
//
// Arithmetic. Everything is float32, written with __fadd_rn / __fmul_rn /
// __fdiv_rn so that nvcc contracts nothing into an FMA, in the order of
// cost_volume.py's cost_volume_plain: cam_r = ((P_r0 X + P_r1 Y) + P_r2 Z)
// + P_r3; the normalised coordinate (px / (W - 1) - 0.5) * 2, then
// grid_sample's ((g + 1) / 2) (W - 1) and the edge test's (g / 2 + 0.5)
// (W - 1); the corners' weights as grid_sample forms them, summed nw, ne,
// sw, se; the channels summed in order from 0 and divided by 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;        // channels: ResNet18's layer1 width
constexpr int kThreads = 128;  // pixels a block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: the low half is the even channel
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void corner(const T* p, bool in, float v[8]) {
  if (in) {
    load8(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cost_volume_fwd_kernel(const T* __restrict__ cur, const T* __restrict__ look,
                       const float* __restrict__ rays, const float* __restrict__ P,
                       const float* __restrict__ bins, const int* __restrict__ valid,
                       float* __restrict__ volume, float* __restrict__ conf,
                       float* __restrict__ lowest, int B, int H, int W, int D) {
  const int HW = H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * HW) return;
  const int b = (int)(idx / HW);
  const int pix = (int)(idx - (long long)b * HW);
  const int y = pix / W;
  const int x = pix - y * W;
  float* vol = volume + (size_t)b * D * HW + pix;

  if (!valid[b]) {  // a zero matching pose: every bin missing
    for (int d = 0; d < D; ++d) vol[(size_t)d * HW] = 0.f;
    conf[idx] = 0.f;
    lowest[idx] = __fdiv_rn(1.f, __ldg(bins));
    return;
  }

  float f[kC];
  const T* c0 = cur + (size_t)b * kC * HW + pix;
#pragma unroll
  for (int c = 0; c < kC; ++c) f[c] = to_float(c0[(size_t)c * HW]);
  const float rx = rays[((size_t)b * 3 + 0) * HW + pix];
  const float ry = rays[((size_t)b * 3 + 1) * HW + pix];
  const float rz = rays[((size_t)b * 3 + 2) * HW + pix];
  float p[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) p[i] = __ldg(P + b * 12 + i);

  const bool inner = y >= 2 && y <= H - 3 && x >= 2 && x <= W - 3;
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  const float xmax = (float)(W - 2), ymax = (float)(H - 2);
  const T* lb = look + (size_t)b * HW * kC;

  bool missing = false;
  int imin = -1;
  float vmin = 0.f, vmax = 0.f;
  for (int d = 0; d < D; ++d) {
    const float dep = __ldg(bins + d);
    const float X = __fmul_rn(dep, rx), Y = __fmul_rn(dep, ry), Z = __fmul_rn(dep, rz);
    float cam[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      cam[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[4 * r], X), __fmul_rn(p[4 * r + 1], Y)),
                                   __fmul_rn(p[4 * r + 2], Z)),
                         p[4 * r + 3]);
    const float z = __fadd_rn(cam[2], 1e-7f);
    const float gx = __fmul_rn(__fsub_rn(__fdiv_rn(__fdiv_rn(cam[0], z), wm1), 0.5f), 2.f);
    const float gy = __fmul_rn(__fsub_rn(__fdiv_rn(__fdiv_rn(cam[1], z), hm1), 0.5f), 2.f);
    const float xv = __fmul_rn(__fadd_rn(__fmul_rn(gx, 0.5f), 0.5f), wm1);
    const float yv = __fmul_rn(__fadd_rn(__fmul_rn(gy, 0.5f), 0.5f), hm1);
    float cost = 0.f;
    if (inner && xv >= 2.f && xv <= xmax && yv >= 2.f && yv <= ymax) {
      const float ix = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), wm1);
      const float iy = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), hm1);
      const float x0 = floorf(ix), y0 = floorf(iy);
      const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
      const float wnw = __fmul_rn(__fsub_rn(x1, ix), __fsub_rn(y1, iy));
      const float wne = __fmul_rn(__fsub_rn(ix, x0), __fsub_rn(y1, iy));
      const float wsw = __fmul_rn(__fsub_rn(x1, ix), __fsub_rn(iy, y0));
      const float wse = __fmul_rn(__fsub_rn(ix, x0), __fsub_rn(iy, y0));
      const int xi = (int)x0, yi = (int)y0;
      const bool inx0 = xi >= 0 && xi < W, inx1 = xi + 1 >= 0 && xi + 1 < W;
      const bool iny0 = yi >= 0 && yi < H, iny1 = yi + 1 >= 0 && yi + 1 < H;
      const T* pnw = lb + ((size_t)yi * W + xi) * kC;
      const T* pne = pnw + kC;
      const T* psw = pnw + (size_t)W * kC;
      const T* pse = psw + kC;
      float acc = 0.f;
#pragma unroll
      for (int c8 = 0; c8 < kC; c8 += 8) {
        float a[8], e[8], g[8], h[8];
        corner(pnw + c8, inx0 && iny0, a);
        corner(pne + c8, inx1 && iny0, e);
        corner(psw + c8, inx0 && iny1, g);
        corner(pse + c8, inx1 && iny1, h);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = __fmul_rn(a[j], wnw);
          s = __fadd_rn(s, __fmul_rn(e[j], wne));
          s = __fadd_rn(s, __fmul_rn(g[j], wsw));
          s = __fadd_rn(s, __fmul_rn(h[j], wse));
          acc = __fadd_rn(acc, fabsf(__fsub_rn(s, f[c8 + j])));
        }
      }
      cost = __fdiv_rn(acc, (float)kC);
    }
    const float v = __fdiv_rn(cost, __fadd_rn(cost > 0.f ? 1.f : 0.f, 1e-7f));
    vol[(size_t)d * HW] = v;
    if (v == 0.f) {
      missing = true;
    } else {
      if (imin < 0 || v < vmin) {
        vmin = v;
        imin = d;
      }
      vmax = fmaxf(vmax, v);
    }
  }
  if (missing) {
    for (int d = 0; d < D; ++d) vol[(size_t)d * HW] = 0.f;
  }
  conf[idx] = missing ? 0.f : 1.f;
  // The first minimum of the missing-to-max volume with 0 read as 100:
  // bin 0 where every bin is missing (all 0) or every bin holds one value
  // (the missing ones the maximum, which is then the minimum too).
  const int arg = (imin < 0 || (missing && vmax == vmin)) ? 0 : imin;
  lowest[idx] = __fdiv_rn(1.f, __ldg(bins + arg));
}

template <typename T>
int launch(const void* cur, const void* look, const float* rays, const float* P,
           const float* bins, const int* valid, float* volume, float* conf, float* lowest,
           int B, int H, int W, int D, cudaStream_t stream) {
  const long long n = (long long)B * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cost_volume_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(cur), static_cast<const T*>(look), rays, P, bins, valid, volume,
      conf, lowest, B, H, W, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kC, kThreads: cost_volume.py checks them when it loads the library.
void depthvo_cost_volume_layout(int* out) {
  out[0] = kC;
  out[1] = kThreads;
}

// cur (B, 64, H, W) and look_nhwc (B, H, W, 64) in float32 (bf16 == 0) or
// bfloat16 (bf16 == 1); rays (B, 3, H, W), P (B, 3, 4), bins (D,) float32;
// valid (B,) int32. Writes volume (B, D, H, W), conf and lowest (B, H, W).
int depthvo_cost_volume_fwd(const void* cur, const void* look_nhwc, const float* rays,
                            const float* P, const float* bins, const int* valid, float* volume,
                            float* conf, float* lowest, int B, int H, int W, int D, int bf16,
                            cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(cur, look_nhwc, rays, P, bins, valid, volume, conf, lowest, B,
                                 H, W, D, stream);
  return launch<float>(cur, look_nhwc, rays, P, bins, valid, volume, conf, lowest, B, H, W, D,
                       stream);
}

}  // extern "C"
