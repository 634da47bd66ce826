// Native data-loading runtime of the PyTorch port.
//
// The port's own copy of the reference's C++ data path (native/dataloader.cpp:
// caffe base_data_layer.cpp + internal_thread.cpp + data_transformer.cpp --
// prefetching pipeline and image transforms), with the prefetch ring's
// counters added (dvf_loader_stats). Python drives it via ctypes
// (depthvo_tpu_torch/data/native_loader.py); the hot loop (PNG
// inflate+unfilter, resize, normalize to [-1,1] float32 or raw uint8 NHWC)
// runs here on host threads while the card computes.
//
// Components:
//   * minimal PNG decoder (zlib inflate + per-scanline unfilter) for 8-bit
//     gray/RGB/RGBA non-interlaced images (KITTI frames are 8-bit RGB);
//   * bilinear resize to the training resolution;
//   * a worker-pool prefetcher with a bounded ring of ready batches.
//
// C ABI (all functions return 0 on success unless noted):
//   dvf_decode_png(path, &w, &h, &c, buf, cap)     one image -> uint8 HWC
//   dvf_load_resized(path, out_h, out_w, out_f32)  decode+resize+normalize
//   dvf_loader_create(paths, n, batch, h, w, threads, seed, shuffle)
//   dvf_loader_next(handle, out_f32, indices_out)  blocking batch fetch
//   dvf_loader_stats(handle, out, n)                the ring's counters
//   dvf_loader_destroy(handle)

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- PNG ----

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // HWC
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit non-interlaced gray/RGB/RGBA PNG. Returns 0 on success.
int decode_png(const char* path, Image* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 45) {
    std::fclose(f);
    return 2;
  }
  std::vector<uint8_t> buf(size);
  if (std::fread(buf.data(), 1, size, f) != size_t(size)) {
    std::fclose(f);
    return 3;
  }
  std::fclose(f);

  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (std::memcmp(buf.data(), kSig, 8) != 0) return 4;

  int w = 0, h = 0, channels = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  int bit_depth = 0, color_type = 0, interlace = 0;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) return 5;
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      w = int(be32(data));
      h = int(be32(data + 4));
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
      if (bit_depth != 8 || interlace != 0) return 6;  // unsupported
      switch (color_type) {
        case 0: channels = 1; break;
        case 2: channels = 3; break;
        case 6: channels = 4; break;
        default: return 7;  // palette/gray+alpha unsupported
      }
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0 || channels == 0 || idat.empty()) return 8;

  const size_t stride = size_t(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return 9;
  }

  out->w = w;
  out->h = h;
  out->c = channels;
  out->data.assign(stride * h, 0);
  const int bpp = channels;  // bytes per pixel (8-bit)
  for (int y = 0; y < h; ++y) {
    const uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &out->data[stride * y];
    const uint8_t* up = y > 0 ? &out->data[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      const int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return 10;
      }
      dst[x] = uint8_t(v);
    }
  }
  return 0;
}

// ------------------------------------------------------------- resize ----

// PIL-compatible separable triangle-filter resampling. On downscale the
// filter support widens with the reduction factor (area-weighted average),
// matching Image.resize(..., BILINEAR) — point-sampled bilinear would
// alias KITTI's ~2x reduction to 608x160 and diverge from the Python
// loader (train/eval distribution shift between the two paths).
struct ResampleAxis {
  std::vector<int> xmin;          // first source tap per output pixel
  std::vector<int> count;         // number of taps
  std::vector<float> weights;     // taps, `max_taps` stride
  int max_taps = 0;
};

ResampleAxis make_axis(int in_size, int out_size) {
  ResampleAxis ax;
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support
  ax.max_taps = int(std::ceil(support)) * 2 + 1;
  ax.xmin.resize(out_size);
  ax.count.resize(out_size);
  ax.weights.assign(size_t(out_size) * ax.max_taps, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = int(center - support + 0.5);
    int hi = int(center + support + 0.5);
    if (lo < 0) lo = 0;
    if (hi > in_size) hi = in_size;
    double total = 0.0;
    float* w = &ax.weights[size_t(i) * ax.max_taps];
    for (int k = lo; k < hi; ++k) {
      const double x = (k - center + 0.5) / filterscale;
      const double v = x < 0 ? (x <= -1 ? 0.0 : 1.0 + x) : (x >= 1 ? 0.0 : 1.0 - x);
      w[k - lo] = float(v);
      total += v;
    }
    if (total > 0) {
      for (int k = 0; k < hi - lo; ++k) w[k] = float(w[k] / total);
    }
    ax.xmin[i] = lo;
    ax.count[i] = hi - lo;
  }
  return ax;
}

// Resize to (out_h, out_w, 3). Exactly one of out_f32 / out_u8 is
// non-null: f32 output is normalized to [-1, 1] (the classic training
// contract); u8 output rounds to the uint8 grid with NO normalization —
// 4x fewer bytes for the host->device uplink, normalization happens
// on-device (train/loop.py::compute_losses, api.DepthVO). The u8
// rounding matches the Python load_image_u8 contract: round(acc),
// clipped — at most half a 1/255 grid step from the f32 path.
void resize_to(const Image& img, int out_h, int out_w, float* out_f32,
               uint8_t* out_u8) {
  const ResampleAxis ax_x = make_axis(img.w, out_w);
  const ResampleAxis ax_y = make_axis(img.h, out_h);
  // Horizontal pass: (h, w, c) -> (h, out_w, 3).
  std::vector<float> tmp(size_t(img.h) * out_w * 3);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* src = &img.data[size_t(y) * img.w * img.c];
    for (int ox = 0; ox < out_w; ++ox) {
      const float* w = &ax_x.weights[size_t(ox) * ax_x.max_taps];
      const int lo = ax_x.xmin[ox];
      const int n = ax_x.count[ox];
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = src + size_t(lo + k) * img.c;
        if (img.c == 1) {
          const float v = w[k] * px[0];
          acc[0] += v;
          acc[1] += v;
          acc[2] += v;
        } else {
          acc[0] += w[k] * px[0];
          acc[1] += w[k] * px[1];
          acc[2] += w[k] * px[2];
        }
      }
      float* dst = &tmp[(size_t(y) * out_w + ox) * 3];
      dst[0] = acc[0];
      dst[1] = acc[1];
      dst[2] = acc[2];
    }
  }
  // Vertical pass + normalize: (h, out_w, 3) -> (out_h, out_w, 3).
  for (int oy = 0; oy < out_h; ++oy) {
    const float* w = &ax_y.weights[size_t(oy) * ax_y.max_taps];
    const int lo = ax_y.xmin[oy];
    const int n = ax_y.count[oy];
    for (int ox = 0; ox < out_w; ++ox) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < n; ++k) {
        const float* px = &tmp[(size_t(lo + k) * out_w + ox) * 3];
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      const size_t o = (size_t(oy) * out_w + ox) * 3;
      if (out_f32) {
        out_f32[o + 0] = acc[0] / 127.5f - 1.0f;
        out_f32[o + 1] = acc[1] / 127.5f - 1.0f;
        out_f32[o + 2] = acc[2] / 127.5f - 1.0f;
      } else {
        for (int ch = 0; ch < 3; ++ch) {
          const float r = acc[ch] + 0.5f;  // round-half-up, clip to u8
          out_u8[o + ch] =
              uint8_t(r <= 0.0f ? 0 : (r >= 255.0f ? 255 : int(r)));
        }
      }
    }
  }
}

void resize_normalize(const Image& img, int out_h, int out_w, float* out) {
  resize_to(img, out_h, out_w, out, nullptr);
}

// ----------------------------------------------------------- prefetch ----

int64_t wall_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// CPU time of the calling thread: under a span of wall time, less than
// the span where the thread waited for a core.
int64_t thread_cpu_ns() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// The ring's counters, in dvf_loader_stats' order: batches served, the
// consumer's wall time blocked in Next(), images decoded, the workers'
// wall time in decode_png and in resize_to, and their thread CPU time
// over the same decode + resize intervals.
enum Stat {
  kBatches,
  kConsumerWaitNs,
  kImages,
  kDecodeNs,
  kResizeNs,
  kWorkCpuNs,
  kNumStats
};

struct Batch {
  std::vector<float> data;       // batch * h * w * 3 (f32 mode)
  std::vector<uint8_t> data_u8;  // batch * h * w * 3 (u8 mode)
  std::vector<int64_t> index;    // source sample indices
  int error = 0;                 // first decode error in the batch, 0 if none
};

class Loader {
 public:
  Loader(std::vector<std::string> paths, int batch, int out_h, int out_w,
         int n_threads, uint64_t seed, bool shuffle, int queue_cap,
         bool emit_u8)
      : paths_(std::move(paths)),
        batch_(batch),
        out_h_(out_h),
        out_w_(out_w),
        shuffle_(shuffle),
        rng_(seed),
        queue_cap_(queue_cap),
        emit_u8_(emit_u8) {
    order_.resize(paths_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    if (shuffle_) std::shuffle(order_.begin(), order_.end(), rng_);
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { Work(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Blocking: copy the next ready batch into out (f32 or u8 matching the
  // loader's mode). Returns 0, a decode error code from the first failing
  // image, -1 on shutdown, or -3 on a mode mismatch. Batches are served
  // strictly in claim (ticket) order regardless of which worker thread
  // finishes first — the consumer-visible stream is deterministic for a
  // given seed, like Caffe's prefetch queue.
  int Next(float* out_f32, uint8_t* out_u8, int64_t* indices) {
    if ((out_f32 != nullptr) == emit_u8_) return -3;
    const int64_t w0 = wall_ns();
    std::unique_lock<std::mutex> lock(mu_);
    cv_ready_.wait(lock, [this] {
      return stop_ || (!ready_.empty() && ready_.front().first == serve_);
    });
    stats_[kConsumerWaitNs] += wall_ns() - w0;
    if (stop_ && (ready_.empty() || ready_.front().first != serve_)) return -1;
    ++stats_[kBatches];
    Batch b = std::move(ready_.front().second);
    std::pop_heap(ready_.begin(), ready_.end(), TicketGreater());
    ready_.pop_back();
    ++serve_;
    lock.unlock();
    cv_space_.notify_one();
    if (emit_u8_) {
      std::memcpy(out_u8, b.data_u8.data(), b.data_u8.size());
    } else {
      std::memcpy(out_f32, b.data.data(), b.data.size() * sizeof(float));
    }
    if (indices) {
      std::memcpy(indices, b.index.data(), b.index.size() * sizeof(int64_t));
    }
    return b.error;
  }

  // Copy the first n counters into out; returns how many there are.
  int Stats(int64_t* out, int n) const {
    for (int i = 0; i < n && i < kNumStats; ++i) out[i] = stats_[i].load();
    return kNumStats;
  }

 private:
  struct TicketGreater {
    bool operator()(const std::pair<uint64_t, Batch>& a,
                    const std::pair<uint64_t, Batch>& b) const {
      return a.first > b.first;  // min-heap on ticket
    }
  };

  // Claim the next `batch_` sample indices (epoch-shuffled, wrapping)
  // plus this batch's serve-order ticket.
  std::vector<size_t> Claim(uint64_t* ticket) {
    std::lock_guard<std::mutex> lock(order_mu_);
    *ticket = next_ticket_++;
    std::vector<size_t> out;
    out.reserve(batch_);
    for (int i = 0; i < batch_; ++i) {
      if (cursor_ >= order_.size()) {
        cursor_ = 0;
        if (shuffle_) std::shuffle(order_.begin(), order_.end(), rng_);
      }
      out.push_back(order_[cursor_++]);
    }
    return out;
  }

  void Work() {
    const size_t frame_elems = size_t(out_h_) * out_w_ * 3;
    for (;;) {
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_space_.wait(lock, [this] {
          return stop_ || ready_.size() + in_flight_ < size_t(queue_cap_);
        });
        if (stop_) return;
        ++in_flight_;
      }
      uint64_t ticket = 0;
      std::vector<size_t> idx = Claim(&ticket);
      Batch b;
      if (emit_u8_) {
        b.data_u8.resize(size_t(batch_) * frame_elems);
      } else {
        b.data.resize(size_t(batch_) * frame_elems);
      }
      b.index.assign(idx.begin(), idx.end());
      for (int i = 0; i < batch_; ++i) {
        Image img;
        // The CPU clock's reads lie inside the wall clock's, so the CPU
        // time never exceeds the wall time it is compared with.
        const int64_t w0 = wall_ns();
        const int64_t c0 = thread_cpu_ns();
        const int rc = decode_png(paths_[idx[i]].c_str(), &img);
        ++stats_[kImages];
        if (rc != 0) {
          stats_[kWorkCpuNs] += thread_cpu_ns() - c0;
          stats_[kDecodeNs] += wall_ns() - w0;
          if (b.error == 0) b.error = rc;
          if (emit_u8_) {
            std::memset(b.data_u8.data() + size_t(i) * frame_elems, 0,
                        frame_elems);
          } else {
            std::memset(b.data.data() + size_t(i) * frame_elems, 0,
                        frame_elems * sizeof(float));
          }
          continue;
        }
        const int64_t w1 = wall_ns();
        stats_[kDecodeNs] += w1 - w0;
        if (emit_u8_) {
          resize_to(img, out_h_, out_w_, nullptr,
                    b.data_u8.data() + size_t(i) * frame_elems);
        } else {
          resize_to(img, out_h_, out_w_,
                    b.data.data() + size_t(i) * frame_elems, nullptr);
        }
        stats_[kWorkCpuNs] += thread_cpu_ns() - c0;
        stats_[kResizeNs] += wall_ns() - w1;
      }
      {
        std::lock_guard<std::mutex> lock(mu_);
        --in_flight_;
        ready_.emplace_back(ticket, std::move(b));
        std::push_heap(ready_.begin(), ready_.end(), TicketGreater());
      }
      cv_ready_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  const int batch_, out_h_, out_w_;
  const bool shuffle_;
  std::mt19937_64 rng_;
  const int queue_cap_;

  std::mutex order_mu_;
  std::vector<size_t> order_;
  size_t cursor_ = 0;
  uint64_t next_ticket_ = 0;

  const bool emit_u8_;

  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  // Min-heap on ticket: Next() serves batches in claim order.
  std::vector<std::pair<uint64_t, Batch>> ready_;
  uint64_t serve_ = 0;
  size_t in_flight_ = 0;
  bool stop_ = false;

  std::atomic<int64_t> stats_[kNumStats] = {};

  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

int dvf_decode_png(const char* path, int* w, int* h, int* c, uint8_t* out,
                   int64_t out_capacity) {
  Image img;
  const int rc = decode_png(path, &img);
  if (rc != 0) return rc;
  *w = img.w;
  *h = img.h;
  *c = img.c;
  const int64_t need = int64_t(img.data.size());
  if (out) {
    if (out_capacity < need) return -2;
    std::memcpy(out, img.data.data(), need);
  }
  return 0;
}

int dvf_load_resized(const char* path, int out_h, int out_w, float* out) {
  Image img;
  const int rc = decode_png(path, &img);
  if (rc != 0) return rc;
  resize_normalize(img, out_h, out_w, out);
  return 0;
}

int dvf_load_resized_u8(const char* path, int out_h, int out_w,
                        uint8_t* out) {
  Image img;
  const int rc = decode_png(path, &img);
  if (rc != 0) return rc;
  resize_to(img, out_h, out_w, nullptr, out);
  return 0;
}

void* dvf_loader_create(const char** paths, int64_t n_paths, int batch,
                        int out_h, int out_w, int n_threads, int64_t seed,
                        int shuffle, int queue_cap, int emit_u8) {
  if (n_paths <= 0 || batch <= 0) return nullptr;
  std::vector<std::string> p(paths, paths + n_paths);
  return new Loader(std::move(p), batch, out_h, out_w,
                    n_threads > 0 ? n_threads : 2, uint64_t(seed),
                    shuffle != 0, queue_cap > 0 ? queue_cap : 4,
                    emit_u8 != 0);
}

int dvf_loader_next(void* handle, float* out, int64_t* indices) {
  return static_cast<Loader*>(handle)->Next(out, nullptr, indices);
}

int dvf_loader_next_u8(void* handle, uint8_t* out, int64_t* indices) {
  return static_cast<Loader*>(handle)->Next(nullptr, out, indices);
}

// The ring's counters (Stat order) into out[0..n); returns their count.
// A null handle writes nothing and returns the count.
int dvf_loader_stats(void* handle, int64_t* out, int n) {
  if (!handle) return kNumStats;
  return static_cast<Loader*>(handle)->Stats(out, n);
}

void dvf_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
