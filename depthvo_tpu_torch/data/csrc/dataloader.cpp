// Native data-loading runtime of the PyTorch port.
//
// The port's own copy of the reference's C++ data path (native/dataloader.cpp:
// caffe base_data_layer.cpp + internal_thread.cpp + data_transformer.cpp --
// prefetching pipeline and image transforms), with the prefetch ring's
// counters added (dvf_loader_stats) and a PNG decoder of its own (the same
// pixels, decoded faster). Python drives it via ctypes
// (depthvo_tpu_torch/data/native_loader.py); the hot loop (PNG
// inflate+unfilter, resize, normalize to [-1,1] float32 or raw uint8 NHWC)
// runs here on host threads while the card computes.
//
// Components:
//   * minimal PNG decoder for 8-bit gray/RGB/RGBA non-interlaced images
//     (KITTI frames are 8-bit RGB): its own table-driven inflate (zlib
//     serves only the Adler-32) and a per-row unfilter, into buffers each
//     ring worker keeps from one image to the next;
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
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- PNG ----

int64_t wall_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// A decoded 8-bit HWC image; the pixels belong to the PngDecoder that made
// it and stay valid until its next Decode.
struct Image {
  int w = 0, h = 0, c = 0;
  const uint8_t* data = nullptr;
};

// Bytes kept across uses: grown when a use needs more, never shrunk, and
// never initialised (every byte handed out is written before it is read).
class Buffer {
 public:
  uint8_t* Reserve(size_t n) {
    if (n > cap_) {
      p_.reset(new uint8_t[n]);
      cap_ = n;
    }
    return p_.get();
  }

 private:
  std::unique_ptr<uint8_t[]> p_;
  size_t cap_ = 0;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// The inflate's bit buffer takes the stream's bytes a word at a time, the
// first byte in the lowest bits.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "load64 reads little-endian words");

uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

void store64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

// ------------------------------------------------------------ inflate ----
//
// A zlib stream (RFC 1950) of DEFLATE blocks (RFC 1951) inflated into a
// buffer of known size, after the design of libdeflate's
// decompress_template.h: a 64-bit bit buffer refilled a word at a time
// without branches; canonical Huffman codes resolved in one lookup of a
// packed table entry, codes longer than the table's bits through a
// subtable; a fast loop that writes literals and copies matches 8 bytes at
// a time without bounds checks while a margin of input and output remains,
// and a loop that checks every step for the rest. Every malformed stream
// returns false: truncated, a code-length set over-subscribed or
// incomplete, a distance before the start of the output, output longer or
// shorter than the buffer, a wrong Adler-32.

// A table entry, read with the next bits of the stream as its index:
//   bits 0-7    bits to consume: the code's length plus its extra bits
//   bits 8-11   the code's length (the extra bits lie above it)
//   bits 12-15  kind (flags below; none for a length or a distance)
//   bits 16-31  the literal, the length or distance base, the precode
//               symbol, or a subtable link's first entry
// A subtable link consumes the main table's bits; its bits 8-11 say how
// many further bits index the subtable.
constexpr uint32_t kLiteral = 1u << 12;
constexpr uint32_t kSubtable = 1u << 13;
constexpr uint32_t kEndOfBlock = 1u << 14;
constexpr uint32_t kInvalid = 1u << 15;

constexpr int kLitlenBits = 11, kDistBits = 8, kPrecodeBits = 7;
constexpr int kMaxCodeLen = 15;
constexpr int kNumLitlen = 288, kNumDist = 32, kNumPrecode = 19;
// The most entries a code of these sizes needs, main table and subtables
// (zlib's `enough` for 288 symbols at 11 bits and 32 at 8, to 15 bits).
constexpr int kLitlenEnough = 2342, kDistEnough = 402;
// The most output a DEFLATE bit can make: a 258-byte match in two bits.
constexpr size_t kMaxInflateRatio = 1032;

constexpr uint32_t entry_value(uint32_t base, uint32_t extra) {
  return (base << 16) | extra;
}

struct PreEntries {
  uint32_t litlen[kNumLitlen];
  uint32_t dist[kNumDist];
  uint32_t precode[kNumPrecode];
};

// Each symbol's entry before its code length is added.
constexpr PreEntries make_pre_entries() {
  constexpr uint16_t kLenBase[29] = {3,  4,  5,  6,   7,   8,   9,   10,  11, 13,
                                     15, 17, 19, 23,  27,  31,  35,  43,  51, 59,
                                     67, 83, 99, 115, 131, 163, 195, 227, 258};
  constexpr uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                     1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                     4, 4, 4, 4, 5, 5, 5, 5, 0};
  constexpr uint16_t kDistBase[30] = {
      1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
      33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
      1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
  PreEntries p{};
  for (int s = 0; s < 256; ++s) p.litlen[s] = entry_value(s, 0) | kLiteral;
  p.litlen[256] = kEndOfBlock;
  for (int s = 257; s < 286; ++s) {
    p.litlen[s] = entry_value(kLenBase[s - 257], kLenExtra[s - 257]);
  }
  p.litlen[286] = p.litlen[287] = kInvalid;
  for (int s = 0; s < 30; ++s) {
    p.dist[s] = entry_value(kDistBase[s], s < 4 ? 0 : s / 2 - 1);
  }
  p.dist[30] = p.dist[31] = kInvalid;
  for (int s = 0; s < kNumPrecode; ++s) p.precode[s] = entry_value(s, 0);
  return p;
}

constexpr PreEntries kPre = make_pre_entries();

// Fill `table` (2^bits entries, then its subtables, at most `capacity`)
// for the canonical code of lens[0, n). Returns false where the lengths
// form no code: over-subscribed, or incomplete beyond what zlib accepts
// (a litlen or distance code of one 1-bit code, whose unused code then
// decodes as invalid, or of none at all).
bool build_table(const uint8_t* lens, int n, const uint32_t* pre, int bits,
                 bool allow_incomplete, uint32_t* table, int capacity) {
  int count[kMaxCodeLen + 1] = {};
  for (int s = 0; s < n; ++s) ++count[lens[s]];
  count[0] = 0;
  int left = 1, max_len = 0;
  for (int len = 1; len <= kMaxCodeLen; ++len) {
    left = (left << 1) - count[len];
    if (left < 0) return false;
    if (count[len]) max_len = len;
  }
  const int main_size = 1 << bits;
  if (left > 0) {
    if (!allow_incomplete || max_len > 1) return false;
    for (int i = 0; i < main_size; ++i) table[i] = kInvalid | 1;
    if (max_len == 0) return true;
  }
  // Symbols in canonical order: by length, then by value.
  uint16_t offset[kMaxCodeLen + 2] = {};
  for (int len = 1; len <= kMaxCodeLen; ++len) {
    offset[len + 1] = uint16_t(offset[len] + count[len]);
  }
  uint16_t sorted[kNumLitlen];
  for (int s = 0; s < n; ++s) {
    if (lens[s]) sorted[offset[lens[s]]++] = uint16_t(s);
  }
  const int num_codes = offset[kMaxCodeLen];  // after the loop: the total
  uint32_t code = 0;
  int code_len = 0, next_free = main_size, sub_start = 0, sub_bits = 0;
  uint32_t sub_prefix = ~0u;
  for (int k = 0; k < num_codes; ++k) {
    const int s = sorted[k], len = lens[s];
    code <<= len - code_len;
    code_len = len;
    uint32_t rev = 0;  // the code in stream order: DEFLATE sends it MSB first
    for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1u) << (len - 1 - b);
    ++code;
    if (len <= bits) {
      const uint32_t e = pre[s] + (uint32_t(len) << 8) + len;
      for (int i = int(rev); i < main_size; i += 1 << len) table[i] = e;
    } else {
      const uint32_t prefix = rev & uint32_t(main_size - 1);
      if (prefix != sub_prefix) {
        // A new subtable, as wide as the longest code under this prefix
        // needs (zlib's inflate_table): codes still to place share it.
        sub_prefix = prefix;
        sub_bits = len - bits;
        int space = 1 << sub_bits;
        while (sub_bits + bits < max_len) {
          space -= count[sub_bits + bits];
          if (space <= 0) break;
          ++sub_bits;
          space <<= 1;
        }
        sub_start = next_free;
        next_free += 1 << sub_bits;
        if (next_free > capacity) return false;
        table[prefix] = kSubtable | (uint32_t(sub_start) << 16) |
                        (uint32_t(sub_bits) << 8) | uint32_t(bits);
      }
      const int sub_len = len - bits;
      const uint32_t e = pre[s] + (uint32_t(sub_len) << 8) + sub_len;
      for (int i = int(rev >> bits); i < (1 << sub_bits); i += 1 << sub_len) {
        table[sub_start + i] = e;
      }
    }
    --count[len];
  }
  return true;
}

// The stream's bits, least significant first. Bits above `left` in `buf`
// are zero or the stream's next bits, so a refill may OR over them.
struct BitReader {
  uint64_t buf = 0;
  unsigned left = 0;
  const uint8_t* in;
  const uint8_t* end;
  unsigned overread = 0;  // zero bytes fed past the end

  // At least 56 bits, a byte at a time; past the end, zero bytes.
  void Refill() {
    while (left < 56) {
      uint64_t byte = 0;
      if (in < end) {
        byte = *in++;
      } else {
        ++overread;
      }
      buf |= byte << left;
      left += 8;
    }
  }
  uint32_t Take(unsigned n) {
    const uint32_t v = uint32_t(buf & ((uint64_t(1) << n) - 1));
    buf >>= n;
    left -= n;
    return v;
  }
  // Drop to a byte boundary and hand back the whole bytes held; the next
  // unread byte, or null where zero bytes past the end were consumed.
  const uint8_t* Align() {
    Take(left & 7);
    const unsigned held = left >> 3;
    if (overread > held) return nullptr;
    in -= held - overread;
    buf = 0;
    left = 0;
    overread = 0;
    return in;
  }
};

// Copy a match of len bytes from dist back, in 8-byte words: up to 7
// bytes past out + len are written (and later overwritten).
inline uint8_t* copy_match(uint8_t* out, uint32_t dist, uint32_t len) {
  uint8_t* const stop = out + len;
  const uint8_t* src = out - dist;
  if (dist >= 8) {
    do {
      store64(out, load64(src));
      out += 8;
      src += 8;
    } while (out < stop);
  } else if (dist == 1) {
    const uint64_t v = uint64_t(src[0]) * 0x0101010101010101ull;
    do {
      store64(out, v);
      out += 8;
    } while (out < stop);
  } else {
    // Overlapping: each word read holds dist bytes already final.
    do {
      store64(out, load64(src));
      out += dist;
      src += dist;
    } while (out < stop);
  }
  return stop;
}

// The fast loop checks no bounds while this much input and output is left:
// an iteration refills at most three times (a word read each, at most 7
// bytes on) and writes at most two literals and a 258-byte match, whose
// copy runs up to a word past its end.
constexpr size_t kFastInMargin = 32;
constexpr size_t kFastOutMargin = 2 + 258 + 8;

// Inflate one Huffman block from `br` into [*out, out_end) of the output
// that starts at `begin`. Returns false on a malformed block.
bool inflate_block(BitReader& br, const uint32_t* litlen,
                   const uint32_t* dist, uint8_t* begin, uint8_t** out,
                   uint8_t* out_end) {
  constexpr uint64_t kLitlenMask = (1u << kLitlenBits) - 1;
  constexpr uint64_t kDistMask = (1u << kDistBits) - 1;
  uint8_t* o = *out;
  uint64_t buf = br.buf;
  unsigned left = br.left;
  const uint8_t* in = br.in;
  // Branchless: at least 56 bits after it.
  auto refill = [&] {
    buf |= load64(in) << left;
    in += (63 - left) >> 3;
    left |= 56;
  };
  auto consume = [&](uint32_t e) {
    buf >>= e & 0xff;
    left -= e & 0xff;
  };
  // The extra bits of an entry consumed from `saved`, added to its base.
  auto value = [](uint32_t e, uint64_t saved) {
    return (e >> 16) +
           (uint32_t(saved & ((uint64_t(1) << (e & 0xff)) - 1)) >> ((e >> 8) & 15));
  };
  auto subtable = [&](const uint32_t* table, uint32_t e, int bits) {
    buf >>= bits;
    left -= bits;
    return table[(e >> 16) + (buf & ((1u << ((e >> 8) & 15)) - 1))];
  };
  // Fast loop. The next litlen entry is looked up before the refill that
  // follows it (a refill leaves the low bits as they are), so the lookup's
  // latency overlaps the rest of the step. A refill gives 56 bits: enough
  // for three main-table literals (11 bits each) and the next lookup, or
  // for a length and its distance (15 + 5 and 15 + 13 bits).
  if (size_t(br.end - in) > kFastInMargin && size_t(out_end - o) > kFastOutMargin) {
    const uint8_t* const in_stop = br.end - kFastInMargin;
    uint8_t* const out_stop = out_end - kFastOutMargin;
    refill();
    uint32_t e = litlen[buf & kLitlenMask];
    do {
      refill();
      if (e & kLiteral) {
        consume(e);
        *o++ = uint8_t(e >> 16);
        e = litlen[buf & kLitlenMask];
        if (e & kLiteral) {
          consume(e);
          *o++ = uint8_t(e >> 16);
          e = litlen[buf & kLitlenMask];
          if (e & kLiteral) {
            consume(e);
            *o++ = uint8_t(e >> 16);
            e = litlen[buf & kLitlenMask];
            continue;
          }
        }
        refill();
      }
      if (e & kSubtable) e = subtable(litlen, e, kLitlenBits);
      uint64_t saved = buf;
      consume(e);
      if (e & kLiteral) {  // a code longer than the main table's bits
        *o++ = uint8_t(e >> 16);
        e = litlen[buf & kLitlenMask];
        continue;
      }
      if (e & (kEndOfBlock | kInvalid)) {
        if (e & kInvalid) return false;
        br.buf = buf, br.left = left, br.in = in;
        *out = o;
        return true;
      }
      const uint32_t len = value(e, saved);
      e = dist[buf & kDistMask];
      if (e & kSubtable) e = subtable(dist, e, kDistBits);
      saved = buf;
      consume(e);
      const uint32_t d = value(e, saved);
      if ((e & kInvalid) || d > size_t(o - begin)) return false;
      refill();
      e = litlen[buf & kLitlenMask];
      o = copy_match(o, d, len);
    } while (in < in_stop && o < out_stop);
  }
  br.buf = buf, br.left = left, br.in = in;
  // The rest, every step checked.
  for (;;) {
    br.Refill();
    if (br.overread > 8) return false;
    uint32_t e = litlen[br.buf & kLitlenMask];
    if (e & kSubtable) {
      br.Take(kLitlenBits);
      e = litlen[(e >> 16) + (br.buf & ((1u << ((e >> 8) & 15)) - 1))];
    }
    const unsigned code_len = (e >> 8) & 15;
    const uint32_t extra = br.Take(e & 0xff) >> code_len;
    if (e & kLiteral) {
      if (o == out_end) return false;
      *o++ = uint8_t(e >> 16);
      continue;
    }
    if (e & kInvalid) return false;
    if (e & kEndOfBlock) break;
    const uint32_t len = (e >> 16) + extra;
    e = dist[br.buf & kDistMask];
    if (e & kSubtable) {
      br.Take(kDistBits);
      e = dist[(e >> 16) + (br.buf & ((1u << ((e >> 8) & 15)) - 1))];
    }
    const uint32_t d = (e >> 16) + (br.Take(e & 0xff) >> ((e >> 8) & 15));
    if ((e & kInvalid) || d > size_t(o - begin) || len > size_t(out_end - o)) {
      return false;
    }
    for (uint32_t i = 0; i < len; ++i, ++o) *o = o[-ptrdiff_t(d)];
  }
  *out = o;
  return true;
}

// Read a dynamic block's code lengths and build its two tables.
bool read_dynamic_tables(BitReader& br, uint32_t* litlen, uint32_t* dist) {
  static constexpr uint8_t kPrecodeOrder[kNumPrecode] = {
      16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
  br.Refill();
  const int nlit = int(br.Take(5)) + 257;
  const int ndist = int(br.Take(5)) + 1;
  const int nclen = int(br.Take(4)) + 4;
  if (nlit > 286 || ndist > 30) return false;  // zlib's limits
  uint8_t clens[kNumPrecode] = {};
  for (int i = 0; i < nclen; ++i) {
    br.Refill();
    clens[kPrecodeOrder[i]] = uint8_t(br.Take(3));
  }
  uint32_t precode[1 << kPrecodeBits];
  if (!build_table(clens, kNumPrecode, kPre.precode, kPrecodeBits, false,
                   precode, 1 << kPrecodeBits)) {
    return false;
  }
  uint8_t lens[kNumLitlen + kNumDist];
  for (int i = 0; i < nlit + ndist;) {
    br.Refill();
    if (br.overread > 8) return false;
    const uint32_t e = precode[br.buf & ((1u << kPrecodeBits) - 1)];
    br.Take(e & 0xff);
    const unsigned sym = e >> 16;
    if (sym < 16) {
      lens[i++] = uint8_t(sym);
      continue;
    }
    uint8_t value = 0;
    int repeat;
    if (sym == 16) {
      if (i == 0) return false;
      value = lens[i - 1];
      repeat = 3 + int(br.Take(2));
    } else if (sym == 17) {
      repeat = 3 + int(br.Take(3));
    } else {
      repeat = 11 + int(br.Take(7));
    }
    if (repeat > nlit + ndist - i) return false;
    std::memset(lens + i, value, repeat);
    i += repeat;
  }
  if (lens[256] == 0) return false;  // no end of block
  return build_table(lens, nlit, kPre.litlen, kLitlenBits, true, litlen,
                     kLitlenEnough) &&
         build_table(lens + nlit, ndist, kPre.dist, kDistBits, true, dist,
                     kDistEnough);
}

void build_fixed_tables(uint32_t* litlen, uint32_t* dist) {
  uint8_t lens[kNumLitlen];
  std::memset(lens, 8, 144);
  std::memset(lens + 144, 9, 112);
  std::memset(lens + 256, 7, 24);
  std::memset(lens + 280, 8, 8);
  build_table(lens, kNumLitlen, kPre.litlen, kLitlenBits, false, litlen,
              kLitlenEnough);
  std::memset(lens, 5, kNumDist);
  build_table(lens, kNumDist, kPre.dist, kDistBits, false, dist, kDistEnough);
}

// Inflate the zlib stream in[0, in_len) into exactly out_len bytes of out
// and check its Adler-32. Returns true on success.
bool zlib_inflate(const uint8_t* in, size_t in_len, uint8_t* out,
                  size_t out_len) {
  if (in_len < 2) return false;
  const unsigned cmf = in[0], flg = in[1];
  // Deflate, a window of at most 32 KiB, the check bits, no dictionary.
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256 + flg) % 31 != 0 ||
      (flg & 0x20)) {
    return false;
  }
  BitReader br;
  br.in = in + 2;
  br.end = in + in_len;
  uint8_t* o = out;
  uint8_t* const out_end = out + out_len;
  uint32_t litlen[kLitlenEnough], dist[kDistEnough];
  for (bool final = false; !final;) {
    br.Refill();
    if (br.overread > 8) return false;
    final = br.Take(1) != 0;
    const uint32_t type = br.Take(2);
    if (type == 0) {  // stored
      const uint8_t* p = br.Align();
      if (!p || br.end - p < 4) return false;
      const size_t len = size_t(p[0]) | (size_t(p[1]) << 8);
      const size_t nlen = size_t(p[2]) | (size_t(p[3]) << 8);
      if (nlen != (~len & 0xffff)) return false;
      p += 4;
      if (len > size_t(br.end - p) || len > size_t(out_end - o)) return false;
      std::memcpy(o, p, len);
      o += len;
      br.in = p + len;
      continue;
    }
    if (type == 1) {
      build_fixed_tables(litlen, dist);
    } else if (type != 2 || !read_dynamic_tables(br, litlen, dist)) {
      return false;
    }
    if (!inflate_block(br, litlen, dist, out, &o, out_end)) return false;
  }
  const uint8_t* p = br.Align();
  if (o != out_end || !p || br.end - p < 4) return false;
  uLong adler = adler32(0L, Z_NULL, 0);
  for (size_t done = 0; done < out_len;) {
    const size_t n = std::min<size_t>(out_len - done, 1u << 30);
    adler = adler32(adler, out + done, uInt(n));
    done += n;
  }
  return adler == be32(p);
}

// ----------------------------------------------------------- unfilter ----
//
// One row at a time: the filter byte picks a loop that has no branch in
// it. Sub, Avg and Paeth carry a pixel to the next, so they go byte by byte
// with bpp a constant of the loop; Up is a vectorisable add and None a
// copy. The first row's "up" is a row of zeros.

void unfilter_up(const uint8_t* src, const uint8_t* up, uint8_t* dst,
                 size_t n) {
  for (size_t i = 0; i < n; ++i) dst[i] = uint8_t(src[i] + up[i]);
}

template <int kBpp>
void unfilter_sub(const uint8_t* src, uint8_t* dst, size_t n) {
  for (size_t i = 0; i < kBpp; ++i) dst[i] = src[i];
  for (size_t i = kBpp; i < n; ++i) dst[i] = uint8_t(src[i] + dst[i - kBpp]);
}

template <int kBpp>
void unfilter_avg(const uint8_t* src, const uint8_t* up, uint8_t* dst,
                  size_t n) {
  for (size_t i = 0; i < kBpp; ++i) dst[i] = uint8_t(src[i] + (up[i] >> 1));
  for (size_t i = kBpp; i < n; ++i) {
    dst[i] = uint8_t(src[i] + ((dst[i - kBpp] + up[i]) >> 1));
  }
}

template <int kBpp>
void unfilter_paeth(const uint8_t* src, const uint8_t* up, uint8_t* dst,
                    size_t n) {
  for (size_t i = 0; i < kBpp; ++i) dst[i] = uint8_t(src[i] + up[i]);
  for (size_t i = kBpp; i < n; ++i) {
    const int a = dst[i - kBpp], b = up[i], c = up[i - kBpp];
    const int pa = std::abs(b - c), pb = std::abs(a - c),
              pc = std::abs(a + b - 2 * c);
    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
    dst[i] = uint8_t(src[i] + pred);
  }
}

template <int kBpp>
bool unfilter_rows(const uint8_t* raw, const uint8_t* zero_row, uint8_t* out,
                   size_t stride, int h) {
  const uint8_t* up = zero_row;
  for (int y = 0; y < h; ++y, raw += stride + 1, out += stride) {
    const uint8_t* src = raw + 1;
    switch (raw[0]) {
      case 0: std::memcpy(out, src, stride); break;
      case 1: unfilter_sub<kBpp>(src, out, stride); break;
      case 2: unfilter_up(src, up, out, stride); break;
      case 3: unfilter_avg<kBpp>(src, up, out, stride); break;
      case 4: unfilter_paeth<kBpp>(src, up, out, stride); break;
      default: return false;
    }
    up = out;
  }
  return true;
}

// Decodes 8-bit non-interlaced gray/RGB/RGBA PNGs, keeping its buffers
// (the file with its IDAT payloads gathered, the inflated rows, the
// pixels) from one image to the next.
class PngDecoder {
 public:
  // Decode the file at `path` into *out. Returns 0 on success, else (the C
  // ABI's codes): 1 no file, 2 too short, 3 short read, 4 no signature,
  // 5 a chunk past the end, 6 not 8-bit or interlaced, 7 another colour
  // type, 8 no IHDR or IDAT, 9 a malformed zlib stream, 10 a row filter
  // past 4.
  int Decode(const char* path, Image* out) {
    inflate_ns_ = 0;
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    std::fseek(f, 0, SEEK_END);
    const long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size < 45) {
      std::fclose(f);
      return 2;
    }
    uint8_t* const buf = file_.Reserve(size_t(size));
    const size_t got = std::fread(buf, 1, size_t(size), f);
    std::fclose(f);
    if (got != size_t(size)) return 3;

    static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (std::memcmp(buf, kSig, 8) != 0) return 4;

    int w = 0, h = 0, channels = 0;
    // The IDAT payloads, gathered in place behind the first one: a later
    // payload moves down over chunks already read, never past its own.
    uint8_t* idat = nullptr;
    size_t idat_len = 0;
    size_t pos = 8;
    while (pos + 8 <= size_t(size)) {
      const uint32_t len = be32(buf + pos);
      if (pos + 12 + size_t(len) > size_t(size)) return 5;
      const uint8_t* type = buf + pos + 4;
      uint8_t* data = buf + pos + 8;
      if (std::memcmp(type, "IHDR", 4) == 0) {
        if (len < 13) return 5;
        w = int(be32(data));
        h = int(be32(data + 4));
        const int bit_depth = data[8], color_type = data[9],
                  interlace = data[12];
        if (bit_depth != 8 || interlace != 0) return 6;  // unsupported
        switch (color_type) {
          case 0: channels = 1; break;
          case 2: channels = 3; break;
          case 6: channels = 4; break;
          default: return 7;  // palette/gray+alpha unsupported
        }
      } else if (std::memcmp(type, "IDAT", 4) == 0) {
        if (!idat) idat = data;
        std::memmove(idat + idat_len, data, len);
        idat_len += len;
      } else if (std::memcmp(type, "IEND", 4) == 0) {
        break;
      }
      pos += 12 + size_t(len);
    }
    if (w <= 0 || h <= 0 || channels == 0 || idat_len == 0) return 8;

    const size_t stride = size_t(w) * channels;
    // Rows the stream could not make are a malformed header, refused before
    // a buffer is sized for them.
    const size_t max_raw = kMaxInflateRatio * idat_len + 1024;
    if (stride + 1 > max_raw || size_t(h) > max_raw / (stride + 1)) return 9;
    const size_t raw_len = (stride + 1) * h;
    uint8_t* const raw = raw_.Reserve(raw_len);
    const int64_t t0 = wall_ns();
    const bool inflated = zlib_inflate(idat, idat_len, raw, raw_len);
    inflate_ns_ = wall_ns() - t0;
    if (!inflated) return 9;

    uint8_t* const zero_row = zero_row_.Reserve(stride);
    std::memset(zero_row, 0, stride);
    uint8_t* const pixels = pixels_.Reserve(stride * h);
    bool ok = false;
    switch (channels) {
      case 1: ok = unfilter_rows<1>(raw, zero_row, pixels, stride, h); break;
      case 3: ok = unfilter_rows<3>(raw, zero_row, pixels, stride, h); break;
      case 4: ok = unfilter_rows<4>(raw, zero_row, pixels, stride, h); break;
    }
    if (!ok) return 10;
    out->w = w;
    out->h = h;
    out->c = channels;
    out->data = pixels;
    return 0;
  }

  // Wall time of the last Decode's inflate.
  int64_t inflate_ns() const { return inflate_ns_; }

 private:
  Buffer file_, raw_, pixels_, zero_row_;
  int64_t inflate_ns_ = 0;
};

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

// CPU time of the calling thread: under a span of wall time, less than
// the span where the thread waited for a core.
int64_t thread_cpu_ns() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// The ring's counters, in dvf_loader_stats' order: batches served, the
// consumer's wall time blocked in Next(), images decoded, the workers'
// wall time in PngDecoder::Decode and in resize_to, their thread CPU time
// over the same decode + resize intervals, and their wall time in the
// decode's inflate.
enum Stat {
  kBatches,
  kConsumerWaitNs,
  kImages,
  kDecodeNs,
  kResizeNs,
  kWorkCpuNs,
  kInflateNs,
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
    PngDecoder decoder;
    Image img;
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
        // The CPU clock's reads lie inside the wall clock's, so the CPU
        // time never exceeds the wall time it is compared with.
        const int64_t w0 = wall_ns();
        const int64_t c0 = thread_cpu_ns();
        const int rc = decoder.Decode(paths_[idx[i]].c_str(), &img);
        ++stats_[kImages];
        stats_[kInflateNs] += decoder.inflate_ns();
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
  PngDecoder decoder;
  Image img;
  const int rc = decoder.Decode(path, &img);
  if (rc != 0) return rc;
  *w = img.w;
  *h = img.h;
  *c = img.c;
  const int64_t need = int64_t(img.w) * img.h * img.c;
  if (out) {
    if (out_capacity < need) return -2;
    std::memcpy(out, img.data, need);
  }
  return 0;
}

int dvf_load_resized(const char* path, int out_h, int out_w, float* out) {
  PngDecoder decoder;
  Image img;
  const int rc = decoder.Decode(path, &img);
  if (rc != 0) return rc;
  resize_normalize(img, out_h, out_w, out);
  return 0;
}

int dvf_load_resized_u8(const char* path, int out_h, int out_w,
                        uint8_t* out) {
  PngDecoder decoder;
  Image img;
  const int rc = decoder.Decode(path, &img);
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
