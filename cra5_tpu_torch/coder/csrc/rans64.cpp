// 64-bit rANS entropy coder — host-side native implementation.
//
// A copy of the JAX package's host coder (cra5_tpu/coder/csrc/rans64.cpp),
// kept here so the port compiles nothing of that package. Bitstream-
// compatible with the CRA5/CompressAI coder (cpp_exts/rans/
// rans_interface.cpp, the published CRA5 archives' "v1"): precision 16,
// 4-bit bypass escapes for out-of-range symbols, LIFO buffered encode with
// the 64-bit final state flushed to the stream head, uint32 words. The rANS
// state machine follows the public ryg_rans rans64 construction.
//
// Interface: plain C ABI over flat int32 buffers (called via ctypes from
// cra5_tpu_torch.coder.native). Unlike CompressAI, no per-symbol Python list
// marshalling and the decoder resolves symbols with binary search rather
// than a linear CDF scan.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecision = 16;
constexpr uint32_t kBypassPrecision = 4;
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;
constexpr uint64_t kRansL = 1ull << 31;

struct Sym {
  uint16_t start;
  uint16_t range;  // freq for cdf symbols, value+1 for bypass raw bits
  bool bypass;
};

inline void enc_put(uint64_t &x, std::vector<uint32_t> &emitted, uint32_t start,
                    uint32_t freq) {
  uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    emitted.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = ((x / freq) << kPrecision) + (x % freq) + start;
}

inline void enc_put_bits(uint64_t &x, std::vector<uint32_t> &emitted,
                         uint32_t val, uint32_t nbits) {
  uint32_t freq = 1u << (kPrecision - nbits);
  uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    emitted.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = (x << nbits) | val;
}

struct DecState {
  uint64_t x;
  const uint32_t *ptr;
  const uint32_t *end;
};

inline uint32_t dec_get_bits(DecState &s, uint32_t nbits) {
  uint32_t val = static_cast<uint32_t>(s.x & ((1u << nbits) - 1));
  s.x >>= nbits;
  if (s.x < kRansL && s.ptr < s.end) {
    s.x = (s.x << 32) | *s.ptr++;
  }
  return val;
}

inline bool cdfs_valid(const int32_t *cdfs, const int32_t *cdf_sizes,
                       size_t ncdfs, size_t cdf_stride) {
  // Mirrors CompressAI's debug-build assert_cdfs
  // (cpp_exts/rans/rans_interface.cpp:56-66): each row starts at 0, ends
  // at 2^precision, and is strictly monotone over its declared length.
  for (size_t k = 0; k < ncdfs; ++k) {
    const int32_t size = cdf_sizes[k];
    if (size < 2 || static_cast<size_t>(size) > cdf_stride) return false;
    const int32_t *cdf = cdfs + k * cdf_stride;
    if (cdf[0] != 0) return false;
    if (cdf[size - 1] != (1 << kPrecision)) return false;
    for (int32_t i = 0; i + 1 < size; ++i) {
      if (cdf[i + 1] <= cdf[i]) return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Standalone table validation for callers that want to check once and
// then skip the per-call validation (e.g. the streaming AR decoder).
// Returns 0 if every row is a well-formed quantized CDF, -2 otherwise.
int rans_validate_cdfs(const int32_t *cdfs, const int32_t *cdf_sizes,
                       size_t ncdfs, size_t cdf_stride) {
  return cdfs_valid(cdfs, cdf_sizes, ncdfs, cdf_stride) ? 0 : -2;
}

// Encode n symbols. cdfs: row-major (ncdfs x cdf_stride) int32. Returns the
// number of bytes written into out (always a multiple of 4), or -1 if the
// out buffer was too small. Worst case output is bounded by the caller via
// out_cap; a safe bound is 4 * (n * 5 + 2) bytes (each symbol can emit one
// word plus up to ~3 bypass words for 32-bit raws, plus final state).
long long rans_encode_with_indexes(
    const int32_t *symbols, const int32_t *indexes, size_t n,
    const int32_t *cdfs, const int32_t *cdf_sizes, const int32_t *offsets,
    size_t ncdfs, size_t cdf_stride, uint8_t *out, size_t out_cap) {
  if (!cdfs_valid(cdfs, cdf_sizes, ncdfs, cdf_stride)) return -2;
  std::vector<Sym> syms;
  syms.reserve(n + n / 8);

  for (size_t i = 0; i < n; ++i) {
    const int32_t k = indexes[i];
    if (k < 0 || static_cast<size_t>(k) >= ncdfs) return -3;
    const int32_t *cdf = cdfs + static_cast<size_t>(k) * cdf_stride;
    const int32_t max_value = cdf_sizes[k] - 2;

    int32_t value = symbols[i] - offsets[k];
    uint32_t raw_val = 0;
    if (value < 0) {
      raw_val = static_cast<uint32_t>(-2 * value - 1);
      value = max_value;
    } else if (value >= max_value) {
      raw_val = static_cast<uint32_t>(2 * (value - max_value));
      value = max_value;
    }

    syms.push_back({static_cast<uint16_t>(cdf[value]),
                    static_cast<uint16_t>(cdf[value + 1] - cdf[value]),
                    false});

    if (value == max_value) {
      // NB: the shift must be 64-bit. CompressAI's uint32 loop
      // (rans_interface.cpp:146-150) hits shift-by-32 UB and hangs for
      // raw_val >= 2^28 (|symbol| >~ 2^27); this version terminates with
      // n_bypass = 8 there and stays bit-identical below that.
      int32_t n_bypass = 0;
      while ((static_cast<uint64_t>(raw_val) >> (n_bypass * kBypassPrecision)) != 0)
        ++n_bypass;
      int32_t val = n_bypass;
      while (val >= static_cast<int32_t>(kMaxBypassVal)) {
        syms.push_back({static_cast<uint16_t>(kMaxBypassVal),
                        static_cast<uint16_t>(kMaxBypassVal + 1), true});
        val -= kMaxBypassVal;
      }
      syms.push_back({static_cast<uint16_t>(val),
                      static_cast<uint16_t>(val + 1), true});
      for (int32_t j = 0; j < n_bypass; ++j) {
        uint32_t chunk = (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal;
        syms.push_back({static_cast<uint16_t>(chunk),
                        static_cast<uint16_t>(chunk + 1), true});
      }
    }
  }

  // LIFO flush.
  uint64_t x = kRansL;
  std::vector<uint32_t> emitted;
  emitted.reserve(syms.size() / 2 + 2);
  for (size_t i = syms.size(); i-- > 0;) {
    const Sym &s = syms[i];
    if (!s.bypass) {
      enc_put(x, emitted, s.start, s.range);
    } else {
      enc_put_bits(x, emitted, s.start, kBypassPrecision);
    }
  }

  const size_t n_words = emitted.size() + 2;
  const size_t nbytes = n_words * sizeof(uint32_t);
  if (nbytes > out_cap) return -1;

  uint32_t *w = reinterpret_cast<uint32_t *>(out);
  w[0] = static_cast<uint32_t>(x);
  w[1] = static_cast<uint32_t>(x >> 32);
  // stream order is the reverse of emission order
  for (size_t i = 0; i < emitted.size(); ++i) {
    w[2 + i] = emitted[emitted.size() - 1 - i];
  }
  return static_cast<long long>(nbytes);
}

// Decode n symbols from the byte stream. Returns 0 on success, -1 on a
// malformed stream (underrun).
int rans_decode_with_indexes(
    const uint8_t *data, size_t nbytes, const int32_t *indexes, size_t n,
    const int32_t *cdfs, const int32_t *cdf_sizes, const int32_t *offsets,
    size_t ncdfs, size_t cdf_stride, int32_t *out) {
  if (!cdfs_valid(cdfs, cdf_sizes, ncdfs, cdf_stride)) return -2;
  if (nbytes < 8 || (nbytes % 4) != 0) return -1;
  DecState s;
  const uint32_t *words = reinterpret_cast<const uint32_t *>(data);
  s.x = static_cast<uint64_t>(words[0]) | (static_cast<uint64_t>(words[1]) << 32);
  s.ptr = words + 2;
  s.end = words + nbytes / 4;

  constexpr uint32_t mask = (1u << kPrecision) - 1;

  for (size_t i = 0; i < n; ++i) {
    const int32_t k = indexes[i];
    if (k < 0 || static_cast<size_t>(k) >= ncdfs) return -3;
    const int32_t *cdf = cdfs + static_cast<size_t>(k) * cdf_stride;
    const int32_t size = cdf_sizes[k];
    const int32_t max_value = size - 2;

    const uint32_t cum = static_cast<uint32_t>(s.x & mask);

    // binary search: last bin with cdf[bin] <= cum
    int32_t lo = 0, hi = size - 1;
    while (hi - lo > 1) {
      const int32_t mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(cdf[mid]) <= cum) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const int32_t sidx = lo;
    const uint32_t start = static_cast<uint32_t>(cdf[sidx]);
    const uint32_t freq = static_cast<uint32_t>(cdf[sidx + 1]) - start;

    s.x = freq * (s.x >> kPrecision) + (s.x & mask) - start;
    if (s.x < kRansL) {
      if (s.ptr >= s.end) return -1;
      s.x = (s.x << 32) | *s.ptr++;
    }

    int32_t value = sidx;
    if (value == max_value) {
      uint32_t val = dec_get_bits(s, kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec_get_bits(s, kBypassPrecision);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        raw_val |= dec_get_bits(s, kBypassPrecision) << (j * kBypassPrecision);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1u) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }

    out[i] = value + offsets[k];
  }
  return 0;
}

// Streaming decoder for autoregressive models (parity with CompressAI's
// RansDecoder::set_stream/decode_stream). The caller owns an opaque state.
struct RansStream {
  DecState s;
  std::vector<uint8_t> buf;
};

void *rans_stream_new(const uint8_t *data, size_t nbytes) {
  if (nbytes < 8 || (nbytes % 4) != 0) return nullptr;
  RansStream *st = new RansStream();
  st->buf.assign(data, data + nbytes);
  const uint32_t *words = reinterpret_cast<const uint32_t *>(st->buf.data());
  st->s.x = static_cast<uint64_t>(words[0]) |
            (static_cast<uint64_t>(words[1]) << 32);
  st->s.ptr = words + 2;
  st->s.end = words + nbytes / 4;
  return st;
}

int rans_stream_decode(void *handle, const int32_t *indexes, size_t n,
                       const int32_t *cdfs, const int32_t *cdf_sizes,
                       const int32_t *offsets, size_t ncdfs, size_t cdf_stride,
                       int32_t *out) {
  // per-call table validation is skipped here (the AR loop calls this per
  // pixel with the same table — use rans_validate_cdfs once instead);
  // index bounds are still enforced per symbol.
  RansStream *st = reinterpret_cast<RansStream *>(handle);
  if (!st) return -1;
  DecState &s = st->s;
  constexpr uint32_t mask = (1u << kPrecision) - 1;
  for (size_t i = 0; i < n; ++i) {
    const int32_t k = indexes[i];
    if (k < 0 || static_cast<size_t>(k) >= ncdfs) return -3;
    const int32_t *cdf = cdfs + static_cast<size_t>(k) * cdf_stride;
    const int32_t size = cdf_sizes[k];
    if (size < 2 || static_cast<size_t>(size) > cdf_stride) return -2;
    const int32_t max_value = size - 2;
    const uint32_t cum = static_cast<uint32_t>(s.x & mask);
    int32_t lo = 0, hi = size - 1;
    while (hi - lo > 1) {
      const int32_t mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(cdf[mid]) <= cum) lo = mid; else hi = mid;
    }
    const uint32_t start = static_cast<uint32_t>(cdf[lo]);
    const uint32_t freq = static_cast<uint32_t>(cdf[lo + 1]) - start;
    s.x = freq * (s.x >> kPrecision) + (s.x & mask) - start;
    if (s.x < kRansL && s.ptr < s.end) s.x = (s.x << 32) | *s.ptr++;
    int32_t value = lo;
    if (value == max_value) {
      uint32_t val = dec_get_bits(s, kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec_get_bits(s, kBypassPrecision);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j)
        raw_val |= dec_get_bits(s, kBypassPrecision) << (j * kBypassPrecision);
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1u) value = -value - 1; else value += max_value;
    }
    out[i] = value + offsets[k];
  }
  return 0;
}

void rans_stream_free(void *handle) {
  delete reinterpret_cast<RansStream *>(handle);
}

// Integer CDF construction (see cra5_tpu_torch/entropy/cdf.py for the
// authoritative spec; CompressAI's cpp_exts/ops/ops.cpp for provenance).
// Returns 0 on success, -1 on invalid pmf.
int pmf_to_quantized_cdf_c(const float *pmf, size_t n, int precision,
                           int32_t *cdf_out /* length n+1 */) {
  for (size_t i = 0; i < n; ++i) {
    if (!(pmf[i] >= 0.0f) || pmf[i] != pmf[i]) return -1;
  }
  std::vector<uint64_t> freq(n);
  uint64_t total = 0;
  const float scale = static_cast<float>(1 << precision);
  for (size_t i = 0; i < n; ++i) {
    const float v = pmf[i] * scale;
    const float fl = static_cast<float>(static_cast<int64_t>(v));
    freq[i] = static_cast<uint64_t>(fl) + ((v - fl >= 0.5f) ? 1 : 0);
    total += freq[i];
  }
  if (total == 0) return -1;

  const uint64_t one = 1ull << precision;
  std::vector<int64_t> f(n);
  for (size_t i = 0; i < n; ++i) f[i] = static_cast<int64_t>((one * freq[i]) / total);
  // pin the sum to 2**precision by adjusting via the cdf representation
  std::vector<int64_t> cdf(n + 1, 0);
  for (size_t i = 0; i < n; ++i) cdf[i + 1] = cdf[i] + f[i];
  cdf[n] = static_cast<int64_t>(one);
  for (size_t i = 0; i < n; ++i) f[i] = cdf[i + 1] - cdf[i];

  for (size_t i = 0; i < n; ++i) {
    if (f[i] == 0) {
      int64_t best = INT64_MAX;
      size_t bj = n;
      for (size_t j = 0; j < n; ++j) {
        if (f[j] > 1 && f[j] < best) {
          best = f[j];
          bj = j;
        }
      }
      if (bj == n) return -1;
      f[bj] -= 1;
      f[i] += 1;
    }
  }
  cdf_out[0] = 0;
  for (size_t i = 0; i < n; ++i) cdf_out[i + 1] = cdf_out[i] + static_cast<int32_t>(f[i]);
  return 0;
}

// Zigzag-LEB128 varints for the v2 escape side channel (byte-identical to
// the numpy implementation in coder/lane_coder.py, which remains the oracle).
// The vectorized numpy path still costs ~95 ms per 700k escapes and holds
// the GIL; this loop is ~2 ms and runs GIL-free under ctypes.
long long zz_varint_encode(const int32_t *vals, size_t n, uint8_t *out,
                           size_t cap) {
  size_t pos = 0;
  for (size_t i = 0; i < n; ++i) {
    int64_t v = vals[i];
    uint64_t u = v >= 0 ? (static_cast<uint64_t>(v) << 1)
                        : ((static_cast<uint64_t>(-(v + 1)) << 1) | 1u);
    do {
      if (pos >= cap) return -1;
      uint8_t b = static_cast<uint8_t>(u & 0x7f);
      u >>= 7;
      out[pos++] = b | (u ? 0x80 : 0);
    } while (u);
  }
  return static_cast<long long>(pos);
}

// Returns bytes consumed, or -1 on a truncated stream.
long long zz_varint_decode(const uint8_t *data, size_t len, size_t n,
                           int32_t *out) {
  size_t pos = 0;
  for (size_t i = 0; i < n; ++i) {
    uint64_t u = 0;
    int shift = 0;
    uint8_t b;
    do {
      if (pos >= len || shift > 63) return -1;
      b = data[pos++];
      u |= static_cast<uint64_t>(b & 0x7f) << shift;
      shift += 7;
    } while (b & 0x80);
    out[i] = (u & 1) ? static_cast<int32_t>(-static_cast<int64_t>(u >> 1) - 1)
                     : static_cast<int32_t>(u >> 1);
  }
  return static_cast<long long>(pos);
}

}  // extern "C"
