// Standalone C++17 tensor codec — runs trained-model bitstreams without
// Python/JAX (the reference's SADL-codec capability,
// /root/reference/sadl_codec/: encoder_generic.h:141-349,
// decoder_generic.h:121-213, rdoq.h, range_coder.{h,cpp}).
//
// Artifact formats (all little-endian):
//   tables file ("CRT1"): int32 ncdfs, stride; then ncdfs*stride int32
//     quantized_cdf, ncdfs int32 cdf_length, ncdfs int32 offset.
//   tensor file ("CRX1"): int32 ndim, dims...; then payload — int32 for
//     symbol tensors, float32 for latent tensors (flag in header).
//   bitstream ("CRB1"): int32 ndim, dims...; uint32 nbytes; rANS payload.
//
// Channel-major CDF indexing (symbol [c, h, w] uses cdf row c), matching
// EntropyBottleneck._build_indexes (reference entropy_models.py:512).
//
// Modes:
//   encode <tables> <tensor-in> <bitstream-out>
//   decode <tables> <bitstream-in> <tensor-out>
//   rdoq   <tables> <float-tensor-in> <lambda> <tensor-out>   (RDO quantize)
//
// RDOQ: per-value candidate search (floor/round/ceil) minimizing
// lambda * (x - q)^2 + bits(q), multithreaded over channels (reference
// rdoq.h multi-pass search, simplified to the per-sample independent case
// valid for factorized/per-channel priors).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecision = 16;
constexpr uint32_t kBypassPrecision = 4;
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;
constexpr uint64_t kRansL = 1ull << 31;

struct Tables {
  int32_t ncdfs = 0;
  int32_t stride = 0;
  std::vector<int32_t> cdf;      // ncdfs * stride
  std::vector<int32_t> length;   // ncdfs
  std::vector<int32_t> offset;   // ncdfs
};

struct Tensor {
  std::vector<int32_t> dims;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  bool is_float = false;
  size_t size() const {
    size_t n = 1;
    for (int32_t d : dims) n *= static_cast<size_t>(d);
    return n;
  }
};

bool read_exact(FILE *f, void *p, size_t n) { return fread(p, 1, n, f) == n; }

// Untrusted dims from an artifact header: reject non-positive entries and
// products that would drive a multi-GB resize() before read_exact can fail.
bool dims_valid(const std::vector<int32_t> &dims) {
  uint64_t n = 1;
  for (int32_t d : dims) {
    if (d <= 0 || d > (1 << 24)) return false;
    n *= static_cast<uint64_t>(d);
    if (n > (1ull << 31)) return false;
  }
  return true;
}

bool load_tables(const char *path, Tables &t) {
  FILE *f = fopen(path, "rb");
  if (!f) return false;
  char magic[4];
  if (!read_exact(f, magic, 4) || memcmp(magic, "CRT1", 4) != 0) { fclose(f); return false; }
  if (!read_exact(f, &t.ncdfs, 4) || !read_exact(f, &t.stride, 4)) { fclose(f); return false; }
  t.cdf.resize(static_cast<size_t>(t.ncdfs) * t.stride);
  t.length.resize(t.ncdfs);
  t.offset.resize(t.ncdfs);
  bool ok = read_exact(f, t.cdf.data(), t.cdf.size() * 4) &&
            read_exact(f, t.length.data(), t.length.size() * 4) &&
            read_exact(f, t.offset.data(), t.offset.size() * 4);
  fclose(f);
  return ok;
}

bool load_tensor(const char *path, Tensor &t) {
  FILE *f = fopen(path, "rb");
  if (!f) return false;
  char magic[4];
  if (!read_exact(f, magic, 4)) { fclose(f); return false; }
  bool is_float;
  if (memcmp(magic, "CRXf", 4) == 0) is_float = true;
  else if (memcmp(magic, "CRX1", 4) == 0) is_float = false;
  else { fclose(f); return false; }
  int32_t ndim;
  if (!read_exact(f, &ndim, 4) || ndim <= 0 || ndim > 8) { fclose(f); return false; }
  t.dims.resize(ndim);
  if (!read_exact(f, t.dims.data(), 4u * ndim) || !dims_valid(t.dims)) { fclose(f); return false; }
  t.is_float = is_float;
  bool ok;
  if (is_float) {
    t.fdata.resize(t.size());
    ok = read_exact(f, t.fdata.data(), t.fdata.size() * 4);
  } else {
    t.idata.resize(t.size());
    ok = read_exact(f, t.idata.data(), t.idata.size() * 4);
  }
  fclose(f);
  return ok;
}

bool save_tensor(const char *path, const Tensor &t) {
  FILE *f = fopen(path, "wb");
  if (!f) return false;
  fwrite(t.is_float ? "CRXf" : "CRX1", 1, 4, f);
  int32_t ndim = static_cast<int32_t>(t.dims.size());
  fwrite(&ndim, 4, 1, f);
  fwrite(t.dims.data(), 4, t.dims.size(), f);
  if (t.is_float) fwrite(t.fdata.data(), 4, t.fdata.size(), f);
  else fwrite(t.idata.data(), 4, t.idata.size(), f);
  fclose(f);
  return true;
}

// channel index per element for a (C, ...) or (B, C, ...) tensor: dim 0 is
// channels for ndim <= 3, dim 1 for ndim == 4.
int channel_axis(const Tensor &t) { return t.dims.size() == 4 ? 1 : 0; }

void channel_indexes(const Tensor &t, std::vector<int32_t> &idx) {
  const int ax = channel_axis(t);
  const size_t n = t.size();
  size_t inner = 1;
  for (size_t d = ax + 1; d < t.dims.size(); ++d) inner *= t.dims[d];
  const int32_t C = t.dims[ax];
  idx.resize(n);
  for (size_t i = 0; i < n; ++i) idx[i] = static_cast<int32_t>((i / inner) % C);
}

// ---- rANS core (same construction as coder/csrc/rans64.cpp) ----

struct Sym { uint16_t start; uint16_t range; bool bypass; };

void enc_put(uint64_t &x, std::vector<uint32_t> &em, uint32_t start, uint32_t freq) {
  uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) { em.push_back(static_cast<uint32_t>(x)); x >>= 32; }
  x = ((x / freq) << kPrecision) + (x % freq) + start;
}

void enc_put_bits(uint64_t &x, std::vector<uint32_t> &em, uint32_t val, uint32_t nbits) {
  uint32_t freq = 1u << (kPrecision - nbits);
  uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) { em.push_back(static_cast<uint32_t>(x)); x >>= 32; }
  x = (x << nbits) | val;
}

std::vector<uint32_t> encode_stream(const Tables &tb, const int32_t *symbols,
                                    const int32_t *indexes, size_t n) {
  std::vector<Sym> syms;
  syms.reserve(n + n / 8);
  for (size_t i = 0; i < n; ++i) {
    const int32_t k = indexes[i];
    const int32_t *cdf = tb.cdf.data() + static_cast<size_t>(k) * tb.stride;
    const int32_t max_value = tb.length[k] - 2;
    int32_t value = symbols[i] - tb.offset[k];
    uint32_t raw_val = 0;
    if (value < 0) { raw_val = static_cast<uint32_t>(-2 * value - 1); value = max_value; }
    else if (value >= max_value) { raw_val = static_cast<uint32_t>(2 * (value - max_value)); value = max_value; }
    syms.push_back({static_cast<uint16_t>(cdf[value]),
                    static_cast<uint16_t>(cdf[value + 1] - cdf[value]), false});
    if (value == max_value) {
      // 64-bit shift: a uint32 loop hits shift-by-32 UB for raw_val >= 2^28
      // (see coder/csrc/rans64.cpp)
      int32_t nb = 0;
      while ((static_cast<uint64_t>(raw_val) >> (nb * kBypassPrecision)) != 0) ++nb;
      int32_t val = nb;
      while (val >= static_cast<int32_t>(kMaxBypassVal)) {
        syms.push_back({static_cast<uint16_t>(kMaxBypassVal), 0, true});
        val -= kMaxBypassVal;
      }
      syms.push_back({static_cast<uint16_t>(val), 0, true});
      for (int32_t j = 0; j < nb; ++j) {
        uint32_t chunk = (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal;
        syms.push_back({static_cast<uint16_t>(chunk), 0, true});
      }
    }
  }
  uint64_t x = kRansL;
  std::vector<uint32_t> em;
  for (size_t i = syms.size(); i-- > 0;) {
    if (!syms[i].bypass) enc_put(x, em, syms[i].start, syms[i].range);
    else enc_put_bits(x, em, syms[i].start, kBypassPrecision);
  }
  std::vector<uint32_t> out(em.size() + 2);
  out[0] = static_cast<uint32_t>(x);
  out[1] = static_cast<uint32_t>(x >> 32);
  for (size_t i = 0; i < em.size(); ++i) out[2 + i] = em[em.size() - 1 - i];
  return out;
}

struct DecState { uint64_t x; const uint32_t *ptr; const uint32_t *end; };

uint32_t dec_get_bits(DecState &s, uint32_t nbits) {
  uint32_t val = static_cast<uint32_t>(s.x & ((1u << nbits) - 1));
  s.x >>= nbits;
  if (s.x < kRansL && s.ptr < s.end) s.x = (s.x << 32) | *s.ptr++;
  return val;
}

bool decode_stream(const Tables &tb, const uint32_t *words, size_t nwords,
                   const int32_t *indexes, size_t n, int32_t *out) {
  if (nwords < 2) return false;
  DecState s{(static_cast<uint64_t>(words[0]) | (static_cast<uint64_t>(words[1]) << 32)),
             words + 2, words + nwords};
  constexpr uint32_t mask = (1u << kPrecision) - 1;
  for (size_t i = 0; i < n; ++i) {
    const int32_t k = indexes[i];
    const int32_t *cdf = tb.cdf.data() + static_cast<size_t>(k) * tb.stride;
    const int32_t size = tb.length[k];
    const int32_t max_value = size - 2;
    const uint32_t cum = static_cast<uint32_t>(s.x & mask);
    int32_t lo = 0, hi = size - 1;
    while (hi - lo > 1) {
      const int32_t mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(cdf[mid]) <= cum) lo = mid; else hi = mid;
    }
    const uint32_t start = static_cast<uint32_t>(cdf[lo]);
    const uint32_t freq = static_cast<uint32_t>(cdf[lo + 1]) - start;
    s.x = freq * (s.x >> kPrecision) + cum - start;
    if (s.x < kRansL && s.ptr < s.end) s.x = (s.x << 32) | *s.ptr++;
    int32_t value = lo;
    if (value == max_value) {
      uint32_t val = dec_get_bits(s, kBypassPrecision);
      uint32_t nb = val;
      while (val == kMaxBypassVal) { val = dec_get_bits(s, kBypassPrecision); nb += val; }
      uint32_t raw = 0;
      for (uint32_t j = 0; j < nb; ++j)
        raw |= dec_get_bits(s, kBypassPrecision) << (j * kBypassPrecision);
      value = static_cast<int32_t>(raw >> 1);
      if (raw & 1u) value = -value - 1; else value += max_value;
    }
    out[i] = value + tb.offset[k];
  }
  return true;
}

// ---- format v2: interleaved-lane rANS (coder/rans_tpu.py container) ----
//
// Byte-compatible with the TPU LaneCoder so v2 archives produced on TPU
// decode in pure C++ (and vice versa). Layout, little-endian:
//   uint32 magic "CRX2", n, K, n_esc, n_words;
//   K x uint32 final lane states;
//   n_words x uint16 stream (ordered by (step asc, lane asc));
//   zigzag-LEB128 escape values (flat symbol order).
// Symbol g lives in lane g % K at step g / K; 32-bit lane state with
// 16-bit renorm words, lower bound 2^16.

constexpr uint32_t kLaneMagic = 0x32585243u;  // "CRX2"
constexpr uint32_t kLaneL = 1u << 16;

int default_num_lanes(size_t n) {
  size_t k = 1;
  while (k * 2 <= (n > 512 ? n / 512 : 1) && k < 4096) k *= 2;
  return static_cast<int>(k);
}

void zigzag_append(std::vector<uint8_t> &out, int32_t v) {
  uint64_t u = v >= 0 ? (static_cast<uint64_t>(v) << 1)
                      : ((static_cast<uint64_t>(-(static_cast<int64_t>(v)) - 1) << 1) | 1);
  do {
    uint8_t b = u & 0x7F;
    u >>= 7;
    out.push_back(b | (u ? 0x80 : 0));
  } while (u);
}

bool zigzag_read(const uint8_t *p, size_t len, size_t count, std::vector<int32_t> &vals) {
  vals.clear();
  // every value consumes >= 1 byte, so a corrupt count > len can be
  // rejected before it drives a multi-GB reserve().
  if (count > len) return false;
  vals.reserve(count);
  size_t i = 0;
  for (size_t c = 0; c < count; ++c) {
    uint64_t u = 0;
    int shift = 0;
    while (true) {
      if (i >= len || shift > 63) return false;
      uint8_t b = p[i++];
      u |= static_cast<uint64_t>(b & 0x7F) << shift;
      shift += 7;
      if (!(b & 0x80)) break;
    }
    int64_t v = (u & 1) ? -static_cast<int64_t>(u >> 1) - 1 : static_cast<int64_t>(u >> 1);
    vals.push_back(static_cast<int32_t>(v));
  }
  return true;
}

std::vector<uint8_t> lane_encode(const Tables &tb, const int32_t *symbols,
                                 const int32_t *indexes, size_t n) {
  const int K = default_num_lanes(n);
  const size_t M = (n + K - 1) / K;
  const size_t total = M * K;

  // per-slot coding params (padded slots: cdf row 0, in-range symbol)
  std::vector<uint16_t> starts(total), freqs(total);
  std::vector<uint8_t> is_esc(total, 0);
  std::vector<int32_t> esc_syms;
  for (size_t g = 0; g < total; ++g) {
    int32_t k = g < n ? indexes[g] : 0;
    int32_t sym = g < n ? symbols[g] : tb.offset[0];
    const int32_t *cdf = tb.cdf.data() + static_cast<size_t>(k) * tb.stride;
    const int32_t max_value = tb.length[k] - 2;
    int32_t v = sym - tb.offset[k];
    int32_t bin = v;
    if (v < 0 || v >= max_value) {
      bin = max_value;
      is_esc[g] = 1;
      esc_syms.push_back(sym);
    }
    starts[g] = static_cast<uint16_t>(cdf[bin]);
    freqs[g] = static_cast<uint16_t>(cdf[bin + 1] - cdf[bin]);
  }

  // reverse scan over steps; emissions at (t, l) recorded in place
  std::vector<uint32_t> x(K, kLaneL);
  std::vector<uint8_t> emit(total, 0);
  std::vector<uint16_t> words(total);
  for (size_t t = M; t-- > 0;) {
    for (int l = 0; l < K; ++l) {
      const size_t g = t * K + l;
      const uint32_t freq = freqs[g];
      const uint32_t x_max = freq << kPrecision;
      if (x[l] >= x_max) {
        emit[g] = 1;
        words[g] = static_cast<uint16_t>(x[l] & 0xFFFF);
        x[l] >>= kPrecision;
      }
      x[l] = ((x[l] / freq) << kPrecision) + (x[l] % freq) + starts[g];
    }
  }

  std::vector<uint16_t> stream;
  stream.reserve(total / 2);
  for (size_t g = 0; g < total; ++g)
    if (emit[g]) stream.push_back(words[g]);

  std::vector<uint8_t> out;
  const uint32_t header[5] = {kLaneMagic, static_cast<uint32_t>(n),
                              static_cast<uint32_t>(K),
                              static_cast<uint32_t>(esc_syms.size()),
                              static_cast<uint32_t>(stream.size())};
  const uint8_t *hp = reinterpret_cast<const uint8_t *>(header);
  out.insert(out.end(), hp, hp + sizeof header);
  const uint8_t *xp = reinterpret_cast<const uint8_t *>(x.data());
  out.insert(out.end(), xp, xp + 4 * x.size());
  const uint8_t *sp = reinterpret_cast<const uint8_t *>(stream.data());
  out.insert(out.end(), sp, sp + 2 * stream.size());
  for (int32_t v : esc_syms) zigzag_append(out, v);
  return out;
}

// Tiny-bucket merge (v2 header bit 29): remap every cdf index whose
// symbol count is below K to the NEAREST index with count >= K (ties
// toward the smaller index; identity when no bucket reaches K). Must
// match coder/rans_tpu.py::_merge_tiny_buckets_np exactly — both sides
// re-derive it from the (identical, sorted) index sequence.
void merge_tiny_buckets(std::vector<int32_t> &sidx, int32_t ncdfs,
                        uint32_t K) {
  std::vector<int64_t> counts(ncdfs, 0);
  for (int32_t v : sidx) counts[static_cast<size_t>(v)]++;
  bool any = false;
  for (int32_t i = 0; i < ncdfs; ++i)
    if (counts[i] >= static_cast<int64_t>(K)) { any = true; break; }
  if (!any) return;
  std::vector<int32_t> remap(ncdfs);
  for (int32_t i = 0; i < ncdfs; ++i) {
    if (counts[i] >= static_cast<int64_t>(K)) { remap[i] = i; continue; }
    int32_t best = 0;
    int64_t bestd = static_cast<int64_t>(ncdfs) + 1;
    for (int32_t j = 0; j < ncdfs; ++j) {  // first minimum = smaller tie
      if (counts[j] < static_cast<int64_t>(K)) continue;
      const int64_t d = i > j ? i - j : j - i;
      if (d < bestd) { bestd = d; best = j; }
    }
    remap[i] = best;
  }
  for (auto &v : sidx) v = remap[static_cast<size_t>(v)];
}

bool lane_decode(const Tables &tb, const uint8_t *data, size_t len,
                 const int32_t *indexes, size_t n, int32_t *out) {
  if (len < 20) return false;
  uint32_t header[5];
  memcpy(header, data, sizeof header);
  if (header[0] != kLaneMagic || header[1] != n) return false;
  // bit 31: index-sorted lane assignment; bit 30: kernel-safety verdict
  // (TPU decode routing only — irrelevant here); bit 29: tiny-bucket merge
  const bool sorted = (header[2] & (1u << 31)) != 0;
  const bool merged = (header[2] & (1u << 29)) != 0;
  const uint32_t K = header[2] & ~(0x7u << 29);
  const uint32_t n_esc = header[3], n_words = header[4];
  if (K == 0 || K > (1u << 20)) return false;
  size_t off = 20;
  // 64-bit arithmetic: a corrupt n_words >= 2^31 must not wrap the
  // 32-bit product and slip past this check (the refill loop then
  // trusts n_words as the stream bound).
  if (static_cast<uint64_t>(len) <
      off + 4ull * K + 2ull * n_words)
    return false;
  std::vector<uint32_t> x(K);
  memcpy(x.data(), data + off, 4u * K);
  off += 4u * K;
  const uint16_t *stream = reinterpret_cast<const uint16_t *>(data + off);
  off += 2ull * n_words;
  std::vector<int32_t> esc_vals;
  if (!zigzag_read(data + off, len - off, n_esc, esc_vals)) return false;

  // sorted streams: reproduce the encoder's stable index sort; decode in
  // sorted order, write each value back through the permutation, consume
  // escapes in sorted (scan) order. Padding uses the LAST sorted index
  // (the encoder pads nondecreasing), vs row 0 for unsorted streams.
  std::vector<int32_t> sidx;
  std::vector<size_t> perm;
  const int32_t *idx_seq = indexes;
  if (sorted && n > 0) {
    perm.resize(n);
    for (size_t i = 0; i < n; ++i) perm[i] = i;
    std::stable_sort(perm.begin(), perm.end(), [&](size_t a, size_t b) {
      return indexes[a] < indexes[b];
    });
    sidx.resize(n);
    for (size_t i = 0; i < n; ++i) {
      const int32_t v = indexes[perm[i]];
      if (v < 0 || v >= tb.ncdfs) return false;
      sidx[i] = v;
    }
    if (merged) merge_tiny_buckets(sidx, tb.ncdfs, K);
    idx_seq = sidx.data();
  }
  const int32_t pad_idx = sorted && n > 0 ? idx_seq[n - 1] : 0;

  const size_t M = (n + K - 1) / K;
  size_t ptr = 0, esc_i = 0;
  for (size_t t = 0; t < M; ++t) {
    for (uint32_t l = 0; l < K; ++l) {
      const size_t g = t * K + l;
      const int32_t k = g < n ? idx_seq[g] : pad_idx;
      const int32_t *cdf = tb.cdf.data() + static_cast<size_t>(k) * tb.stride;
      const int32_t size = tb.length[k];
      const int32_t max_value = size - 2;
      const uint32_t cum = x[l] & ((1u << kPrecision) - 1);
      int32_t lo = 0, hi = size - 1;
      while (hi - lo > 1) {
        const int32_t mid = (lo + hi) >> 1;
        if (static_cast<uint32_t>(cdf[mid]) <= cum) lo = mid; else hi = mid;
      }
      const uint32_t start = static_cast<uint32_t>(cdf[lo]);
      const uint32_t freq = static_cast<uint32_t>(cdf[lo + 1]) - start;
      x[l] = freq * (x[l] >> kPrecision) + cum - start;
      if (x[l] < kLaneL) {
        if (ptr >= n_words) return false;
        x[l] = (x[l] << kPrecision) | stream[ptr++];
      }
      if (g < n) {
        const size_t o = sorted ? perm[g] : g;
        if (lo == max_value) {
          if (esc_i >= esc_vals.size()) return false;
          out[o] = esc_vals[esc_i++];
        } else {
          out[o] = lo + tb.offset[k];
        }
      }
    }
  }
  return esc_i == esc_vals.size();
}

// ---- RDOQ ----

// bits to code symbol s with cdf row k (escape path costed approximately).
double symbol_bits(const Tables &tb, int32_t k, int32_t s) {
  const int32_t *cdf = tb.cdf.data() + static_cast<size_t>(k) * tb.stride;
  const int32_t max_value = tb.length[k] - 2;
  int32_t v = s - tb.offset[k];
  if (v >= 0 && v < max_value) {
    const double freq = static_cast<double>(cdf[v + 1] - cdf[v]);
    return kPrecision - std::log2(freq);
  }
  // escape: tail bucket bits + bypass length/raw nibbles
  const double tail = static_cast<double>(cdf[max_value + 1] - cdf[max_value]);
  uint32_t raw = v < 0 ? static_cast<uint32_t>(-2 * v - 1)
                       : static_cast<uint32_t>(2 * (v - max_value));
  int nb = 0;
  while ((raw >> (nb * kBypassPrecision)) != 0) ++nb;
  return (kPrecision - std::log2(tail)) + kBypassPrecision * (1.0 + nb);
}

void rdoq_range(const Tables &tb, const float *x, const int32_t *idx,
                size_t lo, size_t hi, double lambda, int32_t *out) {
  for (size_t i = lo; i < hi; ++i) {
    const float v = x[i];
    const int32_t k = idx[i];
    const int32_t r = static_cast<int32_t>(std::lround(v));
    double best_cost = 1e300;
    int32_t best_q = r;
    for (int32_t q = r - 1; q <= r + 1; ++q) {
      const double d = (v - q) * (v - q);
      const double cost = lambda * d + symbol_bits(tb, k, q);
      if (cost < best_cost) { best_cost = cost; best_q = q; }
    }
    out[i] = best_q;
  }
}

// ---- neural synthesis (format CRS1) ------------------------------------
//
// Pure-C++ reconstruction: the reference's SADL decoder runs the
// synthesis network without Python (/root/reference/cra5/models/
// compressai/sadl_codec/decoder_generic.h:121-213); this is the
// equivalent for the conv-baseline g_s stacks (deconv / GDN-inverse /
// conv / relu). Weights come from standalone/export.py::export_synthesis
// with GDN weights already re-parameterized to their effective values
// and deconv kernels pre-flipped to scatter-accumulate orientation.

enum SynthLayerType {
  kChannelBias = 0,  // y_hat = sym + medians (EB dequantize offset)
  kDeconv = 1,
  kIGDN = 2,
  kReLU = 3,
  kConv = 4,
  kGDN = 5,
  kLeakyReLU = 6,
};

struct SynthLayer {
  int32_t type = 0;
  int32_t cin = 0, cout = 0, k = 0, s = 0;
  std::vector<float> kernel;      // deconv/conv f32: [dy][dx][ci][co]
  std::vector<int16_t> kernel_q;  // int16 engine (magic CRSq); same layout
  float wscale = 0.f;             // dequantize scale: w = kernel_q * wscale
  std::vector<float> bias;    // cout (or C for channel_bias)
  std::vector<float> beta;    // gdn: C
  std::vector<float> gamma;   // gdn: C*C row-major [co][ci]
};

bool load_synthesis(const char *path, std::vector<SynthLayer> &net) {
  FILE *f = fopen(path, "rb");
  if (!f) return false;
  char magic[4];
  int32_t n_layers;
  if (!read_exact(f, magic, 4) ||
      (memcmp(magic, "CRS1", 4) != 0 && memcmp(magic, "CRSq", 4) != 0) ||
      !read_exact(f, &n_layers, 4) || n_layers < 0 || n_layers > 1024) {
    fclose(f);
    return false;
  }
  const bool quant = memcmp(magic, "CRSq", 4) == 0;
  net.resize(n_layers);
  for (auto &L : net) {
    if (!read_exact(f, &L.type, 4)) { fclose(f); return false; }
    if (L.type == kChannelBias) {
      if (!read_exact(f, &L.cout, 4)) { fclose(f); return false; }
      L.bias.resize(L.cout);
      if (!read_exact(f, L.bias.data(), 4u * L.cout)) { fclose(f); return false; }
    } else if (L.type == kDeconv || L.type == kConv) {
      int32_t geom[4];
      if (!read_exact(f, geom, 16)) { fclose(f); return false; }
      L.cin = geom[0]; L.cout = geom[1]; L.k = geom[2]; L.s = geom[3];
      if (L.cin <= 0 || L.cout <= 0 || L.k <= 0 || L.s <= 0) { fclose(f); return false; }
      const size_t kn = static_cast<size_t>(L.k) * L.k * L.cin * L.cout;
      L.bias.resize(L.cout);
      if (quant) {
        L.kernel_q.resize(kn);
        if (!read_exact(f, &L.wscale, 4) ||
            !read_exact(f, L.kernel_q.data(), 2 * kn) ||
            !read_exact(f, L.bias.data(), 4 * L.bias.size())) {
          fclose(f);
          return false;
        }
      } else {
        L.kernel.resize(kn);
        if (!read_exact(f, L.kernel.data(), 4 * kn) ||
            !read_exact(f, L.bias.data(), 4 * L.bias.size())) {
          fclose(f);
          return false;
        }
      }
    } else if (L.type == kIGDN || L.type == kGDN) {
      if (!read_exact(f, &L.cout, 4)) { fclose(f); return false; }
      L.cin = L.cout;
      L.beta.resize(L.cout);
      L.gamma.resize(static_cast<size_t>(L.cout) * L.cout);
      if (!read_exact(f, L.beta.data(), 4 * L.beta.size()) ||
          !read_exact(f, L.gamma.data(), 4 * L.gamma.size())) { fclose(f); return false; }
    } else if (L.type != kReLU && L.type != kLeakyReLU) {
      fclose(f);
      return false;
    }
  }
  fclose(f);
  return true;
}

// activations are channel-major planes: act[c * H * W + y * W + x]
void synth_deconv(const SynthLayer &L, const std::vector<float> &in, int H,
                  int W, std::vector<float> &out, int &Ho, int &Wo) {
  // flax deconv2d semantics: VALID transpose then crop [p, p + H*s)
  // (nn/conv.py::deconv2d); kernel pre-flipped by the exporter so this
  // is a plain scatter-accumulate.
  const int k = L.k, s = L.s, p = L.k / 2;
  const int Hf = (H - 1) * s + k, Wf = (W - 1) * s + k;
  Ho = H * s; Wo = W * s;
  std::vector<float> full(static_cast<size_t>(L.cout) * Hf * Wf, 0.f);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      const float *xin = in.data() + static_cast<size_t>(i) * W + j;
      for (int dy = 0; dy < k; ++dy)
        for (int dx = 0; dx < k; ++dx) {
          const float *Wk =
              L.kernel.data() + (static_cast<size_t>(dy) * k + dx) * L.cin * L.cout;
          float *o = full.data() + static_cast<size_t>(i * s + dy) * Wf + (j * s + dx);
          for (int ci = 0; ci < L.cin; ++ci) {
            const float v = xin[static_cast<size_t>(ci) * H * W];
            if (v == 0.f) continue;
            const float *wrow = Wk + static_cast<size_t>(ci) * L.cout;
            for (int co = 0; co < L.cout; ++co)
              o[static_cast<size_t>(co) * Hf * Wf] += v * wrow[co];
          }
        }
    }
  out.assign(static_cast<size_t>(L.cout) * Ho * Wo, 0.f);
  for (int co = 0; co < L.cout; ++co)
    for (int y = 0; y < Ho; ++y)
      for (int x = 0; x < Wo; ++x)
        out[(static_cast<size_t>(co) * Ho + y) * Wo + x] =
            full[(static_cast<size_t>(co) * Hf + (y + p)) * Wf + (x + p)] +
            L.bias[co];
}

void synth_conv(const SynthLayer &L, const std::vector<float> &in, int H,
                int W, std::vector<float> &out, int &Ho, int &Wo) {
  // stride-s conv, 'same' padding k//2 (nn/conv.py::conv2d)
  const int k = L.k, s = L.s, p = L.k / 2;
  Ho = (H + s - 1) / s; Wo = (W + s - 1) / s;
  out.assign(static_cast<size_t>(L.cout) * Ho * Wo, 0.f);
  for (int oy = 0; oy < Ho; ++oy)
    for (int ox = 0; ox < Wo; ++ox) {
      for (int dy = 0; dy < k; ++dy) {
        const int iy = oy * s + dy - p;
        if (iy < 0 || iy >= H) continue;
        for (int dx = 0; dx < k; ++dx) {
          const int ix = ox * s + dx - p;
          if (ix < 0 || ix >= W) continue;
          const float *Wk =
              L.kernel.data() + (static_cast<size_t>(dy) * k + dx) * L.cin * L.cout;
          for (int ci = 0; ci < L.cin; ++ci) {
            const float v = in[(static_cast<size_t>(ci) * H + iy) * W + ix];
            const float *wrow = Wk + static_cast<size_t>(ci) * L.cout;
            float *o = out.data() + static_cast<size_t>(oy) * Wo + ox;
            for (int co = 0; co < L.cout; ++co)
              o[static_cast<size_t>(co) * Ho * Wo] += v * wrow[co];
          }
        }
      }
      for (int co = 0; co < L.cout; ++co)
        out[(static_cast<size_t>(co) * Ho + oy) * Wo + ox] += L.bias[co];
    }
}

// ---- int16 engine (magic CRSq) ------------------------------------------
//
// The reference ships float AND int16 SADL builds (sadl_codec
// CMakeLists.txt:18-43). Here the conv/deconv FLOPs — where all the work
// is — run in integer: weights are exported int16 with one f32 dequantize
// scale per layer, activations are quantized to int16 dynamically (max-abs
// per layer boundary), products accumulate in int64 (int16*int16 sums over
// k*k*cin terms overflow int32). GDN/bias/activations between conv layers
// stay f32 islands, the same stance the TPU compute path takes for its
// normalization numerics.

float quantize_act(const std::vector<float> &in, std::vector<int16_t> &q) {
  float amax = 0.f;
  for (float v : in) amax = std::max(amax, std::fabs(v));
  const float s = amax > 0.f ? 32767.f / amax : 1.f;
  q.resize(in.size());
  for (size_t i = 0; i < in.size(); ++i)
    q[i] = static_cast<int16_t>(std::lrintf(in[i] * s));
  return s;
}

void synth_deconv_q(const SynthLayer &L, const std::vector<float> &in, int H,
                    int W, std::vector<float> &out, int &Ho, int &Wo) {
  const int k = L.k, s = L.s, p = L.k / 2;
  const int Hf = (H - 1) * s + k, Wf = (W - 1) * s + k;
  Ho = H * s; Wo = W * s;
  std::vector<int16_t> inq;
  const float ascale = quantize_act(in, inq);
  const float deq = L.wscale / ascale;
  std::vector<int64_t> full(static_cast<size_t>(L.cout) * Hf * Wf, 0);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      const int16_t *xin = inq.data() + static_cast<size_t>(i) * W + j;
      for (int dy = 0; dy < k; ++dy)
        for (int dx = 0; dx < k; ++dx) {
          const int16_t *Wk =
              L.kernel_q.data() + (static_cast<size_t>(dy) * k + dx) * L.cin * L.cout;
          int64_t *o = full.data() + static_cast<size_t>(i * s + dy) * Wf + (j * s + dx);
          for (int ci = 0; ci < L.cin; ++ci) {
            const int32_t v = xin[static_cast<size_t>(ci) * H * W];
            if (v == 0) continue;
            const int16_t *wrow = Wk + static_cast<size_t>(ci) * L.cout;
            for (int co = 0; co < L.cout; ++co)
              o[static_cast<size_t>(co) * Hf * Wf] += static_cast<int64_t>(v) * wrow[co];
          }
        }
    }
  out.assign(static_cast<size_t>(L.cout) * Ho * Wo, 0.f);
  for (int co = 0; co < L.cout; ++co)
    for (int y = 0; y < Ho; ++y)
      for (int x = 0; x < Wo; ++x)
        out[(static_cast<size_t>(co) * Ho + y) * Wo + x] =
            static_cast<float>(
                full[(static_cast<size_t>(co) * Hf + (y + p)) * Wf + (x + p)]) *
                deq +
            L.bias[co];
}

void synth_conv_q(const SynthLayer &L, const std::vector<float> &in, int H,
                  int W, std::vector<float> &out, int &Ho, int &Wo) {
  const int k = L.k, s = L.s, p = L.k / 2;
  Ho = (H + s - 1) / s; Wo = (W + s - 1) / s;
  std::vector<int16_t> inq;
  const float ascale = quantize_act(in, inq);
  const float deq = L.wscale / ascale;
  out.assign(static_cast<size_t>(L.cout) * Ho * Wo, 0.f);
  std::vector<int64_t> acc(static_cast<size_t>(L.cout));
  for (int oy = 0; oy < Ho; ++oy)
    for (int ox = 0; ox < Wo; ++ox) {
      std::fill(acc.begin(), acc.end(), 0);
      for (int dy = 0; dy < k; ++dy) {
        const int iy = oy * s + dy - p;
        if (iy < 0 || iy >= H) continue;
        for (int dx = 0; dx < k; ++dx) {
          const int ix = ox * s + dx - p;
          if (ix < 0 || ix >= W) continue;
          const int16_t *Wk =
              L.kernel_q.data() + (static_cast<size_t>(dy) * k + dx) * L.cin * L.cout;
          for (int ci = 0; ci < L.cin; ++ci) {
            const int32_t v = inq[(static_cast<size_t>(ci) * H + iy) * W + ix];
            if (v == 0) continue;
            const int16_t *wrow = Wk + static_cast<size_t>(ci) * L.cout;
            for (int co = 0; co < L.cout; ++co)
              acc[co] += static_cast<int64_t>(v) * wrow[co];
          }
        }
      }
      for (int co = 0; co < L.cout; ++co)
        out[(static_cast<size_t>(co) * Ho + oy) * Wo + ox] =
            static_cast<float>(acc[co]) * deq + L.bias[co];
    }
}

void synth_gdn(const SynthLayer &L, std::vector<float> &act, int H, int W,
               bool inverse) {
  const int C = L.cout;
  const size_t plane = static_cast<size_t>(H) * W;
  std::vector<float> sq(static_cast<size_t>(C));
  for (size_t px = 0; px < plane; ++px) {
    for (int c = 0; c < C; ++c) {
      const float v = act[static_cast<size_t>(c) * plane + px];
      sq[c] = v * v;
    }
    for (int co = 0; co < C; ++co) {
      float norm = L.beta[co];
      const float *g = L.gamma.data() + static_cast<size_t>(co) * C;
      for (int ci = 0; ci < C; ++ci) norm += g[ci] * sq[ci];
      norm = std::sqrt(norm);
      float &v = act[static_cast<size_t>(co) * plane + px];
      v = inverse ? v * norm : v / norm;
    }
  }
}

bool run_network(const std::vector<SynthLayer> &net, std::vector<float> act,
                 int C, int H, int W, std::vector<float> &out, int &Co,
                 int &Ho, int &Wo) {
  Co = C; Ho = H; Wo = W;
  for (const auto &L : net) {
    if (L.type == kChannelBias) {
      if (L.cout != Co) return false;
      const size_t plane = static_cast<size_t>(Ho) * Wo;
      for (int c = 0; c < Co; ++c)
        for (size_t px = 0; px < plane; ++px)
          act[static_cast<size_t>(c) * plane + px] += L.bias[c];
    } else if (L.type == kDeconv || L.type == kConv) {
      if (L.cin != Co) return false;
      std::vector<float> next;
      int Hn, Wn;
      const bool q = !L.kernel_q.empty();
      if (L.type == kDeconv) {
        if (q) synth_deconv_q(L, act, Ho, Wo, next, Hn, Wn);
        else synth_deconv(L, act, Ho, Wo, next, Hn, Wn);
      } else {
        if (q) synth_conv_q(L, act, Ho, Wo, next, Hn, Wn);
        else synth_conv(L, act, Ho, Wo, next, Hn, Wn);
      }
      act.swap(next);
      Co = L.cout; Ho = Hn; Wo = Wn;
    } else if (L.type == kIGDN || L.type == kGDN) {
      if (L.cout != Co) return false;
      synth_gdn(L, act, Ho, Wo, L.type == kIGDN);
    } else if (L.type == kReLU) {
      for (auto &v : act) v = v > 0.f ? v : 0.f;
    } else if (L.type == kLeakyReLU) {
      for (auto &v : act) v = v > 0.f ? v : 0.01f * v;
    }
  }
  out.swap(act);
  return true;
}

bool run_synthesis(const std::vector<SynthLayer> &net,
                   const std::vector<int32_t> &sym, int C, int H, int W,
                   std::vector<float> &out, int &Co, int &Ho, int &Wo) {
  std::vector<float> act(sym.size());
  for (size_t i = 0; i < sym.size(); ++i) act[i] = static_cast<float>(sym[i]);
  return run_network(net, std::move(act), C, H, W, out, Co, Ho, Wo);
}

int usage() {
  fprintf(stderr,
          "usage: cra5_codec encode <tables> <tensor> <out.bin>\n"
          "       cra5_codec decode <tables> <in.bin> <tensor-out>\n"
          "       cra5_codec encode2 <tables> <tensor> <out.bin> [indexes]   (v2 lane format)\n"
          "       cra5_codec decode2 <tables> <in.bin> <tensor-out> [indexes] (v2 lane format)\n"
          "       cra5_codec rdoq <tables> <float-tensor> <lambda> <tensor-out>\n"
          "       cra5_codec decode-full <tables> <in.bin> <synthesis.crs> <float-tensor-out>\n"
          "       cra5_codec encode-full <tables> <float-tensor> <analysis.crs> <out.bin>\n");
  return 2;
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 2) return usage();
  const std::string mode = argv[1];

  if (mode == "encode" && argc == 5) {
    Tables tb; Tensor t;
    if (!load_tables(argv[2], tb)) { fprintf(stderr, "bad tables\n"); return 1; }
    if (!load_tensor(argv[3], t) || t.is_float) { fprintf(stderr, "bad tensor\n"); return 1; }
    std::vector<int32_t> idx;
    channel_indexes(t, idx);
    std::vector<uint32_t> words = encode_stream(tb, t.idata.data(), idx.data(), t.size());
    FILE *f = fopen(argv[4], "wb");
    if (!f) return 1;
    fwrite("CRB1", 1, 4, f);
    int32_t ndim = static_cast<int32_t>(t.dims.size());
    fwrite(&ndim, 4, 1, f);
    fwrite(t.dims.data(), 4, t.dims.size(), f);
    uint32_t nbytes = static_cast<uint32_t>(words.size() * 4);
    fwrite(&nbytes, 4, 1, f);
    fwrite(words.data(), 4, words.size(), f);
    fclose(f);
    printf("%u\n", nbytes);
    return 0;
  }

  if (mode == "decode" && argc == 5) {
    Tables tb;
    if (!load_tables(argv[2], tb)) { fprintf(stderr, "bad tables\n"); return 1; }
    FILE *f = fopen(argv[3], "rb");
    if (!f) return 1;
    char magic[4];
    int32_t ndim;
    if (!read_exact(f, magic, 4) || memcmp(magic, "CRB1", 4) != 0 ||
        !read_exact(f, &ndim, 4) || ndim <= 0 || ndim > 8) { fclose(f); return 1; }
    Tensor t;
    t.dims.resize(ndim);
    uint32_t nbytes;
    if (!read_exact(f, t.dims.data(), 4u * ndim) || !dims_valid(t.dims) ||
        !read_exact(f, &nbytes, 4)) { fclose(f); return 1; }
    std::vector<uint32_t> words(nbytes / 4);
    if (!read_exact(f, words.data(), nbytes)) { fclose(f); return 1; }
    fclose(f);
    std::vector<int32_t> idx;
    channel_indexes(t, idx);
    t.idata.resize(t.size());
    if (!decode_stream(tb, words.data(), words.size(), idx.data(), t.size(), t.idata.data())) {
      fprintf(stderr, "decode failed\n");
      return 1;
    }
    return save_tensor(argv[4], t) ? 0 : 1;
  }

  if (mode == "encode2" && (argc == 5 || argc == 6)) {
    Tables tb; Tensor t;
    if (!load_tables(argv[2], tb)) { fprintf(stderr, "bad tables\n"); return 1; }
    if (!load_tensor(argv[3], t) || t.is_float) { fprintf(stderr, "bad tensor\n"); return 1; }
    std::vector<int32_t> idx;
    // optional explicit per-symbol cdf-index tensor (e.g. a Gaussian-
    // conditional scale-index grid); default is channel-major EB indexing
    if (argc == 6) {
      Tensor ti;
      if (!load_tensor(argv[5], ti) || ti.is_float || ti.size() != t.size()) {
        fprintf(stderr, "bad indexes tensor\n");
        return 1;
      }
      for (int32_t v : ti.idata)
        if (v < 0 || v >= tb.ncdfs) { fprintf(stderr, "index out of range\n"); return 1; }
      idx.swap(ti.idata);
    } else {
      channel_indexes(t, idx);
    }
    std::vector<uint8_t> payload = lane_encode(tb, t.idata.data(), idx.data(), t.size());
    FILE *f = fopen(argv[4], "wb");
    if (!f) return 1;
    fwrite("CRB2", 1, 4, f);
    int32_t ndim = static_cast<int32_t>(t.dims.size());
    fwrite(&ndim, 4, 1, f);
    fwrite(t.dims.data(), 4, t.dims.size(), f);
    uint32_t nbytes = static_cast<uint32_t>(payload.size());
    fwrite(&nbytes, 4, 1, f);
    fwrite(payload.data(), 1, payload.size(), f);
    fclose(f);
    printf("%u\n", nbytes);
    return 0;
  }

  if (mode == "decode2" && (argc == 5 || argc == 6)) {
    Tables tb;
    if (!load_tables(argv[2], tb)) { fprintf(stderr, "bad tables\n"); return 1; }
    FILE *f = fopen(argv[3], "rb");
    if (!f) return 1;
    char magic[4];
    int32_t ndim;
    if (!read_exact(f, magic, 4) || memcmp(magic, "CRB2", 4) != 0 ||
        !read_exact(f, &ndim, 4) || ndim <= 0 || ndim > 8) { fclose(f); return 1; }
    Tensor t;
    t.dims.resize(ndim);
    uint32_t nbytes;
    if (!read_exact(f, t.dims.data(), 4u * ndim) || !dims_valid(t.dims) ||
        !read_exact(f, &nbytes, 4)) { fclose(f); return 1; }
    std::vector<uint8_t> payload(nbytes);
    if (!read_exact(f, payload.data(), nbytes)) { fclose(f); return 1; }
    fclose(f);
    std::vector<int32_t> idx;
    if (argc == 6) {  // explicit index tensor (GC scale-index grids)
      Tensor ti;
      if (!load_tensor(argv[5], ti) || ti.is_float || ti.size() != t.size()) {
        fprintf(stderr, "bad indexes tensor\n");
        return 1;
      }
      for (int32_t v : ti.idata)
        if (v < 0 || v >= tb.ncdfs) { fprintf(stderr, "index out of range\n"); return 1; }
      idx.swap(ti.idata);
    } else {
      channel_indexes(t, idx);
    }
    t.idata.resize(t.size());
    if (!lane_decode(tb, payload.data(), payload.size(), idx.data(), t.size(), t.idata.data())) {
      fprintf(stderr, "v2 decode failed\n");
      return 1;
    }
    return save_tensor(argv[4], t) ? 0 : 1;
  }

  if (mode == "rdoq" && argc == 6) {
    Tables tb; Tensor t;
    if (!load_tables(argv[2], tb)) { fprintf(stderr, "bad tables\n"); return 1; }
    if (!load_tensor(argv[3], t) || !t.is_float) { fprintf(stderr, "need float tensor\n"); return 1; }
    const double lambda = atof(argv[4]);
    std::vector<int32_t> idx;
    channel_indexes(t, idx);
    Tensor out;
    out.dims = t.dims;
    out.idata.resize(t.size());
    const unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> threads;
    const size_t chunk = (t.size() + nthreads - 1) / nthreads;
    for (unsigned w = 0; w < nthreads; ++w) {
      const size_t lo = w * chunk;
      const size_t hi = std::min(t.size(), lo + chunk);
      if (lo >= hi) break;
      threads.emplace_back(rdoq_range, std::cref(tb), t.fdata.data(), idx.data(),
                           lo, hi, lambda, out.idata.data());
    }
    for (auto &th : threads) th.join();
    return save_tensor(argv[5], out) ? 0 : 1;
  }

  if (mode == "decode-full" && argc == 6) {
    // entropy decode + neural synthesis, no Python anywhere (parity with
    // the reference SADL decoder's full reconstruction path)
    Tables tb;
    if (!load_tables(argv[2], tb)) { fprintf(stderr, "bad tables\n"); return 1; }
    FILE *f = fopen(argv[3], "rb");
    if (!f) return 1;
    char magic[4];
    int32_t ndim;
    if (!read_exact(f, magic, 4) ||
        (memcmp(magic, "CRB1", 4) != 0 && memcmp(magic, "CRB2", 4) != 0) ||
        !read_exact(f, &ndim, 4) || ndim <= 0 || ndim > 8) { fclose(f); return 1; }
    const bool v2 = memcmp(magic, "CRB2", 4) == 0;
    Tensor t;
    t.dims.resize(ndim);
    uint32_t nbytes;
    if (!read_exact(f, t.dims.data(), 4u * ndim) || !dims_valid(t.dims) ||
        !read_exact(f, &nbytes, 4)) { fclose(f); return 1; }
    std::vector<uint8_t> payload(nbytes);
    if (!read_exact(f, payload.data(), nbytes)) { fclose(f); return 1; }
    fclose(f);
    std::vector<int32_t> idx;
    channel_indexes(t, idx);
    t.idata.resize(t.size());
    bool ok;
    if (v2) {
      ok = lane_decode(tb, payload.data(), payload.size(), idx.data(), t.size(),
                       t.idata.data());
    } else {
      ok = decode_stream(tb, reinterpret_cast<const uint32_t *>(payload.data()),
                         payload.size() / 4, idx.data(), t.size(), t.idata.data());
    }
    if (!ok) { fprintf(stderr, "entropy decode failed\n"); return 1; }
    std::vector<SynthLayer> net;
    if (!load_synthesis(argv[4], net)) { fprintf(stderr, "bad synthesis file\n"); return 1; }
    // dims: (..., C, H, W); leading dims must be 1 (single sample)
    if (t.dims.size() < 3) { fprintf(stderr, "need (C,H,W) tensor\n"); return 1; }
    for (size_t d = 0; d + 3 < t.dims.size(); ++d)
      if (t.dims[d] != 1) { fprintf(stderr, "batch decode-full unsupported\n"); return 1; }
    const int C = t.dims[t.dims.size() - 3];
    const int H = t.dims[t.dims.size() - 2];
    const int W = t.dims[t.dims.size() - 1];
    Tensor o;
    int Co, Ho, Wo;
    o.is_float = true;
    if (!run_synthesis(net, t.idata, C, H, W, o.fdata, Co, Ho, Wo)) {
      fprintf(stderr, "synthesis failed (layer/channel mismatch)\n");
      return 1;
    }
    o.dims = {1, Co, Ho, Wo};
    return save_tensor(argv[5], o) ? 0 : 1;
  }

  if (mode == "encode-full" && argc == 6) {
    // neural analysis + quantize + entropy encode, no Python anywhere
    // (parity with the reference SADL encoder running g_a in C++,
    // encoder_generic.h:141-349). The analysis.crs network ends with a
    // channel-bias layer of -medians, so plain round-to-nearest-even
    // (the runtime default rounding mode, matching jnp.round) yields
    // the EB symbols.
    Tables tb; Tensor t;
    if (!load_tables(argv[2], tb)) { fprintf(stderr, "bad tables\n"); return 1; }
    if (!load_tensor(argv[3], t) || !t.is_float) { fprintf(stderr, "need float tensor\n"); return 1; }
    std::vector<SynthLayer> net;
    if (!load_synthesis(argv[4], net)) { fprintf(stderr, "bad analysis file\n"); return 1; }
    if (t.dims.size() < 3) { fprintf(stderr, "need (C,H,W) tensor\n"); return 1; }
    for (size_t d = 0; d + 3 < t.dims.size(); ++d)
      if (t.dims[d] != 1) { fprintf(stderr, "batch encode-full unsupported\n"); return 1; }
    const int C = t.dims[t.dims.size() - 3];
    const int H = t.dims[t.dims.size() - 2];
    const int W = t.dims[t.dims.size() - 1];
    std::vector<float> y;
    int Cy, Hy, Wy;
    if (!run_network(net, std::move(t.fdata), C, H, W, y, Cy, Hy, Wy)) {
      fprintf(stderr, "analysis failed (layer/channel mismatch)\n");
      return 1;
    }
    Tensor q;
    q.dims = {1, Cy, Hy, Wy};
    q.idata.resize(y.size());
    for (size_t i = 0; i < y.size(); ++i)
      q.idata[i] = static_cast<int32_t>(std::nearbyint(y[i]));
    std::vector<int32_t> idx;
    channel_indexes(q, idx);
    std::vector<uint8_t> payload = lane_encode(tb, q.idata.data(), idx.data(), q.size());
    FILE *f = fopen(argv[5], "wb");
    if (!f) return 1;
    fwrite("CRB2", 1, 4, f);
    int32_t ndim = static_cast<int32_t>(q.dims.size());
    fwrite(&ndim, 4, 1, f);
    fwrite(q.dims.data(), 4, q.dims.size(), f);
    uint32_t nbytes = static_cast<uint32_t>(payload.size());
    fwrite(&nbytes, 4, 1, f);
    fwrite(payload.data(), 1, payload.size(), f);
    fclose(f);
    printf("%u\n", nbytes);
    return 0;
  }

  return usage();
}
