// K9 container_write and K10 container_read: the byte image of a CRX2
// (format v2) container written and read on the card (docs/FORMATS.md
// section 3: the 20-byte header, the K lane states, the n_words 16-bit
// words, the n_esc zigzag LEB128 escape varints).
//
// They replace no TPU kernel: the JAX package packs and parses its
// containers on the host (cra5_tpu/coder/rans_tpu.py), as the port did.
// There the escape side channel cost numpy ten or so passes of fancy
// indexing each way and the words two host copies, all while the card
// idled (coder/pack, coder/parse). On the card the same work is a few MB
// of copies and a scan: the bound is bytes (the 268v y stream's ~2 MB in
// and out, ~1.2 us at 3.35 TB/s), so the host keeps one copy of the
// finished bytes each way.
//
// One launch a stream, of two kinds of blocks. Copy blocks move the states
// and the words, which sit in the image at 4-byte-aligned offsets (20 and
// 20 + 4K; the words at 4 mod 16 when K % 4 == 0), as 32-bit units. Tile
// blocks walk the escape side channel, a tile each, in one pass: a tile's
// sums go to the tiles after it by decoupled look-back (each tile publishes
// its own aggregate at once, then its inclusive prefix once the tiles
// before it give theirs; a tile takes its number from an atomic counter, so
// the tiles it waits on are running or done). A first version walked the
// varints in one block of 1024 threads, tile after tile: 96 us (K9) and 146
// us (K10) at the 268v y's ~10^5 escapes on an H100, the block's own load
// and store latency tile after tile.
//   - K9: a tile gives each thread kWriteEscapes consecutive escapes (one
//     16-byte load). Zigzag u = (v << 1) ^ (v >> 31) as a u32, a length of
//     1-5 bytes (7 bits a byte), the block's exclusive scan of the threads'
//     lengths, the look-back for the bytes of the tiles before, then each
//     thread writes its bytes, the high bit set on all but each varint's
//     last. The total size, unknown to the host until then, goes to bytes
//     0-7 of the output (from the last tile, or the first copy block when
//     there are no escapes), ahead of the container, so one copy out
//     brings both.
//   - K10: a tile gives each thread kReadBytes bytes of the image (one
//     16-byte load from the aligned-down start of the escape region); a
//     byte of the region with bit 7 clear ends a varint. One block scan
//     gives each thread its terminators' count before it (a sum) and the
//     last terminator before it (a max), the look-back the same of the
//     tiles before; then escape r, the r-th terminator's, is put together
//     from at most the first 5 bytes after terminator r - 1, as a 64-bit
//     u, zigzagged back and cut to int32 as numpy's astype cuts it. The
//     first n_esc terminators are taken and trailing bytes ignored: what
//     lane_coder.zigzag_varint_decode gives on every region the host
//     accepts (the host counts the terminators and raises below n_esc; past
//     the terminators found, the last tile writes 0).

#include <climits>

#include "common.cuh"

namespace {

constexpr uint32_t kMagic = 0x32585243u;  // "CRX2" little-endian
constexpr uint32_t kSortedFlag = 1u << 31, kSafeFlag = 1u << 30;
constexpr int kHeader = 20;
constexpr int kThreads = 1024;
constexpr int kWriteEscapes = 4;  // K9: escapes a thread a tile (one int4)
constexpr int kReadBytes = 16;    // K10: image bytes a thread a tile (one uint4)
constexpr long long kWriteTile = (long long)kThreads * kWriteEscapes;
constexpr long long kReadTile = (long long)kThreads * kReadBytes;
constexpr int kCopyUnits = 4;  // 32-bit units a copy thread, at the least
constexpr int kMaxCopyBlocks = 128;
// a tile's status word: the flag in bits 62-63, its value below
constexpr unsigned long long kAggregate = 1ull << 62, kPrefix = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// The status word of a tile before, once it has published one; traps after
// ~2^34 clocks.
__device__ __forceinline__ unsigned long long await_status(const unsigned long long* p) {
  const long long t0 = clock64();
  for (;;) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
    if (v >> 62) return v;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Decoupled look-back of tile `tile` (thread 0 of its block): publishes
// the tile's aggregate, sums (combine) those of the tiles before it back
// to the nearest inclusive prefix, publishes its own, and returns the
// exclusive one. status[t] is tile t's word, zeroed before the launch.
template <typename Combine>
__device__ unsigned long long look_back(unsigned long long* status, int tile,
                                        unsigned long long aggregate, Combine combine) {
  if (tile == 0) {
    publish(status, kPrefix | aggregate);
    return 0;
  }
  publish(status + tile, kAggregate | aggregate);
  unsigned long long before = 0;
  for (int t = tile - 1;; --t) {
    const unsigned long long w = await_status(status + t);
    before = combine(before, w & kValue);
    if ((w >> 62) == 2) break;
  }
  publish(status + tile, kPrefix | combine(before, aggregate));
  return before;
}

// The tile this block takes: the next number of an atomic counter.
__device__ __forceinline__ int take_tile(unsigned int* counter, int* slot) {
  if (threadIdx.x == 0) *slot = (int)atomicAdd(counter, 1u);
  __syncthreads();
  return *slot;
}

// Block-wide exclusive scans, in thread order, of one count (a sum) and
// one position (a max, 0 the least) a thread; totals of both. blockDim.x a
// multiple of 32, at most 1024; every thread calls it; scratch 2 x 33 ints.
__device__ __forceinline__ void block_scan_sum_max(int c, int l, int* sc, int* sl, int* excl_c,
                                                   int* excl_l, int* tot_c, int* tot_l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int ic = c, il = l;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int tc = __shfl_up_sync(0xffffffffu, ic, o), tl = __shfl_up_sync(0xffffffffu, il, o);
    if (lane >= o) ic += tc, il = max(il, tl);
  }
  int before_l = __shfl_up_sync(0xffffffffu, il, 1);
  if (lane == 0) before_l = 0;
  if (lane == 31) sc[warp] = ic, sl[warp] = il;
  __syncthreads();
  if (warp == 0) {
    const int wc = lane < nwarps ? sc[lane] : 0, wl = lane < nwarps ? sl[lane] : 0;
    int jc = wc, jl = wl;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int tc = __shfl_up_sync(0xffffffffu, jc, o), tl = __shfl_up_sync(0xffffffffu, jl, o);
      if (lane >= o) jc += tc, jl = max(jl, tl);
    }
    const int prev_l = __shfl_up_sync(0xffffffffu, jl, 1);
    sc[lane] = jc - wc;
    sl[lane] = lane ? prev_l : 0;
    if (lane == 31) sc[32] = jc, sl[32] = jl;
  }
  __syncthreads();
  *excl_c = sc[warp] + ic - c;
  *excl_l = max(sl[warp], before_l);
  *tot_c = sc[32];
  *tot_l = sl[32];
  __syncthreads();  // scratch is rewritten by the next call
}

// Copy blocks: n 32-bit units src -> dst, grid-strided over the blocks
// from `first` on.
__device__ __forceinline__ void copy_units(uint32_t* __restrict__ dst, const uint32_t* __restrict__ src,
                                           long long n, int first) {
  const long long stride = (long long)(gridDim.x - first) * blockDim.x;
  for (long long i = (long long)(blockIdx.x - first) * blockDim.x + threadIdx.x; i < n; i += stride) {
    dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    container_write_kernel(const uint32_t* __restrict__ states, const uint16_t* __restrict__ words,
                           const int* __restrict__ escs, const bool* __restrict__ safe, uint32_t n,
                           uint32_t kflags, int K, long long nw, long long ne, int tiles,
                           unsigned long long* __restrict__ scratch, uint8_t* __restrict__ out) {
  uint8_t* const img = out + 8;  // bytes 0-7: the total
  const long long words_at = kHeader + 4ll * K, esc_at = words_at + 2 * nw;
  if ((int)blockIdx.x >= tiles) {  // copy blocks
    const int first = tiles;
    if ((int)blockIdx.x == first && threadIdx.x == 0) {
      uint32_t* const h = reinterpret_cast<uint32_t*>(img);
      h[0] = kMagic;
      h[1] = n;
      h[2] = kflags | ((kflags & kSortedFlag) && *safe ? kSafeFlag : 0u);
      h[3] = (uint32_t)ne;
      h[4] = (uint32_t)nw;
      if (ne == 0) *reinterpret_cast<long long*>(out) = esc_at;
      if (nw & 1) reinterpret_cast<uint16_t*>(img + words_at)[nw - 1] = words[nw - 1];
    }
    copy_units(reinterpret_cast<uint32_t*>(img + kHeader), states, K, first);
    // words: two u16 loads, one u32 store (the image's words are 4-aligned)
    uint32_t* const wdst = reinterpret_cast<uint32_t*>(img + words_at);
    const long long pairs = nw / 2, stride = (long long)(gridDim.x - first) * blockDim.x;
    for (long long i = (long long)(blockIdx.x - first) * blockDim.x + threadIdx.x; i < pairs;
         i += stride) {
      wdst[i] = (uint32_t)words[2 * i] | ((uint32_t)words[2 * i + 1] << 16);
    }
    return;
  }

  __shared__ int scratch_scan[33];
  __shared__ int slot;
  __shared__ unsigned long long before_s;
  const int tile = take_tile(reinterpret_cast<unsigned int*>(scratch), &slot);
  unsigned long long* const status = scratch + 1;
  const long long i0 = tile * kWriteTile + (long long)threadIdx.x * kWriteEscapes;
  int v[kWriteEscapes];
  if (i0 + kWriteEscapes <= ne && !(reinterpret_cast<uintptr_t>(escs) & 15)) {
    const int4 q = *reinterpret_cast<const int4*>(escs + i0);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < kWriteEscapes; ++e) v[e] = i0 + e < ne ? escs[i0 + e] : 0;
  }
  uint32_t u[kWriteEscapes];
  int len[kWriteEscapes], sum = 0;
#pragma unroll
  for (int e = 0; e < kWriteEscapes; ++e) {
    u[e] = ((uint32_t)v[e] << 1) ^ (uint32_t)(v[e] >> 31);
    len[e] = i0 + e < ne ? 1 + (u[e] >= (1u << 7)) + (u[e] >= (1u << 14)) + (u[e] >= (1u << 21)) +
                               (u[e] >= (1u << 28))
                         : 0;
    sum += len[e];
  }
  int total;
  const int excl = cra5::block_exclusive_scan(sum, scratch_scan, &total);
  if (threadIdx.x == 0) {
    before_s = look_back(status, tile, (unsigned long long)total,
                         [](unsigned long long a, unsigned long long b) { return a + b; });
    if (tile == tiles - 1) *reinterpret_cast<long long*>(out) = esc_at + (long long)before_s + total;
  }
  __syncthreads();
  uint8_t* p = img + esc_at + (long long)before_s + excl;
#pragma unroll
  for (int e = 0; e < kWriteEscapes; ++e) {
    for (int k = 0; k < len[e]; ++k) {
      *p++ = (uint8_t)(((u[e] >> (7 * k)) & 0x7fu) | (k + 1 < len[e] ? 0x80u : 0u));
    }
  }
}

// K10's status value: the count of terminators in bits 31-61, one past the
// last one's region offset (0: none) in bits 0-30; both below 2^31.
__device__ __forceinline__ unsigned long long pack_read(long long count, long long last) {
  return ((unsigned long long)count << 31) | (unsigned long long)last;
}

__global__ void __launch_bounds__(kThreads)
    container_read_kernel(const uint8_t* __restrict__ img, long long img_len, int K, long long nw,
                          long long ne, int tiles, unsigned long long* __restrict__ scratch,
                          uint32_t* __restrict__ states, uint16_t* __restrict__ words,
                          int* __restrict__ escs) {
  const long long words_at = kHeader + 4ll * K, esc_at = words_at + 2 * nw;
  if ((int)blockIdx.x >= tiles) {  // copy blocks
    const int first = tiles;
    copy_units(states, reinterpret_cast<const uint32_t*>(img + kHeader), K, first);
    copy_units(reinterpret_cast<uint32_t*>(words), reinterpret_cast<const uint32_t*>(img + words_at),
               nw / 2, first);
    if ((nw & 1) && (int)blockIdx.x == first && threadIdx.x == 0) {
      words[nw - 1] = reinterpret_cast<const uint16_t*>(img + words_at)[nw - 1];
    }
    return;
  }

  __shared__ int sc[33], sl[33];
  __shared__ int slot;
  __shared__ unsigned long long before_s;
  const int tile = take_tile(reinterpret_cast<unsigned int*>(scratch), &slot);
  unsigned long long* const status = scratch + 1;
  // this thread's 16 bytes, from the 16-byte boundary at or before the region
  const long long a = (esc_at & ~15ll) + tile * kReadTile + (long long)threadIdx.x * kReadBytes;
  uint32_t w[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};  // past the end: none
  if (a + 16 <= img_len) {
    const uint4 q = *reinterpret_cast<const uint4*>(img + a);
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else {
    for (int j = 0; j < 16 && a + j < img_len; ++j) {
      w[j / 4] = (w[j / 4] & ~(0xffu << (8 * (j % 4)))) | ((uint32_t)img[a + j] << (8 * (j % 4)));
    }
  }
  uint32_t mask = 0;  // bit j: byte a + j ends a varint of the region
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool ends_here = !((w[j / 4] >> (8 * (j % 4))) & 0x80u) && a + j >= esc_at;
    mask |= (uint32_t)ends_here << j;
  }
  const long long at = a - esc_at;  // region offset of the thread's first byte
  const int last = mask ? (int)(at + 31 - __clz(mask)) + 1 : 0;
  int excl_c, excl_l, tot_c, tot_l;
  block_scan_sum_max(__popc(mask), last, sc, sl, &excl_c, &excl_l, &tot_c, &tot_l);
  if (threadIdx.x == 0) {
    before_s = look_back(status, tile, pack_read(tot_c, tot_l),
                         [](unsigned long long x, unsigned long long y) {
                           const unsigned long long lo = (1ull << 31) - 1;
                           return pack_read((long long)((x >> 31) + (y >> 31)),
                                            (long long)max(x & lo, y & lo));
                         });
  }
  __syncthreads();
  const long long before_c = (long long)(before_s >> 31);
  const long long found = before_c + tot_c;  // terminators up to this tile's end
  if (tile == tiles - 1) {  // escapes past the terminators the region holds read 0
    for (long long r = found + threadIdx.x; r < ne; r += kThreads) escs[r] = 0;
  }
  long long r = before_c + excl_c;
  long long s = max((long long)(before_s & ((1ull << 31) - 1)), (long long)excl_l);
  const uint8_t* const region = img + esc_at;
  for (; mask && r < ne; ++r, mask &= mask - 1) {
    const long long e = at + __ffs(mask) - 1;  // this varint's last byte; s its first
    uint64_t u = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (s + k <= e) u |= (uint64_t)(region[s + k] & 0x7fu) << (7 * k);
    }
    const long long v = (u & 1) ? -(long long)(u >> 1) - 1 : (long long)(u >> 1);
    escs[r] = (int)(uint32_t)(unsigned long long)v;
    s = e + 1;
  }
}

// Copy blocks for n 32-bit units: at least kCopyUnits a thread, at most
// kMaxCopyBlocks.
int copy_blocks(long long n) {
  const long long per = (long long)kThreads * kCopyUnits;
  const long long b = (n + per - 1) / per;
  return (int)(b < 1 ? 1 : (b > kMaxCopyBlocks ? kMaxCopyBlocks : b));
}

}  // namespace

// The tiles of K9 (ne escapes) and K10 (an escape region from byte `at` of
// an image of img_len bytes, n_esc > 0); each kernel's scratch holds 1 +
// tiles u64 words.
extern "C" long long cra5_container_write_tiles(long long ne) {
  return (ne + kWriteTile - 1) / kWriteTile;
}

extern "C" long long cra5_container_read_tiles(long long img_len, long long at, long long ne) {
  return ne > 0 ? (img_len - (at & ~15ll) + kReadTile - 1) / kReadTile : 0;
}

// out: 8 + 20 + 4K + 2 nw + 5 ne bytes, 16-byte aligned; bytes 0-7 receive
// the container's size (int64), the container starts at byte 8.
extern "C" int cra5_container_write(const void* states, const void* words, const void* escs,
                                    const void* safe, unsigned n, unsigned kflags, int K,
                                    long long nw, long long ne, void* scratch,
                                    long long scratch_words, void* out, void* stream) {
  const long long cap = 8 + kHeader + 4ll * K + 2 * nw + 5 * ne;
  const long long tiles = cra5_container_write_tiles(ne < 0 ? 0 : ne);
  if (K < 1 || K > (1 << 20) || nw < 0 || ne < 0 || cap >= INT_MAX || scratch_words < 1 + tiles ||
      (reinterpret_cast<uintptr_t>(out) & 15) || (kflags & ((1u << 29) - 1)) != (unsigned)K) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * (1 + tiles), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  container_write_kernel<<<(int)tiles + copy_blocks(K + nw / 2), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)states, (const uint16_t*)words, (const int*)escs, (const bool*)safe, n,
      kflags, K, nw, ne, (int)tiles, (unsigned long long*)scratch, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// img: img_len bytes, 16-byte aligned, holding at least the header, states
// and words; states (K,), words (nw,) 4-byte aligned, escs (ne,).
extern "C" int cra5_container_read(const void* img, long long img_len, int K, long long nw,
                                   long long ne, void* scratch, long long scratch_words,
                                   void* states, void* words, void* escs, void* stream) {
  const long long at = kHeader + 4ll * K + 2 * nw;
  if (K < 1 || K > (1 << 20) || nw < 0 || ne < 0 || img_len >= INT_MAX || img_len < at ||
      (reinterpret_cast<uintptr_t>(img) & 15) || (reinterpret_cast<uintptr_t>(words) & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = cra5_container_read_tiles(img_len, at, ne);
  if (scratch_words < 1 + tiles) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * (1 + tiles), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  container_read_kernel<<<(int)tiles + copy_blocks(K + nw / 2), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)img, img_len, K, nw, ne, (int)tiles, (unsigned long long*)scratch,
      (uint32_t*)states, (uint16_t*)words, (int*)escs);
  return (int)cudaGetLastError();
}
