// K2 and K3: interleaved-lane rANS decode of one stream, on one thread
// block cluster or one cooperative grid.
//
// K2 (wrapper rans_decode_generic, a per-lane cdf row from the (M, K)
// index grid) replaces two TPU kernels of cra5_tpu/coder/rans_pallas.py:
// decode_rowplan_pallas (:368, the channel-broadcast z stream) and the
// generic decode_scan_pallas (:705, any index grid). K3 (wrapper
// rans_decode_sorted; every step of an index-sorted stream spans two rows,
// r0 below `split` and r1 from it on) replaces decode_sorted_pallas (:569).
// The TPU kernels build every lookup from one-hot matmuls and coarse/chunk
// tables because Mosaic has no vector gather; Hopper gathers, so both
// kernels here are one skeleton templated on the row lookup.
//
// Bound. The bytes (indexes, states, words in; values and sentinels out)
// take microseconds at 3.35 TB/s, but the steps are a serial chain: step
// t + 1 needs the word pointer after step t, the sum of every lane's
// refill flag. So the time is M x (one symbol lookup + one scan across all
// lanes + one word read), and the design shortens that chain:
//  - one lane a thread where K allows, the lanes spread over a cluster of
//    up to 8 blocks (K3's 8192 lanes: 8 x 1024 threads); lanes are
//    interleaved, lane = g + j x (threads of the grid) for thread g, so the
//    stores of values and sentinels are coalesced;
//  - the rank of a refilling lane in (step, lane) order from a warp ballot
//    and popc, the warp totals scanned by every warp after ONE block
//    barrier, and the block totals pushed to every rank of the cluster by
//    st.async into DSMEM, each rank waiting on its own mbarrier for them
//    (double-buffered by step parity); a cluster barrier a step, with its
//    release of every earlier store, cost ~0.8-1.4 us a step on an H100;
//  - an O(1) symbol lookup: a slot table of each cdf row bounds a binary
//    search to at most 16 bins on the GC table (usually 0-1 probes) instead
//    of ~12 probes over 3133 entries;
//  - nothing global on the chain: K3 keeps its two current rows with their
//    slots in shared memory, fetches the next pair into a second buffer by
//    bulk copies while the steps before it run (a pair switch is then one
//    mbarrier wait: with a block barrier and 4-byte copies by every thread,
//    switches cost K3 ~0.9 us a step on the y stream), and stages the
//    per-step r0/r1/split and max-value/offset scalars 256 steps at a time;
//    K2 stages the whole table and its slots when they fit (the z stream's
//    EB table) and otherwise reads rows through L1 (a size rule), and
//    prefetches each thread's index rows ahead with cp.async (4-byte copies:
//    a row segment of an arbitrary K is not 16-byte aligned); the word
//    stream comes into a shared-memory ring by bulk copies of 4 KB chunks on
//    an mbarrier each, issued a step ahead (a step reads at most K words,
//    all in [ptr, ptr + K)) by thread 0 after its warp has sent the totals.
// Beyond 8 x 1024 x 4 lanes (K <= 2^20, the format's limit) a cooperative
// grid of co-resident blocks exchanges the block totals through global
// memory behind a grid barrier written here, and reads words from global
// memory: one route for every K, chosen by shape (coder/rans_kernels.py::
// decode_geometry), and a launch the card cannot place fails.
// A word read past the stream's end yields 0, so no read leaves the stream.

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = cra5::hopper;
using cra5::kLaneL;
using cra5::kPrecision;

constexpr int kChunk = 2048;  // words a ring chunk: one 4 KB bulk copy
constexpr int kTile = 256;    // K3: steps of scalars staged at a time
constexpr int kSmemBudget = 224 * 1024;  // dynamic shared memory a block may take

struct Params {
  const int* cdf;        // (ncdfs, L) padded search table, L a multiple of 4
  const int16_t* slots;  // (ncdfs, S) slot table, S = 2^(16 - shift) + 8 (rows padded)
  int ncdfs, L, S, shift;
  const int* idx;                                    // K2: (M, K) cdf rows
  const int* r0s; const int* r1s; const int* splits;  // K3: (M,)
  const int* mv_tab; const int* off_tab;             // (ncdfs,)
  const uint32_t* states;                            // (K,)
  const uint16_t* words;                             // (W,), padded to 8 words
  long long W;
  int M, K;
  int* values;
  uint8_t* sentinel;
  unsigned* sync;     // cooperative: [0] the grid barrier's count, totals from [32]
  int ring_chunks;    // chunks of the word ring; 0: words from global memory
  int table_in_smem;  // K2: the whole table, slots, max values and offsets staged
};

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(hp::smem_addr(dst)), "l"(src), "r"(bytes), "r"(hp::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hp::smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's row for this step: the cdf row and its slots, the row's max
// value (the escape sentinel's bin) and offset.
struct Row {
  const int* row;
  const int16_t* slot;
  int mv, off;
};

// K3's lookup: two rows a step. The rows and slots of the step's pair live
// in one of two buffers; when a pair comes into use, thread 0 fetches the
// next pair of the staged steps into the other buffer with four bulk copies
// on that buffer's mbarrier, so it is in shared memory when its step comes
// (the y stream changes pairs every ~2.6 steps), and a switch costs every
// thread one mbarrier wait, no block barrier. The coder pads cdf rows to 4
// entries and slot rows to 8: 16-byte rows, as bulk copies need.
template <int LPT>
struct SortedLookup {
  static constexpr int kTileInts = 7 * kTile;
  uint8_t* buf;     // two buffers of buffer_bytes: rows r0, r1 ([2][L]), then their slots
  int* rows;        // the buffer in use
  int16_t* slots;
  int* tile;        // [7][kTile]: r0, r1, split, mv0, mv1, off0, off1
  uint64_t* bars;   // [2]: one a buffer
  uint32_t phases;  // bit b: the parity of buffer b's next fetch
  int cur, cur0, cur1, nxt0, nxt1, split, mv0, mv1, off0, off1;

  static __host__ __device__ size_t buffer_bytes(const Params& p) {
    return align16(2 * (size_t)p.L * 4) + align16(2 * (size_t)p.S * 2);
  }

  static size_t smem_bytes(const Params& p, int) {
    return 2 * buffer_bytes(p) + kTileInts * 4 + 2 * sizeof(uint64_t);
  }

  __device__ void init(const Params& p, uint8_t* smem, int) {
    buf = smem;
    tile = reinterpret_cast<int*>(smem + 2 * buffer_bytes(p));
    bars = reinterpret_cast<uint64_t*>(tile + kTileInts);
    if (threadIdx.x == 0) {
      hp::mbar_init(&bars[0], 1);
      hp::mbar_init(&bars[1], 1);
    }
    phases = 0;
    cur = 0;
    cur0 = cur1 = nxt0 = nxt1 = -1;
  }

  // Thread 0: bulk copies of rows r0, r1 and their slots into buffer b.
  __device__ void fetch(const Params& p, int b, int r0, int r1) {
    uint8_t* dst = buf + b * buffer_bytes(p);
    int16_t* sl = reinterpret_cast<int16_t*>(dst + align16(2 * (size_t)p.L * 4));
    const uint32_t row_bytes = p.L * 4, slot_bytes = p.S * 2;
    hp::mbar_arrive_expect_tx(&bars[b], 2 * (row_bytes + slot_bytes));
    bulk_load(dst, p.cdf + (size_t)r0 * p.L, row_bytes, &bars[b]);
    bulk_load(dst + row_bytes, p.cdf + (size_t)r1 * p.L, row_bytes, &bars[b]);
    bulk_load(sl, p.slots + (size_t)r0 * p.S, slot_bytes, &bars[b]);
    bulk_load(sl + p.S, p.slots + (size_t)r1 * p.S, slot_bytes, &bars[b]);
  }

  // Every thread, at the start of step t; the reads of step t - 1 are
  // behind the block barrier of step t - 1, so the tile and the buffer
  // left may be rewritten.
  __device__ void begin_step(const Params& p, int t) {
    const int i = t % kTile;
    if (i == 0) {
      for (int k = threadIdx.x; k < kTile && t + k < p.M; k += blockDim.x) {
        const int r0 = p.r0s[t + k], r1 = p.r1s[t + k];
        tile[k] = r0;
        tile[kTile + k] = r1;
        tile[2 * kTile + k] = p.splits[t + k];
        tile[3 * kTile + k] = p.mv_tab[r0];
        tile[4 * kTile + k] = p.mv_tab[r1];
        tile[5 * kTile + k] = p.off_tab[r0];
        tile[6 * kTile + k] = p.off_tab[r1];
      }
      __syncthreads();
    }
    const int r0 = tile[i], r1 = tile[kTile + i];
    split = tile[2 * kTile + i];
    mv0 = tile[3 * kTile + i];
    mv1 = tile[4 * kTile + i];
    off0 = tile[5 * kTile + i];
    off1 = tile[6 * kTile + i];
    if (r0 != cur0 || r1 != cur1) {  // uniform across the block
      const int b = cur ^ 1;
      if ((r0 != nxt0 || r1 != nxt1) && threadIdx.x == 0) fetch(p, b, r0, r1);  // not prefetched
      hp::mbar_wait(&bars[b], (phases >> b) & 1u);
      phases ^= 1u << b;
      cur = b;
      rows = reinterpret_cast<int*>(buf + b * buffer_bytes(p));
      slots = reinterpret_cast<int16_t*>(buf + b * buffer_bytes(p) + align16(2 * (size_t)p.L * 4));
      cur0 = r0;
      cur1 = r1;
      nxt0 = nxt1 = -1;
      for (int k = i + 1; k < kTile && t + k - i < p.M; ++k) {  // the next pair staged
        const int a = tile[k], c = tile[kTile + k];
        if (a != r0 || c != r1) {
          if (threadIdx.x == 0) fetch(p, b ^ 1, a, c);
          nxt0 = a;
          nxt1 = c;
          break;
        }
      }
    }
  }

  __device__ Row row(const Params& p, int, int, int lane) const {
    return lane < split ? Row{rows, slots, mv0, off0}
                        : Row{rows + p.L, slots + p.S, mv1, off1};
  }

  __device__ void finish() const {}
};

// K2's lookup: each lane's row from the index grid, prefetched kDepth - 1
// steps ahead into a per-thread ring in shared memory by cp.async.
template <int LPT>
struct LanesLookup {
  static constexpr int kDepth = LPT >= 8 ? 2 : 4;
  const int* tab;
  const int16_t* slt;
  const int* mv;
  const int* off;
  int* ring;  // [kDepth][LPT][blockDim.x]

  static size_t table_bytes(const Params& p) {
    return align16((size_t)p.ncdfs * p.L * 4) + align16((size_t)p.ncdfs * p.S * 2) +
           align16((size_t)p.ncdfs * 8);
  }

  static size_t smem_bytes(const Params& p, int threads) {
    return (size_t)kDepth * LPT * threads * 4 + (p.table_in_smem ? table_bytes(p) : 0);
  }

  __device__ void issue(const Params& p, int t, int nt) {
    if (t < p.M) {
      const int g = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int lane = g + j * nt;
        if (lane < p.K)
          cp_async4(ring + ((t % kDepth) * LPT + j) * blockDim.x + threadIdx.x,
                    p.idx + (size_t)t * p.K + lane);
      }
    }
    cp_async_commit();
  }

  __device__ void init(const Params& p, uint8_t* smem, int nt) {
    ring = reinterpret_cast<int*>(smem);
    if (p.table_in_smem) {
      uint8_t* q = smem + (size_t)kDepth * LPT * blockDim.x * 4;
      int* t_ = reinterpret_cast<int*>(q);
      int16_t* s_ = reinterpret_cast<int16_t*>(q + align16((size_t)p.ncdfs * p.L * 4));
      int* m_ = reinterpret_cast<int*>(q + align16((size_t)p.ncdfs * p.L * 4) +
                                       align16((size_t)p.ncdfs * p.S * 2));
      for (int k = threadIdx.x; k < p.ncdfs * p.L; k += blockDim.x) t_[k] = __ldg(p.cdf + k);
      for (int k = threadIdx.x; k < p.ncdfs * p.S; k += blockDim.x) s_[k] = __ldg(p.slots + k);
      for (int k = threadIdx.x; k < p.ncdfs; k += blockDim.x) {
        m_[k] = __ldg(p.mv_tab + k);
        m_[p.ncdfs + k] = __ldg(p.off_tab + k);
      }
      tab = t_;
      slt = s_;
      mv = m_;
      off = m_ + p.ncdfs;
    } else {
      tab = p.cdf;
      slt = p.slots;
      mv = p.mv_tab;
      off = p.off_tab;
    }
    for (int t = 0; t < kDepth - 1; ++t) issue(p, t, nt);
  }

  __device__ void begin_step(const Params& p, int t) {
    issue(p, t + kDepth - 1, gridDim.x * blockDim.x);
    cp_async_wait<kDepth - 1>();  // this thread's copies of step t have landed
  }

  __device__ Row row(const Params& p, int t, int j, int) const {
    const int r = ring[((t % kDepth) * LPT + j) * blockDim.x + threadIdx.x];
    return Row{tab + (size_t)r * p.L, slt + (size_t)r * p.S, mv[r], off[r]};
  }

  __device__ void finish() const { cp_async_wait<0>(); }
};

template <template <int> class Lookup, int LPT, bool kCoop>
__global__ void __launch_bounds__(1024, 1) rans_decode_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int wcnt[2][LPT][32];  // warp refill counts, by step parity
  __shared__ int rtot[2][8][LPT];   // cluster: the block totals of each rank, by step parity
  __shared__ uint64_t rbar[2];      // cluster: completes when every rank's totals landed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int nt = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + tid;
  const int C = kCoop ? 1 : gridDim.x;  // a cluster launch is one cluster: rank = blockIdx.x
  const uint32_t nring = p.ring_chunks;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + align16(8 * (size_t)nring));
  Lookup<LPT> look;
  look.init(p, smem + align16(8 * (size_t)nring) + (size_t)nring * kChunk * 2, nt);

  uint32_t x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) x[j] = g + j * nt < p.K ? p.states[g + j * nt] : kLaneL;

  // the word ring: chunk c of the stream lands in slot c % nring and
  // completes phase c / nring of that slot's mbarrier. Positions and counts
  // fit 32 bits (the wrapper checks W and M x K).
  const uint32_t W = (uint32_t)p.W, Wp = (W + 7u) & ~7u;
  const uint32_t nchunks = nring ? (Wp + kChunk - 1) / kChunk : 0;
  uint32_t issued = 0, issued_slot = 0;
  auto issue_upto = [&](uint32_t limit) {  // thread 0 only
    limit = limit < nchunks ? limit : nchunks;
    for (; issued < limit; ++issued) {
      const uint32_t left = Wp - issued * kChunk;
      const uint32_t bytes = (left < kChunk ? left : kChunk) * 2;
      hp::mbar_arrive_expect_tx(&bars[issued_slot], bytes);
      bulk_load(ring + issued_slot * kChunk, p.words + (size_t)issued * kChunk, bytes,
                &bars[issued_slot]);
      if (++issued_slot == nring) issued_slot = 0;
    }
  };
  if (tid == 0) {
    for (uint32_t s = 0; s < nring; ++s) hp::mbar_init(&bars[s], 1);
    hp::mbar_init(&rbar[0], 1);
    hp::mbar_init(&rbar[1], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  if (C > 1) cra5::cluster_sync();  // every rank's barriers exist before the first totals
  if (tid == 0) issue_upto(nring);

  // ptr: the stream position of the step's first refill; it lies in chunk
  // c0, ring slot s0 of phase parity ph0 (kept without a division)
  uint32_t ptr = 0, c0 = 0, s0 = 0, ph0 = 0;
  for (int t = 0; t < p.M; ++t) {
    look.begin_step(p, t);
    unsigned ballot[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int ln = g + j * nt;
      bool refill = false;
      if (ln < p.K) {
        const Row r = look.row(p, t, j, ln);
        const uint32_t cum = x[j] & 0xffffu;
        const int s = cra5::slot_search(r.row, r.slot, p.shift, cum);
        const uint32_t start = (uint32_t)r.row[s];
        const uint32_t freq = (uint32_t)r.row[s + 1] - start;
        x[j] = freq * (x[j] >> kPrecision) + cum - start;
        const size_t o = (size_t)t * p.K + ln;
        p.values[o] = s + r.off;
        p.sentinel[o] = s == r.mv ? 1 : 0;
        refill = x[j] < kLaneL;
      }
      ballot[j] = __ballot_sync(0xffffffffu, refill);
      if (lane == 0) wcnt[t & 1][j][warp] = __popc(ballot[j]);
    }
    __syncthreads();  // the step's one block barrier

    // offsets: warp totals scanned by every warp for itself, then the block
    // totals of the cluster (pushed to every rank) or of the grid
    int off[LPT], tot[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int v = lane < nwarps ? wcnt[t & 1][j][lane] : 0;
      int inc = v;
      for (int o = 1; o < nwarps; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      off[j] = __shfl_sync(0xffffffffu, inc - v, warp);
      tot[j] = __shfl_sync(0xffffffffu, inc, nwarps - 1);
    }
    if (C > 1) {
      // warp 0 sends this block's totals to every rank (itself included);
      // each rank then waits on its own barrier for all C x LPT of them
      if (tid == 0) hp::mbar_arrive_expect_tx(&rbar[t & 1], C * LPT * 4);
      if (warp == 0 && lane < C * LPT) {
        const int j = lane % LPT;
        int v = tot[0];
#pragma unroll
        for (int jj = 1; jj < LPT; ++jj) v = j == jj ? tot[jj] : v;
        cra5::st_remote(&rtot[t & 1][blockIdx.x][j], lane / LPT, v, &rbar[t & 1]);
      }
    }
    // the word chunks of the next step, once this block has read the last
    // step's (behind the block barrier) and sent its totals
    if (tid == 0 && nring) issue_upto(c0 + nring);
    if (C > 1) {
      cra5::mbar_wait_cluster(&rbar[t & 1], (t >> 1) & 1);
      const int v = lane < C * LPT ? rtot[t & 1][lane % C][lane / C] : 0;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        int pre = 0, all = 0;
        for (int q = 0; q < C; ++q) {
          const int u = __shfl_sync(0xffffffffu, v, j * C + q);
          all += u;
          pre += q < (int)blockIdx.x ? u : 0;
        }
        off[j] += pre;
        tot[j] = all;
      }
    } else if (kCoop && gridDim.x > 1) {
      int* gt = reinterpret_cast<int*>(p.sync + 32) + (t & 1) * gridDim.x * LPT;
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if (tid == j) __stcg(gt + blockIdx.x * LPT + j, tot[j]);
      cra5::grid_sync(p.sync, (unsigned)(t + 1) * gridDim.x);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        int pre = 0, all = 0;
        for (int b = lane; b < (int)gridDim.x; b += 32) {
          const int u = __ldcg(gt + b * LPT + j);
          all += u;
          pre += b < (int)blockIdx.x ? u : 0;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          all += __shfl_xor_sync(0xffffffffu, all, o);
          pre += __shfl_xor_sync(0xffffffffu, pre, o);
        }
        off[j] += pre;
        tot[j] = all;
      }
    }

    uint32_t base = ptr;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (ballot[j] >> lane & 1u) {
        const uint32_t pos = base + off[j] + __popc(ballot[j] & ((1u << lane) - 1u));
        uint32_t w = 0;
        if (pos < W) {
          if (nring) {  // pos < ptr + K: within nring chunks of c0
            uint32_t s = s0 + (pos / kChunk - c0), ph = ph0;
            if (s >= nring) {
              s -= nring;
              ph ^= 1u;
            }
            hp::mbar_wait(&bars[s], ph);
            w = ring[s * kChunk + pos % kChunk];
          } else {
            w = __ldg(p.words + pos);
          }
        }
        x[j] = (x[j] << kPrecision) | w;
      }
      base += tot[j];
    }
    ptr = base;
    if (nring) {
      s0 += ptr / kChunk - c0;
      c0 = ptr / kChunk;
      if (s0 >= nring) {
        s0 -= nring;
        ph0 ^= 1u;
      }
    }
  }

  look.finish();
  if (tid == 0) {  // no bulk copy may still be writing when the block leaves
    for (uint32_t c = issued > nring ? issued - nring : 0; c < issued; ++c)
      hp::mbar_wait(&bars[c % nring], (c / nring) & 1u);
  }
  if (C > 1) cra5::cluster_sync();  // no block leaves while the cluster may still reach it
}

template <template <int> class Lookup, int LPT, bool kCoop>
int launch(Params p, int blocks, int threads, cudaStream_t stream) {
  const auto kernel = rans_decode_kernel<Lookup, LPT, kCoop>;
  p.ring_chunks = kCoop ? 0 : (int)((2ll * p.K + kChunk - 1) / kChunk + 1);
  const size_t fixed = align16(8 * (size_t)p.ring_chunks) + (size_t)p.ring_chunks * kChunk * 2;
  if (p.table_in_smem)  // K2: stage the table where it fits
    p.table_in_smem = fixed + Lookup<LPT>::smem_bytes(p, threads) <= (size_t)kSmemBudget;
  const size_t smem = fixed + Lookup<LPT>::smem_bytes(p, threads);
  if (smem > (size_t)kSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (kCoop) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = 1;
  } else if (blocks > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <template <int> class Lookup>
int dispatch(const Params& p, int blocks, int threads, int lpt, int coop, cudaStream_t s) {
  if (!coop) {
    switch (lpt) {
      case 1: return launch<Lookup, 1, false>(p, blocks, threads, s);
      case 2: return launch<Lookup, 2, false>(p, blocks, threads, s);
      case 4: return launch<Lookup, 4, false>(p, blocks, threads, s);
    }
  } else {
    switch (lpt) {
      case 8: return launch<Lookup, 8, true>(p, blocks, threads, s);
      case 16: return launch<Lookup, 16, true>(p, blocks, threads, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One decode of K lanes over M steps. sorted: K3 (r0s/r1s/splits), else K2
// (idx). The geometry comes from coder/rans_kernels.py::decode_geometry:
// `blocks` blocks of `threads` threads with `lpt` lanes each, one cluster
// of `blocks` (lpt 1, 2 or 4) or, with coop, a cooperative grid (lpt 8 or
// 16) whose `sync` buffer (32 + 2 x blocks x lpt ints) is zeroed. `words`
// holds W words padded to a multiple of 8 and starts 16-byte aligned. Every
// cdf row index must lie in the table: the wrappers check it.
extern "C" int cra5_rans_decode(int sorted, const void* cdf, const void* slots, int ncdfs,
                                int L, int S, const void* idx, const void* r0s, const void* r1s,
                                const void* splits, const void* mv_tab, const void* off_tab,
                                const void* states, const void* words, long long W, int M, int K,
                                int blocks, int threads, int lpt, int coop, void* sync,
                                void* values, void* sentinel, void* stream) {
  int bits = 0;
  while ((1 << (bits + 1)) + 8 <= S) ++bits;
  if ((1 << bits) + 8 != S || L % 4 || bits > 16 || threads % 32 || threads > 1024 ||
      (long long)blocks * threads * lpt < K || (coop && sync == nullptr) ||
      (!coop && blocks > 8))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.cdf = (const int*)cdf;
  p.slots = (const int16_t*)slots;
  p.ncdfs = ncdfs;
  p.L = L;
  p.S = S;
  p.shift = kPrecision - bits;
  p.idx = (const int*)idx;
  p.r0s = (const int*)r0s;
  p.r1s = (const int*)r1s;
  p.splits = (const int*)splits;
  p.mv_tab = (const int*)mv_tab;
  p.off_tab = (const int*)off_tab;
  p.states = (const uint32_t*)states;
  p.words = (const uint16_t*)words;
  p.W = W;
  p.M = M;
  p.K = K;
  p.values = (int*)values;
  p.sentinel = (uint8_t*)sentinel;
  p.sync = (unsigned*)sync;
  p.table_in_smem = !sorted;
  cudaStream_t s = (cudaStream_t)stream;
  return sorted ? dispatch<SortedLookup>(p, blocks, threads, lpt, coop, s)
                : dispatch<LanesLookup>(p, blocks, threads, lpt, coop, s);
}
