// K7 perm_expand and K8 perm_dynroll: the two Pallas kernels of the
// permutation probe (profiling/_perm_probe.py, expand_kernel under
// expand :141 and dynroll_kernel under dynroll :160).
//
// K7 replaces a lowering probe of the log-shift word expansion. On the TPU
// every movement was a pltpu.roll, because Mosaic has no vector gather:
// a Kogge-Stone prefix sum of the mask by rolls along the lanes, a second
// one over the row totals, then 13 flat-roll passes built from a lane
// roll and a row fix. Position p's displacement is d[p] = p - rank[p]
// where its mask lane is set (rank: the exclusive count of set lanes
// before p in flat row-major order), else 0; pass b = 1, 2, 4, ... < K
// gives p the value at (p - b) mod K when bit b of d[p] is set, and the
// displacement stays with the position. The same function without a
// barrier between passes: start at q = p and, for b from the highest
// power of two below K down to 1, step q back by b where d[q] has bit b;
// then out[p] = words[q]. Since d[q] <= q, q never passes 0 and the roll
// never wraps. Each output is an independent chain of at most log2 K
// dependent reads of d.
//
// K = R * Kd <= 16384 is a launch-bound size (its bound is the bytes of
// three (R, Kd) int32 arrays, 0.03 us at (8, 1024)), so the design is
// about latency. E blocks of T threads (expand_geometry in
// profiling/perm_probe.py): segment e holds positions e * T .. e * T + T
// - 1. Every block ranks the whole mask: it loads every segment (all loads
// in flight at once), counts each warp's set lanes of each segment by a
// ballot (barrier 1), warp 0 turns the E * 32 counts into prefixes in one
// warp scan (barrier 2; a scan in every warp cost 32 times the shuffles and
// bound the kernel), and every thread writes its positions' d as 16 bits
// (d < 16384) to shared memory (barrier 3). Block e then walks segment e,
// one chain a thread, reading d[q] again only after q moved, and gathers
// words[q] from global memory. Only d lives in shared memory (32 KB at
// most), so no launch needs more than the default 48 KB.
//
// K8 replaces a lowering probe of pltpu.roll with a shift read from SMEM:
// out[r][c] = x[r][(c - s) mod Kd], the shift read on the device, any
// int32 taken modulo Kd as interpret mode does. Bound: bytes; at (8, 1024)
// the launch itself is most of its device time, and what a call costs is
// the wrapper's host time (profiling/perm_probe.py). One element a thread
// with 32-bit index arithmetic, a division only for a shift outside
// [0, Kd): on an H100 this took less device time than 64-bit arithmetic,
// than four elements a thread with 16-byte stores, and than rows staged
// in shared memory with the shift read once a block, which waits at a
// barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxExpand = 16384;  // d fits 16 bits and in 32 KB of shared memory
constexpr int kRollThreads = 256;

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
    perm_expand_kernel(const int* __restrict__ mask, const int* __restrict__ words,
                       int* __restrict__ out, int K) {
  extern __shared__ uint16_t ds[];  // d of every position, K entries
  // set lanes among warp w's 32 positions of segment e at e * 32 + w, then
  // the set lanes before them in flat order
  __shared__ int count[E * 32];
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // segment e holds positions e * T .. e * T + T - 1, thread t the t-th;
  // every load is issued before the first use
  int m[E];
#pragma unroll
  for (int e = 0; e < E; ++e) m[e] = e * T + t < K ? mask[e * T + t] : 0;
  unsigned ballot[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ballot[e] = __ballot_sync(0xffffffffu, m[e] != 0);
    if (lane == 0) count[e * 32 + warp] = __popc(ballot[e]);
  }
  __syncthreads();  // barrier 1

  // warp 0 turns the counts into exclusive prefixes in flat order, lane l
  // taking the E entries from l * E (a warp's own scan of every count
  // costs 32 times the shuffles, and the scans then bound the kernel)
  if (warp == 0) {
    int v[E], sum = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = lane * E + j;
      v[j] = (i & 31) < (T >> 5) ? count[i] : 0;
      sum += v[j];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += x;
    }
    int run = inc - sum;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      count[lane * E + j] = run;
      run += v[j];
    }
  }
  __syncthreads();  // barrier 2

  // rank = the set lanes before this warp's 32 positions of the segment,
  // then those of the lower lanes
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e * T + t;
    const int rank = count[e * 32 + warp] + __popc(ballot[e] & lower);
    if (p < K) ds[p] = ballot[e] >> lane & 1u ? (uint16_t)(p - rank) : (uint16_t)0;
  }
  __syncthreads();  // barrier 3

  // block g walks segment g. d[q] <= q, so a step by b where d[q] has bit
  // b never passes position 0 and the flat roll never wraps; d[q] is read
  // again only after q moved
  const int p = blockIdx.x * T + t;
  if (p >= K) return;
  int q = p;
  uint32_t dq = ds[p];
  for (int b = K > 1 ? 1 << (31 - __clz(K - 1)) : 0; b > 0; b >>= 1) {
    if (dq & b) {
      q -= b;
      dq = ds[q];
    }
  }
  out[p] = words[q];
}

// One element a thread; every thread reads the shift (one broadcast load a
// warp) and divides only for a shift outside [0, Kd).
__global__ void __launch_bounds__(kRollThreads)
    perm_dynroll_kernel(const int* __restrict__ x, const int* __restrict__ shift,
                        int* __restrict__ out, unsigned n, int Kd) {
  const unsigned i = blockIdx.x * kRollThreads + threadIdx.x;
  int s = __ldg(shift);
  if (i >= n) return;
  if ((unsigned)s >= (unsigned)Kd) {
    s %= Kd;
    s += s < 0 ? Kd : 0;
  }
  const int c = (int)(i % (unsigned)Kd);
  out[i] = __ldg(x + (i - c) + (c >= s ? c - s : c - s + Kd));
}

template <int E>
cudaError_t launch_expand(const int* mask, const int* words, int* out, int K, int threads,
                          cudaStream_t stream) {
  perm_expand_kernel<E><<<E, threads, K * sizeof(uint16_t), stream>>>(mask, words, out, K);
  return cudaGetLastError();
}

}  // namespace

// mask, words, out: K = R * Kd int32, contiguous, row-major. per_thread (E,
// the segments and blocks) and threads (T) come from
// profiling/perm_probe.py::expand_geometry(K).
extern "C" int cra5_perm_expand(const void* mask, const void* words, void* out, int K,
                                int per_thread, int threads, void* stream) {
  if (K <= 0 || K > kMaxExpand || threads < 32 || threads > kMaxThreads || threads % 32 ||
      (long long)threads * per_thread < K)
    return (int)cudaErrorInvalidValue;
  const int* m = (const int*)mask;
  const int* w = (const int*)words;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (per_thread) {
    case 1: return (int)launch_expand<1>(m, w, o, K, threads, s);
    case 2: return (int)launch_expand<2>(m, w, o, K, threads, s);
    case 4: return (int)launch_expand<4>(m, w, o, K, threads, s);
    case 8: return (int)launch_expand<8>(m, w, o, K, threads, s);
    case 16: return (int)launch_expand<16>(m, w, o, K, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, out: (R, Kd) int32 contiguous; shift: one int32 on the device.
extern "C" int cra5_perm_dynroll(const void* x, const void* shift, void* out, int R, int Kd,
                                 void* stream) {
  const long long n = (long long)R * Kd;
  if (R <= 0 || Kd <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kRollThreads - 1) / kRollThreads);
  perm_dynroll_kernel<<<blocks, kRollThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)shift, (int*)out, (unsigned)n, Kd);
  return (int)cudaGetLastError();
}
