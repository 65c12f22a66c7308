// Shared device helpers for the lane-rANS kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cra5 {

constexpr uint32_t kLaneL = 1u << 16;  // lower bound of a 32-bit lane state
constexpr int kPrecision = 16;

// Block-wide exclusive prefix sum of one int per thread, in thread order.
// blockDim.x must be a multiple of 32 and at most 1024. `scratch` holds 33
// ints of shared memory; *total receives the block sum. Every thread of
// the block must call it; it synchronises the block three times.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? scratch[lane] : 0;
    int winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += t;
    }
    if (lane < nwarps) scratch[lane] = winc - w;  // exclusive warp offsets
    if (lane == 31) scratch[32] = winc;           // block total
  }
  __syncthreads();
  const int excl = scratch[warp] + inc - v;
  *total = scratch[32];
  __syncthreads();  // scratch is rewritten by the next call
  return excl;
}

// Largest s in [lo, hi] with row[s] <= cum, given row[lo] <= cum. Rows are
// nondecreasing and padded with 2**16 past their length, and cum < 2**16,
// so s + 1 < L and row[s + 1] is the bin's upper edge.
__device__ __forceinline__ int cdf_search(const int* row, int lo, int hi, uint32_t cum) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((uint32_t)row[mid] <= cum) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The bin of cum in a cdf row through its slot table: slot[c] is the
// largest s with row[s] <= min(c << shift, 2**16 - 1), so the bin lies in
// [slot[c], slot[c + 1]] for c = cum >> shift (at most 16 bins on the GC
// table at shift 4, usually one).
__device__ __forceinline__ int slot_search(const int* row, const int16_t* slot, int shift,
                                           uint32_t cum) {
  const int c = (int)(cum >> shift);
  return cdf_search(row, slot[c], slot[c + 1], cum);
}

// ------------------------------------------------------------ clusters (sm_90)
// Every thread of every block of the cluster arrives, then waits: the
// shared-memory writes before it are visible to the whole cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The int at p in the shared memory of the cluster's block `rank` (DSMEM).
__device__ __forceinline__ int ld_cluster(const int* p, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// The shared::cluster address of `p` (a shared variable of this block) in
// the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return a;
}

// Stores v at `dst` in the shared memory of the cluster's block `rank`, and
// counts its 4 bytes on that block's mbarrier `bar` (st.async: the receiver
// waits on its own barrier; no cluster-wide barrier).
__device__ __forceinline__ void st_remote(int* dst, uint32_t rank, int v, uint64_t* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n" ::"r"(
                   cluster_addr(dst, rank)),
               "r"(v), "r"(cluster_addr(bar, rank))
               : "memory");
}

// Waits for the phase of parity `parity` of a barrier that blocks of the
// cluster complete, acquiring their writes; traps after ~2^34 clocks.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// A barrier over every block of a cooperative launch: `count` (zeroed
// before the launch) reaches `target` = (calls so far) x gridDim.x. The
// global writes before it are visible after it to loads that bypass L1
// (__ldcg). A barrier that never completes traps after ~2^34 clocks.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const long long t0 = clock64();
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      if (clock64() - t0 > (1ll << 34)) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
}

}  // namespace cra5
