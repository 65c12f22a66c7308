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

// Largest s in [0, L-1] with row[s] <= cum. Rows are nondecreasing and
// padded with 2**16 past their length, and cum < 2**16, so s + 1 < L and
// row[s + 1] is the bin's upper edge.
__device__ __forceinline__ int cdf_search(const int* row, int L, uint32_t cum) {
  int lo = 0, hi = L - 1;
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

}  // namespace cra5
