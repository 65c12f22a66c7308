// K2 rans_decode_lanes and K3 rans_decode_sorted: interleaved-lane rANS
// decode of one stream by one thread block.
//
// K2 (wrapper rans_decode_generic) replaces two gather-free TPU kernels
// from cra5_tpu/coder/rans_pallas.py: decode_rowplan_pallas (the
// channel-broadcast z stream) and the generic decode_scan_pallas (:705; any
// index grid). K3 replaces decode_sorted_pallas.
// The TPU kernels build every lookup from one-hot matmuls and coarse/chunk
// tables because Mosaic has no vector gather; Hopper has gathers, so each
// lane binary-searches its cdf row directly, and the one K2 body covers
// both the row-plan and the generic case. The steps are a serial chain:
// step t+1 needs the word pointer after step t, which is the block-wide
// sum of the refill flags.
// So one block decodes the whole stream; thread i owns the LPT consecutive
// lanes [i*LPT, (i+1)*LPT), and an exclusive scan over threads gives every
// refilling lane its rank in (step, lane) order. The bound is the latency
// of the M steps (search, state update, three block barriers), not bytes.
// A word read past the stream's end yields 0, so no read leaves the buffer.

#include "common.cuh"

namespace {

// K2: each lane reads its cdf row from the (M, K) index grid. The table is
// small and stays in L1.
template <int LPT>
__global__ void __launch_bounds__(1024) rans_decode_lanes_kernel(
    const int* __restrict__ cdf, int L, const int* __restrict__ idx,
    const int* __restrict__ mv_tab, const int* __restrict__ off_tab,
    const uint32_t* __restrict__ states, const uint16_t* __restrict__ words,
    long long W, int M, int K, int* __restrict__ values,
    uint8_t* __restrict__ sentinel) {
  __shared__ int scratch[33];
  const int base = threadIdx.x * LPT;
  uint32_t x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) x[j] = base + j < K ? states[base + j] : cra5::kLaneL;
  long long ptr = 0;
  for (int t = 0; t < M; ++t) {
    unsigned refill = 0;
    int count = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int lane = base + j;
      if (lane < K) {
        const size_t o = (size_t)t * K + lane;
        const int r = __ldg(idx + o);
        const int* row = cdf + (size_t)r * L;
        const uint32_t cum = x[j] & 0xffffu;
        const int s = cra5::cdf_search(row, L, cum);
        const uint32_t start = (uint32_t)__ldg(row + s);
        const uint32_t freq = (uint32_t)__ldg(row + s + 1) - start;
        x[j] = freq * (x[j] >> cra5::kPrecision) + cum - start;
        values[o] = s + __ldg(off_tab + r);
        sentinel[o] = s == __ldg(mv_tab + r) ? 1 : 0;
        if (x[j] < cra5::kLaneL) {
          refill |= 1u << j;
          ++count;
        }
      }
    }
    int total;
    long long pos = ptr + cra5::block_exclusive_scan(count, scratch, &total);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (refill >> j & 1u) {
        const uint32_t w = pos < W ? (uint32_t)words[pos] : 0u;
        x[j] = (x[j] << cra5::kPrecision) | w;
        ++pos;
      }
    }
    ptr += total;
  }
}

// K3: an index-sorted step spans at most two cdf rows, r0 for the lanes
// below `split` and r1 for the rest. Both rows are staged in shared memory
// whenever they change (sorted streams change rows a few dozen times).
template <int LPT>
__global__ void __launch_bounds__(1024) rans_decode_sorted_kernel(
    const int* __restrict__ cdf, int L, const int* __restrict__ r0s,
    const int* __restrict__ r1s, const int* __restrict__ splits,
    const int* __restrict__ mv_tab, const int* __restrict__ off_tab,
    const uint32_t* __restrict__ states, const uint16_t* __restrict__ words,
    long long W, int M, int K, int* __restrict__ values,
    uint8_t* __restrict__ sentinel) {
  extern __shared__ int rows[];  // [2 * L]: row r0, then row r1
  __shared__ int scratch[33];
  const int base = threadIdx.x * LPT;
  uint32_t x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) x[j] = base + j < K ? states[base + j] : cra5::kLaneL;
  long long ptr = 0;
  int cur0 = -1, cur1 = -1;
  for (int t = 0; t < M; ++t) {
    const int r0 = __ldg(r0s + t);
    const int r1 = __ldg(r1s + t);
    const int split = __ldg(splits + t);
    if (r0 != cur0 || r1 != cur1) {  // uniform across the block
      __syncthreads();
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        rows[i] = __ldg(cdf + (size_t)r0 * L + i);
        rows[L + i] = __ldg(cdf + (size_t)r1 * L + i);
      }
      __syncthreads();
      cur0 = r0;
      cur1 = r1;
    }
    const int mv0 = __ldg(mv_tab + r0), mv1 = __ldg(mv_tab + r1);
    const int off0 = __ldg(off_tab + r0), off1 = __ldg(off_tab + r1);
    unsigned refill = 0;
    int count = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int lane = base + j;
      if (lane < K) {
        const bool first = lane < split;
        const int* row = first ? rows : rows + L;
        const uint32_t cum = x[j] & 0xffffu;
        const int s = cra5::cdf_search(row, L, cum);
        const uint32_t start = (uint32_t)row[s];
        const uint32_t freq = (uint32_t)row[s + 1] - start;
        x[j] = freq * (x[j] >> cra5::kPrecision) + cum - start;
        const size_t o = (size_t)t * K + lane;
        values[o] = s + (first ? off0 : off1);
        sentinel[o] = s == (first ? mv0 : mv1) ? 1 : 0;
        if (x[j] < cra5::kLaneL) {
          refill |= 1u << j;
          ++count;
        }
      }
    }
    int total;
    long long pos = ptr + cra5::block_exclusive_scan(count, scratch, &total);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (refill >> j & 1u) {
        const uint32_t w = pos < W ? (uint32_t)words[pos] : 0u;
        x[j] = (x[j] << cra5::kPrecision) | w;
        ++pos;
      }
    }
    ptr += total;
  }
}

int threads_for(int K, int lpt) {
  const int t = (K + lpt - 1) / lpt;
  return (t + 31) / 32 * 32;
}

}  // namespace

// lpt: lanes per thread, one of 1, 2, 4, 8, 16, with K <= 1024 * lpt.
// Every cdf row index must lie in the table: the wrappers check it.
extern "C" int cra5_rans_decode_lanes(const void* cdf, int L,
                                      const void* idx, const void* mv_tab,
                                      const void* off_tab, const void* states,
                                      const void* words, long long W, int M,
                                      int K, int lpt, void* values,
                                      void* sentinel, void* stream) {
  const dim3 block(threads_for(K, lpt));
  cudaStream_t s = (cudaStream_t)stream;
#define CRA5_LANES(N)                                                        \
  rans_decode_lanes_kernel<N><<<1, block, 0, s>>>(                           \
      (const int*)cdf, L, (const int*)idx, (const int*)mv_tab,                 \
      (const int*)off_tab, (const uint32_t*)states, (const uint16_t*)words, W, \
      M, K, (int*)values, (uint8_t*)sentinel)
  switch (lpt) {
    case 1: CRA5_LANES(1); break;
    case 2: CRA5_LANES(2); break;
    case 4: CRA5_LANES(4); break;
    case 8: CRA5_LANES(8); break;
    case 16: CRA5_LANES(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CRA5_LANES
  return (int)cudaGetLastError();
}

extern "C" int cra5_rans_decode_sorted(const void* cdf, int L,
                                       const void* r0s, const void* r1s,
                                       const void* splits, const void* mv_tab,
                                       const void* off_tab, const void* states,
                                       const void* words, long long W, int M,
                                       int K, int lpt, void* values,
                                       void* sentinel, void* stream) {
  const dim3 block(threads_for(K, lpt));
  const size_t smem = 2 * (size_t)L * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
#define CRA5_SORTED(N)                                                          \
  do {                                                                          \
    if (smem > 48 * 1024) {                                                     \
      cudaError_t e = cudaFuncSetAttribute(                                     \
          rans_decode_sorted_kernel<N>,                                         \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);              \
      if (e != cudaSuccess) return (int)e;                                      \
    }                                                                           \
    rans_decode_sorted_kernel<N><<<1, block, smem, s>>>(                        \
        (const int*)cdf, L, (const int*)r0s, (const int*)r1s,                   \
        (const int*)splits, (const int*)mv_tab, (const int*)off_tab,            \
        (const uint32_t*)states, (const uint16_t*)words, W, M, K, (int*)values, \
        (uint8_t*)sentinel);                                                    \
  } while (0)
  switch (lpt) {
    case 1: CRA5_SORTED(1); break;
    case 2: CRA5_SORTED(2); break;
    case 4: CRA5_SORTED(4); break;
    case 8: CRA5_SORTED(8); break;
    case 16: CRA5_SORTED(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CRA5_SORTED
  return (int)cudaGetLastError();
}
