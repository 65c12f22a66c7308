// The per-step synchronisation costs a lane decode (K2/K3) can choose from,
// and the single-block K3 that csrc/rans_decode.cu replaced, with its
// full-row binary search swapped for the slot lookup: the measurements
// behind csrc/rans_decode.cu's design. A probe built by
// profiling/decode_sync_probe.py; no path of the port runs it.
#include "../../csrc/common.cuh"
#include "../../csrc/hopper.cuh"

namespace {

namespace hp = cra5::hopper;

// M steps of one lane a thread: a warp ballot of data-dependent flags, one
// block barrier, every warp scanning the warp totals; then, over a cluster
// of gridDim.x blocks, mode 1: one cluster barrier and a DSMEM read of every
// rank's total, mode 2: every rank's total pushed by st.async, each rank
// waiting on its own mbarrier. Totals and counts double-buffered by parity.
__global__ void __launch_bounds__(1024) sync_steps(int M, int mode, int* out) {
  __shared__ int wcnt[2][32];
  __shared__ int btot[2];
  __shared__ int rtot[2][8];
  __shared__ uint64_t rbar[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int C = gridDim.x, rank = blockIdx.x;
  if (threadIdx.x == 0) {
    hp::mbar_init(&rbar[0], 1);
    hp::mbar_init(&rbar[1], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  if (mode > 0) cra5::cluster_sync();
  uint32_t x = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + 1u;
  uint32_t ptr = 0;
  for (int t = 0; t < M; ++t) {
    x = x * 1664525u + 1013904223u;
    const unsigned b = __ballot_sync(0xffffffffu, (x >> 28) & 1u);
    if (lane == 0) wcnt[t & 1][warp] = __popc(b);
    __syncthreads();
    const int v = lane < nw ? wcnt[t & 1][lane] : 0;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    const int woff = __shfl_sync(0xffffffffu, inc - v, warp);
    const int bt = __shfl_sync(0xffffffffu, inc, 31);
    int pre = 0, total = bt;
    if (mode > 0) {
      int r = 0;
      if (mode == 1) {
        if (threadIdx.x == 0) btot[t & 1] = bt;
        cra5::cluster_sync();
        r = lane < C ? cra5::ld_cluster(&btot[t & 1], lane) : 0;
      } else {
        if (threadIdx.x == 0) hp::mbar_arrive_expect_tx(&rbar[t & 1], C * 4);
        if (warp == 0 && lane < C) cra5::st_remote(&rtot[t & 1][rank], lane, bt, &rbar[t & 1]);
        cra5::mbar_wait_cluster(&rbar[t & 1], (t >> 1) & 1);
        r = lane < C ? rtot[t & 1][lane] : 0;
      }
      total = 0;
      for (int q = 0; q < C; ++q) {
        const int u = __shfl_sync(0xffffffffu, r, q);
        total += u;
        pre += q < rank ? u : 0;
      }
    }
    x ^= ptr + pre + woff + __popc(b & ((1u << lane) - 1u));
    ptr += total;
  }
  if (mode > 0) cra5::cluster_sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = (int)ptr;
  out[1 + blockIdx.x * blockDim.x + threadIdx.x] = (int)x;
}

// The single-block K3 that csrc/rans_decode.cu replaced (LPT consecutive
// lanes a thread, a three-barrier block scan, words from global memory),
// with the slot lookup.
template <int LPT>
__global__ void __launch_bounds__(1024) k3_slot_kernel(
    const int* __restrict__ cdf, int L, const int16_t* __restrict__ slots, int S, int shift,
    const int* __restrict__ r0s, const int* __restrict__ r1s, const int* __restrict__ splits,
    const int* __restrict__ mv_tab, const int* __restrict__ off_tab,
    const uint32_t* __restrict__ states, const uint16_t* __restrict__ words, long long W, int M,
    int K, int* __restrict__ values, uint8_t* __restrict__ sentinel) {
  extern __shared__ int rows[];  // [2 * L] rows, then [2 * S] int16 slots
  int16_t* srow = reinterpret_cast<int16_t*>(rows + 2 * L);
  __shared__ int scratch[33];
  const int base = threadIdx.x * LPT;
  uint32_t x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) x[j] = base + j < K ? states[base + j] : cra5::kLaneL;
  long long ptr = 0;
  int cur0 = -1, cur1 = -1;
  for (int t = 0; t < M; ++t) {
    const int r0 = __ldg(r0s + t), r1 = __ldg(r1s + t), split = __ldg(splits + t);
    if (r0 != cur0 || r1 != cur1) {
      __syncthreads();
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        rows[i] = __ldg(cdf + (size_t)r0 * L + i);
        rows[L + i] = __ldg(cdf + (size_t)r1 * L + i);
      }
      for (int i = threadIdx.x; i < S; i += blockDim.x) {
        srow[i] = slots[(size_t)r0 * S + i];
        srow[S + i] = slots[(size_t)r1 * S + i];
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
        const int s = cra5::slot_search(row, first ? srow : srow + S, shift, cum);
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

}  // namespace

// Mean ms of `iters` launches of sync_steps on `blocks` blocks of 1024
// threads (one cluster in modes 1 and 2), after one warm-up launch.
extern "C" int probe_sync(int M, int blocks, int mode, int iters, void* out, float* ms) {
  if (mode == 0 && blocks != 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(1024);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = mode > 0 ? 1 : 0;  // modes 1 and 2 run as a cluster, of one block too
  cudaError_t e = cudaLaunchKernelEx(&cfg, sync_steps, M, mode, (int*)out);
  if (e != cudaSuccess) return (int)e;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < iters; ++i) cudaLaunchKernelEx(&cfg, sync_steps, M, mode, (int*)out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(ms, a, b);
  *ms /= iters;
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return (int)cudaGetLastError();
}

extern "C" int probe_k3_slot(const void* cdf, int L, const void* slots, int S, int shift,
                             const void* r0s, const void* r1s, const void* splits,
                             const void* mv_tab, const void* off_tab, const void* states,
                             const void* words, long long W, int M, int K, void* values,
                             void* sentinel, void* stream) {
  int lpt = 1;
  while (K > 1024 * lpt) lpt *= 2;
  const int threads = ((K + lpt - 1) / lpt + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)L * 4 + 2 * (size_t)S * 2;
  cudaStream_t s = (cudaStream_t)stream;
#define K3S(N)                                                                             \
  do {                                                                                     \
    cudaError_t e = cudaFuncSetAttribute(k3_slot_kernel<N>,                                \
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                                         (int)smem);                                       \
    if (e != cudaSuccess) return (int)e;                                                   \
    k3_slot_kernel<N><<<1, threads, smem, s>>>(                                            \
        (const int*)cdf, L, (const int16_t*)slots, S, shift, (const int*)r0s,              \
        (const int*)r1s, (const int*)splits, (const int*)mv_tab, (const int*)off_tab,      \
        (const uint32_t*)states, (const uint16_t*)words, W, M, K, (int*)values,            \
        (uint8_t*)sentinel);                                                               \
  } while (0)
  switch (lpt) {
    case 1: K3S(1); break;
    case 2: K3S(2); break;
    case 4: K3S(4); break;
    case 8: K3S(8); break;
    case 16: K3S(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K3S
  return (int)cudaGetLastError();
}
