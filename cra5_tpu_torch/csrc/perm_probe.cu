// K7 perm_expand and K8 perm_dynroll: the two Pallas kernels of the
// permutation probe (profiling/_perm_probe.py, expand_kernel under
// expand :141 and dynroll_kernel under dynroll :160).
//
// K7 replaces a lowering probe of the log-shift word expansion. On the TPU
// every movement was a pltpu.roll, because Mosaic has no vector gather:
// a Kogge-Stone prefix sum of the mask by rolls along the lanes, a second
// one over the row totals, then 13 flat-roll passes built from a lane
// roll and a row fix. Here one block holds the whole (R, Kd) grid: the
// words are staged in shared memory, the rank of every set mask lane is a
// block-wide exclusive scan in flat row-major order (thread t owns flat
// positions e * blockDim + t, so the scans run segment by segment and
// every shared-memory access is conflict-free), and each pass reads its
// source at p - b (mod K) straight from shared memory, then writes back
// after a barrier. Each position's pending displacement stays with the
// position, not with the word, as in the TPU kernel. K = R * Kd <= 16384
// (64 KiB of shared memory, 16 positions a thread). Bound: bytes (three
// (R, Kd) int32 arrays); at (8, 1024) a launch is far longer than the
// 0.03 us of its bytes, so the kernel is launch-bound.
//
// K8 replaces a lowering probe of pltpu.roll with a shift read from SMEM:
// out[r][c] = x[r][(c - s) mod Kd], the shift read on the device, any
// int32 taken modulo Kd as interpret mode does. One thread an element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 16;  // K <= 16384

__global__ void __launch_bounds__(kMaxThreads)
    perm_expand_kernel(const int* __restrict__ mask, const int* __restrict__ words,
                       int* __restrict__ out, int K) {
  extern __shared__ int smem[];  // buf[K], then 33 ints of scan scratch
  int* buf = smem;
  int* scratch = smem + K;
  const int T = blockDim.x;
  const int t = threadIdx.x;

  int rem[kMaxPerThread];  // pending displacement of each owned position
  int base = 0;            // set mask lanes before this segment
#pragma unroll
  for (int e = 0; e < kMaxPerThread; ++e) {
    rem[e] = 0;
    if (e * T >= K) continue;  // uniform across the block
    const int p = e * T + t;
    const int mf = p < K && mask[p] != 0;
    if (p < K) buf[p] = words[p];
    int total;
    const int rank = base + cra5::block_exclusive_scan(mf, scratch, &total);
    rem[e] = mf ? p - rank : 0;
    base += total;
  }
  __syncthreads();

  for (int b = 1; b < K; b <<= 1) {
    int nv[kMaxPerThread];
#pragma unroll
    for (int e = 0; e < kMaxPerThread; ++e) {
      const int p = e * T + t;
      nv[e] = 0;
      if (p < K) {
        const int src = p >= b ? p - b : p - b + K;
        nv[e] = (rem[e] & b) ? buf[src] : buf[p];
      }
    }
    __syncthreads();  // every read of this pass is done
#pragma unroll
    for (int e = 0; e < kMaxPerThread; ++e) {
      const int p = e * T + t;
      if (p < K) {
        buf[p] = nv[e];
        if (rem[e] & b) rem[e] -= b;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < kMaxPerThread; ++e) {
    const int p = e * T + t;
    if (p < K) out[p] = buf[p];
  }
}

__global__ void perm_dynroll_kernel(const int* __restrict__ x, const int* __restrict__ shift,
                                    int* __restrict__ out, int R, int Kd) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * Kd) return;
  int s = shift[0] % Kd;
  if (s < 0) s += Kd;
  const int c = (int)(i % Kd);
  const int src = c >= s ? c - s : c - s + Kd;
  out[i] = x[i - c + src];
}

}  // namespace

// mask, words, out: K = R * Kd int32, contiguous, row-major.
extern "C" int cra5_perm_expand(const void* mask, const void* words, void* out, int K,
                                void* stream) {
  if (K <= 0 || K > kMaxThreads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  const int threads = K < kMaxThreads ? (K + 31) / 32 * 32 : kMaxThreads;
  const int smem = (K + 33) * (int)sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        perm_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  perm_expand_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const int*)mask, (const int*)words, (int*)out, K);
  return (int)cudaGetLastError();
}

// x, out: (R, Kd) int32 contiguous; shift: one int32 on the device.
extern "C" int cra5_perm_dynroll(const void* x, const void* shift, void* out, int R, int Kd,
                                 void* stream) {
  const long long n = (long long)R * Kd;
  if (R <= 0 || Kd <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  perm_dynroll_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)shift, (int*)out, R, Kd);
  return (int)cudaGetLastError();
}
