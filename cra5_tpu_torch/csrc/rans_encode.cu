// K1 rans_encode: interleaved-lane rANS encode over an (M, K) step-major grid.
//
// Replaces cra5_tpu/coder/rans_pallas.py:encode_scan_pallas. Lanes are
// independent, so each thread owns one lane and walks the M steps in
// reverse (LIFO) order. The quotient uses the hardware's exact u32 division,
// which replaces the TPU kernel's f32 reciprocal with its Newton step and
// +-1 correction. Bound: memory, 11 bytes per symbol (starts and freqs read,
// emit and the word written), and in practice the latency of the M-step
// serial chain per lane; reads and writes are coalesced across lanes.
// A padding step (start 0, freq 2**16) is an exact identity: no emit,
// q = x >> 16, r = x & 0xffff.

#include "common.cuh"

namespace {

__global__ void rans_encode_kernel(const int* __restrict__ starts,
                                   const int* __restrict__ freqs, int M, int K,
                                   uint32_t* __restrict__ states,
                                   uint8_t* __restrict__ emit,
                                   uint16_t* __restrict__ words) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  uint32_t x = cra5::kLaneL;
#pragma unroll 4
  for (int t = M - 1; t >= 0; --t) {
    const size_t o = (size_t)t * K + lane;
    const uint32_t f = (uint32_t)__ldg(freqs + o);
    const uint32_t s = (uint32_t)__ldg(starts + o);
    const bool e = (x >> cra5::kPrecision) >= f;
    words[o] = (uint16_t)(x & 0xffffu);
    emit[o] = e ? 1 : 0;
    if (e) x >>= cra5::kPrecision;
    const uint32_t q = x / f;
    const uint32_t r = x - q * f;
    x = (q << cra5::kPrecision) + r + s;
  }
  states[lane] = x;
}

}  // namespace

extern "C" int cra5_rans_encode(const void* starts, const void* freqs, int M,
                                int K, void* states, void* emit, void* words,
                                void* stream) {
  const int threads = 128;
  const int blocks = (K + threads - 1) / threads;
  rans_encode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)freqs, M, K, (uint32_t*)states,
      (uint8_t*)emit, (uint16_t*)words);
  return (int)cudaGetLastError();
}
