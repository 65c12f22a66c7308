// The serial chain of the lane encode K1 (csrc/rans_encode.cu) alone: each
// lane walks M steps of K1's arithmetic (the emit compare and shift, the
// quotient as mulhi by an integer reciprocal with two corrections side by
// side, the push) on freqs and starts made in registers from the lane and
// step, off the chain, with no loads and no stores but the final states.
// So its time a step is one step's dependent latency: the floor under K1's
// time, which chip_smoke.py prints beside K1. Its states are not K1's; no
// path of the port runs it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kLaneL = 1u << 16;
constexpr int kPrecision = 16;

// A lane's freq in [1, 2^15] and start at step t, made in registers.
__device__ __forceinline__ uint32_t reg_freq(int lane, int t) {
  return 1u + (((uint32_t)lane * 2654435761u ^ (uint32_t)t * 40503u) >> 17);
}
__device__ __forceinline__ uint32_t reg_start(int lane, int t) {
  return ((uint32_t)lane + (uint32_t)t) & 1023u;
}

__global__ void chain_only(int M, int K, uint32_t* __restrict__ states) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K) return;
  uint32_t x = kLaneL;
#pragma unroll 16
  for (int t = M - 1; t >= 0; --t) {
    const uint32_t f = reg_freq(lane, t), s = reg_start(lane, t);
    const uint32_t lim = (f << kPrecision) - 1u;
    const uint32_t g = (1u << kPrecision) - f;
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__uint2float_rn(f)));
    const uint32_t rcp = __float2uint_rz(__fmul_rz(r, 4294966272.0f));
    const uint32_t xe = x > lim ? x >> kPrecision : x;
    const uint32_t qe = __umulhi(xe, rcp);
    uint32_t re;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(re) : "r"(qe), "r"(0u - f), "r"(xe));
    const uint32_t pushed = qe * g + (xe + s);
    x = re >= 2u * f ? pushed + 2u * g : (re >= f ? pushed + g : pushed);
  }
  states[lane] = x;
}

}  // namespace

// Launches the chain on K lanes of M steps, in blocks of 64 lanes as K1.
extern "C" int probe_encode_chain(int M, int K, void* states, void* stream) {
  if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  chain_only<<<(K + 63) / 64, 64, 0, (cudaStream_t)stream>>>(M, K, (uint32_t*)states);
  return (int)cudaGetLastError();
}
