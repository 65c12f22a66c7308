// K1 rans_encode: interleaved-lane rANS encode over an (M, K) step-major grid.
//
// Replaces cra5_tpu/coder/rans_pallas.py:encode_scan_pallas. Lanes are
// independent, so each thread owns one lane and walks the M steps in
// reverse (LIFO) order. A step reads its start and freq, tests emit, writes
// the low word and the emit flag, renormalizes and pushes x = (x / f) << 16
// + x mod f + start. A padding step (start 0, freq 2**16) is an exact
// identity: no emit, q = x >> 16, r = x & 0xffff.
//
// Bound: not bytes (11 a symbol, 0.0087 ms for the 268v y stream on an
// H100) but the serial chain of M steps a lane: the streams' lanes are few
// (8192 for y, 256 for z), so a warp runs alone on its scheduler and a step
// costs what the warp waits for. Copies of the first form of this kernel
// (loads from device memory four steps ahead, the hardware's u32 division),
// timed on an H100 (PERF.md, §6), took 111 (y) and 100 (z) ns a step, 59
// with the loads taken from registers and 31 with the division by a
// constant as well. So the design takes what does not depend on x off the
// chain:
//   - the quotient: R = trunc(2^32 rcp(f) (1 - 2^-22)), from the float32
//     reciprocal (rcp.approx, within 1 ulp) rounded toward zero, lies in
//     [2^32 (1 - 2^-21) / f - 1, 2^32 / f) and depends on f alone; then
//     qe = mulhi(x, R) is q, q - 1 or q - 2 (x / f < 2^16 after
//     renormalization), and r = x - qe f < 3f picks the correction by two
//     compares side by side. The push is x + s + q (2^16 - f), so the
//     correction adds 0, 2^16 - f or twice that. The chain a step: the emit
//     compare, the shift, IMAD.HI, IMAD, the two compares, a select and an
//     add; profiling/encode_chain_probe.py times it alone, the floor that
//     chip_smoke.py prints beside this kernel. tests/test_torch_rans.py
//     holds a numpy mirror of this quotient to exact division for every
//     freq;
//   - the loads: a producer warp loads each block's (freq, start) rows into
//     a ring of shared memory, kSlots slots of kChunk steps, with full and
//     empty mbarriers (hopper.cuh), so the consumer warps' chains neither
//     issue nor wait on a global load. Of the rings timed, 2 slots of 16
//     steps was the fastest (4 of 16 and slots of 8 steps were slower);
//     each consumer thread staging its own lane by cp.async, or loading its
//     next chunk into registers, was slower still, the latter because ptxas
//     moved the loads to the end of the chunk before;
//   - the word and emit stores, which nothing waits on.
// Blocks of kLanes = 64 lanes (two consumer warps and the producer) spread
// the 268v streams over 128 (y) and 4 (z) SMs. Positions: each chunk's
// lowest row in 64 bits, once a chunk, and a step's offset from it in 32
// bits (< 16 K, so K <= 2^28). On an H100 this costs 3-5 ns a step over
// 32-bit positions (a 64-bit position a step cost more); peeling the
// padded first chunk off the other chunks' body, so that they skip the pad
// select, made the kernel much slower.

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = cra5::hopper;

constexpr int kLanes = 64;             // lanes a block: two consumer warps, a lane a thread
constexpr int kThreads = kLanes + 32;  // + one producer warp
constexpr int kChunk = 16;             // steps a ring slot
constexpr int kSlots = 2;              // slots of the ring: 32 steps, 16 KB

// 2^32 / f rounded down to an integer R in [2^32 (1 - 2^-21) / f - 1, 2^32 /
// f): rcp.approx is within 1 ulp, and (1 - 2^-22) 2^32 = 2^32 - 2^10 is
// exact in float32.
__device__ __forceinline__ uint32_t reciprocal_below(uint32_t f) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__uint2float_rn(f)));
  return __float2uint_rz(__fmul_rz(r, 4294966272.0f));
}

// a * b + c in one IMAD: written as C++, nvcc turned xe + qe * (-f) back into
// a negation of qe and an IMAD, one more operation on the chain.
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One step of the lane state x on (freq, start) = fs: stores the word and
// the emit flag at o and returns the pushed state.
__device__ __forceinline__ uint32_t step(uint32_t x, int2 fs, uint32_t o, uint8_t* __restrict__ emit,
                                         uint16_t* __restrict__ words) {
  const uint32_t f = (uint32_t)fs.x, s = (uint32_t)fs.y;
  // off the chain: the emit bound (x > lim iff x >= f 2^16; never for f =
  // 2^16), the reciprocal, -f, 2f and g = 2^16 - f
  const uint32_t lim = (f << cra5::kPrecision) - 1u;
  const uint32_t rcp = reciprocal_below(f);
  const uint32_t nf = 0u - f, f2 = 2u * f, g = (1u << cra5::kPrecision) - f;
  const bool e = x > lim;
  words[o] = (uint16_t)(x & 0xffffu);
  emit[o] = e ? 1 : 0;
  const uint32_t xe = e ? x >> cra5::kPrecision : x;
  const uint32_t qe = __umulhi(xe, rcp);      // q, q - 1 or q - 2
  const uint32_t re = mad(qe, nf, xe);        // x - qe f, in [0, 3f)
  const uint32_t pushed = qe * g + (xe + s);  // x + s + qe (2^16 - f)
  return re >= f2 ? pushed + 2u * g : (re >= f ? pushed + g : pushed);
}

// Chunk c holds steps top(c) - u, u < C, top(c) = M + pad - 1 - C c: chunks
// of C steps from the top, the first padded at its top to a whole chunk with
// identity steps (freq 2^16, start 0) whose stores go to row M - 1, which its
// real step overwrites after them. So every chunk runs one branch-free
// unrolled body, on rows from top(c) - C + 1 >= 0 up.
__global__ void __launch_bounds__(kThreads)
    rans_encode_kernel(const int* __restrict__ starts, const int* __restrict__ freqs, int M,
                       int K, uint32_t* __restrict__ states, uint8_t* __restrict__ emit,
                       uint16_t* __restrict__ words) {
  __shared__ int2 ring[kSlots][kChunk][kLanes];  // (freq, start) of a step and lane
  __shared__ uint64_t full[kSlots], empty[kSlots];
  const int lane0 = blockIdx.x * kLanes;
  const int pad = (kChunk - M % kChunk) % kChunk;
  const int nchunks = (M + pad) / kChunk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) {
      hw::mbar_init(&full[i], 32);            // the producer's lanes, after their stores
      hw::mbar_init(&empty[i], kLanes / 32);  // a lane of each consumer warp
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kLanes) {  // the producer warp: lanes l and l + 32 of the block
    const int l = threadIdx.x - kLanes;
#pragma unroll 1
    for (int c = 0; c < nchunks; ++c) {
      const int slot = c % kSlots, top = M + pad - 1 - c * kChunk, low = top - (kChunk - 1);
      const int* const f_c = freqs + (size_t)low * K;
      const int* const s_c = starts + (size_t)low * K;
      int2 fs[kChunk][2];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const uint32_t row = (uint32_t)(min(top - u, M - 1) - low) * (uint32_t)K;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t lane = lane0 + l + 32 * h;
          if (lane < (uint32_t)K) fs[u][h] = make_int2(__ldg(f_c + row + lane), __ldg(s_c + row + lane));
        }
      }
      if (c >= kSlots) hw::mbar_wait(&empty[slot], (c / kSlots - 1) & 1);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) ring[slot][u][l + 32 * h] = fs[u][h];
      }
      hw::mbar_arrive(&full[slot]);
    }
    return;
  }

  // the consumer warps: one lane a thread
  const int tid = threadIdx.x, lane = lane0 + tid;
  uint32_t x = cra5::kLaneL;
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    const int slot = c % kSlots, top = M + pad - 1 - c * kChunk, low = top - (kChunk - 1);
    hw::mbar_wait(&full[slot], (c / kSlots) & 1);
    int2 fs[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) fs[u] = ring[slot][u][tid];
    __syncwarp();
    if (tid % 32 == 0) hw::mbar_arrive(&empty[slot]);  // this warp has read the slot
    if (lane < K) {
      uint8_t* const e_c = emit + (size_t)low * K;
      uint16_t* const w_c = words + (size_t)low * K;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        x = step(x, top - u < M ? fs[u] : make_int2(1 << cra5::kPrecision, 0),
                 (uint32_t)(min(top - u, M - 1) - low) * (uint32_t)K + lane, e_c, w_c);
      }
    }
  }
  if (lane < K) states[lane] = x;
}

}  // namespace

extern "C" int cra5_rans_encode(const void* starts, const void* freqs, int M,
                                int K, void* states, void* emit, void* words,
                                void* stream) {
  // a chunk's top row, the pad's too, counts in 32 bits, a step's offset
  // in its chunk too
  if (M < 1 || K < 1 || M > INT_MAX - kChunk || K > (1 << 28)) return (int)cudaErrorInvalidValue;
  rans_encode_kernel<<<(K + kLanes - 1) / kLanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)freqs, M, K, (uint32_t*)states, (uint8_t*)emit,
      (uint16_t*)words);
  return (int)cudaGetLastError();
}
