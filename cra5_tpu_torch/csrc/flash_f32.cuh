// SIMT helpers of the float32 flash-attention kernels (K4, K5 and K6 with
// float32 operands, head dim 64). Products and sums run in full float32 on
// the FFMA units: tensor-core TF32 would round every operand to 10
// mantissa bits, and the port keeps float32 as float32.
//
// Layout: each row a block owns (a query row in K4/K5, a key row in K6) is
// held by a pair of adjacent threads, thread h of the pair keeping head
// dims [32h, 32h + 32) of that row in registers. A dot product over the
// head dim is the pair's two half sums joined by one __shfl_xor, so both
// threads of a pair hold the same logits and softmax statistics. The
// walked rows are staged 64 at a time in shared memory with their second
// half 36 floats (not 32) after the first, so the two distinct float4
// addresses a warp reads in one step fall in different banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cra5 {
namespace f32attn {

constexpr int kD = 64;                // head dim
constexpr int kHalf = kD / 2;         // head dims a thread holds
constexpr int kRows = 64;             // rows a block owns
constexpr int kThreads = 2 * kRows;   // two threads a row
constexpr int kTile = 64;             // walked rows staged at a time
constexpr int kHoff = kHalf + 4;      // a staged row's second half
constexpr int kLd = kHoff + kHalf;    // staged row stride (floats; 16-byte multiple)
constexpr float kNegInf = -1e30f;

// Stage rows [r0, r0 + kTile) of a (N, 64) float32 matrix; rows past N are
// zero. Every thread of the block calls it.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0, int N) {
  for (int i = threadIdx.x; i < kTile * (kD / 4); i += blockDim.x) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N) val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * kD + c);
    *reinterpret_cast<float4*>(dst + r * kLd + c + (c >= kHalf ? kHoff - kHalf : 0)) = val;
  }
}

// This thread's half of a (64,) row, times `scale`; zeros when !valid.
__device__ __forceinline__ void load_half(float (&x)[kHalf], const float* __restrict__ row,
                                          int h, bool valid, float scale) {
#pragma unroll
  for (int i = 0; i < kHalf; i += 4) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) t = *reinterpret_cast<const float4*>(row + h * kHalf + i);
    x[i] = t.x * scale;
    x[i + 1] = t.y * scale;
    x[i + 2] = t.z * scale;
    x[i + 3] = t.w * scale;
  }
}

// Store this thread's half of a row, times `scale`.
__device__ __forceinline__ void store_half(float* __restrict__ row, const float (&x)[kHalf],
                                           int h, float scale) {
#pragma unroll
  for (int i = 0; i < kHalf; i += 4) {
    *reinterpret_cast<float4*>(row + h * kHalf + i) =
        make_float4(x[i] * scale, x[i + 1] * scale, x[i + 2] * scale, x[i + 3] * scale);
  }
}

// sum_i x[i] * s[i] over this thread's half (s: a staged row at this
// thread's half), then joined with the pair's other half: the full dot.
__device__ __forceinline__ float pair_dot(const float (&x)[kHalf], const float* s) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < kHalf; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(s + i);
    a0 = fmaf(x[i], t.x, a0);
    a1 = fmaf(x[i + 1], t.y, a1);
    a2 = fmaf(x[i + 2], t.z, a2);
    a3 = fmaf(x[i + 3], t.w, a3);
  }
  const float part = (a0 + a1) + (a2 + a3);
  return part + __shfl_xor_sync(0xffffffffu, part, 1);
}

// acc[i] += p * s[i] over this thread's half.
__device__ __forceinline__ void half_axpy(float (&acc)[kHalf], float p, const float* s) {
#pragma unroll
  for (int i = 0; i < kHalf; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(s + i);
    acc[i] = fmaf(p, t.x, acc[i]);
    acc[i + 1] = fmaf(p, t.y, acc[i + 1]);
    acc[i + 2] = fmaf(p, t.z, acc[i + 2]);
    acc[i + 3] = fmaf(p, t.w, acc[i + 3]);
  }
}

inline int row_blocks(int BH, int N, int* per_head) {
  *per_head = (N + kRows - 1) / kRows;
  const long long blocks = (long long)BH * *per_head;
  return blocks > 0x7fffffffLL ? -1 : (int)blocks;
}

}  // namespace f32attn
}  // namespace cra5
