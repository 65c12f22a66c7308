// Tensor-core helpers shared by the flash-attention kernels (K4, K5, K6):
// bf16 packing and one mma.sync m16n8k16 bf16 product with float32
// accumulators. Fragment layouts (g = lane / 4, tg = lane % 4):
//   A (16x16, row-major): a0 = A[g][2tg..], a1 = A[g+8][2tg..],
//                         a2 = A[g][2tg+8..], a3 = A[g+8][2tg+8..]
//   B (16x8, col-major):  b0 = B[2tg..][g], b1 = B[2tg+8..][g]
//   C (16x8):             c0, c1 = C[g][2tg..], c2, c3 = C[g+8][2tg..]
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace cra5 {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(&lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(&hi);
  return l | (h << 16);
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace cra5
