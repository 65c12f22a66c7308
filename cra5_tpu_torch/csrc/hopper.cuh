// Hopper (sm_90a) building blocks shared by the flash kernels K4
// (flash_attn_fwd.cu) and K5/K6 (flash_attn_bwd.cu, and on float32
// flash_attn_bwd_f32.cu), and the any-head-dim K4/K6
// (flash_attn_anydim.cu, flash_attn_anydim_f32.cu), as inline PTX:
//   - mbarriers: init, arrive, arrive with an expected transaction count,
//     and the wait on a phase parity;
//   - TMA: cp.async.bulk.tensor 3-D loads that complete on an mbarrier, and
//     the host-side tensor maps over (D, N, BH) 16-bit or float32 with
//     128-byte swizzle, boxes one swizzle atom wide, zero-filled past N and
//     past D;
//   - wgmma: fence, commit_group, wait_group, the shared-memory matrix
//     descriptor for 128-byte swizzle, m64nNk16 f32 += bf16 x bf16 (and f16
//     x f16) with A from shared memory or from registers, and m64nNk8 f32 +=
//     tf32 x tf32 for N = 64, 32 and 16 (both operands K-major: the tf32
//     forms have no transpose);
//   - cvt.rna.tf32.f32 and the split of float32 tiles into the hi and lo
//     planes of 3xTF32 products, as stored or transposed;
//   - setmaxnreg, named barriers and fence.proxy.async.
//
// Layouts. A tile of R rows of 64 bf16 (128 bytes a row), loaded by TMA
// with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned buffer, keeps
// row r at byte 128 r with its 16-byte chunk c at chunk c ^ (r % 8). As a
// wgmma operand it is
//   K-major  (rows = M or N, the 64 columns = K): LBO unused (16 B), SBO =
//            1024 B between 8-row groups; the k-th 16-wide K step starts
//            32 k bytes in (the swizzle is applied to the address bits);
//   MN-major (rows = K, the 64 columns = N, transpose bit set): SBO = 1024
//            B between 8-row groups of K, LBO the stride between 64-wide
//            column blocks (one block here); the k-th K step starts 2048 k
//            bytes in.
// A float32 row of 64 (256 bytes) is two swizzle atoms, so a float32 tile
// is kept as two halves, head dims [0, 32) and [32, 64), each R rows of
// 128 bytes swizzled as above (a TMA box 32 floats wide per half). As a
// K-major tf32 operand the k-th 8-wide K step starts in half k / 4, 32 (k
// % 4) bytes in, SBO 1024 B.
// The accumulator of m64nNk16 (and of m64nNk8) gives thread t of the
// warpgroup (warp w = t / 32, g = (t % 32) / 4, tg = t % 4) d[4 n + 2 h +
// j] = D[16 w + g + 8 h][8 n + 2 tg + j]; the bf16 register A operand is
// the m16n8k16 A fragment of rows 16 w .. 16 w + 15, so accumulator chunks
// 2k and 2k + 1 of a logits tile, packed to bf16, are the A operand of K
// step k. The tf32 register A operand is the m16n8k8 A fragment, a = {A[g]
// [tg], A[g + 8][tg], A[g][tg + 4], A[g + 8][tg + 4]}: accumulator chunk k
// holds columns 2 tg and 2 tg + 1 instead, so a kernel that feeds it
// reorders the keys of each 8-key step in the B operand to match.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cra5::hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte-aligned address at or after p, in shared memory.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to every thread and to the TMA unit.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// One arrival that also expects `bytes` more bytes of transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// True once the phase of parity `parity` has completed (the barrier's
// current phase has the other parity); try_wait itself blocks for a while.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity`. A pipeline fault (a phase that
// never completes) traps after about 2^34 clocks, seconds, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ------------------------------------------------------------------ TMA
// Box (c0, c1, c2) of a 3-D tensor map into shared memory at dst; the
// bytes complete on bar. Out-of-range rows arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ threads
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits of the result are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// ------------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Pins wgmma operand registers (accumulators, register A operands): the
// compiler moves no read or write of them across this point. Called before
// wgmma_fence, it keeps their definitions ahead of the fence; after
// wgmma_wait, it keeps their reads (and any reuse of the registers) behind
// the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// Matrix descriptor of a 128-byte-swizzled operand starting at p.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// Matrix descriptor of an operand at p swizzled over `span` bytes (128, 64
// or 32: the rows of its 8-row atoms).
__device__ __forceinline__ uint64_t swz_desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes,
                                             int span) {
  const uint64_t mode = span == 128 ? 1 : span == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (mode << 62);
}

// Offset of a descriptor's start address by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// D (64 x 128, f32) += A (64 x 16) * B (16 x 128), both in shared memory,
// K-major; D is only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16) * B (16 x 64), both in shared memory,
// K-major; D is only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers, the m16n8k16 A fragment
// of each warp's 16 rows) * B (16 x 64, shared memory, MN-major: the
// transpose bit is set); D is only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 8) * B (8 x 64), tf32, both in shared memory,
// K-major; D is only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32], uint64_t desc_a,
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 8) * B (8 x 32), tf32, both in shared memory,
// K-major; D is only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t desc_a,
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 8, tf32 registers, the m16n8k8 A fragment of
// each warp's 16 rows) * B (8 x 64, tf32, shared memory, K-major); D is
// only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The forms the any-head-dim kernels (flash_attn_anydim.cu) add, for 16-bit
// operands of type T (__nv_bfloat16 or __half: wgmma takes f16 beside
// bf16) and tf32. Same operand conventions as the forms above.
#define CRA5_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define CRA5_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define CRA5_R16(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define CRA5_R32(d)                                                                            \
  CRA5_R16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),  \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),           \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define CRA5_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

template <typename T>
constexpr bool is_f16 = std::is_same_v<T, __half>;

// D (64 x 32, f32) += A (64 x 16) * B (16 x 32), both in shared memory,
// K-major; D is only read when scale_d != 0.
template <typename T>
__device__ __forceinline__ void wgmma_m64n32k16_ss_t(float (&d)[16], uint64_t desc_a,
                                                     uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " CRA5_D16
                 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
                 : CRA5_R16(d)
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " CRA5_D16
                 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
                 : CRA5_R16(d)
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// wgmma_m64n128k16_ss for bf16 or f16.
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_ss_t(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : CRA5_R32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    wgmma_m64n128k16_ss(d, desc_a, desc_b, scale_d);
  }
}

// wgmma_m64n64k16_ss for bf16 or f16.
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss_t(float (&d)[32], uint64_t desc_a,
                                                     uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " CRA5_D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : CRA5_R32(d)
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    wgmma_m64n64k16_ss(d, desc_a, desc_b, scale_d);
  }
}

// wgmma_m64n64k16_rs (A from registers, B MN-major) for bf16 or f16.
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs_t(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " CRA5_D32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : CRA5_R32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else {
    wgmma_m64n64k16_rs(d, a, desc_b, scale_d);
  }
}

// D (64 x N, f32) += A (64 x 16, 16-bit registers) * B (16 x N, shared
// memory, MN-major) for N = 32 and 16, bf16 or f16.
template <typename T>
__device__ __forceinline__ void wgmma_m64n32k16_rs_t(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " CRA5_D16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
                 : CRA5_R16(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " CRA5_D16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
                 : CRA5_R16(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_m64n16k16_rs_t(float (&d)[8], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  if constexpr (is_f16<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 " CRA5_D8
                 ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " CRA5_D8
                 ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

// D (64 x 32, f32) += A (64 x 8, tf32 registers) * B (8 x 32, tf32, shared
// memory, K-major); D is only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " CRA5_D16
               ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
               : CRA5_R16(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 8, tf32 registers) * B (8 x 16, tf32, shared
// memory, K-major); D is only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n16k8_tf32_rs(float (&d)[8], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " CRA5_D8
               ", {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                 "+f"(d[6]), "+f"(d[7])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 8) * B (8 x 16), tf32, both in shared memory,
// K-major; D is only read when scale_d != 0.
__device__ __forceinline__ void wgmma_m64n16k8_tf32_ss(float (&d)[8], uint64_t desc_a,
                                                       uint64_t desc_b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " CRA5_D8
               ", %8, %9, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                 "+f"(d[6]), "+f"(d[7])
               : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef CRA5_D8
#undef CRA5_D16
#undef CRA5_D32
#undef CRA5_R16
#undef CRA5_R32

// ------------------------------------------------------------------ 3xTF32 planes
// x = hi + lo + (~2^-22 x): hi = tf32(x), lo = tf32(x - hi) (x - hi is exact).
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// Splits x and stores hi and lo as whole 16-byte chunks.
__device__ __forceinline__ void tf32_split4(float4 x, float4* hi, float4* lo) {
  float4 h, l;
  tf32_split(x.x, h.x, l.x);
  tf32_split(x.y, h.y, l.y);
  tf32_split(x.z, h.z, l.z);
  tf32_split(x.w, h.w, l.w);
  *hi = h;
  *lo = l;
}

// Byte offset of 16-byte chunk c of row r in a half (128-byte rows, 128-byte
// swizzle).
__device__ __forceinline__ int swz128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Splits `n4` float4 chunks of src, times `scale`, into hi and lo at the
// same positions (any layout; src may be hi). Thread t of `threads`.
__device__ __forceinline__ void tf32_split_planes(const float* src, float* hi, float* lo, int n4,
                                                  float scale, int t, int threads) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll 1
  for (int i = t; i < n4; i += threads) {
    const float4 x = s4[i];
    tf32_split4(make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale), h4 + i, l4 + i);
  }
}

// Splits a raw float32 tile of R rows x 64 columns, as TMA brings it (two
// halves of R rows x 32, 128-byte swizzled), into hi and lo planes of its
// transpose, 64 rows x R columns in R / 32 halves of 64 rows x 32 (each
// half 64 * 32 floats, swizzled), ready as the K-major B operand of a
// product that sums over the R rows. The rows of each group of 8 are
// reordered for the tf32 register A fragment, which takes columns tg and
// tg + 4 of a K step where the accumulator holds 2 tg and 2 tg + 1: row 2c
// of the group goes to column c, row 2c + 1 to column c + 4. Called by the
// 128 threads of a warpgroup (t = 0..127): each warp writes 32 transposed
// rows at one chunk, four raw rows a step (8 (kc / 2) + (kc % 2) + {0, 2,
// 4, 6}), reading one swizzled 128-byte raw row per load.
template <int R>
__device__ __forceinline__ void tf32_split_transposed(const float* raw, float* hi, float* lo,
                                                      int t) {
  const int lane = t % 32;
#pragma unroll 1
  for (int u = t / 32; u < R / 2; u += 4) {
    const int dh = u & 1, kc = u >> 1;
    const int d = 32 * dh + lane;
    const int row0 = 8 * (kc >> 1) + (kc & 1);
    const uint8_t* src = reinterpret_cast<const uint8_t*>(raw + dh * R * 32);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = *reinterpret_cast<const float*>(src + swz128(row0 + 2 * e, lane >> 2) +
                                             4 * (lane & 3));
    }
    const int off = (kc >> 3) * 64 * 128 + swz128(d, kc & 7);
    tf32_split4(make_float4(x[0], x[1], x[2], x[3]),
                reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(hi) + off),
                reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(lo) + off));
  }
}


// The same split for a tile of R <= 32 rows and NB boxes of 32 columns, into
// a transposed plane of 32 NB head-dim rows (128 bytes each, swizzled) in
// which raw row r goes to column c0 + r (c0 a multiple of 4, c0 + R <= 32).
template <int NB, int R>
__device__ __forceinline__ void tf32_split_transposed(const float* raw, float* hi, float* lo,
                                                      int c0, int t) {
  static_assert(R <= 32, "one 32-column half of the transposed plane");
  const unsigned lane = t % 32;
#pragma unroll 1
  for (unsigned u = t / 32; u < NB * R / 4; u += 4) {
    const unsigned dh = u % NB, kc = u / NB;
    const int row0 = 8 * (kc >> 1) + (kc & 1);
    const uint8_t* src = reinterpret_cast<const uint8_t*>(raw + dh * R * 32);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = *reinterpret_cast<const float*>(src + swz128(row0 + 2 * e, lane >> 2) +
                                             4 * (lane & 3));
    }
    const int off = swz128(32 * dh + lane, c0 / 4 + kc);
    tf32_split4(make_float4(x[0], x[1], x[2], x[3]),
                reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(hi) + off),
                reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(lo) + off));
  }
}

// ------------------------------------------------------------------ host
// A 3-D tensor map over a contiguous (BH, N, D) array of `elem_bytes` (2:
// bf16 or float16, whose bits TMA copies alike; 4: float32) elements, dims
// innermost first (D, N, BH), boxes of (128 / elem_bytes, rows, 1), one
// 128-byte swizzle atom wide, with zero fill: a box past a head's last row
// reads zeros, never the next head, and a box whose columns run past D
// reads zeros there. So a head dim that is not a multiple of the box width
// is padded to it in shared memory at no instruction's cost: a kernel loads
// ceil(D elem_bytes / 128) boxes a row, and the zero columns add nothing to
// any sum (the products still spend their tensor-core operations on them).
// D defaults to 64, the head-dim-64 kernels' maps. A row of D elements must
// be a multiple of 16 bytes (TMA's stride rule). `box_bytes` (128, 64 or 32)
// narrows the box and its swizzle to that many bytes, for the last columns
// of a head dim that are fewer than a 128-byte atom. cuTensorMapEncodeTiled
// is looked up through the CUDA runtime's entry-point query, so the library
// needs no -lcuda.
inline bool make_tensor_map_3d(CUtensorMap* map, const void* base, int N, int BH, int rows,
                               int elem_bytes = 2, int D = 64, int box_bytes = 128) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return false;
  if (elem_bytes != 2 && elem_bytes != 4) return false;
  if (D < 1 || (D * elem_bytes) % 16 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)BH};
  const cuuint64_t row_bytes = (cuuint64_t)D * elem_bytes;
  const cuuint64_t strides[2] = {row_bytes, (cuuint64_t)N * row_bytes};  // bytes, dims 1 and 2
  if (box_bytes != 128 && box_bytes != 64 && box_bytes != 32) return false;
  const cuuint32_t box[3] = {(cuuint32_t)(box_bytes / elem_bytes), (cuuint32_t)rows, 1};
  const CUtensorMapSwizzle swizzle = box_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return encode(map, type, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Allows `kernel` `bytes` of dynamic shared memory (above 48 KB it must
// ask), and checks that the registers it is launched with cover what its
// warpgroups ask for with setmaxnreg: one producer warpgroup at
// `producer_regs` and two consumers at `consumer_regs`, or a consumer's
// setmaxnreg.inc would wait forever.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, int bytes, int producer_regs, int consumer_regs) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  return attr.numRegs * 384 >= 128 * producer_regs + 256 * consumer_regs
             ? cudaSuccess
             : cudaErrorInvalidConfiguration;
}

}  // namespace cra5::hopper
