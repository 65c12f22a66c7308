// K5 flash_attn_bwd_dq and K6 flash_attn_bwd_dkv: the flash-attention
// backward, bf16 in and out, float32 accumulation and statistics.
//
// Replace the two backward kernels of cra5_tpu/ops/attention.py
// (_bwd_dq_kernel and _bwd_dkv_kernel, driven by _flash_backward). Given
// the forward's log-sum-exp rows and delta = rowsum(dO * O), both
// recompute P = exp(S - lse) tile by tile, so no (N x N) buffer reaches
// device memory (FlashAttention-2):
//   K5: one block per 128-query tile walks every 64-key tile;
//       dQ = scale * sum_k dS K, dS = P * (dO V^T - delta).
//   K6: one block per 128-key tile walks every 64-query tile;
//       dV = sum_q P^T dO, dK = scale * sum_q dS^T Q.
// Bound: tensor-core operations (K5 does three N*N*D products per head,
// K6 four, against 4*N*D*2 bytes in). Rounding follows the TPU kernels: K5
// uses q pre-scaled and rounded to bf16 and writes dq rounded once; K6
// scales the float32 logits of raw q, and its dk/dv stay float32 in
// registers until the one rounding at the end. P (for dV) and dS are
// rounded to bf16 before their products. Keys past N get P = 0 in K5 (the
// TPU kernel masks their logits to -1e30), query rows past N get P = 0 in
// K6. No atomics: the result is deterministic.
//
// Both are built for Hopper (hopper.cuh): a block of 384 threads, one
// producer warpgroup whose first thread issues every TMA load on 3-D tensor
// maps (rows past N zero-filled, never the next head's), and two consumer
// warpgroups of 64 rows each on wgmma.
//
// K5: a block owns BQ = 128 queries. Q and dO arrive once by TMA; each
// consumer scales its q rows in float32 and rounds them to bf16 in place
// (the TPU kernel's rounding point), then fences the async proxy. K and V
// tiles of BK = 64 keys stream through a ring of kStages stages with full
// and empty mbarriers. Per stage a consumer runs S = (q scale) K^T and dP
// = dO V^T (wgmma m64n64k16, both operands in shared memory, K-major), P =
// exp2(S log2 e - lse log2 e) (one FFMA and one ex2 a logit; 0 for keys
// past N) and dS = P (dP - delta) in registers, dS rounded to bf16 straight
// into the register A operand of dQ += dS K, with K MN-major: one staged K
// tile serves both majors. lse log2 e and delta of a thread's two rows stay
// in registers for the whole walk. dq * scale is rounded to bf16 once.
//
// K6: a block owns 128 keys: the producer warpgroup is lowered to 40
// registers, the consumers raised to 232. K and V arrive once by TMA and
// stay in shared memory as the A operands. The producer's first warp
// streams 64-query tiles of Q and dO, with their lse (times log2 e) and
// delta rows, through a ring of kStages stages with full and empty
// mbarriers; both consumers read each staged tile. Per tile a consumer
// runs S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands in
// shared memory, K-major), P^T = exp2(S^T scale log2 e - lse log2 e) and
// dS^T = P^T (dP^T - delta) in registers, and then dV += bf16(P^T) dO and
// dK += bf16(dS^T) Q with A from registers and B MN-major: one staged copy
// of Q and dO serves both majors.
//
// Float32 operands take second entries (cra5_flash_attn_bwd_dq_f32,
// cra5_flash_attn_bwd_dkv_f32) on 3xTF32: flash_attn_bwd_f32.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

namespace dq_hopper {

namespace hw = cra5::hopper;

constexpr int BQ = 128;  // queries a block, 64 per consumer warpgroup
constexpr int BK = 64;   // keys a ring stage
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 168 a thread at launch
constexpr int kQueryBytes = BQ * 64 * 2;
constexpr int kKeyBytes = BK * 64 * 2;

// Every tile is a multiple of 1024 bytes, so each starts 1024-aligned, as
// the 128-byte swizzle needs.
struct alignas(1024) DqSmem {
  __nv_bfloat16 q[BQ * 64];
  __nv_bfloat16 dout[BQ * 64];
  __nv_bfloat16 k[kStages][BK * 64];
  __nv_bfloat16 v[kStages][BK * 64];
  uint64_t q_full, full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(DqSmem) + 1024;  // + the alignment slack

// One consumer warpgroup: query rows [r0, r0 + 64) of head bh, rows 64c of
// the block's Q and dO tiles.
__device__ __forceinline__ void consumer(DqSmem& s, const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         __nv_bfloat16* __restrict__ dq, int N, int bh, int r0,
                                         int nkb, float scale, int c) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  __nv_bfloat16* sq = s.q + c * 64 * 64;

  float l2[2], dl[2];  // rows g and g + 8 of this warp; read before the wait
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    l2[h] = row < N ? lse[(size_t)bh * N + row] * kLog2e : 0.f;
    dl[h] = row < N ? delta[(size_t)bh * N + row] : 0.f;
  }

  hw::mbar_wait(&s.q_full, 0);
  {  // q * scale, rounded to bf16 once; the swizzle moves whole 16-byte chunks
    uint4* p = reinterpret_cast<uint4*>(sq);
    for (int i = t; i < 64 * 64 / 8; i += 128) {
      uint4 val = p[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * scale);
      p[i] = val;
    }
  }
  hw::fence_proxy_async();
  hw::named_sync(1 + c, 128);

  const uint64_t q_desc = hw::sw128_desc(sq, 16, 1024);
  const uint64_t o_desc = hw::sw128_desc(s.dout + c * 64 * 64, 16, 1024);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int j = 0; j < nkb; ++j) {
    const int st = j % kStages;
    hw::mbar_wait(&s.full[st], (j / kStages) & 1);

    float sc[32], dp[32];  // 64 rows x 64 keys each
    const uint64_t k_desc = hw::sw128_desc(s.k[st], 16, 1024);
    const uint64_t v_desc = hw::sw128_desc(s.v[st], 16, 1024);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // S = (q * scale) K^T
      hw::wgmma_m64n64k16_ss(sc, hw::desc_add(q_desc, 32 * kk), hw::desc_add(k_desc, 32 * kk),
                             kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dP = dO V^T
      hw::wgmma_m64n64k16_ss(dp, hw::desc_add(o_desc, 32 * kk), hw::desc_add(v_desc, 32 * kk),
                             kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);
    hw::fence_regs(dp);

    // dS = P (dP - delta), P = exp2(S log2 e - lse log2 e), 0 for keys past
    // N (zero-filled keys give a logit of 0), rounded to bf16 into the A
    // operand of key step kk: accumulator chunks 2kk and 2kk + 1
    const int k0 = j * BK;
    const bool ragged = k0 + BK > N;
    uint32_t dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // registers 4n + 2h + jj: key 8n + 2tg + jj
        float ds[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int i = 4 * n + 2 * h + jj;
          float p = hw::ex2(fmaf(sc[i], kLog2e, -l2[h]));
          if (ragged && k0 + 8 * n + 2 * tg + jj >= N) p = 0.f;
          ds[jj] = p * (dp[i] - dl[h]);
        }
        dsa[n >> 1][2 * (n & 1) + h] = hw::pack_bf16(ds[0], ds[1]);
      }
    }

    const uint64_t k_mn = hw::sw128_desc(s.k[st], BK * 128, 1024);  // MN-major
    hw::fence_regs(acc);
    hw::fence_regs(dsa);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dQ += dS K
      hw::wgmma_m64n64k16_rs(acc, dsa[kk], hw::desc_add(k_mn, 2048 * kk), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_regs(dsa);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.empty[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= N) continue;
    __nv_bfloat16* dst = dq + ((size_t)bh * N + row) * 64 + 2 * tg;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(acc[4 * d + 2 * h] * scale, acc[4 * d + 2 * h + 1] * scale);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, int N, int nqb, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& s = *reinterpret_cast<DqSmem*>(hw::align_1024(smem_raw));
  const int bh = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * BQ;
  const int nkb = (N + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hw::mbar_init(&s.q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&s.full[st], 1);
      hw::mbar_init(&s.empty[st], 8);  // one arrival per consumer warp
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hw::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hw::mbar_arrive_expect_tx(&s.q_full, 2 * kQueryBytes);
      hw::tma_load_3d(s.q, &map_q, &s.q_full, 0, q0, bh);
      hw::tma_load_3d(s.dout, &map_do, &s.q_full, 0, q0, bh);
      for (int j = 0; j < nkb; ++j) {
        const int st = j % kStages;
        if (j >= kStages) hw::mbar_wait(&s.empty[st], (j / kStages - 1) & 1);
        hw::mbar_arrive_expect_tx(&s.full[st], 2 * kKeyBytes);
        hw::tma_load_3d(s.k[st], &map_k, &s.full[st], 0, j * BK, bh);
        hw::tma_load_3d(s.v[st], &map_v, &s.full[st], 0, j * BK, bh);
      }
    }
  } else {  // consumers
    hw::regs_inc<kConsumerRegs>();
    consumer(s, lse, delta, dq, N, bh, q0 + (wg - 1) * 64, nkb, scale, wg - 1);
  }
}

}  // namespace dq_hopper

namespace dkv {

namespace hw = cra5::hopper;

constexpr int BKV = 128;  // keys a block, 64 per consumer warpgroup
constexpr int BQ = 64;    // queries a ring stage
constexpr int kStages = 3;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 168 a thread at launch
constexpr int kKeyBytes = BKV * 64 * 2;
constexpr int kQueryBytes = BQ * 64 * 2;

// Every tile is a multiple of 1024 bytes, so each starts 1024-aligned, as
// the 128-byte swizzle needs.
struct alignas(1024) DkvSmem {
  __nv_bfloat16 k[BKV * 64];
  __nv_bfloat16 v[BKV * 64];
  __nv_bfloat16 q[kStages][BQ * 64];
  __nv_bfloat16 dout[kStages][BQ * 64];
  float lse[kStages][BQ];  // lse * log2 e
  float delta[kStages][BQ];
  uint64_t kv_full, full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(DkvSmem) + 1024;  // + the alignment slack

// P^T = exp2(S^T scale log2 e - lse log2 e) (0 for queries past N) and
// dS^T = P^T (dP^T - delta) of one stage, rounded to bf16 into A operands:
// accumulator chunks 2kk and 2kk + 1 are the operand of query step kk.
__device__ __forceinline__ void p_ds_tile(const float (&sT)[32], const float (&dpT)[32],
                                          uint32_t (&pa)[4][4], uint32_t (&dsa)[4][4],
                                          const DkvSmem& s, int st, int q0, int N, float sl,
                                          int tg) {
  const bool ragged = q0 + BQ > N;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(&s.lse[st][8 * n + 2 * tg]);
    const float2 dl = *reinterpret_cast<const float2*>(&s.delta[st][8 * n + 2 * tg]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // registers 4n + 2h + j: column 8n + 2tg + j
      float p[2], ds[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = 4 * n + 2 * h + j;
        p[j] = hw::ex2(fmaf(sT[i], sl, -(j ? l2.y : l2.x)));
        if (ragged && q0 + 8 * n + 2 * tg + j >= N) p[j] = 0.f;
        ds[j] = p[j] * (dpT[i] - (j ? dl.y : dl.x));
      }
      pa[n >> 1][2 * (n & 1) + h] = hw::pack_bf16(p[0], p[1]);
      dsa[n >> 1][2 * (n & 1) + h] = hw::pack_bf16(ds[0], ds[1]);
    }
  }
}

// One consumer warpgroup: keys [r0, r0 + 64) of head bh, rows 64c of the
// block's K and V tiles.
__device__ __forceinline__ void consumer(DkvSmem& s, __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv, int N, int bh, int r0,
                                         int nqb, float scale, int c) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const float sl = scale * kLog2e;

  hw::mbar_wait(&s.kv_full, 0);
  const uint64_t k_desc = hw::sw128_desc(s.k + c * 64 * 64, 16, 1024);
  const uint64_t v_desc = hw::sw128_desc(s.v + c * 64 * 64, 16, 1024);
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int j = 0; j < nqb; ++j) {
    const int st = j % kStages;
    hw::mbar_wait(&s.full[st], (j / kStages) & 1);

    // transposed tiles: rows are this warpgroup's keys, columns the queries
    float sT[32], dpT[32];
    const uint64_t q_desc = hw::sw128_desc(s.q[st], 16, 1024);
    const uint64_t o_desc = hw::sw128_desc(s.dout[st], 16, 1024);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // S^T = K Q^T
      hw::wgmma_m64n64k16_ss(sT, hw::desc_add(k_desc, 32 * kk), hw::desc_add(q_desc, 32 * kk),
                             kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dP^T = V dO^T
      hw::wgmma_m64n64k16_ss(dpT, hw::desc_add(v_desc, 32 * kk), hw::desc_add(o_desc, 32 * kk),
                             kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sT);
    hw::fence_regs(dpT);

    uint32_t pa[4][4], dsa[4][4];
    p_ds_tile(sT, dpT, pa, dsa, s, st, j * BQ, N, sl, tg);

    const uint64_t o_mn = hw::sw128_desc(s.dout[st], BQ * 128, 1024);  // MN-major
    const uint64_t q_mn = hw::sw128_desc(s.q[st], BQ * 128, 1024);
    hw::fence_regs(dv_acc);
    hw::fence_regs(dk_acc);
    hw::fence_regs(pa);
    hw::fence_regs(dsa);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dV += P^T dO
      hw::wgmma_m64n64k16_rs(dv_acc, pa[kk], hw::desc_add(o_mn, 2048 * kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dK += dS^T Q
      hw::wgmma_m64n64k16_rs(dk_acc, dsa[kk], hw::desc_add(q_mn, 2048 * kk), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dv_acc);
    hw::fence_regs(dk_acc);
    hw::fence_regs(pa);
    hw::fence_regs(dsa);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.empty[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= N) continue;
    const size_t o = ((size_t)bh * N + row) * 64 + 2 * tg;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * d) = __floats2bfloat162_rn(
          dk_acc[4 * d + 2 * h] * scale, dk_acc[4 * d + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * d) =
          __floats2bfloat162_rn(dv_acc[4 * d + 2 * h], dv_acc[4 * d + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N, int nkb,
           float scale) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& s = *reinterpret_cast<DkvSmem*>(hw::align_1024(smem_raw));
  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x % nkb) * BKV;
  const int nqb = (N + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hw::mbar_init(&s.kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&s.full[st], 32);  // the producer warp's lanes, after their lse/delta
      hw::mbar_init(&s.empty[st], 8);  // one arrival per consumer warp
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: its first warp
    hw::regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hw::mbar_arrive_expect_tx(&s.kv_full, 2 * kKeyBytes);
        hw::tma_load_3d(s.k, &map_k, &s.kv_full, 0, k0, bh);
        hw::tma_load_3d(s.v, &map_v, &s.kv_full, 0, k0, bh);
      }
      const float* lse_h = lse + (size_t)bh * N;
      const float* delta_h = delta + (size_t)bh * N;
      for (int j = 0; j < nqb; ++j) {
        const int st = j % kStages;
        float l2[2], dl[2];  // read before the wait, so the loads overlap it
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = j * BQ + lane + 32 * u;
          l2[u] = row < N ? lse_h[row] * kLog2e : 0.f;
          dl[u] = row < N ? delta_h[row] : 0.f;
        }
        if (j >= kStages) hw::mbar_wait(&s.empty[st], (j / kStages - 1) & 1);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          s.lse[st][lane + 32 * u] = l2[u];
          s.delta[st][lane + 32 * u] = dl[u];
        }
        if (lane == 0) {
          hw::mbar_arrive_expect_tx(&s.full[st], 2 * kQueryBytes);
          hw::tma_load_3d(s.q[st], &map_q, &s.full[st], 0, j * BQ, bh);
          hw::tma_load_3d(s.dout[st], &map_do, &s.full[st], 0, j * BQ, bh);
        } else {
          hw::mbar_arrive(&s.full[st]);
        }
      }
    }
  } else {  // consumers
    hw::regs_inc<kConsumerRegs>();
    consumer(s, dk, dv, N, bh, k0 + (wg - 1) * 64, nqb, scale, wg - 1);
  }
}

}  // namespace dkv

}  // namespace

// q, k, v, dout, dq: (BH, N, D) bf16 contiguous; lse, delta: (BH, N) f32.
extern "C" int cra5_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int BH, int N, int D, float scale,
                                      void* stream) {
  namespace hw = cra5::hopper;
  namespace k5 = dq_hopper;
  if (D != 64 || N < 1 || BH < 1) return (int)cudaErrorInvalidValue;
  const int nqb = (N + k5::BQ - 1) / k5::BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!hw::make_tensor_map_3d(&map_q, q, N, BH, k5::BQ) ||
      !hw::make_tensor_map_3d(&map_do, dout, N, BH, k5::BQ) ||
      !hw::make_tensor_map_3d(&map_k, k, N, BH, k5::BK) ||
      !hw::make_tensor_map_3d(&map_v, v, N, BH, k5::BK)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e =
      hw::prepare(k5::kernel, k5::kSmemBytes, k5::kProducerRegs, k5::kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  k5::kernel<<<(unsigned)blocks, k5::kThreads, k5::kSmemBytes, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, map_do, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq,
      N, nqb, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dout, dk, dv: (BH, N, D) bf16 contiguous; lse, delta: (BH, N) f32.
extern "C" int cra5_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int BH, int N, int D, float scale,
                                       void* stream) {
  namespace hw = cra5::hopper;
  if (D != 64 || N < 1 || BH < 1) return (int)cudaErrorInvalidValue;
  const int nkb = (N + dkv::BKV - 1) / dkv::BKV;
  const long long blocks = (long long)BH * nkb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!hw::make_tensor_map_3d(&map_q, q, N, BH, dkv::BQ) ||
      !hw::make_tensor_map_3d(&map_do, dout, N, BH, dkv::BQ) ||
      !hw::make_tensor_map_3d(&map_k, k, N, BH, dkv::BKV) ||
      !hw::make_tensor_map_3d(&map_v, v, N, BH, dkv::BKV)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e =
      hw::prepare(dkv::kernel, dkv::kSmemBytes, dkv::kProducerRegs, dkv::kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  dkv::kernel<<<(unsigned)blocks, dkv::kThreads, dkv::kSmemBytes, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, map_do, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, N, nkb, scale);
  return (int)cudaGetLastError();
}
