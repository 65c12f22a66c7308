// K5 flash_attn_bwd_dq and K6 flash_attn_bwd_dkv: the flash-attention
// backward, bf16 in and out, float32 accumulation and statistics.
//
// Replace the two backward kernels of cra5_tpu/ops/attention.py
// (_bwd_dq_kernel and _bwd_dkv_kernel, driven by _flash_backward). Given
// the forward's log-sum-exp rows and delta = rowsum(dO * O), both
// recompute P = exp(S - lse) tile by tile, so no (N x N) buffer reaches
// device memory (FlashAttention-2):
//   K5: one block per 64-query tile walks every 64-key tile;
//       dQ = scale * sum_k dS K, dS = P * (dO V^T - delta).
//   K6: one block per 64-key tile walks every 64-query tile;
//       dV = sum_q P^T dO, dK = scale * sum_q dS^T Q.
// Bound: tensor-core operations (K5 does three N*N*D products per head,
// K6 four, against 4*N*D*2 bytes in), so every product is an mma.sync
// m16n8k16 bf16 with float32 accumulators (mma.cuh). Four warps own 16
// rows each of the block's tile; the row tile lives in registers as A
// fragments, the walked tiles are staged in shared memory, and each warp's
// 16x64 logits tile turns into the A fragment of the next product in
// registers, as in K4. Rounding follows the TPU kernels: K5 uses q
// pre-scaled and rounded to bf16 and writes dq rounded once; K6 scales the
// float32 logits of raw q, and its dk/dv stay float32 in registers until
// the one rounding at the end. P (for dV) and dS are rounded to bf16 before
// their products. The ragged key tail is masked (-1e30) in K5; query rows
// past N get P = 0 in K6. No atomics: the result is deterministic.
// Later work: wgmma, TMA loads and one pass sharing P between dQ and dK/dV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using cra5::mma_16816;
using cra5::pack_bf16;
using cra5::pack_bf16_raw;

constexpr int BT = 64;  // rows of every tile, query or key
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// Stage rows [r0, r0 + BT) of a (N, D) bf16 matrix into shared memory with
// row stride D + 8 (conflict-free fragment loads); rows past N are zero.
// With `scale`, each value is scaled in float32 and rounded back to bf16.
template <int D, bool kScale>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int r0, int N, float scale) {
  constexpr int LD = D + 8, CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BT * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    if (kScale) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The A fragments of rows [row0, row0 + 16) of a staged tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4], const __nv_bfloat16* s,
                                       int row0, int g, int tg) {
  constexpr int LD = D + 8;
  const __nv_bfloat16* p0 = s + (row0 + g) * LD + tg * 2;
  const __nv_bfloat16* p1 = p0 + 8 * LD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = *reinterpret_cast<const uint32_t*>(p0 + kk * 16);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(p1 + kk * 16);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + kk * 16 + 8);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + kk * 16 + 8);
  }
}

// s (16 x BT) = A (16 x D) * T^T, T a staged tile whose BT rows are the
// columns of s.
template <int D>
__device__ __forceinline__ void mma_abt(float (&s)[BT / 8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* t, int g, int tg) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* pk = t + (nt * 8 + g) * LD + tg * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_16816(s[nt], a[kk], *reinterpret_cast<const uint32_t*>(pk + kk * 16),
                *reinterpret_cast<const uint32_t*>(pk + kk * 16 + 8));
    }
  }
}

// acc (16 x D) += bf16(p) (16 x BT, accumulator layout) * T, T a staged
// (BT x D) tile: accumulator tiles (2kk, 2kk + 1) of p are exactly the A
// fragment of step kk, so p never leaves registers.
template <int D>
__device__ __forceinline__ void mma_pt(float (&acc)[D / 8][4], const float (&p)[BT / 8][4],
                                       const __nv_bfloat16* t, int g, int tg) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]),
    };
    const __nv_bfloat16* pv = t + (kk * 16 + tg * 2) * LD + g;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      const __nv_bfloat16* e = pv + d * 8;
      mma_16816(acc[d], a, pack_bf16_raw(e[0], e[LD]), pack_bf16_raw(e[8 * LD], e[9 * LD]));
    }
  }
}

// Write a warp's 16 x D float32 accumulator rows as bf16, times `scale`;
// rows past N are dropped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[D / 8][4], int row0, int N,
                                           float scale, int g, int tg) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= N) continue;
    __nv_bfloat16* o = dst + (size_t)row * D + tg * 2;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(o + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * h] * scale, acc[d][2 * h + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int N, int nqb,
                             float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 sO[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 sK[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BT * LD];

  const int bh = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * BT;
  const size_t base = (size_t)bh * N * D;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tg = threadIdx.x & 3;

  stage_tile<D, true>(sQ, q + base, q0, N, scale);
  stage_tile<D, false>(sO, dout + base, q0, N, 1.f);
  __syncthreads();
  uint32_t qf[D / 16][4], of[D / 16][4];
  load_a<D>(qf, sQ, warp * 16, g, tg);
  load_a<D>(of, sO, warp * 16, g, tg);
  float lse_r[2], dl_r[2];  // rows g and g + 8 of this warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    lse_r[h] = row < N ? lse[(size_t)bh * N + row] : 0.f;
    dl_r[h] = row < N ? delta[(size_t)bh * N + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int nkb = (N + BT - 1) / BT;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BT;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile<D, false>(sK, k + base, k0, N, 1.f);
    stage_tile<D, false>(sV, v + base, k0, N, 1.f);
    __syncthreads();

    float s[BT / 8][4], dp[BT / 8][4];
    mma_abt<D>(s, qf, sK, g, tg);   // (q * scale) K^T
    mma_abt<D>(dp, of, sV, g, tg);  // dO V^T
    if (k0 + BT > N) {  // ragged tail tile
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt) {
        const int col = k0 + nt * 8 + tg * 2;
        if (col >= N) s[nt][0] = s[nt][2] = kNegInf;
        if (col + 1 >= N) s[nt][1] = s[nt][3] = kNegInf;
      }
    }
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - lse_r[e >> 1]);
        s[nt][e] = p * (dp[nt][e] - dl_r[e >> 1]);  // dS
      }
    }
    mma_pt<D>(acc, s, sK, g, tg);  // dQ += dS K
  }
  store_rows<D>(dq + base, acc, q0 + warp * 16, N, scale, g, tg);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int N, int nkb,
                              float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 sO[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 sK[BT * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BT * LD];
  __shared__ float sL[BT];
  __shared__ float sD[BT];

  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x % nkb) * BT;
  const size_t base = (size_t)bh * N * D;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tg = threadIdx.x & 3;

  stage_tile<D, false>(sK, k + base, k0, N, 1.f);
  stage_tile<D, false>(sV, v + base, k0, N, 1.f);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, sK, warp * 16, g, tg);
  load_a<D>(vf, sV, warp * 16, g, tg);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    dk_acc[d][0] = dk_acc[d][1] = dk_acc[d][2] = dk_acc[d][3] = 0.f;
    dv_acc[d][0] = dv_acc[d][1] = dv_acc[d][2] = dv_acc[d][3] = 0.f;
  }

  const int nqb = (N + BT - 1) / BT;
  for (int qb = 0; qb < nqb; ++qb) {
    const int q0 = qb * BT;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile<D, false>(sQ, q + base, q0, N, 1.f);
    stage_tile<D, false>(sO, dout + base, q0, N, 1.f);
    for (int i = threadIdx.x; i < BT; i += kThreads) {
      const bool in = q0 + i < N;
      sL[i] = in ? lse[(size_t)bh * N + q0 + i] : 0.f;
      sD[i] = in ? delta[(size_t)bh * N + q0 + i] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are this warp's keys, columns the queries
    float s[BT / 8][4], dp[BT / 8][4];
    mma_abt<D>(s, kf, sQ, g, tg);   // K Q^T
    mma_abt<D>(dp, vf, sO, g, tg);  // V dO^T
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tg * 2 + (e & 1);
        const float p = q0 + col < N ? expf(s[nt][e] * scale - sL[col]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sD[col]);  // dS^T
      }
    }
    mma_pt<D>(dv_acc, s, sO, g, tg);   // dV += P^T dO
    mma_pt<D>(dk_acc, dp, sQ, g, tg);  // dK += dS^T Q
  }
  store_rows<D>(dk + base, dk_acc, k0 + warp * 16, N, scale, g, tg);
  store_rows<D>(dv + base, dv_acc, k0 + warp * 16, N, 1.f, g, tg);
}

int tile_blocks(int BH, int N, int* ntiles) {
  *ntiles = (N + BT - 1) / BT;
  const long long blocks = (long long)BH * *ntiles;
  return blocks > 0x7fffffffLL ? -1 : (int)blocks;
}

}  // namespace

// q, k, v, dout, dq: (BH, N, D) bf16 contiguous; lse, delta: (BH, N) f32.
extern "C" int cra5_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int BH, int N, int D, float scale,
                                      void* stream) {
  int nqb;
  const int blocks = tile_blocks(BH, N, &nqb);
  if (D != 64 || blocks <= 0) return (int)cudaErrorInvalidValue;
  flash_attn_bwd_dq_kernel<64><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, N, nqb, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dout, dk, dv: (BH, N, D) bf16 contiguous; lse, delta: (BH, N) f32.
extern "C" int cra5_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int BH, int N, int D, float scale,
                                       void* stream) {
  int nkb;
  const int blocks = tile_blocks(BH, N, &nkb);
  if (D != 64 || blocks <= 0) return (int)cudaErrorInvalidValue;
  flash_attn_bwd_dkv_kernel<64><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, N, nkb, scale);
  return (int)cudaGetLastError();
}
