// K4 flash_attn_fwd: online-softmax attention forward, bf16 in and out,
// float32 accumulation and statistics, plus the log-sum-exp rows.
//
// Replaces the forward kernel of cra5_tpu/ops/attention.py (_fwd_kernel,
// driven by _flash_forward). Bound: tensor-core operations (4*N*N*D per
// head against 3*N*D*2 bytes of q, k, v), so both products run on tensor
// cores via mma.sync m16n8k16 bf16 with float32 accumulators. One block of
// four warps owns BQ = 64 query rows (16 per warp, kept as A fragments in
// registers) and walks the keys in BK = 64 tiles staged in shared memory;
// the logits never reach device memory. As in the TPU kernel, q is
// pre-scaled and rounded to bf16 once, P is rounded to bf16 for the PV
// product while its row sums stay float32, and only the ragged tail tile
// is masked (-1e30). No atomics: the result is deterministic.
// Later work: wgmma, TMA loads and a pipelined K/V ring.
//
// Float32 operands take a second entry, cra5_flash_attn_fwd_f32, a SIMT
// tile in full float32 (flash_f32.cuh), with the TPU kernel's numerics for
// float32 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"
#include "mma.cuh"

namespace {

using cra5::mma_16816;
using cra5::pack_bf16;
using cra5::pack_bf16_raw;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int N, int nqb,
                          float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  constexpr int CH = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LD];

  const int bh = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * BQ;
  const size_t base = (size_t)bh * N * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int tg = lane & 3;  // thread in group

  for (int i = tid; i < BQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < N) val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * D + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * scale);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }
  __syncthreads();

  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* p0 = sQ + (warp * 16 + g) * LD + tg * 2;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(p0 + kk * 16);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(p1 + kk * 16);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + kk * 16 + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + kk * 16 + 8);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};  // rows g and g + 8 of this warp
  float l_row[2] = {0.f, 0.f};

  const int nkb = (N + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < N) {
        const size_t o = base + (size_t)(k0 + r) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + o);
        vv = *reinterpret_cast<const uint4*>(v + o);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vv;
    }
    __syncthreads();

    // S = (q * scale) K^T for this warp's 16 rows: BK / 8 tiles of 16x8
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* pk = sK + (nt * 8 + g) * LD + tg * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(pk + kk * 16),
                  *reinterpret_cast<const uint32_t*>(pk + kk * 16 + 8));
      }
    }
    if (k0 + BK > N) {  // ragged tail tile
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const int col = k0 + nt * 8 + tg * 2;
        if (col >= N) s[nt][0] = s[nt][2] = kNegInf;
        if (col + 1 >= N) s[nt][1] = s[nt][3] = kNegInf;
      }
    }

    float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[h] = fmaxf(m_row[h], mx);
      alpha[h] = expf(m_row[h] - m_new[h]);
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_new[e >> 1]);
        psum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l_row[h] = l_row[h] * alpha[h] + psum[h];
      m_row[h] = m_new[h];
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // acc += P V: the S accumulator tiles (2kk, 2kk+1) are exactly the A
    // fragment of key step kk, so P never leaves registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const __nv_bfloat16* pv = sV + (kk * 16 + tg * 2) * LD + g;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        const __nv_bfloat16* p = pv + d * 8;
        mma_16816(acc[d], a, pack_bf16_raw(p[0], p[LD]),
                  pack_bf16_raw(p[8 * LD], p[9 * LD]));
      }
    }
  }

  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= N) continue;
    const float l = fmaxf(l_row[h], 1e-30f);
    __nv_bfloat16* o = out + base + (size_t)row * D + tg * 2;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(o + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * h] / l, acc[d][2 * h + 1] / l);
    }
    if (tg == 0) lse[(size_t)bh * N + row] = m_row[h] + logf(l);
  }
}

}  // namespace

namespace cra5::f32attn {
namespace {

// The float32 forward: a SIMT tile (flash_f32.cuh). One block of 128
// threads owns 64 query rows, two threads a row, each holding half of its
// pre-scaled q and of its output accumulator in registers; keys and values
// are staged 64 rows at a time, and the online softmax rescales once per
// 16 keys. As in the TPU kernel with float32 inputs, q is scaled in
// float32 and P multiplies V unrounded. Bound: FP32 operations, 4*N*N*D
// per head at 67 TFLOP/s (the tile is limited by its shared-memory reads,
// one float4 for every four FFMAs).
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out,
                              float* __restrict__ lse, int N, int nqb, float scale) {
  __shared__ __align__(16) float sK[kTile * kLd];
  __shared__ __align__(16) float sV[kTile * kLd];

  const int bh = blockIdx.x / nqb;
  const int row = (blockIdx.x % nqb) * kRows + (threadIdx.x >> 1);
  const int h = threadIdx.x & 1;
  const int hoff = h ? kHoff : 0;
  const size_t base = (size_t)bh * N * kD;
  const bool valid = row < N;

  float qh[kHalf], acc[kHalf];
  load_half(qh, q + base + (size_t)row * kD, h, valid, scale);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage(sK, k + base, k0, N);
    stage(sV, v + base, k0, N);
    __syncthreads();
    const int nk = min(kTile, N - k0);
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float t = pair_dot(qh, sK + (j0 + j) * kLd + hoff);
        s[j] = j0 + j < nk ? t : kNegInf;  // the ragged tail
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * alpha + psum;
      m = m_new;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) half_axpy(acc, s[j], sV + (j0 + j) * kLd + hoff);
    }
  }
  if (!valid) return;
  l = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) acc[i] /= l;
  store_half(out + base + (size_t)row * kD, acc, h, 1.f);
  if (h == 0) lse[(size_t)bh * N + row] = m + logf(l);
}

}  // namespace
}  // namespace cra5::f32attn

// q, k, v, out: (BH, N, D) bf16 contiguous; lse: (BH, N) float32.
extern "C" int cra5_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int BH, int N, int D,
                                   float scale, void* stream) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  const int nqb = (N + BQ - 1) / BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attn_fwd_kernel<64><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, N, nqb, scale);
  return (int)cudaGetLastError();
}

// q, k, v, out: (BH, N, D) float32 contiguous; lse: (BH, N) float32.
extern "C" int cra5_flash_attn_fwd_f32(const void* q, const void* k, const void* v,
                                       void* out, void* lse, int BH, int N, int D,
                                       float scale, void* stream) {
  namespace fa = cra5::f32attn;
  int nqb;
  const int blocks = fa::row_blocks(BH, N, &nqb);
  if (D != fa::kD || blocks <= 0) return (int)cudaErrorInvalidValue;
  fa::flash_attn_fwd_f32_kernel<<<blocks, fa::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, N, nqb,
      scale);
  return (int)cudaGetLastError();
}
