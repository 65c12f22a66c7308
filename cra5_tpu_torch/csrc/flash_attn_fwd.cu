// K4 flash_attn_fwd: online-softmax attention forward, bf16 in and out,
// float32 accumulation and statistics, plus the log-sum-exp rows.
//
// Replaces the forward kernel of cra5_tpu/ops/attention.py (_fwd_kernel,
// driven by _flash_forward). Bound: tensor-core operations, 4*N*N*D per
// head against 3*N*D*2 bytes of q, k and v; at D = 64 the N*N exponentials
// on the special-function units (16 a clock per SM) come close to that
// bound too. So the design keeps the threads on products and exponentials
// and takes every load off them (Hopper pieces in hopper.cuh):
//   - a block of 384 threads owns BQ = 128 query rows: one producer
//     warpgroup, lowered to 24 registers, of which one thread issues every
//     TMA load, and two consumer warpgroups of 64 rows each, raised to 240;
//   - q arrives once by TMA; each consumer scales its rows in float32 and
//     rounds them back to bf16 in place (the TPU kernel's rounding point),
//     then fences the async proxy before wgmma reads them;
//   - K and V tiles of BK = 128 keys stream through a ring of kStages
//     stages with full and empty mbarriers. The 3-D tensor maps (D, N, BH)
//     zero-fill rows past N, never reading the next head, and the logits
//     of those keys are masked to -1e30;
//   - S = q K^T is wgmma m64n128k16 with both operands in shared memory;
//     the online softmax runs in registers in log2 units (one FFMA and one
//     ex2.approx a logit); P is rounded to bf16 straight into the register
//     A operand of O += P V, wgmma m64n64k16 with V MN-major; the row sums
//     of P stay float32;
//   - the epilogue divides by l (clamped at 1e-30), writes bf16 out and the
//     float32 lse rows in natural-log units, and drops rows past N.
// No atomics: the result is deterministic.
//
// Float32 operands take a second entry, cra5_flash_attn_fwd_f32, a SIMT
// tile in full float32 (flash_f32.cuh), with the TPU kernel's numerics for
// float32 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"
#include "hopper.cuh"

namespace {

namespace hw = cra5::hopper;

constexpr int BQ = 128;  // query rows a block, 64 per consumer warpgroup
constexpr int BK = 128;  // keys a ring stage
constexpr int kStages = 2;
constexpr int kThreads = 384;             // producer warpgroup + two consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 168 a thread at launch
constexpr int kTileBytes = 128 * 64 * 2;  // one 128-row bf16 tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Every tile is a multiple of 1024 bytes, so each starts 1024-aligned, as
// the 128-byte swizzle needs.
struct alignas(1024) FwdSmem {
  __nv_bfloat16 q[BQ * 64];
  __nv_bfloat16 k[kStages][BK * 64];
  __nv_bfloat16 v[kStages][BK * 64];
  uint64_t q_full, full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(FwdSmem) + 1024;  // + the alignment slack

// One consumer warpgroup: query rows [r0, r0 + 64) of head bh.
__device__ __forceinline__ void fwd_consumer(FwdSmem& s, __nv_bfloat16* __restrict__ out,
                                             float* __restrict__ lse, int N, int bh, int r0,
                                             int nkb, float scale, int c) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  __nv_bfloat16* sq = s.q + c * 64 * 64;

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
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running row maxima (rows g, g + 8), log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  for (int j = 0; j < nkb; ++j) {
    const int st = j % kStages;
    hw::mbar_wait(&s.full[st], (j / kStages) & 1);

    float sc[64];  // S = (q * scale) K^T, 64 rows x 128 keys
    const uint64_t k_desc = hw::sw128_desc(s.k[st], 16, 1024);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::wgmma_m64n128k16_ss(sc, hw::desc_add(q_desc, 32 * kk), hw::desc_add(k_desc, 32 * kk),
                              kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);

    const int k0 = j * BK;
    if (k0 + BK > N) {  // the ragged tail: zero-filled keys give 0, not -inf
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = k0 + 8 * n + 2 * tg;
        if (col >= N) sc[4 * n] = sc[4 * n + 2] = kNegInf;
        if (col + 1 >= N) sc[4 * n + 1] = sc[4 * n + 3] = kNegInf;
      }
    }

    float neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 16; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[h], mx * kLog2e);
      const float alpha = hw::ex2(m2[h] - m_new);
      m2[h] = m_new;
      neg_m[h] = -m_new;
      l[h] *= alpha;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        o[4 * d + 2 * h] *= alpha;
        o[4 * d + 2 * h + 1] *= alpha;
      }
    }

    // P = exp2(S log2 e - m), rounded to bf16 into the A operand of key
    // step kk: accumulator chunks 2kk and 2kk + 1 (registers 8kk .. 8kk + 7)
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int h = (e >> 1) & 1;
        p[e] = hw::ex2(fmaf(sc[8 * kk + e], kLog2e, neg_m[h]));
        l[h] += p[e];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) pa[kk][u] = hw::pack_bf16(p[2 * u], p[2 * u + 1]);
    }

    const uint64_t v_desc = hw::sw128_desc(s.v[st], BK * 128, 1024);  // MN-major
    hw::fence_regs(o);
    hw::fence_regs(pa);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      hw::wgmma_m64n64k16_rs(o, pa[kk], hw::desc_add(v_desc, 2048 * kk), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(o);
    hw::fence_regs(pa);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.empty[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= N) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst = out + ((size_t)bh * N + row) * 64 + 2 * tg;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(o[4 * d + 2 * h] / lc, o[4 * d + 2 * h + 1] / lc);
    }
    if (tg == 0) lse[(size_t)bh * N + row] = m2[h] * kLn2 + logf(lc);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int N,
                          int nqb, float scale) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(hw::align_1024(smem_raw));
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
      hw::mbar_arrive_expect_tx(&s.q_full, kTileBytes);
      hw::tma_load_3d(s.q, &map_q, &s.q_full, 0, q0, bh);
      for (int j = 0; j < nkb; ++j) {
        const int st = j % kStages;
        if (j >= kStages) hw::mbar_wait(&s.empty[st], (j / kStages - 1) & 1);
        hw::mbar_arrive_expect_tx(&s.full[st], 2 * kTileBytes);
        hw::tma_load_3d(s.k[st], &map_k, &s.full[st], 0, j * BK, bh);
        hw::tma_load_3d(s.v[st], &map_v, &s.full[st], 0, j * BK, bh);
      }
    }
  } else {  // consumers
    hw::regs_inc<kConsumerRegs>();
    fwd_consumer(s, out, lse, N, bh, q0 + (wg - 1) * 64, nkb, scale, wg - 1);
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
  if (D != 64 || N < 1 || BH < 1) return (int)cudaErrorInvalidValue;
  const int nqb = (N + BQ - 1) / BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  if (!hw::make_tensor_map_3d(&map_q, q, N, BH, BQ) ||
      !hw::make_tensor_map_3d(&map_k, k, N, BH, BK) ||
      !hw::make_tensor_map_3d(&map_v, v, N, BH, BK)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e =
      hw::prepare(flash_attn_fwd_kernel, kSmemBytes, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  flash_attn_fwd_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, (__nv_bfloat16*)out, (float*)lse, N, nqb, scale);
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
