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
// Float32 operands take a second entry, cra5_flash_attn_fwd_f32, on the
// tensor cores with 3xTF32: each operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna), and each product is hi hi + hi lo + lo hi
// with float32 accumulators, which drops only the lo lo term (~2^-22
// relative) and keeps float32 accuracy. Bound: TF32 tensor-core
// operations, 3 * 4*N*N*D per head. The block is the bf16 K4's shape, with
// what float32 changes:
//   - BK = 64 keys a stage; q (pre-scaled in float32, as the TPU kernel
//     does with float32 inputs) is split once per block by its consumer;
//   - the tf32 wgmma reads both shared-memory operands K-major only. K is
//     K-major as stored for S = q K^T, but V is not for O += P V, so the
//     producer warpgroup (all four warps, lowered to 40 registers) splits
//     each raw K and V tile that TMA brought into hi and lo planes, writing
//     V's transposed (head dims x keys). Its first thread issues the TMA
//     loads into a one-stage raw ring; the split planes form a two-stage
//     ring, so the split of one tile overlaps the products of the last;
//   - a float32 row is two 128-byte swizzle atoms, so every tile is kept as
//     two halves of 32 head dims (or keys), each one TMA box (hopper.cuh);
//   - P is split in registers into the tf32 A operand, whose fragment
//     takes columns tg and tg + 4 of each 8-key step where the accumulator
//     holds 2 tg and 2 tg + 1: the split of V^T puts key 2c of each 8-key
//     group at column c and key 2c + 1 at column c + 4, so each thread's P
//     meets its own keys;
//   - the tensor cores' float32 sums truncate, which biases a long sum
//     toward zero (carried in O over the 10368 keys of a 268v global block
//     it put that block's float32 gradients ~8x past their 1e-5 bound on an
//     H100), so each stage's P V is summed in a fresh accumulator and added
//     to O by FFMA, rounded to nearest, and the small hi lo and lo hi terms
//     of every product go in before the hi hi terms;
//   - P multiplies V unrounded (its hi/lo pair keeps ~22 bits), the online
//     softmax runs in log2 units with one ex2 a logit, out and lse are
//     float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------------ float32
namespace f32 {

constexpr int BK = 64;  // keys a stage
constexpr int kSplitStages = 2;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 168 a thread at launch
constexpr int kQueryBytes = BQ * 64 * 4;
constexpr int kKeyBytes = BK * 64 * 4;

// Float32 tiles in two halves of 32 floats a row (hopper.cuh). q_hi holds
// raw q as TMA brings it, then q * scale split in place; the split planes
// of K are K-major as stored, those of V transposed (rows are head dims,
// halves are keys [0, 32) and [32, 64)). 225 KB of the 227 KB.
struct alignas(1024) F32Smem {
  float q_hi[2][BQ * 32];
  float q_lo[2][BQ * 32];
  float k_raw[2][BK * 32];
  float v_raw[2][BK * 32];
  float k_hi[kSplitStages][2][BK * 32];
  float k_lo[kSplitStages][2][BK * 32];
  float vt_hi[kSplitStages][2][64 * 32];
  float vt_lo[kSplitStages][2][64 * 32];
  uint64_t q_full, raw_full, split_full[kSplitStages], split_empty[kSplitStages];
};
constexpr int kSmemBytes = sizeof(F32Smem) + 1024;  // + the alignment slack

// The producer warpgroup: thread 0 issues the TMA loads (q once, then raw K
// and V of each stage); all 128 threads split each raw tile into its split
// stage once the consumers have released it.
__device__ __forceinline__ void producer(F32Smem& s, const CUtensorMap* map_q,
                                         const CUtensorMap* map_k, const CUtensorMap* map_v,
                                         int bh, int q0, int nkb) {
  const int t = threadIdx.x;
  auto load_kv = [&](int j) {
    hw::mbar_arrive_expect_tx(&s.raw_full, 2 * kKeyBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hw::tma_load_3d(s.k_raw[h], map_k, &s.raw_full, 32 * h, j * BK, bh);
      hw::tma_load_3d(s.v_raw[h], map_v, &s.raw_full, 32 * h, j * BK, bh);
    }
  };
  if (t == 0) {
    hw::mbar_arrive_expect_tx(&s.q_full, kQueryBytes);
    hw::tma_load_3d(s.q_hi[0], map_q, &s.q_full, 0, q0, bh);
    hw::tma_load_3d(s.q_hi[1], map_q, &s.q_full, 32, q0, bh);
    load_kv(0);
  }
  for (int j = 0; j < nkb; ++j) {
    const int ss = j % kSplitStages;
    hw::mbar_wait(&s.raw_full, j & 1);
    if (j >= kSplitStages) hw::mbar_wait(&s.split_empty[ss], (j / kSplitStages - 1) & 1);
    // K: hi and lo at the raw tile's own positions; V transposed
    hw::tf32_split_planes(s.k_raw[0], s.k_hi[ss][0], s.k_lo[ss][0], 2 * BK * 32 / 4, 1.f, t,
                          128);
    hw::tf32_split_transposed<BK>(s.v_raw[0], s.vt_hi[ss][0], s.vt_lo[ss][0], t);
    hw::fence_proxy_async();  // the planes are read by wgmma, the raw tiles rewritten by TMA
    hw::mbar_arrive(&s.split_full[ss]);
    hw::named_sync(3, 128);  // every producer thread is done with the raw tiles
    if (t == 0 && j + 1 < nkb) load_kv(j + 1);
  }
}

// One consumer warpgroup: query rows [r0, r0 + 64) of head bh, rows 64c of
// the block's q tile.
__device__ __forceinline__ void consumer(F32Smem& s, float* __restrict__ out,
                                         float* __restrict__ lse, int N, int bh, int r0, int nkb,
                                         float scale, int c) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;

  hw::mbar_wait(&s.q_full, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // q * scale in float32, split in place
    float* hi = &s.q_hi[h][c * 64 * 32];
    hw::tf32_split_planes(hi, hi, &s.q_lo[h][c * 64 * 32], 64 * 32 / 4, scale, t, 128);
  }
  hw::fence_proxy_async();
  hw::named_sync(1 + c, 128);

  // one descriptor a plane; a step adds its half's offset and 32 bytes a
  // step of 8 within it (a q half is BQ rows, a K or V^T half 64)
  const uint64_t qh = hw::sw128_desc(&s.q_hi[0][c * 64 * 32], 16, 1024);
  const uint64_t ql = hw::sw128_desc(&s.q_lo[0][c * 64 * 32], 16, 1024);
  constexpr int kQHalf = BQ * 128, kHalf = 64 * 128;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running row maxima (rows g, g + 8), log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  for (int j = 0; j < nkb; ++j) {
    const int ss = j % kSplitStages;
    hw::mbar_wait(&s.split_full[ss], (j / kSplitStages) & 1);

    // S = (q * scale) K^T, 64 rows x 64 keys, in head-dim steps of 8. The
    // tensor cores' sums truncate, so the small hi lo and lo hi terms go
    // first, summed at their own size, and the hi hi terms last: 8
    // truncations at the size of S, not 24.
    float sc[32];
    const uint64_t kh = hw::sw128_desc(s.k_hi[ss], 16, 1024);
    const uint64_t kl = hw::sw128_desc(s.k_lo[ss], 16, 1024);
    hw::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int qo = (k >> 2) * kQHalf + 32 * (k & 3), ko = (k >> 2) * kHalf + 32 * (k & 3);
      hw::wgmma_m64n64k8_tf32_ss(sc, hw::desc_add(qh, qo), hw::desc_add(kl, ko), k);
      hw::wgmma_m64n64k8_tf32_ss(sc, hw::desc_add(ql, qo), hw::desc_add(kh, ko), 1);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int qo = (k >> 2) * kQHalf + 32 * (k & 3), ko = (k >> 2) * kHalf + 32 * (k & 3);
      hw::wgmma_m64n64k8_tf32_ss(sc, hw::desc_add(qh, qo), hw::desc_add(kh, ko), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);

    const int k0 = j * BK;
    if (k0 + BK > N) {  // the ragged tail: zero-filled keys give 0, not -inf
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = k0 + 8 * n + 2 * tg;
        if (col >= N) sc[4 * n] = sc[4 * n + 2] = kNegInf;
        if (col + 1 >= N) sc[4 * n + 1] = sc[4 * n + 3] = kNegInf;
      }
    }

    float neg_m[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[h], mx * kLog2e);
      alpha[h] = hw::ex2(m2[h] - m_new);
      m2[h] = m_new;
      neg_m[h] = -m_new;
      l[h] *= alpha[h];
    }

    // P = exp2(S log2 e - m), split into the tf32 A operands of key step
    // kk (accumulator chunk kk): a = {P[g][2tg], P[g+8][2tg], P[g][2tg+1],
    // P[g+8][2tg+1]}, registers 4kk + {0, 2, 1, 3}
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = hw::ex2(fmaf(sc[4 * kk + e], kLog2e, neg_m[h]));
        l[h] += p;
        float hi, lo;
        hw::tf32_split(p, hi, lo);
        const int a = (e & 1) * 2 + h;  // register 4kk + e is A element a
        ph[kk][a] = __float_as_uint(hi);
        pl[kk][a] = __float_as_uint(lo);
      }
    }

    // this stage's P V in key steps of 8, small terms first
    // as for S, in an accumulator of its own: o takes it in float32 FFMA,
    // rounded to nearest, so the truncating sums never span the N keys
    float pv[32];
    const uint64_t vh = hw::sw128_desc(s.vt_hi[ss], 16, 1024);
    const uint64_t vl = hw::sw128_desc(s.vt_lo[ss], 16, 1024);
    hw::fence_regs(ph);
    hw::fence_regs(pl);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int vo = (kk >> 2) * kHalf + 32 * (kk & 3);
      hw::wgmma_m64n64k8_tf32_rs(pv, ph[kk], hw::desc_add(vl, vo), kk);
      hw::wgmma_m64n64k8_tf32_rs(pv, pl[kk], hw::desc_add(vh, vo), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int vo = (kk >> 2) * kHalf + 32 * (kk & 3);
      hw::wgmma_m64n64k8_tf32_rs(pv, ph[kk], hw::desc_add(vh, vo), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(pv);
    hw::fence_regs(ph);
    hw::fence_regs(pl);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.split_empty[ss]);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= N) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    float* dst = out + ((size_t)bh * N + row) * 64 + 2 * tg;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      *reinterpret_cast<float2*>(dst + 8 * d) =
          make_float2(o[4 * d + 2 * h] / lc, o[4 * d + 2 * h + 1] / lc);
    }
    if (tg == 0) lse[(size_t)bh * N + row] = m2[h] * kLn2 + logf(lc);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, float* __restrict__ out,
           float* __restrict__ lse, int N, int nqb, float scale) {
  extern __shared__ uint8_t smem_raw[];
  F32Smem& s = *reinterpret_cast<F32Smem*>(hw::align_1024(smem_raw));
  const int bh = blockIdx.x / nqb;
  const int q0 = (blockIdx.x % nqb) * BQ;
  const int nkb = (N + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hw::mbar_init(&s.q_full, 1);
    hw::mbar_init(&s.raw_full, 1);
    for (int st = 0; st < kSplitStages; ++st) {
      hw::mbar_init(&s.split_full[st], 128);  // every producer thread, after its writes
      hw::mbar_init(&s.split_empty[st], 8);   // one arrival per consumer warp
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hw::regs_dec<kProducerRegs>();
    producer(s, &map_q, &map_k, &map_v, bh, q0, nkb);
  } else {
    hw::regs_inc<kConsumerRegs>();
    consumer(s, out, lse, N, bh, q0 + (wg - 1) * 64, nkb, scale, wg - 1);
  }
}

}  // namespace f32

}  // namespace

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
  if (D != 64 || N < 1 || BH < 1) return (int)cudaErrorInvalidValue;
  const int nqb = (N + BQ - 1) / BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  if (!hw::make_tensor_map_3d(&map_q, q, N, BH, BQ, 4) ||
      !hw::make_tensor_map_3d(&map_k, k, N, BH, f32::BK, 4) ||
      !hw::make_tensor_map_3d(&map_v, v, N, BH, f32::BK, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e =
      hw::prepare(f32::kernel, f32::kSmemBytes, f32::kProducerRegs, f32::kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  f32::kernel<<<(unsigned)blocks, kThreads, f32::kSmemBytes, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, (float*)out, (float*)lse, N, nqb, scale);
  return (int)cudaGetLastError();
}
