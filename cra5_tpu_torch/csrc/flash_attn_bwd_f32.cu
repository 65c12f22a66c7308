// K5 and K6 on float32 operands: the flash-attention backward's dQ
// (cra5_flash_attn_bwd_dq_f32) and dK/dV (cra5_flash_attn_bwd_dkv_f32),
// float32 in and out, on the tensor cores with 3xTF32.
//
// Replace the two backward kernels of cra5_tpu/ops/attention.py
// (_bwd_dq_kernel and _bwd_dkv_kernel) on float32 inputs. Numerics are the
// TPU kernels' with float32 inputs: K5 uses q pre-scaled in float32, K6
// scales the float32 logits of raw q; dS and P multiply unrounded (each
// split into a tf32 hi/lo pair, ~22 bits); dq and dk are scaled once at the
// end. Keys past N get P = 0 in K5, query rows past N get P = 0 in K6. No
// atomics: two calls give equal bits.
//
// Bound: TF32 tensor-core operations, three products each of K5's 6 N^2 D
// and K6's 8 N^2 D per head at 495 TFLOP/s. The design is the float32 K4's
// (flash_attn_fwd.cu), with what the backward changes (pieces in
// hopper.cuh):
//   - every operand x is split into hi = tf32(x) and lo = tf32(x - hi),
//     and each product is hi lo + lo hi + hi hi, the small terms first;
//   - the tf32 wgmma reads shared-memory operands K-major only, so each
//     product that sums over the walked rows (dQ += dS K in K5; dV += P^T
//     dO and dK += dS^T Q in K6) takes a transposed plane (K^T; dO^T and
//     Q^T), its rows reordered within 8 for the tf32 register A fragment
//     that dS, P^T or dS^T fill straight from the accumulators. The
//     producer warpgroup (four warps at 40 registers; its first thread
//     issues every TMA load) writes those planes beside the planes as
//     stored while it splits each raw tile;
//   - the tensor cores' float32 sums truncate, which biases a long sum
//     toward zero, so each stage's dQ, dK and dV products go to fresh
//     accumulators that the consumers add to their running sums in float32,
//     rounded to nearest;
//   - shared memory sets the shape. A block owns 64 rows (queries in K5,
//     keys in K6) whose two operands stay resident as hi/lo planes (64 KB).
//     The walked rows come in stages of 32 through two raw TMA stages (16
//     KB each) and two split stages (K5: K, V and K^T hi/lo, 48 KB; K6: Q,
//     dO, Q^T and dO^T hi/lo, 64 KB): 193 KB in K5 and 225 KB in K6 of the
//     227. The two consumer warpgroups take the stages in turn (stage j to
//     consumer j % 2, split stage j % 2 its own), each over all 64 rows with
//     sums of its own, so one consumer's products overlap the other's
//     exponentials and the producer's split. At the end consumer 1 hands
//     its sums to consumer 0 through its split stage, and consumer 0 adds
//     them to its own, always in that order.
// What this shape costs: the logits products (m64n32k8, both operands in
// shared memory) read 3 KB per 16 clocks of tensor work, and with the
// producer's planes a stage moves ~105 (K5) and ~97 (K6) KB of shared
// memory per MFLOP, against ~66 in the float32 K4. Both run near a third of
// their bound on an H100. That shared-memory bandwidth holds them there is
// a hypothesis, not a measurement: taking the hi planes of the logits
// products from register A fragments, which cut those reads, left K6's
// time unchanged and gained K5 6.6%, which points away from it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hw = cra5::hopper;

constexpr int kRows = 64;  // rows a block owns: queries (K5) or keys (K6)
constexpr int kStep = 32;  // walked rows a stage: keys (K5) or queries (K6)
constexpr int kRawStages = 2;
constexpr int kSplitStages = 2;  // split stage j % 2 belongs to consumer j % 2
constexpr int kThreads = 384;    // producer warpgroup + two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 168 a thread at launch
constexpr int kResBytes = 2 * kRows * 64 * 4;  // the two resident tiles
constexpr int kRawBytes = 2 * kStep * 64 * 4;  // the two raw tiles of a stage
constexpr int kResHalf = kRows * 128;          // bytes of a half of a resident plane
constexpr int kStepHalf = kStep * 128;         // bytes of a half of a stage plane
constexpr float kLog2e = 1.4426950408889634f;

// The split planes of one stage's walked rows x and y: both as stored (two
// halves of 32 head dims), and x (with kNT = 2 also y) transposed: 64 head
// dims x 32 rows (hopper.cuh, tf32_split_transposed).
template <int kNT>
struct alignas(1024) Stage {
  float x_hi[2][kStep * 32], x_lo[2][kStep * 32];
  float y_hi[2][kStep * 32], y_lo[2][kStep * 32];
  float t_hi[kNT][64 * 32], t_lo[kNT][64 * 32];
};

// K5 (kNT = 1): a = q * scale, b = dO resident; x = K, y = V walked.
// K6 (kNT = 2): a = K, b = V resident; x = Q, y = dO walked, with their lse
// (times log2 e) and delta rows. a_hi and b_hi first hold the raw tiles as
// TMA brings them, then their hi planes, split in place.
template <int kNT>
struct alignas(1024) Smem {
  float a_hi[2][kRows * 32], a_lo[2][kRows * 32];
  float b_hi[2][kRows * 32], b_lo[2][kRows * 32];
  float x_raw[kRawStages][2][kStep * 32];
  float y_raw[kRawStages][2][kStep * 32];
  Stage<kNT> st[kSplitStages];
  float lse[kSplitStages][kStep];
  float delta[kSplitStages][kStep];
  uint64_t res_loaded, res_full, raw_full[kRawStages], split_full[kSplitStages],
      split_empty[kSplitStages];
};
template <int kNT>
constexpr int kSmemBytes = sizeof(Smem<kNT>) + 1024;  // + the alignment slack

template <int kNT>
__device__ __forceinline__ void init_barriers(Smem<kNT>& s) {
  if (threadIdx.x == 0) {
    hw::mbar_init(&s.res_loaded, 1);
    hw::mbar_init(&s.res_full, 128);  // every producer thread, after its split
    for (int r = 0; r < kRawStages; ++r) hw::mbar_init(&s.raw_full[r], 1);
    for (int st = 0; st < kSplitStages; ++st) {
      hw::mbar_init(&s.split_full[st], 128);
      hw::mbar_init(&s.split_empty[st], 4);  // the owning consumer's four warps
    }
    hw::mbar_init_fence();
  }
}

// The producer warpgroup: thread 0 issues the TMA loads (the resident tiles
// a and b once, then raw x and y of each stage, two stages ahead); all 128
// threads split the resident tiles in place (a times a_scale), then each
// raw stage into its split stage once its consumer has released it. In K6
// the first 32 threads also stage each step's lse (times log2 e) and delta.
template <int kNT>
__device__ __forceinline__ void producer(Smem<kNT>& s, const CUtensorMap* map_a,
                                         const CUtensorMap* map_b, const CUtensorMap* map_x,
                                         const CUtensorMap* map_y, const float* __restrict__ lse,
                                         const float* __restrict__ delta, int N, int bh, int r0,
                                         int nsteps, float a_scale) {
  const int t = threadIdx.x;
  auto load = [&](int j) {
    const int rs = j % kRawStages;
    hw::mbar_arrive_expect_tx(&s.raw_full[rs], kRawBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hw::tma_load_3d(s.x_raw[rs][h], map_x, &s.raw_full[rs], 32 * h, j * kStep, bh);
      hw::tma_load_3d(s.y_raw[rs][h], map_y, &s.raw_full[rs], 32 * h, j * kStep, bh);
    }
  };
  if (t == 0) {
    hw::mbar_arrive_expect_tx(&s.res_loaded, kResBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hw::tma_load_3d(s.a_hi[h], map_a, &s.res_loaded, 32 * h, r0, bh);
      hw::tma_load_3d(s.b_hi[h], map_b, &s.res_loaded, 32 * h, r0, bh);
    }
    for (int j = 0; j < kRawStages && j < nsteps; ++j) load(j);
  }
  hw::mbar_wait(&s.res_loaded, 0);
  hw::tf32_split_planes(s.a_hi[0], s.a_hi[0], s.a_lo[0], 2 * kRows * 32 / 4, a_scale, t, 128);
  hw::tf32_split_planes(s.b_hi[0], s.b_hi[0], s.b_lo[0], 2 * kRows * 32 / 4, 1.f, t, 128);
  hw::fence_proxy_async();  // the planes are read by wgmma
  hw::mbar_arrive(&s.res_full);

#pragma unroll 1
  for (int j = 0; j < nsteps; ++j) {
    const int rs = j % kRawStages, ss = j % kSplitStages;
    float l2 = 0.f, dl = 0.f;  // read before the waits, so the loads overlap them
    const int row = j * kStep + t;
    if (kNT == 2 && t < kStep && row < N) {
      l2 = lse[(size_t)bh * N + row] * kLog2e;
      dl = delta[(size_t)bh * N + row];
    }
    hw::mbar_wait(&s.raw_full[rs], (j / kRawStages) & 1);
    if (j >= kSplitStages) hw::mbar_wait(&s.split_empty[ss], (j / kSplitStages - 1) & 1);
    Stage<kNT>& p = s.st[ss];
    hw::tf32_split_planes(s.x_raw[rs][0], p.x_hi[0], p.x_lo[0], 2 * kStep * 32 / 4, 1.f, t, 128);
    hw::tf32_split_planes(s.y_raw[rs][0], p.y_hi[0], p.y_lo[0], 2 * kStep * 32 / 4, 1.f, t, 128);
    hw::tf32_split_transposed<kStep>(s.x_raw[rs][0], p.t_hi[0], p.t_lo[0], t);
    if (kNT == 2) {
      hw::tf32_split_transposed<kStep>(s.y_raw[rs][0], p.t_hi[kNT - 1], p.t_lo[kNT - 1], t);
      if (t < kStep) {
        s.lse[ss][t] = l2;
        s.delta[ss][t] = dl;
      }
    }
    hw::fence_proxy_async();  // the planes are read by wgmma, the raw tiles rewritten by TMA
    hw::mbar_arrive(&s.split_full[ss]);
    hw::named_sync(2, 128);  // every producer thread is done with raw stage rs
    if (t == 0 && j + kRawStages < nsteps) load(j + kRawStages);
  }
}

// S (64 x 32) = A B^T over the 64 head dims, A resident (a halves of 64
// rows), B a stage's walked rows (halves of 32), in steps of 8: the small
// hi lo and lo hi terms first, the hi hi terms last. Issued, not waited.
__device__ __forceinline__ void logits(float (&d)[16], uint64_t ah, uint64_t al, uint64_t bh,
                                       uint64_t bl) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ao = (k >> 2) * kResHalf + 32 * (k & 3), bo = (k >> 2) * kStepHalf + 32 * (k & 3);
    hw::wgmma_m64n32k8_tf32_ss(d, hw::desc_add(ah, ao), hw::desc_add(bl, bo), k);
    hw::wgmma_m64n32k8_tf32_ss(d, hw::desc_add(al, ao), hw::desc_add(bh, bo), 1);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ao = (k >> 2) * kResHalf + 32 * (k & 3), bo = (k >> 2) * kStepHalf + 32 * (k & 3);
    hw::wgmma_m64n32k8_tf32_ss(d, hw::desc_add(ah, ao), hw::desc_add(bh, bo), 1);
  }
}

// D (64 x 64), fresh, = A (64 x 32 walked rows, register fragments hi and
// lo) times a transposed plane (hi th, lo tl), small terms first. Issued,
// not waited.
__device__ __forceinline__ void update(float (&d)[32], const uint32_t (&ah)[4][4],
                                       const uint32_t (&al)[4][4], uint64_t th, uint64_t tl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hw::wgmma_m64n64k8_tf32_rs(d, ah[kk], hw::desc_add(tl, 32 * kk), kk);
    hw::wgmma_m64n64k8_tf32_rs(d, al[kk], hw::desc_add(th, 32 * kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hw::wgmma_m64n64k8_tf32_rs(d, ah[kk], hw::desc_add(th, 32 * kk), 1);
}

// Accumulator register 4n + e (e = 2h + j: row g + 8h, column 8n + 2tg + j)
// split into the tf32 A fragments of K step n, register a = 2j + h.
__device__ __forceinline__ void put(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], int n, int e,
                                    float x) {
  float h, l;
  hw::tf32_split(x, h, l);
  hi[n][(e & 1) * 2 + (e >> 1)] = __float_as_uint(h);
  lo[n][(e & 1) * 2 + (e >> 1)] = __float_as_uint(l);
}

// Consumer 1 hands its running sums to consumer 0 through its own split
// stage, which no later stage rewrites; consumer 0 adds them to its own
// (consumer 0's + consumer 1's, always) and returns true.
template <int kNT, int R>
__device__ __forceinline__ bool join(Smem<kNT>& s, float (&acc)[R], int c, int t) {
  float* xfer = reinterpret_cast<float*>(&s.st[1]);
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) xfer[i * 128 + t] = acc[i];
  }
  hw::named_sync(1, 256);
  if (c == 1) return false;
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += xfer[i * 128 + t];
  return true;
}

// Rows g and g + 8 of this warp's 16 in a (64 x 64) accumulator, times
// `scale`, into rows r0 + 16 warp + ... of a (BH, N, 64) float32 array.
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float* acc, int N,
                                           int bh, int r0, float scale, int t) {
  const int warp = t / 32, g = (t % 32) / 4, tg = t % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= N) continue;
    float* dst = out + ((size_t)bh * N + row) * 64 + 2 * tg;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      *reinterpret_cast<float2*>(dst + 8 * d) =
          make_float2(acc[4 * d + 2 * h] * scale, acc[4 * d + 2 * h + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ K5
// Consumer c of a K5 block: queries [r0, r0 + 64) of head bh, key stages
// j = c, c + 2, ...: S = (q scale) K^T and dP = dO V^T, P = exp2(S log2 e -
// lse log2 e) (0 for keys past N), dS = P (dP - delta), dQ += dS K.
__device__ __forceinline__ void dq_consumer(Smem<1>& s, const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            float* __restrict__ dq, int N, int bh, int r0,
                                            int nsteps, float scale, int c) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;

  float l2[2], dl[2];  // rows g and g + 8 of this warp; read before the wait
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    l2[h] = row < N ? lse[(size_t)bh * N + row] * kLog2e : 0.f;
    dl[h] = row < N ? delta[(size_t)bh * N + row] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  hw::mbar_wait(&s.res_full, 0);
  const uint64_t qh = hw::sw128_desc(s.a_hi[0], 16, 1024), ql = hw::sw128_desc(s.a_lo[0], 16, 1024);
  const uint64_t oh = hw::sw128_desc(s.b_hi[0], 16, 1024), ol = hw::sw128_desc(s.b_lo[0], 16, 1024);
  Stage<1>& p = s.st[c];
  const uint64_t kh = hw::sw128_desc(p.x_hi[0], 16, 1024), kl = hw::sw128_desc(p.x_lo[0], 16, 1024);
  const uint64_t vh = hw::sw128_desc(p.y_hi[0], 16, 1024), vl = hw::sw128_desc(p.y_lo[0], 16, 1024);
  const uint64_t th = hw::sw128_desc(p.t_hi[0], 16, 1024), tl = hw::sw128_desc(p.t_lo[0], 16, 1024);

#pragma unroll 1
  for (int j = c; j < nsteps; j += 2) {
    hw::mbar_wait(&s.split_full[c], (j >> 1) & 1);
    float sc[16], dp[16];  // 64 queries x 32 keys each
    hw::wgmma_fence();
    logits(sc, qh, ql, kh, kl);  // S = (q * scale) K^T
    logits(dp, oh, ol, vh, vl);  // dP = dO V^T
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);
    hw::fence_regs(dp);

    const int k0 = j * kStep;
    const bool ragged = k0 + kStep > N;
    uint32_t dsh[4][4], dsl[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, i = 4 * n + e;
        float pr = hw::ex2(fmaf(sc[i], kLog2e, -l2[h]));
        if (ragged && k0 + 8 * n + 2 * tg + (e & 1) >= N) pr = 0.f;
        put(dsh, dsl, n, e, pr * (dp[i] - dl[h]));
      }
    }

    float dqs[32];  // this stage's dS K
    hw::fence_regs(dsh);
    hw::fence_regs(dsl);
    hw::wgmma_fence();
    update(dqs, dsh, dsl, th, tl);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dqs);
    hw::fence_regs(dsh);
    hw::fence_regs(dsl);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.split_empty[c]);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += dqs[i];
  }

  if (join(s, acc, c, t)) store_rows(dq, acc, N, bh, r0, scale, t);
}

__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int N, int nblk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  Smem<1>& s = *reinterpret_cast<Smem<1>*>(hw::align_1024(smem_raw));
  const int bh = blockIdx.x / nblk;
  const int r0 = (blockIdx.x % nblk) * kRows;
  const int nsteps = (N + kStep - 1) / kStep;
  const int wg = threadIdx.x / 128;
  init_barriers(s);
  __syncthreads();
  if (wg == 0) {
    hw::regs_dec<kProducerRegs>();
    producer(s, &map_q, &map_do, &map_k, &map_v, nullptr, nullptr, N, bh, r0, nsteps, scale);
  } else {
    hw::regs_inc<kConsumerRegs>();
    dq_consumer(s, lse, delta, dq, N, bh, r0, nsteps, scale, wg - 1);
  }
}

// ------------------------------------------------------------------ K6
// Consumer c of a K6 block: keys [r0, r0 + 64) of head bh, query stages
// j = c, c + 2, ...: S^T = K Q^T and dP^T = V dO^T, P^T = exp2(S^T scale
// log2 e - lse log2 e) (0 for queries past N), dS^T = P^T (dP^T - delta),
// dV += P^T dO and dK += dS^T Q.
__device__ __forceinline__ void dkv_consumer(Smem<2>& s, float* __restrict__ dk,
                                             float* __restrict__ dv, int N, int bh, int r0,
                                             int nsteps, float scale, int c) {
  const int t = threadIdx.x % 128;
  const int lane = t % 32, tg = lane % 4;
  const float sl = scale * kLog2e;
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hw::mbar_wait(&s.res_full, 0);
  const uint64_t kh = hw::sw128_desc(s.a_hi[0], 16, 1024), kl = hw::sw128_desc(s.a_lo[0], 16, 1024);
  const uint64_t vh = hw::sw128_desc(s.b_hi[0], 16, 1024), vl = hw::sw128_desc(s.b_lo[0], 16, 1024);
  Stage<2>& p = s.st[c];
  const uint64_t qh = hw::sw128_desc(p.x_hi[0], 16, 1024), ql = hw::sw128_desc(p.x_lo[0], 16, 1024);
  const uint64_t oh = hw::sw128_desc(p.y_hi[0], 16, 1024), ol = hw::sw128_desc(p.y_lo[0], 16, 1024);
  const uint64_t qth = hw::sw128_desc(p.t_hi[0], 16, 1024);
  const uint64_t qtl = hw::sw128_desc(p.t_lo[0], 16, 1024);
  const uint64_t oth = hw::sw128_desc(p.t_hi[1], 16, 1024);
  const uint64_t otl = hw::sw128_desc(p.t_lo[1], 16, 1024);

#pragma unroll 1
  for (int j = c; j < nsteps; j += 2) {
    hw::mbar_wait(&s.split_full[c], (j >> 1) & 1);
    float sT[16], dpT[16];  // 64 keys x 32 queries each
    hw::wgmma_fence();
    logits(sT, kh, kl, qh, ql);   // S^T = K Q^T
    logits(dpT, vh, vl, oh, ol);  // dP^T = V dO^T
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sT);
    hw::fence_regs(dpT);

    const int q0 = j * kStep;
    const bool ragged = q0 + kStep > N;
    uint32_t ph[4][4], pl[4][4], dsh[4][4], dsl[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(&s.lse[c][8 * n + 2 * tg]);
      const float2 dl = *reinterpret_cast<const float2*>(&s.delta[c][8 * n + 2 * tg]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = e & 1, i = 4 * n + e;
        float pr = hw::ex2(fmaf(sT[i], sl, -(jj ? l2.y : l2.x)));
        if (ragged && q0 + 8 * n + 2 * tg + jj >= N) pr = 0.f;
        put(ph, pl, n, e, pr);
        put(dsh, dsl, n, e, pr * (dpT[i] - (jj ? dl.y : dl.x)));
      }
    }

    // this stage's P^T dO, then its dS^T Q, in one fresh accumulator: the
    // two in flight at once would take 32 more registers than the 232
    float fresh[32];
    hw::fence_regs(ph);
    hw::fence_regs(pl);
    hw::wgmma_fence();
    update(fresh, ph, pl, oth, otl);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(fresh);
    hw::fence_regs(ph);
    hw::fence_regs(pl);
#pragma unroll
    for (int i = 0; i < 32; ++i) dv_acc[i] += fresh[i];
    hw::fence_regs(fresh);
    hw::fence_regs(dsh);
    hw::fence_regs(dsl);
    hw::wgmma_fence();
    update(fresh, dsh, dsl, qth, qtl);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(fresh);
    hw::fence_regs(dsh);
    hw::fence_regs(dsl);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.split_empty[c]);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] += fresh[i];
  }

  float both[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    both[i] = dk_acc[i];
    both[32 + i] = dv_acc[i];
  }
  if (!join(s, both, c, t)) return;
  store_rows(dk, both, N, bh, r0, scale, t);
  store_rows(dv, both + 32, N, bh, r0, 1.f, t);
}

__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int N, int nblk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  Smem<2>& s = *reinterpret_cast<Smem<2>*>(hw::align_1024(smem_raw));
  const int bh = blockIdx.x / nblk;
  const int r0 = (blockIdx.x % nblk) * kRows;
  const int nsteps = (N + kStep - 1) / kStep;
  const int wg = threadIdx.x / 128;
  init_barriers(s);
  __syncthreads();
  if (wg == 0) {
    hw::regs_dec<kProducerRegs>();
    producer(s, &map_k, &map_v, &map_q, &map_do, lse, delta, N, bh, r0, nsteps, 1.f);
  } else {
    hw::regs_inc<kConsumerRegs>();
    dkv_consumer(s, dk, dv, N, bh, r0, nsteps, scale, wg - 1);
  }
}

// The blocks of a launch (BH x row blocks of 64), or -1 when out of range;
// the resident maps box 64 rows, the walked ones 32.
int prepare_launch(const void* res_a, const void* res_b, const void* walk_x, const void* walk_y,
                   CUtensorMap* maps, int BH, int N, int D, int* nblk) {
  if (D != 64 || N < 1 || BH < 1) return -1;
  *nblk = (N + kRows - 1) / kRows;
  const long long blocks = (long long)BH * *nblk;
  if (blocks > 0x7fffffffLL) return -1;
  if (!hw::make_tensor_map_3d(&maps[0], res_a, N, BH, kRows, 4) ||
      !hw::make_tensor_map_3d(&maps[1], res_b, N, BH, kRows, 4) ||
      !hw::make_tensor_map_3d(&maps[2], walk_x, N, BH, kStep, 4) ||
      !hw::make_tensor_map_3d(&maps[3], walk_y, N, BH, kStep, 4)) {
    return -1;
  }
  return (int)blocks;
}

}  // namespace

// q, k, v, dout, dq: (BH, N, D) float32 contiguous; lse, delta: (BH, N) f32.
extern "C" int cra5_flash_attn_bwd_dq_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int BH, int N, int D, float scale,
                                          void* stream) {
  CUtensorMap maps[4];
  int nblk;
  const int blocks = prepare_launch(q, dout, k, v, maps, BH, N, D, &nblk);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = hw::prepare(dq_kernel, kSmemBytes<1>, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<(unsigned)blocks, kThreads, kSmemBytes<1>, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dq, N,
      nblk, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dout, dk, dv: (BH, N, D) float32 contiguous; lse, delta: (BH, N) f32.
extern "C" int cra5_flash_attn_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int BH,
                                           int N, int D, float scale, void* stream) {
  CUtensorMap maps[4];
  int nblk;
  const int blocks = prepare_launch(k, v, q, dout, maps, BH, N, D, &nblk);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = hw::prepare(dkv_kernel, kSmemBytes<2>, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<<<(unsigned)blocks, kThreads, kSmemBytes<2>, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, N, nblk, scale);
  return (int)cudaGetLastError();
}
