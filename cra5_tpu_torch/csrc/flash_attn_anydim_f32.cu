// K4, K5 and K6 at every head dim on float32 operands, on the tensor cores
// with 3xTF32: the float32 halves of cra5_flash_attn_fwd_anydim,
// cra5_flash_attn_bwd_dq_anydim and cra5_flash_attn_bwd_dkv_anydim
// (flash_attn_anydim.cu, which dispatches here), for every head dim D <= 96
// with D % 4 == 0.
//
// Replace _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel of
// cra5_tpu/ops/attention.py on float32 inputs at those head dims. Bound:
// TF32 tensor-core operations, three products each of K4's 4 N^2 D, K5's 6
// N^2 D and K6's 8 N^2 D per head at 495 TFLOP/s. The design and the
// numerics are the head-dim-64 float32 kernels' (flash_attn_fwd.cu,
// namespace f32; flash_attn_bwd_f32.cu): every operand split into hi =
// tf32(x) and lo = tf32(x - hi), each product hi lo + lo hi + hi hi with the
// small terms first, each stage's P V, dQ, dV and dK products in a fresh
// accumulator added to the running sums in float32, a producer warpgroup
// that splits each raw tile TMA brings into the planes wgmma reads (the tf32
// forms read K-major only, so a product that sums over the walked rows takes
// a transposed plane, its rows reordered within 8 for the tf32 register A
// fragment). What another head dim changes:
//   - a float32 row is NB = ceil(D / 32) boxes of 32 floats, one 128-byte
//     swizzle atom each, loaded by TMA from maps of D columns; columns past D
//     arrive as zeros (out-of-bounds fill), so they add nothing to any sum;
//   - S (and dP, dP^T) sum over the head dim in k-steps of 8, NP / 8 of them
//     (NP below; a count known at compile time keeps branches out of the
//     products, where ptxas would fence each one): 72 pads to 80. The
//     products whose N is the head dim read a transposed plane whose rows
//     are head dims, so N is any multiple of 8 and needs no swizzle atom of
//     its own: it runs as pieces of 64, 32 and 16 rows, N rounded up to NP,
//     a multiple of 16 (72 to 80);
//   - shared memory sets the tiles. At NB = 3 a 32-float row takes 1.5x the
//     head-dim-64 bytes, whose kernels use 225 KB of the 227. K4 keeps its
//     128-query blocks (two consumers of 64, q resident as hi/lo planes, 96
//     KB) and walks 32-key stages (one raw stage, two split stages: 216 KB).
//     K6 keeps its 64-key blocks (K and V resident as hi/lo planes, 96 KB)
//     and walks 16-query stages; the transposed planes of a stage's Q and dO
//     share one 128-byte row, Q^T in columns 0-15 and dO^T in 16-31 (two raw
//     stages and two split stages: 216 KB). The two consumers take the
//     stages in turn and add their sums at the end, consumer 0's first.
//     K5 keeps the head-dim-64 K5's 64-query blocks (q and dO resident as
//     hi/lo planes) and its 32-key stages (K and V as stored and K^T, hi and
//     lo), which at three full boxes would need 264 KB. Three shapes were
//     weighed: 16-key stages everywhere (216 KB; the logits products m64n16k8,
//     the shape that holds the float32 K6 at 13-20% of its bound), 24-key
//     stages (K^T rows of 24 floats fill no swizzle atom), and keeping the
//     columns past 64 at 72 and 80 in a 16-float tail box with the 64-byte
//     swizzle (as the 16-bit kernels keep theirs), which brings 80 columns to
//     220 KB with one raw stage. The last is built: D = 72, the 268v
//     hyperprior's head dim, runs m64n32k8 logits; past 80 (three full
//     boxes) the stages take 16 keys, and up to 64 the head-dim-64 layout
//     fits as it is. The tail's transposed split reads the 64-byte swizzle
//     (split_tail_transposed).
// Keys (K4, K5) and queries (K6) past N are masked; rows past N are not written.
// No atomics: two calls give equal bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hw = cra5::hopper;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte offset of K step k (8 head dims) of a tile kept as 32-float boxes of
// `rows` rows each: box k / 4, 32 bytes a step within it.
__device__ __forceinline__ uint32_t kstep(int k, int rows) {
  return (k >> 2) * rows * 128 + 32 * (k & 3);
}

// D (64 x NP) of one 8-row K step, A from registers, B a transposed plane
// whose rows are the NP output columns: pieces of 64, 32 and 16 rows.
template <int NP>
__device__ __forceinline__ void rs_np(float (&d)[NP / 2], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  constexpr int n64 = NP >= 64 ? 64 : 0;
  constexpr int n32 = (NP - n64) & 32;
  constexpr int n16 = (NP - n64) & 16;
  static_assert(n64 + n32 + n16 == NP, "NP is 16, 32, 48, 64, 80 or 96");
  if constexpr (n64 != 0) {
    hw::wgmma_m64n64k8_tf32_rs(*reinterpret_cast<float(*)[32]>(&d[0]), a, b, scale_d);
  }
  if constexpr (n32 != 0) {
    hw::wgmma_m64n32k8_tf32_rs(*reinterpret_cast<float(*)[16]>(&d[n64 / 2]), a,
                               hw::desc_add(b, n64 * 128), scale_d);
  }
  if constexpr (n16 != 0) {
    hw::wgmma_m64n16k8_tf32_rs(*reinterpret_cast<float(*)[8]>(&d[(n64 + n32) / 2]), a,
                               hw::desc_add(b, (n64 + n32) * 128), scale_d);
  }
}

// D (64 x NP), fresh, = A (64 x 8 KS walked rows, register fragments hi
// and lo) times a transposed plane (hi th, lo tl, K steps from byte c0 of
// each row), small terms first. Issued, not waited.
template <int NP, int KS>
__device__ __forceinline__ void update(float (&d)[NP / 2], const uint32_t (&ah)[KS][4],
                                       const uint32_t (&al)[KS][4], uint64_t th, uint64_t tl,
                                       int c0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    rs_np<NP>(d, ah[kk], hw::desc_add(tl, c0 + 32 * kk), kk);
    rs_np<NP>(d, al[kk], hw::desc_add(th, c0 + 32 * kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) rs_np<NP>(d, ah[kk], hw::desc_add(th, c0 + 32 * kk), 1);
}

// Accumulator register 4n + e (e = 2h + j: row g + 8h, column 8n + 2tg + j)
// split into the tf32 A fragments of K step n, register a = 2j + h.
template <int KS>
__device__ __forceinline__ void put(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4], int n, int e,
                                    float x) {
  float h, l;
  hw::tf32_split(x, h, l);
  hi[n][(e & 1) * 2 + (e >> 1)] = __float_as_uint(h);
  lo[n][(e & 1) * 2 + (e >> 1)] = __float_as_uint(l);
}

// Rows g and g + 8 of this warp's 16 in a (64 x NP) accumulator, times
// `scale`, into rows r0 + 16 warp + ... of a (BH, N, D) float32 array; the
// columns past D are not written.
template <int NP>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float* acc, int N,
                                           int D, int bh, int r0, float scale, int t) {
  const int warp = t / 32, g = (t % 32) / 4, tg = t % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= N) continue;
    float* dst = out + ((size_t)bh * N + row) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < NP / 8; ++n) {
      if (8 * n + 2 * tg < D) {
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
      }
    }
  }
}

// Consumer 1 of a block whose two consumers take the split stages in turn
// (K5, K6) hands its running sums to consumer 0 through its own split stage
// st[1], which no later stage rewrites; consumer 0 adds them to its own
// (consumer 0's + consumer 1's, always) and returns true.
template <class Smem, int R>
__device__ __forceinline__ bool join(Smem& s, float (&acc)[R], int c, int t) {
  static_assert(R * 128 * 4 <= sizeof(s.st[1]), "the sums fit a split stage");
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

// ------------------------------------------------------------------ K4
namespace fwd {

constexpr int BQ = 128;  // query rows a block, 64 per consumer warpgroup
constexpr int BK = 32;   // keys a stage
constexpr int kSplitStages = 2;

// q_hi holds raw q as TMA brings it, then q * scale split in place; K's
// planes as stored, V's transposed (rows are head dims, columns the 32 keys).
template <int NB>
struct alignas(1024) Smem {
  float q_hi[NB][BQ * 32], q_lo[NB][BQ * 32];
  float k_raw[NB][BK * 32], v_raw[NB][BK * 32];
  float k_hi[kSplitStages][NB][BK * 32], k_lo[kSplitStages][NB][BK * 32];
  float vt_hi[kSplitStages][NB * 32 * 32], vt_lo[kSplitStages][NB * 32 * 32];
  uint64_t q_full, raw_full, split_full[kSplitStages], split_empty[kSplitStages];
};

// The producer warpgroup: thread 0 issues the TMA loads (q once, then raw K
// and V of each stage); all 128 threads split each raw tile into its split
// stage once the consumers have released it.
template <int NB>
__device__ __forceinline__ void producer(Smem<NB>& s, const CUtensorMap* map_q,
                                         const CUtensorMap* map_k, const CUtensorMap* map_v,
                                         int bh, int q0, int nkb) {
  const int t = threadIdx.x;
  auto load_kv = [&](int j) {
    hw::mbar_arrive_expect_tx(&s.raw_full, 2 * NB * BK * 128);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      hw::tma_load_3d(s.k_raw[b], map_k, &s.raw_full, 32 * b, j * BK, bh);
      hw::tma_load_3d(s.v_raw[b], map_v, &s.raw_full, 32 * b, j * BK, bh);
    }
  };
  if (t == 0) {
    hw::mbar_arrive_expect_tx(&s.q_full, NB * BQ * 128);
#pragma unroll
    for (int b = 0; b < NB; ++b) hw::tma_load_3d(s.q_hi[b], map_q, &s.q_full, 32 * b, q0, bh);
    load_kv(0);
  }
  for (int j = 0; j < nkb; ++j) {
    const int ss = j % kSplitStages;
    hw::mbar_wait(&s.raw_full, j & 1);
    if (j >= kSplitStages) hw::mbar_wait(&s.split_empty[ss], (j / kSplitStages - 1) & 1);
    hw::tf32_split_planes(s.k_raw[0], s.k_hi[ss][0], s.k_lo[ss][0], NB * BK * 32 / 4, 1.f, t,
                          128);
    hw::tf32_split_transposed<NB, BK>(s.v_raw[0], s.vt_hi[ss], s.vt_lo[ss], 0, t);
    hw::fence_proxy_async();  // the planes are read by wgmma, the raw tiles rewritten by TMA
    hw::mbar_arrive(&s.split_full[ss]);
    hw::named_sync(3, 128);  // every producer thread is done with the raw tiles
    if (t == 0 && j + 1 < nkb) load_kv(j + 1);
  }
}

// One consumer warpgroup: query rows [r0, r0 + 64) of head bh, rows 64c of
// the block's q tile.
template <int NB, int NP>
__device__ __forceinline__ void consumer(Smem<NB>& s, float* __restrict__ out,
                                         float* __restrict__ lse, int N, int D, int bh, int r0,
                                         int nkb, float scale, int c) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  hw::mbar_wait(&s.q_full, 0);
#pragma unroll
  for (int b = 0; b < NB; ++b) {  // q * scale in float32, split in place
    float* hi = &s.q_hi[b][c * 64 * 32];
    hw::tf32_split_planes(hi, hi, &s.q_lo[b][c * 64 * 32], 64 * 32 / 4, scale, t, 128);
  }
  hw::fence_proxy_async();
  hw::named_sync(1 + c, 128);

  const uint64_t qh = hw::sw128_desc(&s.q_hi[0][c * 64 * 32], 16, 1024);
  const uint64_t ql = hw::sw128_desc(&s.q_lo[0][c * 64 * 32], 16, 1024);
  float o[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) o[i] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running row maxima (rows g, g + 8), log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  for (int j = 0; j < nkb; ++j) {
    const int ss = j % kSplitStages;
    hw::mbar_wait(&s.split_full[ss], (j / kSplitStages) & 1);

    // S = (q * scale) K^T, 64 rows x 32 keys, in NP / 8 head-dim steps of
    // 8 (steps past D multiply zeros; a step count known at compile time
    // keeps the products free of branches): the small hi lo and lo hi terms
    // first, the hi hi terms last
    float sc[16];
    const uint64_t kh = hw::sw128_desc(s.k_hi[ss][0], 16, 1024);
    const uint64_t kl = hw::sw128_desc(s.k_lo[ss][0], 16, 1024);
    hw::wgmma_fence();
#pragma unroll
    for (int k = 0; k < NP / 8; ++k) {
      const uint32_t qo = kstep(k, BQ), ko = kstep(k, BK);
      hw::wgmma_m64n32k8_tf32_ss(sc, hw::desc_add(qh, qo), hw::desc_add(kl, ko), k);
      hw::wgmma_m64n32k8_tf32_ss(sc, hw::desc_add(ql, qo), hw::desc_add(kh, ko), 1);
    }
#pragma unroll
    for (int k = 0; k < NP / 8; ++k) {
      hw::wgmma_m64n32k8_tf32_ss(sc, hw::desc_add(qh, kstep(k, BQ)),
                                 hw::desc_add(kh, kstep(k, BK)), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);

    const int k0 = j * BK;
    if (k0 + BK > N) {  // the ragged tail: zero-filled keys give 0, not -inf
#pragma unroll
      for (int n = 0; n < 4; ++n) {
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
      for (int n = 0; n < 4; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[h], mx * kLog2e);
      alpha[h] = hw::ex2(m2[h] - m_new);
      m2[h] = m_new;
      neg_m[h] = -m_new;
      l[h] *= alpha[h];
    }

    // P = exp2(S log2 e - m), split into the tf32 A operands of key step kk
    // (accumulator chunk kk)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hw::ex2(fmaf(sc[4 * kk + e], kLog2e, neg_m[e >> 1]));
        l[e >> 1] += p;
        put(ph, pl, kk, e, p);
      }
    }

    // this stage's P V in an accumulator of its own: o takes it in float32
    // FFMA, rounded to nearest, so the truncating sums never span the N keys
    float pv[NP / 2];
    const uint64_t vh = hw::sw128_desc(s.vt_hi[ss], 16, 1024);
    const uint64_t vl = hw::sw128_desc(s.vt_lo[ss], 16, 1024);
    hw::fence_regs(ph);
    hw::fence_regs(pl);
    hw::wgmma_fence();
    update<NP, 4>(pv, ph, pl, vh, vl, 0);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(pv);
    hw::fence_regs(ph);
    hw::fence_regs(pl);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.split_empty[ss]);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row < N && tg == 0) lse[(size_t)bh * N + row] = m2[h] * kLn2 + logf(l[h]);
  }
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) o[i] /= l[(i >> 1) & 1];
  store_rows<NP>(out, o, N, D, bh, r0, 1.f, t);
}

template <int NB, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, float* __restrict__ out,
           float* __restrict__ lse, int N, int D, int nqb, float scale) {
  extern __shared__ uint8_t smem_raw[];
  Smem<NB>& s = *reinterpret_cast<Smem<NB>*>(hw::align_1024(smem_raw));
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
    consumer<NB, NP>(s, out, lse, N, D, bh, q0 + (wg - 1) * 64, nkb, scale, wg - 1);
  }
}

template <int NP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int N,
           int D, float scale, cudaStream_t stream) {
  constexpr int NB = (NP + 31) / 32;
  constexpr int kSmemBytes = sizeof(Smem<NB>) + 1024;  // + the alignment slack
  const int nqb = (N + BQ - 1) / BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  if (!hw::make_tensor_map_3d(&map_q, q, N, BH, BQ, 4, D) ||
      !hw::make_tensor_map_3d(&map_k, k, N, BH, BK, 4, D) ||
      !hw::make_tensor_map_3d(&map_v, v, N, BH, BK, 4, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = hw::prepare(kernel<NB, NP>, kSmemBytes, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  kernel<NB, NP><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      map_q, map_k, map_v, (float*)out, (float*)lse, N, D, nqb, scale);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// ------------------------------------------------------------------ K6
namespace dkv {

constexpr int kRows = 64;  // keys a block owns
constexpr int kStep = 16;  // queries a stage
constexpr int kRawStages = 2;
constexpr int kSplitStages = 2;  // split stage j % 2 belongs to consumer j % 2

// The split planes of one stage's queries: Q (x) and dO (y) as stored, NB
// boxes of 16 rows, and both transposed into one plane of 32 NB head-dim
// rows, Q^T in columns 0-15 and dO^T in 16-31.
template <int NB>
struct alignas(1024) Stage {
  float x_hi[NB][kStep * 32], x_lo[NB][kStep * 32];
  float y_hi[NB][kStep * 32], y_lo[NB][kStep * 32];
  float t_hi[NB * 32 * 32], t_lo[NB * 32 * 32];
};

// a = K, b = V resident: raw as TMA brings them, then their hi planes, split
// in place.
template <int NB>
struct alignas(1024) Smem {
  float a_hi[NB][kRows * 32], a_lo[NB][kRows * 32];
  float b_hi[NB][kRows * 32], b_lo[NB][kRows * 32];
  float x_raw[kRawStages][NB][kStep * 32];
  float y_raw[kRawStages][NB][kStep * 32];
  Stage<NB> st[kSplitStages];
  float lse[kSplitStages][kStep];  // lse * log2 e
  float delta[kSplitStages][kStep];
  uint64_t res_loaded, res_full, raw_full[kRawStages], split_full[kSplitStages],
      split_empty[kSplitStages];
};

// The producer warpgroup: thread 0 issues the TMA loads (K and V once, then
// raw Q and dO of each stage, two stages ahead); all 128 threads split K and
// V in place, then each raw stage into its split stage once its consumer has
// released it; the first 16 stage each step's lse (times log2 e) and delta.
template <int NB>
__device__ __forceinline__ void producer(Smem<NB>& s, const CUtensorMap* map_k,
                                         const CUtensorMap* map_v, const CUtensorMap* map_q,
                                         const CUtensorMap* map_do, const float* __restrict__ lse,
                                         const float* __restrict__ delta, int N, int bh, int r0,
                                         int nsteps) {
  const int t = threadIdx.x;
  auto load = [&](int j) {
    const int rs = j % kRawStages;
    hw::mbar_arrive_expect_tx(&s.raw_full[rs], 2 * NB * kStep * 128);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      hw::tma_load_3d(s.x_raw[rs][b], map_q, &s.raw_full[rs], 32 * b, j * kStep, bh);
      hw::tma_load_3d(s.y_raw[rs][b], map_do, &s.raw_full[rs], 32 * b, j * kStep, bh);
    }
  };
  if (t == 0) {
    hw::mbar_arrive_expect_tx(&s.res_loaded, 2 * NB * kRows * 128);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      hw::tma_load_3d(s.a_hi[b], map_k, &s.res_loaded, 32 * b, r0, bh);
      hw::tma_load_3d(s.b_hi[b], map_v, &s.res_loaded, 32 * b, r0, bh);
    }
    for (int j = 0; j < kRawStages && j < nsteps; ++j) load(j);
  }
  hw::mbar_wait(&s.res_loaded, 0);
  hw::tf32_split_planes(s.a_hi[0], s.a_hi[0], s.a_lo[0], NB * kRows * 32 / 4, 1.f, t, 128);
  hw::tf32_split_planes(s.b_hi[0], s.b_hi[0], s.b_lo[0], NB * kRows * 32 / 4, 1.f, t, 128);
  hw::fence_proxy_async();  // the planes are read by wgmma
  hw::mbar_arrive(&s.res_full);

#pragma unroll 1
  for (int j = 0; j < nsteps; ++j) {
    const int rs = j % kRawStages, ss = j % kSplitStages;
    float l2 = 0.f, dl = 0.f;  // read before the waits, so the loads overlap them
    const int row = j * kStep + t;
    if (t < kStep && row < N) {
      l2 = lse[(size_t)bh * N + row] * kLog2e;
      dl = delta[(size_t)bh * N + row];
    }
    hw::mbar_wait(&s.raw_full[rs], (j / kRawStages) & 1);
    if (j >= kSplitStages) hw::mbar_wait(&s.split_empty[ss], (j / kSplitStages - 1) & 1);
    Stage<NB>& p = s.st[ss];
    hw::tf32_split_planes(s.x_raw[rs][0], p.x_hi[0], p.x_lo[0], NB * kStep * 32 / 4, 1.f, t,
                          128);
    hw::tf32_split_planes(s.y_raw[rs][0], p.y_hi[0], p.y_lo[0], NB * kStep * 32 / 4, 1.f, t,
                          128);
    hw::tf32_split_transposed<NB, kStep>(s.x_raw[rs][0], p.t_hi, p.t_lo, 0, t);
    hw::tf32_split_transposed<NB, kStep>(s.y_raw[rs][0], p.t_hi, p.t_lo, kStep, t);
    if (t < kStep) {
      s.lse[ss][t] = l2;
      s.delta[ss][t] = dl;
    }
    hw::fence_proxy_async();  // the planes are read by wgmma, the raw tiles rewritten by TMA
    hw::mbar_arrive(&s.split_full[ss]);
    hw::named_sync(2, 128);  // every producer thread is done with raw stage rs
    if (t == 0 && j + kRawStages < nsteps) load(j + kRawStages);
  }
}

// S^T (64 keys x 16 queries) = A B^T over the head dim, A resident (boxes of
// 64 rows), B a stage's rows (boxes of 16), in KS k-steps of 8 (steps past D
// multiply zeros): the small hi lo and lo hi terms first, the hi hi terms
// last. Issued, not waited.
template <int KS>
__device__ __forceinline__ void logits(float (&d)[8], uint64_t ah, uint64_t al, uint64_t bh,
                                       uint64_t bl) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint32_t ao = kstep(k, kRows), bo = kstep(k, kStep);
    hw::wgmma_m64n16k8_tf32_ss(d, hw::desc_add(ah, ao), hw::desc_add(bl, bo), k);
    hw::wgmma_m64n16k8_tf32_ss(d, hw::desc_add(al, ao), hw::desc_add(bh, bo), 1);
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    hw::wgmma_m64n16k8_tf32_ss(d, hw::desc_add(ah, kstep(k, kRows)),
                               hw::desc_add(bh, kstep(k, kStep)), 1);
  }
}

// Consumer c of a K6 block: keys [r0, r0 + 64) of head bh, query stages
// j = c, c + 2, ...: S^T = K Q^T and dP^T = V dO^T, P^T = exp2(S^T scale
// log2 e - lse log2 e) (0 for queries past N), dS^T = P^T (dP^T - delta),
// dV += P^T dO and dK += dS^T Q.
template <int NB, int NP>
__device__ __forceinline__ void consumer(Smem<NB>& s, float* __restrict__ dk,
                                         float* __restrict__ dv, int N, int D, int bh, int r0,
                                         int nsteps, float scale, int c) {
  const int t = threadIdx.x % 128;
  const int lane = t % 32, tg = lane % 4;
  const float sl = scale * kLog2e;
  float dk_acc[NP / 2], dv_acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hw::mbar_wait(&s.res_full, 0);
  const uint64_t kh = hw::sw128_desc(s.a_hi[0], 16, 1024), kl = hw::sw128_desc(s.a_lo[0], 16, 1024);
  const uint64_t vh = hw::sw128_desc(s.b_hi[0], 16, 1024), vl = hw::sw128_desc(s.b_lo[0], 16, 1024);
  Stage<NB>& p = s.st[c];
  const uint64_t qh = hw::sw128_desc(p.x_hi[0], 16, 1024), ql = hw::sw128_desc(p.x_lo[0], 16, 1024);
  const uint64_t oh = hw::sw128_desc(p.y_hi[0], 16, 1024), ol = hw::sw128_desc(p.y_lo[0], 16, 1024);
  const uint64_t th = hw::sw128_desc(p.t_hi, 16, 1024), tl = hw::sw128_desc(p.t_lo, 16, 1024);

#pragma unroll 1
  for (int j = c; j < nsteps; j += 2) {
    hw::mbar_wait(&s.split_full[c], (j >> 1) & 1);
    float sT[8], dpT[8];  // 64 keys x 16 queries each
    hw::wgmma_fence();
    logits<NP / 8>(sT, kh, kl, qh, ql);   // S^T = K Q^T
    logits<NP / 8>(dpT, vh, vl, oh, ol);  // dP^T = V dO^T
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sT);
    hw::fence_regs(dpT);

    const int q0 = j * kStep;
    const bool ragged = q0 + kStep > N;
    uint32_t ph[2][4], pl[2][4], dsh[2][4], dsl[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
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

    // this stage's P^T dO (dO^T at columns 16-31 of the transposed plane),
    // then its dS^T Q (Q^T at columns 0-15), in one fresh accumulator
    float fresh[NP / 2];
    hw::fence_regs(ph);
    hw::fence_regs(pl);
    hw::wgmma_fence();
    update<NP, 2>(fresh, ph, pl, th, tl, 4 * kStep);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(fresh);
    hw::fence_regs(ph);
    hw::fence_regs(pl);
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dv_acc[i] += fresh[i];
    hw::fence_regs(fresh);
    hw::fence_regs(dsh);
    hw::fence_regs(dsl);
    hw::wgmma_fence();
    update<NP, 2>(fresh, dsh, dsl, th, tl, 0);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(fresh);
    hw::fence_regs(dsh);
    hw::fence_regs(dsl);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.split_empty[c]);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dk_acc[i] += fresh[i];
  }

  float both[NP];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) {
    both[i] = dk_acc[i];
    both[NP / 2 + i] = dv_acc[i];
  }
  if (!join(s, both, c, t)) return;
  store_rows<NP>(dk, both, N, D, bh, r0, scale, t);
  store_rows<NP>(dv, both + NP / 2, N, D, bh, r0, 1.f, t);
}

template <int NB, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
           const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int N, int D, int nblk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  Smem<NB>& s = *reinterpret_cast<Smem<NB>*>(hw::align_1024(smem_raw));
  const int bh = blockIdx.x / nblk;
  const int r0 = (blockIdx.x % nblk) * kRows;
  const int nsteps = (N + kStep - 1) / kStep;
  const int wg = threadIdx.x / 128;
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
  __syncthreads();
  if (wg == 0) {
    hw::regs_dec<kProducerRegs>();
    producer(s, &map_k, &map_v, &map_q, &map_do, lse, delta, N, bh, r0, nsteps);
  } else {
    hw::regs_inc<kConsumerRegs>();
    consumer<NB, NP>(s, dk, dv, N, D, bh, r0, nsteps, scale, wg - 1);
  }
}

template <int NP>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int BH, int N, int D, float scale,
           cudaStream_t stream) {
  constexpr int NB = (NP + 31) / 32;
  constexpr int kSmemBytes = sizeof(Smem<NB>) + 1024;  // + the alignment slack
  const int nblk = (N + kRows - 1) / kRows;
  const long long blocks = (long long)BH * nblk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_k, map_v, map_q, map_do;
  if (!hw::make_tensor_map_3d(&map_k, k, N, BH, kRows, 4, D) ||
      !hw::make_tensor_map_3d(&map_v, v, N, BH, kRows, 4, D) ||
      !hw::make_tensor_map_3d(&map_q, q, N, BH, kStep, 4, D) ||
      !hw::make_tensor_map_3d(&map_do, dout, N, BH, kStep, 4, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = hw::prepare(kernel<NB, NP>, kSmemBytes, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  kernel<NB, NP><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      map_k, map_v, map_q, map_do, (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, N, D, nblk, scale);
  return (int)cudaGetLastError();
}

}  // namespace dkv

// ------------------------------------------------------------------ K5
namespace dq {

constexpr int kRows = 64;        // queries a block
constexpr int kSplitStages = 2;  // split stage j % 2 belongs to consumer j % 2

// The tiles of a head dim whose products run NP = D rounded up to 16
// columns: NB boxes of 32 floats (128-byte swizzle) and, at NP = 80, a tail
// of 16 in a box of its own (64-byte rows, 64-byte swizzle), so that COLS
// columns are kept; STEP keys a stage; RAW raw stages. Shared memory sets
// them: 32-key stages fit at NP <= 80 (220 KB at 80 with one raw stage,
// where three full boxes would take 264), 16-key stages at 96 (216 KB).
template <int NP>
struct Shape {
  static constexpr bool TAIL = NP == 80;
  static constexpr int NB = TAIL ? 2 : (NP + 31) / 32;
  static constexpr int COLS = 32 * NB + (TAIL ? 16 : 0);
  static constexpr int STEP = NP == 96 ? 16 : 32;
  static constexpr int RAW = TAIL ? 1 : 2;
  static constexpr int RES = kRows * COLS;  // floats of a resident tile
  static constexpr int WALK = STEP * COLS;  // floats of a stage's tile
};

// A stage's K and V as stored, and K transposed: COLS head-dim rows of 32
// key columns (128 bytes, swizzled), of which a 16-key stage fills 0-15.
template <int NP>
struct alignas(1024) Stage {
  float x_hi[Shape<NP>::WALK], x_lo[Shape<NP>::WALK];
  float y_hi[Shape<NP>::WALK], y_lo[Shape<NP>::WALK];
  float t_hi[Shape<NP>::COLS * 32], t_lo[Shape<NP>::COLS * 32];
};

// Each tile is its boxes (rows x 32 floats each) and then its tail (rows x
// 16). a = q * scale, b = dO resident: raw as TMA brings them, then their hi
// planes, split in place; x = K, y = V walked.
template <int NP>
struct alignas(1024) Smem {
  using S = Shape<NP>;
  float a_hi[S::RES], a_lo[S::RES], b_hi[S::RES], b_lo[S::RES];
  float x_raw[S::RAW][S::WALK], y_raw[S::RAW][S::WALK];
  Stage<NP> st[kSplitStages];
  uint64_t res_loaded, res_full, raw_full[S::RAW], split_full[kSplitStages],
      split_empty[kSplitStages];
};

// The transposed split of a tail box of R <= 32 raw rows of 16 floats (64
// bytes a row, 64-byte swizzle: chunk c of row r at chunk c ^ ((r / 2) %
// 4)) into head-dim rows row0 .. row0 + 15 of a transposed plane, raw row r
// at column r, reordered within 8 as tf32_split_transposed (hopper.cuh)
// reorders them. Thread t of the producer warpgroup's 128.
template <int R>
__device__ __forceinline__ void split_tail_transposed(const float* raw, float* hi, float* lo,
                                                      int row0, int t) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(raw);
#pragma unroll 1
  for (int u = t; u < 16 * R / 4; u += 128) {
    const int d = u % 16, kc = u / 16;
    const int r0 = 8 * (kc >> 1) + (kc & 1);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 2 * e;
      x[e] = *reinterpret_cast<const float*>(src + r * 64 + (((d >> 2) ^ ((r >> 1) & 3)) << 4) +
                                             4 * (d & 3));
    }
    const int off = hw::swz128(row0 + d, kc);
    hw::tf32_split4(make_float4(x[0], x[1], x[2], x[3]),
                    reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(hi) + off),
                    reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(lo) + off));
  }
}

// Loads rows [r0, r0 + rows) of head bh, every box and the tail, onto bar.
template <int NP>
__device__ __forceinline__ void load_rows(float* dst, const CUtensorMap* map,
                                          const CUtensorMap* tail, uint64_t* bar, int rows, int r0,
                                          int bh) {
  using S = Shape<NP>;
#pragma unroll
  for (int b = 0; b < S::NB; ++b) hw::tma_load_3d(dst + b * rows * 32, map, bar, 32 * b, r0, bh);
  if constexpr (S::TAIL) hw::tma_load_3d(dst + S::NB * rows * 32, tail, bar, 32 * S::NB, r0, bh);
}

// The producer warpgroup: thread 0 issues the TMA loads (q and dO once, then
// raw K and V of each stage, RAW stages ahead); all 128 threads split q
// (times the scale) and dO in place, then each raw stage into its split
// stage once its consumer has released it.
template <int NP>
__device__ __forceinline__ void producer(Smem<NP>& s, const CUtensorMap* const (&maps)[8], int bh,
                                         int r0, int nsteps, float scale) {
  using S = Shape<NP>;
  const int t = threadIdx.x;
  auto load = [&](int j) {
    const int rs = j % S::RAW;
    hw::mbar_arrive_expect_tx(&s.raw_full[rs], 2 * S::WALK * 4);
    load_rows<NP>(s.x_raw[rs], maps[2], maps[6], &s.raw_full[rs], S::STEP, j * S::STEP, bh);
    load_rows<NP>(s.y_raw[rs], maps[3], maps[7], &s.raw_full[rs], S::STEP, j * S::STEP, bh);
  };
  if (t == 0) {
    hw::mbar_arrive_expect_tx(&s.res_loaded, 2 * S::RES * 4);
    load_rows<NP>(s.a_hi, maps[0], maps[4], &s.res_loaded, kRows, r0, bh);
    load_rows<NP>(s.b_hi, maps[1], maps[5], &s.res_loaded, kRows, r0, bh);
    for (int j = 0; j < S::RAW && j < nsteps; ++j) load(j);
  }
  hw::mbar_wait(&s.res_loaded, 0);
  hw::tf32_split_planes(s.a_hi, s.a_hi, s.a_lo, S::RES / 4, scale, t, 128);
  hw::tf32_split_planes(s.b_hi, s.b_hi, s.b_lo, S::RES / 4, 1.f, t, 128);
  hw::fence_proxy_async();  // the planes are read by wgmma
  hw::mbar_arrive(&s.res_full);

#pragma unroll 1
  for (int j = 0; j < nsteps; ++j) {
    const int rs = j % S::RAW, ss = j % kSplitStages;
    hw::mbar_wait(&s.raw_full[rs], (j / S::RAW) & 1);
    if (j >= kSplitStages) hw::mbar_wait(&s.split_empty[ss], (j / kSplitStages - 1) & 1);
    Stage<NP>& p = s.st[ss];
    hw::tf32_split_planes(s.x_raw[rs], p.x_hi, p.x_lo, S::WALK / 4, 1.f, t, 128);
    hw::tf32_split_planes(s.y_raw[rs], p.y_hi, p.y_lo, S::WALK / 4, 1.f, t, 128);
    hw::tf32_split_transposed<S::NB, S::STEP>(s.x_raw[rs], p.t_hi, p.t_lo, 0, t);
    if constexpr (S::TAIL) {
      split_tail_transposed<S::STEP>(s.x_raw[rs] + S::NB * S::STEP * 32, p.t_hi, p.t_lo,
                                     32 * S::NB, t);
    }
    hw::fence_proxy_async();  // the planes are read by wgmma, the raw tiles rewritten by TMA
    hw::mbar_arrive(&s.split_full[ss]);
    hw::named_sync(2, 128);  // every producer thread is done with raw stage rs
    if (t == 0 && j + S::RAW < nsteps) load(j + S::RAW);
  }
}

// Descriptor of K step k (8 head dims) of a K-major tile of `rows` rows:
// four steps a box from `box`, then the tail's two from `tail`.
template <int NP>
__device__ __forceinline__ uint64_t kdesc(uint64_t box, uint64_t tail, int k, int rows) {
  constexpr int NB = Shape<NP>::NB;
  return k < 4 * NB ? hw::desc_add(box, kstep(k, rows)) : hw::desc_add(tail, 32 * (k - 4 * NB));
}

// Descriptors of a tile's boxes and tail (64-byte rows, 64-byte swizzle).
template <int NP>
__device__ __forceinline__ void descs(const float* p, int rows, uint64_t& box, uint64_t& tail) {
  box = hw::sw128_desc(p, 16, 1024);
  tail = hw::swz_desc(p + Shape<NP>::NB * rows * 32, 16, 8 * 64, 64);
}

// D (64 x STEP) += A (64 x 8) B (8 x STEP)^T, both K-major in shared memory.
template <int STEP>
__device__ __forceinline__ void mma_keys(float (&d)[STEP / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (STEP == 32) {
    hw::wgmma_m64n32k8_tf32_ss(d, a, b, scale_d);
  } else {
    hw::wgmma_m64n16k8_tf32_ss(d, a, b, scale_d);
  }
}

// S (64 x STEP) = A B^T over the NP head dims, A resident (64 rows), B a
// stage's keys, in NP / 8 steps of 8 (steps past D multiply zeros): the
// small hi lo and lo hi terms first, the hi hi terms last. The operands'
// descriptors are {box, tail} of hi and lo. Issued, not waited.
template <int NP>
__device__ __forceinline__ void logits(float (&d)[Shape<NP>::STEP / 2], const uint64_t (&a)[4],
                                       const uint64_t (&b)[4]) {
  constexpr int STEP = Shape<NP>::STEP;
#pragma unroll
  for (int k = 0; k < NP / 8; ++k) {
    const uint64_t ah = kdesc<NP>(a[0], a[1], k, kRows), al = kdesc<NP>(a[2], a[3], k, kRows);
    const uint64_t bh = kdesc<NP>(b[0], b[1], k, STEP), bl = kdesc<NP>(b[2], b[3], k, STEP);
    mma_keys<STEP>(d, ah, bl, k);
    mma_keys<STEP>(d, al, bh, 1);
  }
#pragma unroll
  for (int k = 0; k < NP / 8; ++k) {
    mma_keys<STEP>(d, kdesc<NP>(a[0], a[1], k, kRows), kdesc<NP>(b[0], b[1], k, STEP), 1);
  }
}

// Consumer c of a K5 block: queries [r0, r0 + 64) of head bh, key stages j =
// c, c + 2, ...: S = (q scale) K^T and dP = dO V^T, P = exp2(S log2 e - lse
// log2 e) (0 for keys past N), dS = P (dP - delta), and each stage's dS K in
// a fresh accumulator added to the running sum in float32.
template <int NP>
__device__ __forceinline__ void consumer(Smem<NP>& s, const float* __restrict__ lse,
                                         const float* __restrict__ delta, float* __restrict__ dq,
                                         int N, int D, int bh, int r0, int nsteps, float scale,
                                         int c) {
  using S = Shape<NP>;
  constexpr int KS = S::STEP / 8;  // key steps of 8 in a stage
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
  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;

  hw::mbar_wait(&s.res_full, 0);
  uint64_t q[4], o[4], kd[4], vd[4];  // {box, tail} of the hi planes, then of the lo
  descs<NP>(s.a_hi, kRows, q[0], q[1]);
  descs<NP>(s.a_lo, kRows, q[2], q[3]);
  descs<NP>(s.b_hi, kRows, o[0], o[1]);
  descs<NP>(s.b_lo, kRows, o[2], o[3]);
  Stage<NP>& p = s.st[c];
  descs<NP>(p.x_hi, S::STEP, kd[0], kd[1]);
  descs<NP>(p.x_lo, S::STEP, kd[2], kd[3]);
  descs<NP>(p.y_hi, S::STEP, vd[0], vd[1]);
  descs<NP>(p.y_lo, S::STEP, vd[2], vd[3]);
  const uint64_t th = hw::sw128_desc(p.t_hi, 16, 1024), tl = hw::sw128_desc(p.t_lo, 16, 1024);

#pragma unroll 1
  for (int j = c; j < nsteps; j += 2) {
    hw::mbar_wait(&s.split_full[c], (j >> 1) & 1);
    float sc[S::STEP / 2], dp[S::STEP / 2];  // 64 queries x STEP keys each
    hw::wgmma_fence();
    logits<NP>(sc, q, kd);  // S = (q * scale) K^T
    logits<NP>(dp, o, vd);  // dP = dO V^T
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);
    hw::fence_regs(dp);

    const int k0 = j * S::STEP;
    const bool ragged = k0 + S::STEP > N;
    uint32_t dsh[KS][4], dsl[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, i = 4 * n + e;
        float pr = hw::ex2(fmaf(sc[i], kLog2e, -l2[h]));
        if (ragged && k0 + 8 * n + 2 * tg + (e & 1) >= N) pr = 0.f;
        put(dsh, dsl, n, e, pr * (dp[i] - dl[h]));
      }
    }

    float dqs[NP / 2];  // this stage's dS K
    hw::fence_regs(dsh);
    hw::fence_regs(dsl);
    hw::wgmma_fence();
    update<NP, KS>(dqs, dsh, dsl, th, tl, 0);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dqs);
    hw::fence_regs(dsh);
    hw::fence_regs(dsl);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.split_empty[c]);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] += dqs[i];
  }

  if (join(s, acc, c, t)) store_rows<NP>(dq, acc, N, D, bh, r0, scale, t);
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
           const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
           const __grid_constant__ CUtensorMap tail_q, const __grid_constant__ CUtensorMap tail_do,
           const __grid_constant__ CUtensorMap tail_k, const __grid_constant__ CUtensorMap tail_v,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int N, int D, int nblk, float scale) {
  using S = Shape<NP>;
  extern __shared__ uint8_t smem_raw[];
  Smem<NP>& s = *reinterpret_cast<Smem<NP>*>(hw::align_1024(smem_raw));
  const int bh = blockIdx.x / nblk;
  const int r0 = (blockIdx.x % nblk) * kRows;
  const int nsteps = (N + S::STEP - 1) / S::STEP;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    hw::mbar_init(&s.res_loaded, 1);
    hw::mbar_init(&s.res_full, 128);  // every producer thread, after its split
    for (int r = 0; r < S::RAW; ++r) hw::mbar_init(&s.raw_full[r], 1);
    for (int st = 0; st < kSplitStages; ++st) {
      hw::mbar_init(&s.split_full[st], 128);
      hw::mbar_init(&s.split_empty[st], 4);  // the owning consumer's four warps
    }
    hw::mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {
    hw::regs_dec<kProducerRegs>();
    // the maps stay kernel parameters: TMA reads them in the param space
    const CUtensorMap* const maps[8] = {&map_q,  &map_do,  &map_k,  &map_v,
                                        &tail_q, &tail_do, &tail_k, &tail_v};
    producer(s, maps, bh, r0, nsteps, scale);
  } else {
    hw::regs_inc<kConsumerRegs>();
    consumer<NP>(s, lse, delta, dq, N, D, bh, r0, nsteps, scale, wg - 1);
  }
}

template <int NP>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int BH, int N, int D, float scale, cudaStream_t stream) {
  using S = Shape<NP>;
  constexpr int kSmemBytes = sizeof(Smem<NP>) + 1024;  // + the alignment slack
  static_assert(kSmemBytes <= 232448, "a block's shared memory on Hopper");
  const int nblk = (N + kRows - 1) / kRows;
  const long long blocks = (long long)BH * nblk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8] = {};  // q, dO, K, V: boxes of 32 floats, then their tails' boxes of 16
  const void* base[4] = {q, dout, k, v};
  for (int i = 0; i < 4; ++i) {
    const int rows = i < 2 ? kRows : S::STEP;
    if (!hw::make_tensor_map_3d(&maps[i], base[i], N, BH, rows, 4, D) ||
        (S::TAIL && !hw::make_tensor_map_3d(&maps[4 + i], base[i], N, BH, rows, 4, D, 64))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const cudaError_t e = hw::prepare(kernel<NP>, kSmemBytes, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  kernel<NP><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], (const float*)lse,
      (const float*)delta, (float*)dq, N, D, nblk, scale);
  return (int)cudaGetLastError();
}

}  // namespace dq

}  // namespace

namespace cra5::anydim {

// D % 4 == 0, 4 <= D <= 96 (checked by the entries): N of the head-dim
// products rounded up to a multiple of 16.
int fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int N,
            int D, float scale, cudaStream_t stream) {
  switch ((D + 15) / 16) {
    case 1: return fwd::launch<16>(q, k, v, out, lse, BH, N, D, scale, stream);
    case 2: return fwd::launch<32>(q, k, v, out, lse, BH, N, D, scale, stream);
    case 3: return fwd::launch<48>(q, k, v, out, lse, BH, N, D, scale, stream);
    case 4: return fwd::launch<64>(q, k, v, out, lse, BH, N, D, scale, stream);
    case 5: return fwd::launch<80>(q, k, v, out, lse, BH, N, D, scale, stream);
    case 6: return fwd::launch<96>(q, k, v, out, lse, BH, N, D, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BH, int N, int D, float scale,
            cudaStream_t stream) {
  switch ((D + 15) / 16) {
    case 1: return dkv::launch<16>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, stream);
    case 2: return dkv::launch<32>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, stream);
    case 3: return dkv::launch<48>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, stream);
    case 4: return dkv::launch<64>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, stream);
    case 5: return dkv::launch<80>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, stream);
    case 6: return dkv::launch<96>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int BH, int N, int D, float scale, cudaStream_t stream) {
  switch ((D + 15) / 16) {
    case 1: return dq::launch<16>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, stream);
    case 2: return dq::launch<32>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, stream);
    case 3: return dq::launch<48>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, stream);
    case 4: return dq::launch<64>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, stream);
    case 5: return dq::launch<80>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, stream);
    case 6: return dq::launch<96>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cra5::anydim
