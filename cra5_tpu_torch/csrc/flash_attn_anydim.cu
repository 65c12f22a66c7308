// K4, K5 and K6 at every head dim on the tensor cores: the flash-attention
// forward (cra5_flash_attn_fwd_anydim), dQ (cra5_flash_attn_bwd_dq_anydim)
// and dK/dV (cra5_flash_attn_bwd_dkv_anydim) for bf16 and float16 at every
// head dim D <= 128 with D % 8 == 0 (rows of a multiple of 16 bytes, as TMA
// needs), and for float32 (3xTF32, flash_attn_anydim_f32.cu) at every D <= 96
// with D % 4 == 0. The entries take the SIMT entries' dtype code (0 bf16, 1
// float16, 2 float32).
//
// Replace _fwd_kernel (driven by _flash_forward), _bwd_dq_kernel and
// _bwd_dkv_kernel of cra5_tpu/ops/attention.py at those head dims and
// dtypes, which the head-dim-64 kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, flash_attn_bwd_f32.cu) do not take and the SIMT tile of
// flash_attn_any.cu computed on the FMA units. Bound: tensor-core
// operations, 4 N^2 D per head for K4, 6 N^2 D for K5 and 8 N^2 D for K6
// (bf16/f16 at 989 TFLOP/s, 3xTF32 three times as many at 495), against 4 N
// D (K4), 5 N D (K5) and 6 N D (K6) elements of traffic.
//
// The design is the head-dim-64 kernels' (hopper.cuh: one producer
// warpgroup issuing TMA through an mbarrier ring, two consumer warpgroups of
// 64 rows on wgmma), with what another head dim changes:
//   - TMA at the real head dim: the tensor maps have D columns. A row is
//     loaded as FB boxes of 64 columns (one 128-byte swizzle atom each) and a
//     tail of TW = 16 or 32 columns in a box of its own, 32 or 64 bytes wide
//     with the swizzle of that width (Cols below): 72 is 64 + 16. Columns
//     past D arrive as zeros through the maps' out-of-bounds fill, so the
//     padding costs no instruction and adds nothing to any sum; a tail of 48
//     or 56 columns has no swizzle of its own and takes a full box;
//   - the products that sum over the head dim (S = q K^T, dP = dO V^T in K5,
//     dP^T = V dO^T in K6) run in k-steps of 16, four a box and one a 16
//     tail columns, each step's descriptor that of its box or of the tail,
//     all known at compile time (a first version issued ceil(D / 16) steps
//     behind a branch, and ptxas fenced each product, C7519);
//   - the products whose N is the head dim (O += P V in K4; dQ += dS K in
//     K5; dV += P^T dO and dK += dS^T Q in K6) read their B operand
//     MN-major, as the head-dim-64 kernels do. An MN-major operand comes in
//     atoms as wide as its swizzle (64 columns at 128 bytes), so each product
//     runs as one m64n64k16 a box and one m64n16k16 or m64n32k16 on the
//     tail's 32- or 64-byte atom: N is D rounded up to 16. At D = 72 the
//     products spend the operations of 80 columns where padding N to 64 a
//     box, the first version, spent 128; in one run on an H100 (a one-off
//     build of both, bf16 and float16) the tail was the faster in K6 at (1,
//     5, 2048, 72) and (1, 5, 10368, 72) and in K4 at the second; at the
//     first the two K4s were within the run's spread (PERF.md, §6). The third
//     choice, transposed planes written by the producer as the float32
//     kernels must, moves the transposition onto the threads and was not
//     built;
//   - ptxas compiles the consumers within the 168 registers a thread of the
//     launch, whatever setmaxnreg grants, so the tiles follow the registers.
//     K4: a block owns 128 queries and walks stages of 128 keys through a
//     ring of three (64 keys past one box and a 16-column tail, where the
//     logits and O outgrow the registers). K6 walks 32-query stages through
//     a ring of four; a consumer's dK and dV take 64 floats a thread a box
//     and TW a tail (a first version holding 128 spilled 2 KB a thread and
//     took 13.0002 ms at (1, 5, 10368, 72) in bf16, chip_smoke.py on an
//     H100). So up to 80 a block owns 128 keys, 64 a consumer; past that
//     (two boxes, or a box and a 32-column tail) it owns 64 keys that both
//     consumers share, consumer 0 taking the first box of their dK and dV
//     and consumer 1 the rest, and both compute the same logits. Past D =
//     128 a consumer would hold two boxes, so every head dim past 128 stays
//     on the SIMT tile. K5 is the head-dim-64 K5 (flash_attn_bwd.cu,
//     dq_hopper) with these columns: a block owns 128 queries (Q and dO
//     resident), 64 a consumer, and walks a ring of four key stages; a
//     consumer holds S and dP (BK / 2 floats each), dS (BK / 4 registers)
//     and dQ (D rounded to 16, halved). Up to 80 columns the stages take 64
//     keys (120 live values at D = 72); past that the key stage is halved to
//     32 keys rather than dQ's boxes split between the consumers as K6 does,
//     which would compute every logit twice (104 live values at D = 128).
// Numerics are the head-dim-64 kernels' and the plain versions': K4 scales q
// in float32 and rounds it to the dtype once, keeps logits and statistics in
// float32 (log2 units, one ex2 a logit), rounds P to the dtype for P V and
// clamps the row sum at 1e-30; K5 uses the same rounded q, P = exp(S - lse),
// dS = P (dP - delta) rounded to the dtype for dS K, and rounds dq times the
// scale once; K6 scales the float32 logits of raw q, rounds P to the dtype
// for dV and dS for dK, sums in float32 and rounds dk (times the scale) and
// dv once. Keys (K4, K5) and queries (K6) past N are masked, rows past N are
// not written. No atomics: two calls give equal bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cra5::anydim {
// flash_attn_anydim_f32.cu
int fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int N,
            int D, float scale, cudaStream_t stream);
int dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BH, int N, int D, float scale,
            cudaStream_t stream);
int dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int BH, int N, int D, float scale, cudaStream_t stream);
}  // namespace cra5::anydim

namespace {

namespace hw = cra5::hopper;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The 16-bit storage types: conversions and the packing of two floats into
// one register of a wgmma A operand.
template <typename T>
struct Half;
template <>
struct Half<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return hw::pack_bf16(lo, hi);
  }
};
template <>
struct Half<__half> {
  static __device__ __forceinline__ float load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half store(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Two adjacent columns of a row, rounded to the dtype, as one 4-byte store
// (an even column of a row of D % 8 == 0 elements).
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = Half<T>::pack(a, b);
}

// The columns of a head dim D (D % 8 == 0, D <= 128): FB full boxes of 64
// (128-byte rows, 128-byte swizzle) and a tail of TW = 0, 16 or 32 columns
// in a box of its own, TB = 2 TW bytes a row swizzled over TB, which wgmma
// reads as one atom of that swizzle.
template <int FB_, int TW_>
struct Cols {
  static constexpr int FB = FB_, TW = TW_, TB = 2 * TW_;
  static constexpr int KS = 4 * FB + TW / 16;  // k-steps of 16 over the head dim
  static constexpr int NFB = FB ? FB : 1;      // array extents, never 0
  static constexpr int NTW = TW ? TW : 16;
};

// Descriptor of k-step kk (16 columns) of a K-major tile: four steps a box
// (boxes of `rows` rows from descriptor `box`), then the tail's (`tail`).
template <class C>
__device__ __forceinline__ uint64_t kmajor(uint64_t box, uint64_t tail, int kk, int rows) {
  return kk < 4 * C::FB ? hw::desc_add(box, (kk >> 2) * rows * 128 + 32 * (kk & 3))
                        : hw::desc_add(tail, 32 * (kk - 4 * C::FB));
}

// Descriptor of a tail tile starting at p, K-major or (MN-major) as the B
// operand of a product summing over its rows.
template <class C, typename T>
__device__ __forceinline__ uint64_t tail_desc(const T* p) {
  return hw::swz_desc(p, 16, 8 * C::TB, C::TB);
}

// D (64 x TW) += A (64 x 16, registers) * B (16 x TW, a tail, MN-major).
template <typename T, int TW>
__device__ __forceinline__ void mma_tail(float* d, const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (TW == 16) {
    hw::wgmma_m64n16k16_rs_t<T>(*reinterpret_cast<float(*)[8]>(d), a, b, scale_d);
  } else if constexpr (TW == 32) {
    hw::wgmma_m64n32k16_rs_t<T>(*reinterpret_cast<float(*)[16]>(d), a, b, scale_d);
  }
}

// q * scale rounded to the dtype in place, n8 chunks of 8 elements.
template <typename T>
__device__ __forceinline__ void scale_in_place(T* q, int n8, float scale, int t) {
  uint4* p = reinterpret_cast<uint4*>(q);
  for (int i = t; i < n8; i += 128) {
    uint4 val = p[i];
    T* e = reinterpret_cast<T*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = Half<T>::store(Half<T>::load(e[u]) * scale);
    p[i] = val;
  }
}

// Loads rows [r0, r0 + rows) of head bh, every box and the tail, onto bar.
template <class C, typename T>
__device__ __forceinline__ void load_rows(T* boxes, int box_elems, T* tail,
                                          const CUtensorMap* map, const CUtensorMap* map_tail,
                                          uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int b = 0; b < C::FB; ++b) hw::tma_load_3d(boxes + b * box_elems, map, bar, 64 * b, r0, bh);
  if constexpr (C::TW != 0) hw::tma_load_3d(tail, map_tail, bar, 64 * C::FB, r0, bh);
}

// The maps of a (BH, N, D) operand: boxes of 64 columns and the tail's box.
template <class C>
bool make_maps(CUtensorMap* map, CUtensorMap* map_tail, const void* base, int N, int BH, int rows,
               int D) {
  return (C::FB == 0 || hw::make_tensor_map_3d(map, base, N, BH, rows, 2, D)) &&
         (C::TW == 0 || hw::make_tensor_map_3d(map_tail, base, N, BH, rows, 2, D, C::TB));
}

// ------------------------------------------------------------------ K4
namespace fwd {

constexpr int BQ = 128;  // query rows a block, 64 per consumer warpgroup
constexpr int kStages = 3;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// Keys a ring stage: 128, as the head-dim-64 K4 walks, while the logits (64
// floats a thread), P (32) and O fit the consumers' registers (up to one box
// and a 16-column tail), else 64.
template <class C>
constexpr int kBK = C::FB <= 1 && C::TW <= 16 ? 128 : 64;

// Every tile a multiple of 1024 bytes, so each starts 1024-aligned.
template <typename T, class C>
struct alignas(1024) Smem {
  T q[C::NFB][BQ * 64];
  T k[kStages][C::NFB][kBK<C> * 64];
  T v[kStages][C::NFB][kBK<C> * 64];
  T q_tail[BQ * C::NTW];
  T k_tail[kStages][kBK<C> * C::NTW];
  T v_tail[kStages][kBK<C> * C::NTW];
  uint64_t q_full, full[kStages], empty[kStages];
};

template <typename T, class C>
__device__ __forceinline__ void consumer(Smem<T, C>& s, T* __restrict__ out,
                                         float* __restrict__ lse, int N, int D, int bh, int r0,
                                         int nkb, float scale, int c) {
  constexpr int BK = kBK<C>;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;

  hw::mbar_wait(&s.q_full, 0);
#pragma unroll
  for (int b = 0; b < C::FB; ++b) scale_in_place(s.q[b] + c * 64 * 64, 64 * 64 / 8, scale, t);
  if constexpr (C::TW != 0) scale_in_place(s.q_tail + c * 64 * C::TW, 64 * C::TW / 8, scale, t);
  hw::fence_proxy_async();
  hw::named_sync(1 + c, 128);

  const uint64_t q_box = hw::sw128_desc(s.q[0] + c * 64 * 64, 16, 1024);
  const uint64_t q_tail = tail_desc<C>(s.q_tail + c * 64 * C::TW);
  float o[C::NFB][32], ot[C::NTW / 2];
#pragma unroll
  for (int b = 0; b < C::NFB; ++b) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < C::NTW / 2; ++i) ot[i] = 0.f;
  float m2[2] = {kNegInf, kNegInf};  // running row maxima (rows g, g + 8), log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  for (int j = 0; j < nkb; ++j) {
    const int st = j % kStages;
    hw::mbar_wait(&s.full[st], (j / kStages) & 1);

    float sc[BK / 2];  // S = (q * scale) K^T, 64 rows x BK keys
    const uint64_t k_box = hw::sw128_desc(s.k[st][0], 16, 1024);
    const uint64_t k_tail = tail_desc<C>(s.k_tail[st]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      const uint64_t a = kmajor<C>(q_box, q_tail, kk, BQ), b = kmajor<C>(k_box, k_tail, kk, BK);
      if constexpr (BK == 128) {
        hw::wgmma_m64n128k16_ss_t<T>(sc, a, b, kk);
      } else {
        hw::wgmma_m64n64k16_ss_t<T>(sc, a, b, kk);
      }
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);

    const int k0 = j * BK;
    if (k0 + BK > N) {  // the ragged tail: zero-filled keys give 0, not -inf
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
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
      for (int n = 0; n < BK / 8; ++n) {
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[h], mx * kLog2e);
      const float alpha = hw::ex2(m2[h] - m_new);
      m2[h] = m_new;
      neg_m[h] = -m_new;
      l[h] *= alpha;
#pragma unroll
      for (int b = 0; b < C::FB; ++b) {
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          o[b][4 * d + 2 * h] *= alpha;
          o[b][4 * d + 2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int d = 0; d < C::TW / 8; ++d) {
        ot[4 * d + 2 * h] *= alpha;
        ot[4 * d + 2 * h + 1] *= alpha;
      }
    }

    // P = exp2(S log2 e - m), rounded to the dtype into the A operand of key
    // step kk: accumulator chunks 2kk and 2kk + 1 (registers 8kk .. 8kk + 7)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int h = (e >> 1) & 1;
        p[e] = hw::ex2(fmaf(sc[8 * kk + e], kLog2e, neg_m[h]));
        l[h] += p[e];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) pa[kk][u] = Half<T>::pack(p[2 * u], p[2 * u + 1]);
    }

#pragma unroll
    for (int b = 0; b < C::FB; ++b) hw::fence_regs(o[b]);
    if constexpr (C::TW != 0) hw::fence_regs(ot);
    hw::fence_regs(pa);
    hw::wgmma_fence();
#pragma unroll
    for (int b = 0; b < C::FB; ++b) {  // O[:, 64b:64b+64] += P V[:, 64b:64b+64], V MN-major
      const uint64_t v_desc = hw::sw128_desc(s.v[st][b], BK * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hw::wgmma_m64n64k16_rs_t<T>(o[b], pa[kk], hw::desc_add(v_desc, 2048 * kk), 1);
      }
    }
    if constexpr (C::TW != 0) {  // the tail's columns, one atom of its swizzle
      const uint64_t v_desc = tail_desc<C>(s.v_tail[st]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        mma_tail<T, C::TW>(ot, pa[kk], hw::desc_add(v_desc, 16 * C::TB * kk), 1);
      }
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < C::FB; ++b) hw::fence_regs(o[b]);
    if constexpr (C::TW != 0) hw::fence_regs(ot);
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
    T* dst = out + ((size_t)bh * N + row) * D + 2 * tg;
#pragma unroll
    for (int b = 0; b < C::FB; ++b) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        if (64 * b + 8 * d < D) {
          store_pair(dst + 64 * b + 8 * d, o[b][4 * d + 2 * h] / lc, o[b][4 * d + 2 * h + 1] / lc);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < C::TW / 8; ++d) {
      const int col = 64 * C::FB + 8 * d;
      if (col < D) store_pair(dst + col, ot[4 * d + 2 * h] / lc, ot[4 * d + 2 * h + 1] / lc);
    }
    if (tg == 0) lse[(size_t)bh * N + row] = m2[h] * kLn2 + logf(lc);
  }
}

template <typename T, class C>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap tail_q,
           const __grid_constant__ CUtensorMap tail_k, const __grid_constant__ CUtensorMap tail_v,
           T* __restrict__ out, float* __restrict__ lse, int N, int D, int nqb, float scale) {
  constexpr int BK = kBK<C>;
  extern __shared__ uint8_t smem_raw[];
  Smem<T, C>& s = *reinterpret_cast<Smem<T, C>*>(hw::align_1024(smem_raw));
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
      hw::mbar_arrive_expect_tx(&s.q_full, BQ * (C::FB * 128 + C::TB));
      load_rows<C>(s.q[0], BQ * 64, s.q_tail, &map_q, &tail_q, &s.q_full, q0, bh);
      for (int j = 0; j < nkb; ++j) {
        const int st = j % kStages;
        if (j >= kStages) hw::mbar_wait(&s.empty[st], (j / kStages - 1) & 1);
        hw::mbar_arrive_expect_tx(&s.full[st], 2 * BK * (C::FB * 128 + C::TB));
        load_rows<C>(s.k[st][0], BK * 64, s.k_tail[st], &map_k, &tail_k, &s.full[st], j * BK, bh);
        load_rows<C>(s.v[st][0], BK * 64, s.v_tail[st], &map_v, &tail_v, &s.full[st], j * BK, bh);
      }
    }
  } else {  // consumers
    hw::regs_inc<kConsumerRegs>();
    consumer(s, out, lse, N, D, bh, q0 + (wg - 1) * 64, nkb, scale, wg - 1);
  }
}

template <typename T, class C>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int N,
           int D, float scale, cudaStream_t stream) {
  constexpr int kSmemBytes = sizeof(Smem<T, C>) + 1024;  // + the alignment slack
  const int nqb = (N + BQ - 1) / BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  if (!make_maps<C>(&maps[0], &maps[3], q, N, BH, BQ, D) ||
      !make_maps<C>(&maps[1], &maps[4], k, N, BH, kBK<C>, D) ||
      !make_maps<C>(&maps[2], &maps[5], v, N, BH, kBK<C>, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = hw::prepare(kernel<T, C>, kSmemBytes, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  kernel<T, C><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], (T*)out, (float*)lse, N, D, nqb,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// ------------------------------------------------------------------ K6
namespace dkv {

constexpr int BQ = 32;  // queries a ring stage
constexpr int kStages = 4;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Whether the two consumers share a block's keys and split the columns of
// their dK and dV (more than 80 accumulator floats a thread otherwise), and
// the keys a block owns.
template <class C>
constexpr bool kSplit = 64 * C::FB + C::TW > 80;
template <class C>
constexpr int kKeys = kSplit<C> ? 64 : 128;

// Every tile a multiple of 1024 bytes, so each starts 1024-aligned.
template <typename T, class C>
struct alignas(1024) Smem {
  T k[C::NFB][kKeys<C> * 64];
  T v[C::NFB][kKeys<C> * 64];
  T q[kStages][C::NFB][BQ * 64];
  T dout[kStages][C::NFB][BQ * 64];
  T k_tail[kKeys<C> * C::NTW];
  T v_tail[kKeys<C> * C::NTW];
  T q_tail[kStages][BQ * C::NTW];
  T dout_tail[kStages][BQ * C::NTW];
  float lse[kStages][BQ];  // lse * log2 e
  float delta[kStages][BQ];
  uint64_t kv_full, full[kStages], empty[kStages];
};

// One consumer warpgroup: keys [r0, r0 + 64) of head bh, rows `row` of the
// block's K and V tiles; of their dK and dV the NBOX boxes from box b0 and,
// with TAIL, the tail columns.
template <typename T, class C, int NBOX, bool TAIL>
__device__ __forceinline__ void consumer(Smem<T, C>& s, T* __restrict__ dk, T* __restrict__ dv,
                                         int N, int D, int bh, int r0, int row, int b0, int nqb,
                                         float scale) {
  constexpr int KR = kKeys<C>;
  constexpr int NB = NBOX ? NBOX : 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const float sl = scale * kLog2e;

  hw::mbar_wait(&s.kv_full, 0);
  const uint64_t k_box = hw::sw128_desc(s.k[0] + row * 64, 16, 1024);
  const uint64_t v_box = hw::sw128_desc(s.v[0] + row * 64, 16, 1024);
  const uint64_t k_tail = tail_desc<C>(s.k_tail + row * C::TW);
  const uint64_t v_tail = tail_desc<C>(s.v_tail + row * C::TW);
  float dk_acc[NB][32], dv_acc[NB][32], dk_t[C::NTW / 2], dv_t[C::NTW / 2];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < C::NTW / 2; ++i) dk_t[i] = dv_t[i] = 0.f;

  for (int j = 0; j < nqb; ++j) {
    const int st = j % kStages;
    hw::mbar_wait(&s.full[st], (j / kStages) & 1);

    // transposed tiles: rows are this warpgroup's keys, columns the queries
    float sT[16], dpT[16];
    const uint64_t q_box = hw::sw128_desc(s.q[st][0], 16, 1024);
    const uint64_t o_box = hw::sw128_desc(s.dout[st][0], 16, 1024);
    const uint64_t q_tail = tail_desc<C>(s.q_tail[st]);
    const uint64_t o_tail = tail_desc<C>(s.dout_tail[st]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {  // S^T = K Q^T
      hw::wgmma_m64n32k16_ss_t<T>(sT, kmajor<C>(k_box, k_tail, kk, KR),
                                  kmajor<C>(q_box, q_tail, kk, BQ), kk);
    }
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {  // dP^T = V dO^T
      hw::wgmma_m64n32k16_ss_t<T>(dpT, kmajor<C>(v_box, v_tail, kk, KR),
                                  kmajor<C>(o_box, o_tail, kk, BQ), kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sT);
    hw::fence_regs(dpT);

    // P^T = exp2(S^T scale log2 e - lse log2 e) (0 for queries past N) and
    // dS^T = P^T (dP^T - delta), rounded to the dtype into A operands:
    // accumulator chunks 2kk and 2kk + 1 are the operand of query step kk
    const int q0 = j * BQ;
    const bool ragged = q0 + BQ > N;
    uint32_t pa[2][4], dsa[2][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(&s.lse[st][8 * n + 2 * tg]);
      const float2 dl = *reinterpret_cast<const float2*>(&s.delta[st][8 * n + 2 * tg]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // registers 4n + 2h + jj: column 8n + 2tg + jj
        float p[2], ds[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int i = 4 * n + 2 * h + jj;
          p[jj] = hw::ex2(fmaf(sT[i], sl, -(jj ? l2.y : l2.x)));
          if (ragged && q0 + 8 * n + 2 * tg + jj >= N) p[jj] = 0.f;
          ds[jj] = p[jj] * (dpT[i] - (jj ? dl.y : dl.x));
        }
        pa[n >> 1][2 * (n & 1) + h] = Half<T>::pack(p[0], p[1]);
        dsa[n >> 1][2 * (n & 1) + h] = Half<T>::pack(ds[0], ds[1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q over this consumer's boxes and tail, dO
    // and Q MN-major
#pragma unroll
    for (int b = 0; b < NBOX; ++b) {
      hw::fence_regs(dv_acc[b]);
      hw::fence_regs(dk_acc[b]);
    }
    if constexpr (TAIL) {
      hw::fence_regs(dv_t);
      hw::fence_regs(dk_t);
    }
    hw::fence_regs(pa);
    hw::fence_regs(dsa);
    hw::wgmma_fence();
#pragma unroll
    for (int b = 0; b < NBOX; ++b) {
      const uint64_t o_mn = hw::sw128_desc(s.dout[st][b0 + b], BQ * 128, 1024);
      const uint64_t q_mn = hw::sw128_desc(s.q[st][b0 + b], BQ * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        hw::wgmma_m64n64k16_rs_t<T>(dv_acc[b], pa[kk], hw::desc_add(o_mn, 2048 * kk), 1);
        hw::wgmma_m64n64k16_rs_t<T>(dk_acc[b], dsa[kk], hw::desc_add(q_mn, 2048 * kk), 1);
      }
    }
    if constexpr (TAIL) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        mma_tail<T, C::TW>(dv_t, pa[kk], hw::desc_add(o_tail, 16 * C::TB * kk), 1);
        mma_tail<T, C::TW>(dk_t, dsa[kk], hw::desc_add(q_tail, 16 * C::TB * kk), 1);
      }
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NBOX; ++b) {
      hw::fence_regs(dv_acc[b]);
      hw::fence_regs(dk_acc[b]);
    }
    if constexpr (TAIL) {
      hw::fence_regs(dv_t);
      hw::fence_regs(dk_t);
    }
    hw::fence_regs(pa);
    hw::fence_regs(dsa);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.empty[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + g + 8 * h;
    if (r >= N) continue;
    const size_t o = ((size_t)bh * N + r) * D + 2 * tg;
#pragma unroll
    for (int b = 0; b < NBOX; ++b) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int col = 64 * (b0 + b) + 8 * d;
        if (col >= D) continue;
        store_pair(dk + o + col, dk_acc[b][4 * d + 2 * h] * scale,
                   dk_acc[b][4 * d + 2 * h + 1] * scale);
        store_pair(dv + o + col, dv_acc[b][4 * d + 2 * h], dv_acc[b][4 * d + 2 * h + 1]);
      }
    }
    if constexpr (TAIL) {
#pragma unroll
      for (int d = 0; d < C::TW / 8; ++d) {
        const int col = 64 * C::FB + 8 * d;
        if (col >= D) continue;
        store_pair(dk + o + col, dk_t[4 * d + 2 * h] * scale, dk_t[4 * d + 2 * h + 1] * scale);
        store_pair(dv + o + col, dv_t[4 * d + 2 * h], dv_t[4 * d + 2 * h + 1]);
      }
    }
  }
}

template <typename T, class C>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const __grid_constant__ CUtensorMap tail_q, const __grid_constant__ CUtensorMap tail_k,
           const __grid_constant__ CUtensorMap tail_v, const __grid_constant__ CUtensorMap tail_do,
           const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
           T* __restrict__ dv, int N, int D, int nkb, float scale) {
  constexpr int KR = kKeys<C>;
  extern __shared__ uint8_t smem_raw[];
  Smem<T, C>& s = *reinterpret_cast<Smem<T, C>*>(hw::align_1024(smem_raw));
  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x % nkb) * KR;
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
        hw::mbar_arrive_expect_tx(&s.kv_full, 2 * KR * (C::FB * 128 + C::TB));
        load_rows<C>(s.k[0], KR * 64, s.k_tail, &map_k, &tail_k, &s.kv_full, k0, bh);
        load_rows<C>(s.v[0], KR * 64, s.v_tail, &map_v, &tail_v, &s.kv_full, k0, bh);
      }
      const float* lse_h = lse + (size_t)bh * N;
      const float* delta_h = delta + (size_t)bh * N;
      for (int j = 0; j < nqb; ++j) {
        const int st = j % kStages;
        const int row = j * BQ + lane;  // read before the wait, so the loads overlap it
        const float l2 = row < N ? lse_h[row] * kLog2e : 0.f;
        const float dl = row < N ? delta_h[row] : 0.f;
        if (j >= kStages) hw::mbar_wait(&s.empty[st], (j / kStages - 1) & 1);
        s.lse[st][lane] = l2;
        s.delta[st][lane] = dl;
        if (lane == 0) {
          hw::mbar_arrive_expect_tx(&s.full[st], 2 * BQ * (C::FB * 128 + C::TB));
          load_rows<C>(s.q[st][0], BQ * 64, s.q_tail[st], &map_q, &tail_q, &s.full[st], j * BQ,
                       bh);
          load_rows<C>(s.dout[st][0], BQ * 64, s.dout_tail[st], &map_do, &tail_do, &s.full[st],
                       j * BQ, bh);
        } else {
          hw::mbar_arrive(&s.full[st]);
        }
      }
    }
  } else {  // consumers
    hw::regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    if constexpr (!kSplit<C>) {
      consumer<T, C, C::FB, C::TW != 0>(s, dk, dv, N, D, bh, k0 + 64 * c, 64 * c, 0, nqb, scale);
    } else if (c == 0) {
      consumer<T, C, 1, false>(s, dk, dv, N, D, bh, k0, 0, 0, nqb, scale);
    } else {
      consumer<T, C, C::FB - 1, C::TW != 0>(s, dk, dv, N, D, bh, k0, 0, 1, nqb, scale);
    }
  }
}

template <typename T, class C>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int BH, int N, int D, float scale,
           cudaStream_t stream) {
  constexpr int kSmemBytes = sizeof(Smem<T, C>) + 1024;  // + the alignment slack
  const int nkb = (N + kKeys<C> - 1) / kKeys<C>;
  const long long blocks = (long long)BH * nkb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  if (!make_maps<C>(&maps[0], &maps[4], q, N, BH, BQ, D) ||
      !make_maps<C>(&maps[1], &maps[5], k, N, BH, kKeys<C>, D) ||
      !make_maps<C>(&maps[2], &maps[6], v, N, BH, kKeys<C>, D) ||
      !make_maps<C>(&maps[3], &maps[7], dout, N, BH, BQ, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = hw::prepare(kernel<T, C>, kSmemBytes, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  kernel<T, C><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, N, D, nkb, scale);
  return (int)cudaGetLastError();
}

}  // namespace dkv

// ------------------------------------------------------------------ K5
namespace dq {

constexpr int BQ = 128;  // queries a block, 64 per consumer warpgroup
constexpr int kStages = 4;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// Keys a ring stage: 64, as the head-dim-64 K5 walks, while S and dP (32
// floats a thread each), dS (16 registers) and dQ (one float a thread per
// two columns) fit the consumers' registers (up to 80 columns: 120 live
// values at D = 72), else 32 (at D = 128: 16 + 16 + 8 + 64).
template <class C>
constexpr int kBK = 64 * C::FB + C::TW <= 80 ? 64 : 32;

// Every tile a multiple of 1024 bytes, so each starts 1024-aligned.
template <typename T, class C>
struct alignas(1024) Smem {
  T q[C::NFB][BQ * 64];
  T dout[C::NFB][BQ * 64];
  T k[kStages][C::NFB][kBK<C> * 64];
  T v[kStages][C::NFB][kBK<C> * 64];
  T q_tail[BQ * C::NTW];
  T dout_tail[BQ * C::NTW];
  T k_tail[kStages][kBK<C> * C::NTW];
  T v_tail[kStages][kBK<C> * C::NTW];
  uint64_t q_full, full[kStages], empty[kStages];
};

// D (64 x BK) += A (64 x 16) * B (16 x BK), both in shared memory, K-major.
template <typename T, int BK>
__device__ __forceinline__ void mma_keys(float (&d)[BK / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BK == 64) {
    hw::wgmma_m64n64k16_ss_t<T>(d, a, b, scale_d);
  } else {
    hw::wgmma_m64n32k16_ss_t<T>(d, a, b, scale_d);
  }
}

// One consumer warpgroup: query rows [r0, r0 + 64) of head bh, rows 64c of
// the block's Q and dO tiles.
template <typename T, class C>
__device__ __forceinline__ void consumer(Smem<T, C>& s, const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dq,
                                         int N, int D, int bh, int r0, int nkb, float scale,
                                         int c) {
  constexpr int BK = kBK<C>;
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

  hw::mbar_wait(&s.q_full, 0);
#pragma unroll
  for (int b = 0; b < C::FB; ++b) scale_in_place(s.q[b] + c * 64 * 64, 64 * 64 / 8, scale, t);
  if constexpr (C::TW != 0) scale_in_place(s.q_tail + c * 64 * C::TW, 64 * C::TW / 8, scale, t);
  hw::fence_proxy_async();
  hw::named_sync(1 + c, 128);

  const uint64_t q_box = hw::sw128_desc(s.q[0] + c * 64 * 64, 16, 1024);
  const uint64_t q_tail = tail_desc<C>(s.q_tail + c * 64 * C::TW);
  const uint64_t o_box = hw::sw128_desc(s.dout[0] + c * 64 * 64, 16, 1024);
  const uint64_t o_tail = tail_desc<C>(s.dout_tail + c * 64 * C::TW);
  float acc[C::NFB][32], at[C::NTW / 2];
#pragma unroll
  for (int b = 0; b < C::NFB; ++b) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < C::NTW / 2; ++i) at[i] = 0.f;

  for (int j = 0; j < nkb; ++j) {
    const int st = j % kStages;
    hw::mbar_wait(&s.full[st], (j / kStages) & 1);

    float sc[BK / 2], dp[BK / 2];  // 64 rows x BK keys each
    const uint64_t k_box = hw::sw128_desc(s.k[st][0], 16, 1024);
    const uint64_t k_tail = tail_desc<C>(s.k_tail[st]);
    const uint64_t v_box = hw::sw128_desc(s.v[st][0], 16, 1024);
    const uint64_t v_tail = tail_desc<C>(s.v_tail[st]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {  // S = (q * scale) K^T
      mma_keys<T, BK>(sc, kmajor<C>(q_box, q_tail, kk, BQ), kmajor<C>(k_box, k_tail, kk, BK), kk);
    }
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {  // dP = dO V^T
      mma_keys<T, BK>(dp, kmajor<C>(o_box, o_tail, kk, BQ), kmajor<C>(v_box, v_tail, kk, BK), kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);
    hw::fence_regs(dp);

    // dS = P (dP - delta), P = exp2(S log2 e - lse log2 e), 0 for keys past
    // N (zero-filled keys give a logit of 0), rounded to the dtype into the
    // A operand of key step kk: accumulator chunks 2kk and 2kk + 1
    const int k0 = j * BK;
    const bool ragged = k0 + BK > N;
    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
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
        dsa[n >> 1][2 * (n & 1) + h] = Half<T>::pack(ds[0], ds[1]);
      }
    }

    // dQ += dS K over every box and the tail, K MN-major
#pragma unroll
    for (int b = 0; b < C::FB; ++b) hw::fence_regs(acc[b]);
    if constexpr (C::TW != 0) hw::fence_regs(at);
    hw::fence_regs(dsa);
    hw::wgmma_fence();
#pragma unroll
    for (int b = 0; b < C::FB; ++b) {
      const uint64_t k_mn = hw::sw128_desc(s.k[st][b], BK * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hw::wgmma_m64n64k16_rs_t<T>(acc[b], dsa[kk], hw::desc_add(k_mn, 2048 * kk), 1);
      }
    }
    if constexpr (C::TW != 0) {  // the tail's columns, one atom of its swizzle
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        mma_tail<T, C::TW>(at, dsa[kk], hw::desc_add(k_tail, 16 * C::TB * kk), 1);
      }
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < C::FB; ++b) hw::fence_regs(acc[b]);
    if constexpr (C::TW != 0) hw::fence_regs(at);
    hw::fence_regs(dsa);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&s.empty[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= N) continue;
    T* dst = dq + ((size_t)bh * N + row) * D + 2 * tg;
#pragma unroll
    for (int b = 0; b < C::FB; ++b) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int col = 64 * b + 8 * d;
        if (col < D) {
          store_pair(dst + col, acc[b][4 * d + 2 * h] * scale, acc[b][4 * d + 2 * h + 1] * scale);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < C::TW / 8; ++d) {
      const int col = 64 * C::FB + 8 * d;
      if (col < D) store_pair(dst + col, at[4 * d + 2 * h] * scale, at[4 * d + 2 * h + 1] * scale);
    }
  }
}

template <typename T, class C>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const __grid_constant__ CUtensorMap tail_q, const __grid_constant__ CUtensorMap tail_k,
           const __grid_constant__ CUtensorMap tail_v, const __grid_constant__ CUtensorMap tail_do,
           const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
           int N, int D, int nqb, float scale) {
  constexpr int BK = kBK<C>;
  extern __shared__ uint8_t smem_raw[];
  Smem<T, C>& s = *reinterpret_cast<Smem<T, C>*>(hw::align_1024(smem_raw));
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
      hw::mbar_arrive_expect_tx(&s.q_full, 2 * BQ * (C::FB * 128 + C::TB));
      load_rows<C>(s.q[0], BQ * 64, s.q_tail, &map_q, &tail_q, &s.q_full, q0, bh);
      load_rows<C>(s.dout[0], BQ * 64, s.dout_tail, &map_do, &tail_do, &s.q_full, q0, bh);
      for (int j = 0; j < nkb; ++j) {
        const int st = j % kStages;
        if (j >= kStages) hw::mbar_wait(&s.empty[st], (j / kStages - 1) & 1);
        hw::mbar_arrive_expect_tx(&s.full[st], 2 * BK * (C::FB * 128 + C::TB));
        load_rows<C>(s.k[st][0], BK * 64, s.k_tail[st], &map_k, &tail_k, &s.full[st], j * BK, bh);
        load_rows<C>(s.v[st][0], BK * 64, s.v_tail[st], &map_v, &tail_v, &s.full[st], j * BK, bh);
      }
    }
  } else {  // consumers
    hw::regs_inc<kConsumerRegs>();
    consumer(s, lse, delta, dq, N, D, bh, q0 + (wg - 1) * 64, nkb, scale, wg - 1);
  }
}

template <typename T, class C>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int BH, int N, int D, float scale, cudaStream_t stream) {
  constexpr int kSmemBytes = sizeof(Smem<T, C>) + 1024;  // + the alignment slack
  const int nqb = (N + BQ - 1) / BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  if (!make_maps<C>(&maps[0], &maps[4], q, N, BH, BQ, D) ||
      !make_maps<C>(&maps[1], &maps[5], k, N, BH, kBK<C>, D) ||
      !make_maps<C>(&maps[2], &maps[6], v, N, BH, kBK<C>, D) ||
      !make_maps<C>(&maps[3], &maps[7], dout, N, BH, BQ, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = hw::prepare(kernel<T, C>, kSmemBytes, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  kernel<T, C><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], (const float*)lse,
      (const float*)delta, (T*)dq, N, D, nqb, scale);
  return (int)cudaGetLastError();
}

}  // namespace dq

// The columns of a 16-bit head dim (D % 8 == 0, 8 <= D <= 128): Cols<FB, TW>
// for launch<T, Cols<FB, TW>>.
template <class F>
int by_cols(int D, F&& launch) {
  const int fb = D / 64, r = D % 64;
  if (r == 0) return fb == 1 ? launch(Cols<1, 0>{}) : launch(Cols<2, 0>{});
  if (r <= 16) return fb == 0 ? launch(Cols<0, 16>{}) : launch(Cols<1, 16>{});
  if (r <= 32) return fb == 0 ? launch(Cols<0, 32>{}) : launch(Cols<1, 32>{});
  return fb == 0 ? launch(Cols<1, 0>{}) : launch(Cols<2, 0>{});
}

// What the entries take: 16-bit rows of D % 8 == 0 up to 128, float32 rows
// of D % 4 == 0 up to 96 (ops/attention.py::anydim_supports says the same).
bool covered(int dtype, int D) {
  if (dtype == 2) return D >= 4 && D <= 96 && D % 4 == 0;
  return (dtype == 0 || dtype == 1) && D >= 8 && D <= 128 && D % 8 == 0;
}

}  // namespace

// q, k, v, out: (BH, N, D) contiguous of `dtype` (0 bf16, 1 float16, 2
// float32); lse: (BH, N) float32.
extern "C" int cra5_flash_attn_fwd_anydim(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int BH, int N, int D, float scale,
                                          int dtype, void* stream) {
  if (N < 1 || BH < 1 || !covered(dtype, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 2) return cra5::anydim::fwd_f32(q, k, v, out, lse, BH, N, D, scale, s);
  auto run = [&](auto t) {
    using T = decltype(t);
    return by_cols(D, [&](auto cols) {
      return fwd::launch<T, decltype(cols)>(q, k, v, out, lse, BH, N, D, scale, s);
    });
  };
  return dtype == 0 ? run(__nv_bfloat16{}) : run(__half{});
}

// q, k, v, dout, dk, dv: (BH, N, D) contiguous of `dtype`; lse, delta: (BH,
// N) float32.
extern "C" int cra5_flash_attn_bwd_dkv_anydim(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int BH,
                                              int N, int D, float scale, int dtype,
                                              void* stream) {
  if (N < 1 || BH < 1 || !covered(dtype, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 2) {
    return cra5::anydim::dkv_f32(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, s);
  }
  auto run = [&](auto t) {
    using T = decltype(t);
    return by_cols(D, [&](auto cols) {
      return dkv::launch<T, decltype(cols)>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale,
                                            s);
    });
  };
  return dtype == 0 ? run(__nv_bfloat16{}) : run(__half{});
}

// q, k, v, dout, dq: (BH, N, D) contiguous of `dtype`; lse, delta: (BH, N)
// float32.
extern "C" int cra5_flash_attn_bwd_dq_anydim(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, int BH, int N, int D,
                                             float scale, int dtype, void* stream) {
  if (N < 1 || BH < 1 || !covered(dtype, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 2) return cra5::anydim::dq_f32(q, k, v, dout, lse, delta, dq, BH, N, D, scale, s);
  auto run = [&](auto t) {
    using T = decltype(t);
    return by_cols(D, [&](auto cols) {
      return dq::launch<T, decltype(cols)>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, s);
    });
  };
  return dtype == 0 ? run(__nv_bfloat16{}) : run(__half{});
}
