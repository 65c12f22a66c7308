// K4, K5 and K6 for every head dim and every float dtype the
// model may compute in (bf16, float16, float32, float64): the counterparts
// of _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel of
// cra5_tpu/ops/attention.py, which take their head dim from the operands.
// The kernels on the tensor cores (flash_attn_fwd.cu, flash_attn_bwd.cu,
// flash_attn_bwd_f32.cu) are built for head dim 64 in bf16 and float32, and
// K4 and K6 of flash_attn_anydim.cu and flash_attn_anydim_f32.cu for the
// 16-bit head dims of a multiple of 8 up to 128 and the float32 ones of a
// multiple of 4 up to 96; ops/attention.py sends the rest here: K5 at every
// head dim but 64, float64, and the head dims past those kernels' reach.
//
// SIMT tiles, products and sums on the FMA units in the accumulation type
// (float32, or float64 for float64 operands). Each row a block owns (a
// query row in K4 and K5, a key row in K6) is held by kLanes adjacent
// threads, lane l keeping head dims [l kPart, (l + 1) kPart) of it in
// registers; a dot product over the head dim is the lanes' part sums
// joined by __shfl_xor, so every lane of a row holds the same logits and
// statistics. The head dim is padded with zeros to kD (64, 128 or 256),
// which adds zero products and changes no sum; a head dim past 256 is
// walked in 256-column chunks (the *_wide kernels below). The walked rows are staged
// kTile at a time in shared memory, converted to the accumulation type,
// with each lane's part kPad elements after the last, so the kLanes
// distinct addresses a warp reads in one step fall in different banks.
//
// Numerics are the TPU kernels' (and the plain versions'): K4 scales q in
// the accumulation type and rounds it to the operands' dtype once, keeps
// logits and statistics unrounded, rounds P to the dtype for P V and
// clamps the row sum at 1e-30; K5 uses the same q and rounds dS for dS K;
// K6 scales the logits of raw q and rounds P for dV and dS for dK; dq and
// dk are scaled once at the end. K4 runs the online softmax a staged tile
// at a time. Keys (K4, K5) and queries (K6) past N are masked, rows past N
// are not written. No atomics: the results are deterministic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Storage type T: its accumulation type and the conversions to and from it.
template <typename T>
struct Num;
template <>
struct Num<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Num<__half> {
  using Acc = float;
  static __device__ __forceinline__ float load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half store(float x) { return __float2half_rn(x); }
};
template <>
struct Num<float> {
  using Acc = float;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <>
struct Num<double> {
  using Acc = double;
  static __device__ __forceinline__ double load(double x) { return x; }
  static __device__ __forceinline__ double store(double x) { return x; }
};

__device__ __forceinline__ float acc_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double acc_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float acc_exp(float x) { return expf(x); }
__device__ __forceinline__ double acc_exp(double x) { return exp(x); }
__device__ __forceinline__ float acc_log(float x) { return logf(x); }
__device__ __forceinline__ double acc_log(double x) { return log(x); }

// x rounded to T and back: the rounding points of the TPU kernels.
template <typename T>
__device__ __forceinline__ typename Num<T>::Acc rnd(typename Num<T>::Acc x) {
  return Num<T>::load(Num<T>::store(x));
}

enum Kind { kFwd, kDq, kDkv };

template <typename T, int kD>
struct Tile {
  using Acc = typename Num<T>::Acc;
  static constexpr int kPart = sizeof(Acc) == 8 ? 16 : 32;  // head dims a thread holds
  static constexpr int kLanes = kD / kPart;                   // threads a row, 2 to 16
  static constexpr int kThreads = 128;
  static constexpr int kRows = kThreads / kLanes;             // rows a block owns
  static constexpr int kPad = 16 / (int)sizeof(Acc);
  static constexpr int kStride = kPart + kPad;                // a lane's part in a staged row
  static constexpr int kLd = kLanes * kStride;                // staged row stride
  // staged rows: two tiles of 16 KB of head dims (in float32 units) at most
  static constexpr int kTile = 16384 / (kD * (int)sizeof(Acc)) < 64
                                   ? 16384 / (kD * (int)sizeof(Acc))
                                   : 64;
  static constexpr float kNegInf = -1e30f;

  // Rows [r0, r0 + kTile) of a (N, D) matrix, head dims [c0, c0 + kD),
  // into dst; rows past N and head dims past D are zero. Every thread of
  // the block calls it.
  static __device__ __forceinline__ void stage(Acc* dst, const T* __restrict__ src, int r0,
                                               int N, int D, int c0 = 0) {
    for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      Acc x = 0;
      if (r0 + r < N && c0 + d < D) x = Num<T>::load(src[(size_t)(r0 + r) * D + c0 + d]);
      dst[r * kLd + (d / kPart) * kStride + d % kPart] = x;
    }
  }

  // This lane's part of a row's head dims [c0, c0 + kD), times `scale`;
  // zeros past D or when !valid.
  static __device__ __forceinline__ void load_part(Acc (&x)[kPart], const T* __restrict__ row,
                                                   int lane, bool valid, int D, Acc scale,
                                                   int c0 = 0) {
#pragma unroll
    for (int i = 0; i < kPart; ++i) {
      const int d = c0 + lane * kPart + i;
      x[i] = valid && d < D ? Num<T>::load(row[d]) * scale : Acc(0);
    }
  }

  static __device__ __forceinline__ void store_part(T* __restrict__ row, const Acc (&x)[kPart],
                                                    int lane, int D, Acc scale, int c0 = 0) {
#pragma unroll
    for (int i = 0; i < kPart; ++i) {
      const int d = c0 + lane * kPart + i;
      if (d < D) row[d] = Num<T>::store(x[i] * scale);
    }
  }

  // The full dot product of a row with staged row s (at this lane's part).
  static __device__ __forceinline__ Acc dot(const Acc (&x)[kPart], const Acc* s) {
    Acc a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
    for (int i = 0; i < kPart; i += 4) {
      a0 = acc_fma(x[i], s[i], a0);
      a1 = acc_fma(x[i + 1], s[i + 1], a1);
      a2 = acc_fma(x[i + 2], s[i + 2], a2);
      a3 = acc_fma(x[i + 3], s[i + 3], a3);
    }
    Acc part = (a0 + a1) + (a2 + a3);
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    return part;
  }

  static __device__ __forceinline__ void axpy(Acc (&acc)[kPart], Acc p, const Acc* s) {
#pragma unroll
    for (int i = 0; i < kPart; ++i) acc[i] = acc_fma(p, s[i], acc[i]);
  }
};

// Pointers and sizes of one call; each kernel reads the ones it needs.
template <typename T, typename Acc>
struct Args {
  const T *q, *k, *v, *dout;
  const Acc *lse_in, *delta;
  T *out0, *out1;  // K4: out; K5: dq; K6: dk, dv
  Acc* lse_out;
  int N, D, nb;    // nb: row blocks a head
  Acc scale;
};

template <typename T, int kD>
__global__ void __launch_bounds__(128)
    fwd_kernel(Args<T, typename Num<T>::Acc> a) {
  using C = Tile<T, kD>;
  using Acc = typename C::Acc;
  __shared__ __align__(16) Acc sK[C::kTile * C::kLd];
  __shared__ __align__(16) Acc sV[C::kTile * C::kLd];

  const int N = a.N, D = a.D;
  const int bh = blockIdx.x / a.nb;
  const int row = (blockIdx.x % a.nb) * C::kRows + threadIdx.x / C::kLanes;
  const int lane = threadIdx.x % C::kLanes;
  const int off = lane * C::kStride;
  const size_t base = (size_t)bh * N * D;
  const bool valid = row < N;

  Acc qs[C::kPart], o[C::kPart];
  C::load_part(qs, a.q + base + (size_t)row * D, lane, valid, D, a.scale);
#pragma unroll
  for (int i = 0; i < C::kPart; ++i) {
    qs[i] = rnd<T>(qs[i]);  // q * scale, rounded to the dtype once
    o[i] = 0;
  }
  Acc m = C::kNegInf, l = 0;

  for (int k0 = 0; k0 < N; k0 += C::kTile) {
    __syncthreads();  // every thread is done with the previous tile
    C::stage(sK, a.k + base, k0, N, D);
    C::stage(sV, a.v + base, k0, N, D);
    __syncthreads();
    const int nk = min(C::kTile, N - k0);
    Acc s[C::kTile];
    Acc mx = m;
#pragma unroll
    for (int j = 0; j < C::kTile; ++j) {
      s[j] = j < nk ? C::dot(qs, sK + j * C::kLd + off) : Acc(C::kNegInf);
      mx = s[j] > mx ? s[j] : mx;
    }
    const Acc alpha = acc_exp(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < C::kPart; ++i) o[i] *= alpha;
#pragma unroll
    for (int j = 0; j < C::kTile; ++j) {
      const Acc p = acc_exp(s[j] - m);
      l += p;
      C::axpy(o, rnd<T>(p), sV + j * C::kLd + off);
    }
  }
  if (!valid) return;
  const Acc lc = l > Acc(1e-30) ? l : Acc(1e-30);
#pragma unroll
  for (int i = 0; i < C::kPart; ++i) o[i] /= lc;
  C::store_part(a.out0 + base + (size_t)row * D, o, lane, D, Acc(1));
  if (lane == 0) a.lse_out[(size_t)bh * N + row] = m + acc_log(lc);
}

template <typename T, int kD>
__global__ void __launch_bounds__(128)
    dq_kernel(Args<T, typename Num<T>::Acc> a) {
  using C = Tile<T, kD>;
  using Acc = typename C::Acc;
  __shared__ __align__(16) Acc sK[C::kTile * C::kLd];
  __shared__ __align__(16) Acc sV[C::kTile * C::kLd];

  const int N = a.N, D = a.D;
  const int bh = blockIdx.x / a.nb;
  const int row = (blockIdx.x % a.nb) * C::kRows + threadIdx.x / C::kLanes;
  const int lane = threadIdx.x % C::kLanes;
  const int off = lane * C::kStride;
  const size_t base = (size_t)bh * N * D;
  const bool valid = row < N;

  Acc qs[C::kPart], dop[C::kPart], acc[C::kPart];
  C::load_part(qs, a.q + base + (size_t)row * D, lane, valid, D, a.scale);
  C::load_part(dop, a.dout + base + (size_t)row * D, lane, valid, D, Acc(1));
#pragma unroll
  for (int i = 0; i < C::kPart; ++i) {
    qs[i] = rnd<T>(qs[i]);
    acc[i] = 0;
  }
  const Acc lse_r = valid ? a.lse_in[(size_t)bh * N + row] : Acc(0);
  const Acc dl_r = valid ? a.delta[(size_t)bh * N + row] : Acc(0);

  for (int k0 = 0; k0 < N; k0 += C::kTile) {
    __syncthreads();
    C::stage(sK, a.k + base, k0, N, D);
    C::stage(sV, a.v + base, k0, N, D);
    __syncthreads();
    const int nk = min(C::kTile, N - k0);
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      const Acc* kj = sK + j * C::kLd + off;
      const Acc s = C::dot(qs, kj);                          // (q * scale) k
      const Acc dp = C::dot(dop, sV + j * C::kLd + off);     // dO v
      C::axpy(acc, rnd<T>(acc_exp(s - lse_r) * (dp - dl_r)), kj);  // dS k
    }
  }
  if (valid) C::store_part(a.out0 + base + (size_t)row * D, acc, lane, D, a.scale);
}

template <typename T, int kD>
__global__ void __launch_bounds__(128)
    dkv_kernel(Args<T, typename Num<T>::Acc> a) {
  using C = Tile<T, kD>;
  using Acc = typename C::Acc;
  __shared__ __align__(16) Acc sQ[C::kTile * C::kLd];
  __shared__ __align__(16) Acc sO[C::kTile * C::kLd];
  __shared__ Acc sL[C::kTile];
  __shared__ Acc sD[C::kTile];

  const int N = a.N, D = a.D;
  const int bh = blockIdx.x / a.nb;
  const int row = (blockIdx.x % a.nb) * C::kRows + threadIdx.x / C::kLanes;
  const int lane = threadIdx.x % C::kLanes;
  const int off = lane * C::kStride;
  const size_t base = (size_t)bh * N * D;
  const bool valid = row < N;

  Acc kr[C::kPart], vr[C::kPart], dk[C::kPart], dv[C::kPart];
  C::load_part(kr, a.k + base + (size_t)row * D, lane, valid, D, Acc(1));
  C::load_part(vr, a.v + base + (size_t)row * D, lane, valid, D, Acc(1));
#pragma unroll
  for (int i = 0; i < C::kPart; ++i) dk[i] = dv[i] = 0;

  for (int q0 = 0; q0 < N; q0 += C::kTile) {
    __syncthreads();
    C::stage(sQ, a.q + base, q0, N, D);
    C::stage(sO, a.dout + base, q0, N, D);
    for (int i = threadIdx.x; i < C::kTile; i += C::kThreads) {
      const bool in = q0 + i < N;
      sL[i] = in ? a.lse_in[(size_t)bh * N + q0 + i] : Acc(0);
      sD[i] = in ? a.delta[(size_t)bh * N + q0 + i] : Acc(0);
    }
    __syncthreads();
    const int nq = min(C::kTile, N - q0);
#pragma unroll 2
    for (int i = 0; i < nq; ++i) {
      const Acc* qi = sQ + i * C::kLd + off;
      const Acc* oi = sO + i * C::kLd + off;
      const Acc p = acc_exp(C::dot(kr, qi) * a.scale - sL[i]);  // raw q, logits scaled
      const Acc ds = p * (C::dot(vr, oi) - sD[i]);
      C::axpy(dv, rnd<T>(p), oi);   // dV += P^T dO
      C::axpy(dk, rnd<T>(ds), qi);  // dK += dS^T Q
    }
  }
  if (!valid) return;
  C::store_part(a.out0 + base + (size_t)row * D, dk, lane, D, a.scale);
  C::store_part(a.out1 + base + (size_t)row * D, dv, lane, D, Acc(1));
}

// Head dims past 256: the same tile at kD = 256, walked over the head dim
// in 256-column chunks. A block owns kRows rows and ONE 256-column chunk of
// the output (blockIdx.x = row block x chunks + chunk), so its accumulators
// stay kPart registers a lane whatever D is; each walked tile's logits (and
// for K5/K6 the dO v or v dO products) are summed over every chunk first,
// staging one chunk of the walked rows at a time, and only then is the
// tile's output chunk staged and accumulated. The ceil(D / 256) blocks of a
// row block each recompute the logits: (chunks + 1) / 2 times the products
// of one pass in all, for a block whose registers do not grow with D and a
// grid of chunks times more blocks. The rounding points are those of the
// kernels above; only the order of the head-dim sums differs (chunk part
// sums added in chunk order).
constexpr int kWide = 256;

template <typename T>
__global__ void __launch_bounds__(128)
    fwd_wide_kernel(Args<T, typename Num<T>::Acc> a) {
  using C = Tile<T, kWide>;
  using Acc = typename C::Acc;
  __shared__ __align__(16) Acc sK[C::kTile * C::kLd];
  __shared__ __align__(16) Acc sV[C::kTile * C::kLd];

  const int N = a.N, D = a.D;
  const int nc = (D + kWide - 1) / kWide;
  const int c0 = (blockIdx.x % nc) * kWide;  // this block's output columns
  const int rb = blockIdx.x / nc;
  const int bh = rb / a.nb;
  const int row = (rb % a.nb) * C::kRows + threadIdx.x / C::kLanes;
  const int lane = threadIdx.x % C::kLanes;
  const int off = lane * C::kStride;
  const size_t base = (size_t)bh * N * D;
  const bool valid = row < N;
  const T* qrow = a.q + base + (size_t)(valid ? row : 0) * D;

  Acc o[C::kPart];
#pragma unroll
  for (int i = 0; i < C::kPart; ++i) o[i] = 0;
  Acc m = C::kNegInf, l = 0;

  for (int k0 = 0; k0 < N; k0 += C::kTile) {
    Acc s[C::kTile];
#pragma unroll
    for (int j = 0; j < C::kTile; ++j) s[j] = 0;
    for (int d0 = 0; d0 < D; d0 += kWide) {
      __syncthreads();  // every thread is done with the previous chunk
      C::stage(sK, a.k + base, k0, N, D, d0);
      __syncthreads();
      Acc qs[C::kPart];
      C::load_part(qs, qrow, lane, valid, D, a.scale, d0);
#pragma unroll
      for (int i = 0; i < C::kPart; ++i) qs[i] = rnd<T>(qs[i]);
#pragma unroll
      for (int j = 0; j < C::kTile; ++j) s[j] += C::dot(qs, sK + j * C::kLd + off);
    }
    __syncthreads();
    C::stage(sV, a.v + base, k0, N, D, c0);
    __syncthreads();
    const int nk = min(C::kTile, N - k0);
    Acc mx = m;
#pragma unroll
    for (int j = 0; j < C::kTile; ++j) {
      if (j >= nk) s[j] = C::kNegInf;
      mx = s[j] > mx ? s[j] : mx;
    }
    const Acc alpha = acc_exp(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < C::kPart; ++i) o[i] *= alpha;
#pragma unroll
    for (int j = 0; j < C::kTile; ++j) {
      const Acc p = acc_exp(s[j] - m);
      l += p;
      C::axpy(o, rnd<T>(p), sV + j * C::kLd + off);
    }
  }
  if (!valid) return;
  const Acc lc = l > Acc(1e-30) ? l : Acc(1e-30);
#pragma unroll
  for (int i = 0; i < C::kPart; ++i) o[i] /= lc;
  C::store_part(a.out0 + base + (size_t)row * D, o, lane, D, Acc(1), c0);
  if (c0 == 0 && lane == 0) a.lse_out[(size_t)bh * N + row] = m + acc_log(lc);
}

template <typename T>
__global__ void __launch_bounds__(128)
    dq_wide_kernel(Args<T, typename Num<T>::Acc> a) {
  using C = Tile<T, kWide>;
  using Acc = typename C::Acc;
  __shared__ __align__(16) Acc sK[C::kTile * C::kLd];
  __shared__ __align__(16) Acc sV[C::kTile * C::kLd];

  const int N = a.N, D = a.D;
  const int nc = (D + kWide - 1) / kWide;
  const int c0 = (blockIdx.x % nc) * kWide;
  const int rb = blockIdx.x / nc;
  const int bh = rb / a.nb;
  const int row = (rb % a.nb) * C::kRows + threadIdx.x / C::kLanes;
  const int lane = threadIdx.x % C::kLanes;
  const int off = lane * C::kStride;
  const size_t base = (size_t)bh * N * D;
  const bool valid = row < N;
  const size_t roff = base + (size_t)(valid ? row : 0) * D;

  Acc acc[C::kPart];
#pragma unroll
  for (int i = 0; i < C::kPart; ++i) acc[i] = 0;
  const Acc lse_r = valid ? a.lse_in[(size_t)bh * N + row] : Acc(0);
  const Acc dl_r = valid ? a.delta[(size_t)bh * N + row] : Acc(0);

  for (int k0 = 0; k0 < N; k0 += C::kTile) {
    Acc s[C::kTile], dp[C::kTile];
#pragma unroll
    for (int j = 0; j < C::kTile; ++j) s[j] = dp[j] = 0;
    for (int d0 = 0; d0 < D; d0 += kWide) {
      __syncthreads();
      C::stage(sK, a.k + base, k0, N, D, d0);
      C::stage(sV, a.v + base, k0, N, D, d0);
      __syncthreads();
      Acc x[C::kPart];
      C::load_part(x, a.q + roff, lane, valid, D, a.scale, d0);
#pragma unroll
      for (int i = 0; i < C::kPart; ++i) x[i] = rnd<T>(x[i]);
#pragma unroll
      for (int j = 0; j < C::kTile; ++j) s[j] += C::dot(x, sK + j * C::kLd + off);  // (q * scale) k
      C::load_part(x, a.dout + roff, lane, valid, D, Acc(1), d0);
#pragma unroll
      for (int j = 0; j < C::kTile; ++j) dp[j] += C::dot(x, sV + j * C::kLd + off);  // dO v
    }
    __syncthreads();
    C::stage(sK, a.k + base, k0, N, D, c0);
    __syncthreads();
    const int nk = min(C::kTile, N - k0);
#pragma unroll
    for (int j = 0; j < C::kTile; ++j)
      if (j < nk) C::axpy(acc, rnd<T>(acc_exp(s[j] - lse_r) * (dp[j] - dl_r)), sK + j * C::kLd + off);
  }
  if (valid) C::store_part(a.out0 + roff, acc, lane, D, a.scale, c0);
}

template <typename T>
__global__ void __launch_bounds__(128)
    dkv_wide_kernel(Args<T, typename Num<T>::Acc> a) {
  using C = Tile<T, kWide>;
  using Acc = typename C::Acc;
  __shared__ __align__(16) Acc sQ[C::kTile * C::kLd];
  __shared__ __align__(16) Acc sO[C::kTile * C::kLd];
  __shared__ Acc sL[C::kTile];
  __shared__ Acc sD[C::kTile];

  const int N = a.N, D = a.D;
  const int nc = (D + kWide - 1) / kWide;
  const int c0 = (blockIdx.x % nc) * kWide;
  const int rb = blockIdx.x / nc;
  const int bh = rb / a.nb;
  const int row = (rb % a.nb) * C::kRows + threadIdx.x / C::kLanes;
  const int lane = threadIdx.x % C::kLanes;
  const int off = lane * C::kStride;
  const size_t base = (size_t)bh * N * D;
  const bool valid = row < N;
  const size_t roff = base + (size_t)(valid ? row : 0) * D;

  Acc dk[C::kPart], dv[C::kPart];
#pragma unroll
  for (int i = 0; i < C::kPart; ++i) dk[i] = dv[i] = 0;

  for (int q0 = 0; q0 < N; q0 += C::kTile) {
    Acc s[C::kTile], dp[C::kTile];
#pragma unroll
    for (int i = 0; i < C::kTile; ++i) s[i] = dp[i] = 0;
    for (int d0 = 0; d0 < D; d0 += kWide) {
      __syncthreads();
      C::stage(sQ, a.q + base, q0, N, D, d0);
      C::stage(sO, a.dout + base, q0, N, D, d0);
      if (d0 == 0) {
        for (int i = threadIdx.x; i < C::kTile; i += C::kThreads) {
          const bool in = q0 + i < N;
          sL[i] = in ? a.lse_in[(size_t)bh * N + q0 + i] : Acc(0);
          sD[i] = in ? a.delta[(size_t)bh * N + q0 + i] : Acc(0);
        }
      }
      __syncthreads();
      Acc x[C::kPart];
      C::load_part(x, a.k + roff, lane, valid, D, Acc(1), d0);
#pragma unroll
      for (int i = 0; i < C::kTile; ++i) s[i] += C::dot(x, sQ + i * C::kLd + off);  // raw q k
      C::load_part(x, a.v + roff, lane, valid, D, Acc(1), d0);
#pragma unroll
      for (int i = 0; i < C::kTile; ++i) dp[i] += C::dot(x, sO + i * C::kLd + off);  // v dO
    }
    __syncthreads();
    C::stage(sQ, a.q + base, q0, N, D, c0);
    C::stage(sO, a.dout + base, q0, N, D, c0);
    __syncthreads();
    const int nq = min(C::kTile, N - q0);
#pragma unroll
    for (int i = 0; i < C::kTile; ++i) {
      if (i < nq) {
        const Acc p = acc_exp(s[i] * a.scale - sL[i]);  // logits scaled
        const Acc ds = p * (dp[i] - sD[i]);
        C::axpy(dv, rnd<T>(p), sO + i * C::kLd + off);   // dV += P^T dO
        C::axpy(dk, rnd<T>(ds), sQ + i * C::kLd + off);  // dK += dS^T Q
      }
    }
  }
  if (!valid) return;
  C::store_part(a.out0 + roff, dk, lane, D, a.scale, c0);
  C::store_part(a.out1 + roff, dv, lane, D, Acc(1), c0);
}

template <Kind kKind, typename T>
int launch_wide(Args<T, typename Num<T>::Acc> a, int BH, cudaStream_t stream) {
  using C = Tile<T, kWide>;
  a.nb = (a.N + C::kRows - 1) / C::kRows;
  const long long blocks = (long long)BH * a.nb * ((a.D + kWide - 1) / kWide);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if constexpr (kKind == kFwd) fwd_wide_kernel<T><<<(unsigned)blocks, C::kThreads, 0, stream>>>(a);
  if constexpr (kKind == kDq) dq_wide_kernel<T><<<(unsigned)blocks, C::kThreads, 0, stream>>>(a);
  if constexpr (kKind == kDkv) dkv_wide_kernel<T><<<(unsigned)blocks, C::kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <Kind kKind, typename T, int kD>
int launch(Args<T, typename Num<T>::Acc> a, int BH, cudaStream_t stream) {
  using C = Tile<T, kD>;
  a.nb = (a.N + C::kRows - 1) / C::kRows;
  const long long blocks = (long long)BH * a.nb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if constexpr (kKind == kFwd) fwd_kernel<T, kD><<<(unsigned)blocks, C::kThreads, 0, stream>>>(a);
  if constexpr (kKind == kDq) dq_kernel<T, kD><<<(unsigned)blocks, C::kThreads, 0, stream>>>(a);
  if constexpr (kKind == kDkv) dkv_kernel<T, kD><<<(unsigned)blocks, C::kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel of the narrowest padded head dim that holds D; past 256 the
// chunked walk.
template <Kind kKind, typename T>
int by_dim(const void* q, const void* k, const void* v, const void* dout, const void* lse_in,
           const void* delta, void* out0, void* out1, void* lse_out, int BH, int N, int D,
           double scale, void* stream) {
  using Acc = typename Num<T>::Acc;
  Args<T, Acc> a{(const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const Acc*)lse_in,
                 (const Acc*)delta, (T*)out0, (T*)out1, (Acc*)lse_out, N, D, 0, (Acc)scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64) return launch<kKind, T, 64>(a, BH, s);
  if (D <= 128) return launch<kKind, T, 128>(a, BH, s);
  if (D <= kWide) return launch<kKind, T, 256>(a, BH, s);
  return launch_wide<kKind, T>(a, BH, s);
}

// dtype: 0 bf16, 1 float16, 2 float32, 3 float64.
template <Kind kKind>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* dout,
             const void* lse_in, const void* delta, void* out0, void* out1, void* lse_out, int BH,
             int N, int D, double scale, void* stream) {
  if (N < 1 || BH < 1 || D < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return by_dim<kKind, __nv_bfloat16>(q, k, v, dout, lse_in, delta, out0, out1, lse_out, BH,
                                          N, D, scale, stream);
    case 1:
      return by_dim<kKind, __half>(q, k, v, dout, lse_in, delta, out0, out1, lse_out, BH, N, D,
                                   scale, stream);
    case 2:
      return by_dim<kKind, float>(q, k, v, dout, lse_in, delta, out0, out1, lse_out, BH, N, D,
                                  scale, stream);
    case 3:
      return by_dim<kKind, double>(q, k, v, dout, lse_in, delta, out0, out1, lse_out, BH, N, D,
                                   scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (BH, N, D) contiguous of `dtype`; lse: (BH, N) float32
// (float64 for float64 operands).
extern "C" int cra5_flash_attn_fwd_any(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int BH, int N, int D, double scale, int dtype,
                                       void* stream) {
  return dispatch<kFwd>(dtype, q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse, BH, N, D,
                        scale, stream);
}

// q, k, v, dout, dq: (BH, N, D) contiguous of `dtype`; lse, delta: (BH, N)
// in the accumulation type.
extern "C" int cra5_flash_attn_bwd_dq_any(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int BH, int N, int D, double scale, int dtype,
                                          void* stream) {
  return dispatch<kDq>(dtype, q, k, v, dout, lse, delta, dq, nullptr, nullptr, BH, N, D, scale,
                       stream);
}

// q, k, v, dout, dk, dv: (BH, N, D) contiguous of `dtype`; lse, delta:
// (BH, N) in the accumulation type.
extern "C" int cra5_flash_attn_bwd_dkv_any(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int BH, int N, int D, double scale,
                                           int dtype, void* stream) {
  return dispatch<kDkv>(dtype, q, k, v, dout, lse, delta, dk, dv, nullptr, BH, N, D, scale,
                        stream);
}
