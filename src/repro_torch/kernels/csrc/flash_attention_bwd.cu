// The gradient of flash_attention for full-sequence attention, for Hopper.
//
// The reference trains through its jnp attention (_attend_dense_impl,
// repro/models/layers.py:100), which XLA differentiates: it has no backward
// kernel.  The port's forward runs the hand-written flash_attention.cu, so
// its gradient is written by hand as well.  Contract: q (b, hq, s, dh), k
// and v (b, hkv, s, dh) with GQA groups g = hq / hkv (head h reads kv head
// h / g), o the forward's output and dO its cotangent, both (b, hq, s,
// dh); every query sees the keys its mask allows (kv_len = s for every
// row: no kv_lens), an optional causal mask, a sliding window (query i
// sees key j iff i - j < window) and a tanh softcap on the scaled scores.
// Outputs dq, dk, dv in the input dtype, accumulated in f32.  Tensors come
// with element strides for their three leading dims (the last dim
// contiguous), as the forward takes them.
//
// Three launches, no float atomics, so every output element is written
// once by one thread and repeated calls are bit-identical:
//
// 1. bwd_lse_kernel, one block per (query tile, head, batch row): the
//    log-sum-exp of each query row over its valid keys, recomputed from q
//    and k (the forward kernel keeps no statistics), and D = sum(dO * o)
//    in f32.
// 2. bwd_dkdv_kernel, one block per (key tile, kv head, batch row): it
//    holds its K and V tile and walks the g query heads of its group and,
//    for each, only the query tiles that can see the tile (the causal and
//    window bounds).  It rebuilds P = exp(s - lse), accumulates dV += P^T
//    dO and dK += dS^T Q in registers, and writes them once: the GQA sum
//    over the group needs no atomic.  In bf16 P is rounded to bf16 before
//    P^T dO, as the forward rounds p to the V dtype before P.V
//    (repro/models/layers.py:118).
// 3. bwd_dq_kernel, one block per (query tile, head, batch row), walks the
//    key tiles its rows see and accumulates dQ += dS K.
//
// dS = P * (dP - D) with dP = dO V^T, times the softcap's derivative 1 -
// tanh^2(s / cap) where there is a cap; the 1/sqrt(dh) scale is applied
// to dQ and dK at the end.
//
// Bound: five products of 2 * dh flops per valid (query, key) pair (S
// recomputed, dP, dV, dK, dQ) against q, k, v, o and dO read once and dq,
// dk, dv written once: operations bound at the training shapes (qwen's
// microbatch, 4 x 1023 tokens of 16 x 64 heads, causal: 21.4 GFLOP, 0.022
// ms at the bf16 tensor-core rate, against 67 MB, 0.020 ms of bytes).  This
// design does not chase that bound: it issues the products as scalar f32
// FMAs (67 TFLOP/s at most) and recomputes S in each launch.
//
// The products are scalar f32 FMAs on tiles staged in shared memory as
// f32 (rows padded by one float, so a warp's 16 rows at one column fall
// in 16 banks): 256 threads as 16 x 16, each owning a (rows / 16) x (cols
// / 16) register tile with rows ty, ty + 16, ... and columns tx, tx + 16,
// ....  Tiles are 64 x 64 up to dh 128 and 32 x 32 at dh 256 (shared
// memory: 4 tiles of (rows x (dh + 1)) floats plus P; 149,248 bytes at dh
// 128).  Speed is left to a later design: this one is simple and right.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

using attn::from_f;
using attn::to_f;

constexpr int THREADS = 256;

struct BwdStrides {
  // (batch, head, sequence) element strides of q, k, v, o, dO, dq, dk, dv
  long long t[8][3];
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

struct Mask {
  int s, causal, window;
  __device__ __forceinline__ bool ok(int qi, int kj) const {
    return qi < s && kj < s && (!causal || kj <= qi) &&
           (window <= 0 || qi - kj < window);
  }
};

template <int DH> struct Cfg {
  static constexpr int B = DH > 128 ? 32 : 64;  // rows of every tile
  static constexpr int PT = B / 16;             // per thread, each way
  static constexpr int TD = DH / 16;            // per thread, along dh
  static constexpr int LD = DH + 1;             // padded row, floats
  static constexpr int PLD = B + 1;
  static constexpr int SMEM_LSE = 2 * B * LD * 4;
  static constexpr int SMEM = (4 * B * LD + B * PLD + 2 * B) * 4;
};

// rows r0 .. r0 + B - 1 of an (s, DH) matrix (row stride rs) into dst as
// f32, zeros past s
template <typename T, int DH, int B>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int s) {
  for (int e = threadIdx.x; e < B * DH; e += THREADS) {
    const int r = e / DH, c = e - r * DH;
    dst[r * (DH + 1) + c] =
        r0 + r < s ? to_f(src[(long long)(r0 + r) * rs + c]) : 0.f;
  }
}

// acc[i][j] += sum_x A(ty + 16 i, x) * B(tx + 16 j, x), with A(r, x) =
// a[r * sar + x * sax] and B(c, x) = b[c * sbc + x * sbx]
template <int TM, int TN>
__device__ __forceinline__ void tile_mm(float (&acc)[TM][TN], int n,
                                        const float* a, int sar, int sax,
                                        const float* b, int sbc, int sbx) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int x = 0; x < n; ++x) {
    float ra[TM], rb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ra[i] = a[(ty + 16 * i) * sar + x * sax];
#pragma unroll
    for (int j = 0; j < TN; ++j) rb[j] = b[(tx + 16 * j) * sbc + x * sbx];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// the 16 lanes of a half warp share a row: reduce over them
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(attn::FULL, x, off, 16));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(attn::FULL, x, off, 16);
  return x;
}

// the scaled, softcapped score of the S tile entry held in sc; f gets the
// softcap's derivative (1 without a cap)
__device__ __forceinline__ float capped(float sc, float scale, float softcap,
                                        float& f) {
  float s = sc * scale;
  f = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    s = softcap * t;
    f = 1.f - t * t;
  }
  return s;
}

template <typename T> __device__ __forceinline__ float v_dtype(float p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(p));
  else
    return p;
}

// query tiles [first, last] that see keys [k0, k1]
__device__ __forceinline__ void query_tiles(const Mask& m, int k0, int k1,
                                            int B, int& first, int& last) {
  const int lo = m.causal ? k0 : 0;
  const int hi = m.window > 0 ? min(m.s - 1, k1 + m.window - 1) : m.s - 1;
  first = lo / B;
  last = hi / B;
}

// key tiles [first, last] that queries [q0, q1] see
__device__ __forceinline__ void key_tiles(const Mask& m, int q0, int q1,
                                          int B, int& first, int& last) {
  const int lo = m.window > 0 ? max(0, q0 - m.window + 1) : 0;
  const int hi = m.causal ? q1 : m.s - 1;
  first = lo / B;
  last = hi / B;
}

// 1. log-sum-exp of each query row and D = sum(dO * o)
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    bwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ o, const T* __restrict__ dO,
                   float* __restrict__ lse, float* __restrict__ dsum, int hq,
                   int hkv, BwdStrides st, Mask mask, float scale,
                   float softcap) {
  using C = Cfg<DH>;
  constexpr int B = C::B, TT = C::PT, LD = C::LD;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + B * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * B, q1 = min(mask.s, q0 + B) - 1;
  const T* qb = q + b * st.t[Q][0] + h * st.t[Q][1];
  const T* kb = k + b * st.t[K][0] + kvh * st.t[K][1];
  const long long row0 = ((long long)b * hq + h) * mask.s;
  load_tile<T, DH, B>(Qs, qb, st.t[Q][2], q0, mask.s);

  // D: the 16 lanes of a half warp sum a row's columns tx, tx + 16, ...
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int qi = q0 + ty + 16 * i;
    float acc = 0.f;
    if (qi < mask.s) {
      const T* orow = o + b * st.t[O][0] + h * st.t[O][1] + qi * st.t[O][2];
      const T* grow =
          dO + b * st.t[DO][0] + h * st.t[DO][1] + qi * st.t[DO][2];
      for (int d = tx; d < DH; d += 16) acc += to_f(orow[d]) * to_f(grow[d]);
    }
    acc = half_sum(acc);
    if (tx == 0 && qi < mask.s) dsum[row0 + qi] = acc;
  }

  float m[TT], l[TT];
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  int kt0, kt1;
  key_tiles(mask, q0, q1, B, kt0, kt1);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * B;
    __syncthreads();
    load_tile<T, DH, B>(Ks, kb, st.t[K][2], k0, mask.s);
    __syncthreads();
    float sc[TT][TT];
    zero(sc);
    tile_mm(sc, DH, Qs, LD, 1, Ks, LD, 1);
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      const int qi = q0 + ty + 16 * i;
      float s[TT], tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        float f;
        s[j] = mask.ok(qi, k0 + tx + 16 * j)
                   ? capped(sc[i][j], scale, softcap, f)
                   : -INFINITY;
        tmax = fmaxf(tmax, s[j]);
      }
      const float mn = fmaxf(m[i], half_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TT; ++j)
        sum += (s[j] == -INFINITY) ? 0.f : expf(s[j] - mn);
      sum = half_sum(sum);
      if (mn != -INFINITY) {
        l[i] = l[i] * expf(m[i] - mn) + sum;
        m[i] = mn;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (tx == 0 && qi < mask.s) lse[row0 + qi] = m[i] + logf(l[i]);
  }
}

// Q, dO of head h and query tile q0, with their rows' lse and D
template <typename T, int DH>
__device__ __forceinline__ void load_query_side(
    float* Qs, float* dOs, float* Ls, float* Ds, const T* q, const T* dO,
    const float* lse, const float* dsum, const BwdStrides& st, int b, int h,
    int hq, int q0, int s) {
  constexpr int B = Cfg<DH>::B;
  load_tile<T, DH, B>(Qs, q + b * st.t[Q][0] + h * st.t[Q][1], st.t[Q][2],
                      q0, s);
  load_tile<T, DH, B>(dOs, dO + b * st.t[DO][0] + h * st.t[DO][1],
                      st.t[DO][2], q0, s);
  const long long row0 = ((long long)b * hq + h) * s;
  for (int r = threadIdx.x; r < B; r += THREADS) {
    Ls[r] = q0 + r < s ? lse[row0 + q0 + r] : 0.f;
    Ds[r] = q0 + r < s ? dsum[row0 + q0 + r] : 0.f;
  }
}

// P of the tile pair (q0, k0) into pf (times the softcap's derivative) and,
// with Ps, P itself in the V dtype to shared memory
template <typename T, int DH>
__device__ __forceinline__ void tile_p(float (&pf)[Cfg<DH>::PT][Cfg<DH>::PT],
                                       const float* Qs, const float* Ks,
                                       const float* Ls, float* Ps,
                                       const Mask& mask, int q0, int k0,
                                       float scale, float softcap) {
  using C = Cfg<DH>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[C::PT][C::PT];
  zero(sc);
  tile_mm(sc, DH, Qs, C::LD, 1, Ks, C::LD, 1);
#pragma unroll
  for (int i = 0; i < C::PT; ++i)
#pragma unroll
    for (int j = 0; j < C::PT; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      float f;
      const float s = capped(sc[i][j], scale, softcap, f);
      const float p = mask.ok(q0 + r, k0 + c) ? expf(s - Ls[r]) : 0.f;
      pf[i][j] = p * f;
      if (Ps) Ps[r * C::PLD + c] = v_dtype<T>(p);
    }
}

// dS = P f (dP - D), dP = dO V^T, into Ps
template <int DH>
__device__ __forceinline__ void tile_ds(
    const float (&pf)[Cfg<DH>::PT][Cfg<DH>::PT], const float* dOs,
    const float* Vs, const float* Ds, float* Ps) {
  using C = Cfg<DH>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float dp[C::PT][C::PT];
  zero(dp);
  tile_mm(dp, DH, dOs, C::LD, 1, Vs, C::LD, 1);
  __syncthreads();  // every thread is done reading Ps
#pragma unroll
  for (int i = 0; i < C::PT; ++i)
#pragma unroll
    for (int j = 0; j < C::PT; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      Ps[r * C::PLD + c] = pf[i][j] * (dp[i][j] - Ds[r]);
    }
}

// 2. dK and dV of one key tile over every query of its kv head's group
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dk,
                    T* __restrict__ dv, int hq, int hkv, BwdStrides st,
                    Mask mask, float scale, float softcap) {
  using C = Cfg<DH>;
  constexpr int B = C::B, TT = C::PT, TD = C::TD, LD = C::LD, PLD = C::PLD;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + B * LD;
  float* Ks = dOs + B * LD;
  float* Vs = Ks + B * LD;
  float* Ps = Vs + B * LD;
  float* Ls = Ps + B * PLD;
  float* Ds = Ls + B;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kvh = blockIdx.y, b = blockIdx.z, g = hq / hkv;
  const int k0 = blockIdx.x * B, k1 = min(mask.s, k0 + B) - 1;
  load_tile<T, DH, B>(Ks, k + b * st.t[K][0] + kvh * st.t[K][1], st.t[K][2],
                      k0, mask.s);
  load_tile<T, DH, B>(Vs, v + b * st.t[V][0] + kvh * st.t[V][1], st.t[V][2],
                      k0, mask.s);
  float ak[TT][TD], av[TT][TD];
  zero(ak);
  zero(av);
  int qt0, qt1;
  query_tiles(mask, k0, k1, B, qt0, qt1);
  for (int h = kvh * g; h < (kvh + 1) * g; ++h) {
    for (int qt = qt0; qt <= qt1; ++qt) {
      const int q0 = qt * B;
      __syncthreads();
      load_query_side<T, DH>(Qs, dOs, Ls, Ds, q, dO, lse, dsum, st, b, h, hq,
                             q0, mask.s);
      __syncthreads();
      float pf[TT][TT];
      tile_p<T, DH>(pf, Qs, Ks, Ls, Ps, mask, q0, k0, scale, softcap);
      __syncthreads();
      // dV += P^T dO: rows are keys, columns dh, summed over the queries
      tile_mm(av, B, Ps, 1, PLD, dOs, 1, LD);
      tile_ds<DH>(pf, dOs, Vs, Ds, Ps);
      __syncthreads();
      // dK += dS^T Q
      tile_mm(ak, B, Ps, 1, PLD, Qs, 1, LD);
    }
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= mask.s) continue;
    T* dkr = dk + b * st.t[DK][0] + kvh * st.t[DK][1] + kj * st.t[DK][2];
    T* dvr = dv + b * st.t[DV][0] + kvh * st.t[DV][1] + kj * st.t[DV][2];
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      dkr[tx + 16 * c] = from_f<T>(ak[i][c] * scale);
      dvr[tx + 16 * c] = from_f<T>(av[i][c]);
    }
  }
}

// 3. dQ of one query tile over the keys it sees
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, T* __restrict__ dq, int hq,
                  int hkv, BwdStrides st, Mask mask, float scale,
                  float softcap) {
  using C = Cfg<DH>;
  constexpr int B = C::B, TT = C::PT, TD = C::TD, LD = C::LD, PLD = C::PLD;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + B * LD;
  float* Ks = dOs + B * LD;
  float* Vs = Ks + B * LD;
  float* Ps = Vs + B * LD;
  float* Ls = Ps + B * PLD;
  float* Ds = Ls + B;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * B, q1 = min(mask.s, q0 + B) - 1;
  const T* kb = k + b * st.t[K][0] + kvh * st.t[K][1];
  const T* vb = v + b * st.t[V][0] + kvh * st.t[V][1];
  load_query_side<T, DH>(Qs, dOs, Ls, Ds, q, dO, lse, dsum, st, b, h, hq, q0,
                         mask.s);
  float aq[TT][TD];
  zero(aq);
  int kt0, kt1;
  key_tiles(mask, q0, q1, B, kt0, kt1);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * B;
    __syncthreads();
    load_tile<T, DH, B>(Ks, kb, st.t[K][2], k0, mask.s);
    load_tile<T, DH, B>(Vs, vb, st.t[V][2], k0, mask.s);
    __syncthreads();
    float pf[TT][TT];
    tile_p<T, DH>(pf, Qs, Ks, Ls, nullptr, mask, q0, k0, scale, softcap);
    tile_ds<DH>(pf, dOs, Vs, Ds, Ps);
    __syncthreads();
    // dQ += dS K: rows are queries, columns dh, summed over the keys
    tile_mm(aq, B, Ps, PLD, 1, Ks, 1, LD);
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= mask.s) continue;
    T* dqr = dq + b * st.t[DQ][0] + h * st.t[DQ][1] + qi * st.t[DQ][2];
#pragma unroll
    for (int c = 0; c < TD; ++c) dqr[tx + 16 * c] = from_f<T>(aq[i][c] * scale);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, void* dq, void* dk, void* dv, float* lse,
           float* dsum, int b, int hq, int hkv, const BwdStrides& st,
           const Mask& mask, float scale, float softcap,
           cudaStream_t stream) {
  using C = Cfg<DH>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_lse_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM_LSE);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dkdv_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dq_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (mask.s + C::B - 1) / C::B;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  bwd_lse_kernel<T, DH><<<dim3(tiles, hq, b), THREADS, C::SMEM_LSE, stream>>>(
      tq, tk, static_cast<const T*>(o), tdo, lse, dsum, hq, hkv, st, mask,
      scale, softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_kernel<T, DH><<<dim3(tiles, hkv, b), THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      hq, hkv, st, mask, scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<T, DH><<<dim3(tiles, hq, b), THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dq), hq, hkv, st, mask,
      scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 float32, 1 bfloat16; strides: 8 x (batch, head, sequence) of q,
// k, v, o, dO, dq, dk, dv; lse and dsum are (b, hq, s) f32 scratch.
extern "C" int flash_attention_bwd(int dtype, int dh, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dO, void* dq,
                                   void* dk, void* dv, float* lse,
                                   float* dsum, int b, int hq, int hkv,
                                   int s, const long long* strides,
                                   float scale, float softcap, int causal,
                                   int window, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  BwdStrides st;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) st.t[i][j] = strides[3 * i + j];
  const Mask mask{s, causal, window};
#define BWD(TYPE, DH)                                                      \
  return launch<TYPE, DH>(q, k, v, o, dO, dq, dk, dv, lse, dsum, b, hq,   \
                          hkv, st, mask, scale, softcap, stream)
  if (dtype == 0) {
    switch (dh) {
      case 32: BWD(float, 32);
      case 64: BWD(float, 64);
      case 80: BWD(float, 80);
      case 128: BWD(float, 128);
      case 256: BWD(float, 256);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 32: BWD(__nv_bfloat16, 32);
      case 64: BWD(__nv_bfloat16, 64);
      case 80: BWD(__nv_bfloat16, 80);
      case 128: BWD(__nv_bfloat16, 128);
      case 256: BWD(__nv_bfloat16, 256);
    }
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}
