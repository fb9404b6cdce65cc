// Pieces shared by flash_attention.cu and paged_attention.cu.
//
// * dtype conversions and warp reductions;
// * PTX wrappers for the bf16 tensor-core path and the vector loads:
//   16-byte cp.async with zero fill, ldmatrix, mma.sync m16n8k16.
// * combine_rows: the deterministic merge of key-split partials, and
//   optionally each row's log-sum-exp (flash's backward reads it).
//
// Everywhere: scores in f32, p cast to the V dtype before P.V
// (repro/kernels/flash_attention.py:89), rows without a valid key end
// with l = 0 and are written as 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with ok false the 16 bytes are
// zero-filled and src is not read (it must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (through L1); zero-filled when ok is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 16 bytes of T as 16 / sizeof(T) floats
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// ---- merge of key-split partials ------------------------------------------
//
// A kernel that splits a row's keys into n_split ranges writes, per split
// s and row, the range's running max m (log2 domain), sum l and the
// unnormalised f32 accumulator: pm[s * n_rows + row], pl[...],
// pacc[(s * n_rows + row) * DH + d].  A split with no valid key writes
// l = 0 and its m and acc are never read.  One warp merges one row: its
// lanes read 32 splits' (m, l) at once, then it adds the splits' acc in
// index order and sums l by a fixed shuffle tree (no atomics: the result
// does not depend on the order the blocks ran in), and writes o at the
// row's address: row =
// (bb * nh + hh) * ni + i, element offset bb * ob + hh * oh + i * os.
// With lse, it also writes lse[row] = ln(sum of exp(score)) over the
// row's valid keys (-inf without one), from the merged m and l.
// Lane l holds elements l, l + 32, ...: at a width that is not a multiple
// of 32 (dh 80) the last pass's lanes past DH are predicated off.
template <typename T, int DH>
__device__ __forceinline__ void combine_rows(
    const float* __restrict__ pm, const float* __restrict__ pl,
    const float* __restrict__ pacc, T* __restrict__ o, long long n_rows,
    int n_split, int nh, int ni, long long ob, long long oh, long long os,
    float* __restrict__ lse = nullptr) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= n_rows) return;             // whole warps leave together
  const int lane = threadIdx.x & 31;
  // lane s reads split s's (m, l), 32 splits at a time, all in flight
  float mx = -INFINITY;
  for (int s0 = 0; s0 < n_split; s0 += 32) {
    const int s = s0 + lane;
    if (s < n_split && pl[s * n_rows + row] > 0.f)
      mx = fmaxf(mx, pm[s * n_rows + row]);
  }
  mx = warp_max(mx);
  constexpr int NE = (DH + 31) / 32;      // elements per lane
  const auto owns = [lane](int e) {
    return DH % 32 == 0 || lane + 32 * e < DH;
  };
  float lsum = 0.f, a[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) a[e] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += 32) {
    const int s = s0 + lane;
    float c = 0.f;
    if (s < n_split) {
      const float l = pl[s * n_rows + row];
      if (l > 0.f) {
        c = exp2f(pm[s * n_rows + row] - mx);
        lsum += l * c;
      }
    }
    const int n = min(32, n_split - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float cj = __shfl_sync(FULL, c, j);
      if (cj == 0.f) continue;           // no valid key: acc is not read
      const float* src = pacc + ((s0 + j) * n_rows + row) * DH;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        if (owns(e)) a[e] += src[lane + 32 * e] * cj;
    }
  }
  lsum = warp_sum(lsum);
  if (lse && lane == 0)
    lse[row] = lsum > 0.f ? (mx + log2f(lsum)) * LN2 : -INFINITY;
  const long long bb = row / ((long long)nh * ni);
  const int hh = (int)((row / ni) % nh), i = (int)(row % ni);
  T* dst = o + bb * ob + hh * oh + i * os;
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
#pragma unroll
  for (int e = 0; e < NE; ++e)
    if (owns(e)) dst[lane + 32 * e] = from_f<T>(a[e] * inv);
}

}  // namespace attn
