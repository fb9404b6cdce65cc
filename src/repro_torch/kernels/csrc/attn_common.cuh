// Online-softmax pieces shared by flash_attention.cu and paged_attention.cu.
//
// Both kernels stage keys in tiles of 32 (one key per lane of a warp) in
// shared memory as float32, and update one query row's running max m,
// running sum l and f32 accumulator acc per tile, as the Pallas kernels
// do per block: scores in f32, p cast to the V dtype before P.V
// (repro/kernels/flash_attention.py:89), rows without a valid key end
// with l = 0 and are written as 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int TILE = 32;            // keys per staged tile = lanes per warp
constexpr float NEG_BIG = -1e30f;   // initial running max (as in Pallas)
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

// Stage keys [t0, t0 + TILE) into ks (TILE x (DH + 1)) and vs (TILE x DH)
// as f32; keys at or past n are zero.  NT threads cooperate (tid in
// [0, NT)); row_off(t, ko, vo) gives the element offsets of key t's K and V
// rows.  Each thread first loads a chunk of up to 16 K and 16 V elements,
// raw, into registers (unrolled, so the loads are in flight together), and
// only then converts and stores them: a load-convert-store loop makes the
// global-memory latencies add up one after another.
template <typename T, int DH, int NT, typename RowOff>
__device__ __forceinline__ void stage_tile(const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           RowOff row_off, int t0, int n,
                                           int tid, float* ks, float* vs) {
  constexpr int PER = TILE * DH / NT;   // elements per thread
  constexpr int CHUNK = PER < 16 ? PER : 16;
  static_assert(PER % CHUNK == 0, "tile must split evenly");
  const T zero = from_f<T>(0.f);
#pragma unroll
  for (int c = 0; c < PER; c += CHUNK) {
    T kr[CHUNK], vr[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int idx = tid + (c + i) * NT;
      const int t = t0 + idx / DH, d = idx % DH;
      kr[i] = zero;
      vr[i] = zero;
      if (t < n) {
        long long ko, vo;
        row_off(t, ko, vo);
        kr[i] = k[ko + d];
        vr[i] = v[vo + d];
      }
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int idx = tid + (c + i) * NT;
      const int j = idx / DH, d = idx % DH;
      ks[j * (DH + 1) + d] = to_f(kr[i]);
      vs[j * DH + d] = to_f(vr[i]);
    }
  }
}

// One query row (qrow: DH floats in shared memory) against one staged
// tile.  Lane j owns key j: its K row starts at ks + j * (DH + 1) (the +1
// pad puts the 32 lanes' reads in 32 distinct banks), its V row at
// vs + j * DH.  Rows of keys past the end of the sequence must be zero
// in ks/vs (the loaders fill them so), because p = 0 times a stale
// non-finite value would still poison acc.  `valid` masks this lane's
// key (padding, causality, window).  All 32 lanes must call together.
template <typename T, int DH>
__device__ __forceinline__ void row_update(const float* qrow,
                                           const float* ks, const float* vs,
                                           bool valid, float scale,
                                           float softcap, float& m, float& l,
                                           float (&acc)[DH / 32]) {
  const int lane = threadIdx.x & 31;
  const float* krow = ks + lane * (DH + 1);
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < DH; ++d) s = fmaf(qrow[d], krow[d], s);
  s *= scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  const float m_new = fmaxf(m, warp_max(valid ? s : -INFINITY));
  const float p = valid ? expf(s - m_new) : 0.f;
  const float corr = expf(m - m_new);
  l = l * corr + warp_sum(p);
  const float pv = to_f(from_f<T>(p));   // p in the V dtype for P.V
#pragma unroll
  for (int i = 0; i < DH / 32; ++i) acc[i] *= corr;
#pragma unroll 8
  for (int j = 0; j < TILE; ++j) {
    const float pj = __shfl_sync(FULL, pv, j);
    const float* vrow = vs + j * DH + lane;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[i] = fmaf(pj, vrow[32 * i], acc[i]);
  }
  m = m_new;
}

}  // namespace attn
