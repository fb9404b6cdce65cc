// Prefix-append flash attention for Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:107
// (_flash_kernel :44, pallas_call :139).  Same contract: q (b, hq, sq, dh)
// is the append chunk, k and v (b, hkv, skv, dh) hold prefix || append,
// GQA groups g = hq / hkv fold into the rows of one block, query row i of
// batch row b sits at global position kv_len_b - sq + i, keys at or past
// kv_len_b are masked, optional causal mask, tanh softcap and sliding
// window, online softmax with f32 m / l / acc, p cast to the V dtype
// before P.V.  One addition: an optional per-row kv_lens (b,); without it
// kv_len_b = skv for every row, which is the Pallas kernel exactly.  With
// it, the model's append passes its padded cache (b, S, hkv, dh) whole.
//
// Tensors are passed with element strides for their three leading dims
// (the last dim must be contiguous), so the model hands over its
// (b, s, h, dh) activations and caches as transposed views, without a copy.
//
// Bound: on the main path (a short chunk over a long prefix at dh 64) the
// work is about 4 * dh flops per (query, key) pair against 2 * dh * 2
// bytes of K/V per key, so with g query rows per K/V read it sits below the
// card's flop:byte ridge: bytes bound at small sq * g, operations bound at
// large.  Design for this first version: one block per (b, kv head, tile of
// bq queries with their g rows; g * bq = ROWS = 16, or 64 when g > 16), K/V
// tiles of 32 keys staged in shared memory as f32 and shared by the block's
// 4 warps (each warp owns ROWS / 4 rows), loop bounds cut to the keys the
// tile can see (causal end, window start, kv_len), scalar f32 FMAs.  Small
// row tiles keep enough blocks in flight for a short append chunk (128
// queries over 16 heads make 128 blocks).  Tensor cores (wgmma), TMA and
// warp specialisation are later work.
#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;        // query rows (g * bq) per block, at most

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int DH, int ROWS>
constexpr int smem_floats() {
  return ROWS * DH + TILE * (DH + 1) + TILE * DH;
}

template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const int* __restrict__ kv_lens, int g, int bq, int sq, int skv,
             Strides st, float scale, float softcap, int causal,
             int window) {
  constexpr int RPW = ROWS / NWARPS;     // rows per warp
  extern __shared__ float smem[];
  float* qs = smem;                      // ROWS x DH
  float* ks = qs + ROWS * DH;            // TILE x (DH + 1)
  float* vs = ks + TILE * (DH + 1);      // TILE x DH

  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = blockIdx.x * bq;        // first query of this tile
  const int nq = min(bq, sq - i0);
  const int rows = g * bq;               // row r = gi * bq + ri
  int kv_len = kv_lens ? kv_lens[b] : skv;
  kv_len = min(max(kv_len, 0), skv);
  const int q_start = kv_len - sq;       // global position of query 0

  for (int idx = threadIdx.x; idx < rows * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int gi = r / bq, ri = r % bq;
    float x = 0.f;
    if (ri < nq)
      x = to_f(q[b * st.qb + (long long)(h * g + gi) * st.qh +
                 (long long)(i0 + ri) * st.qs + d]);
    qs[idx] = x;
  }

  // keys any row of this tile can see
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_start + i0 + nq);
  const int k_beg = window > 0 ? max(0, q_start + i0 - window + 1) : 0;

  const long long kb = b * st.kb + h * st.kh, vb = b * st.vb + h * st.vh;
  auto row_off = [&](int t, long long& ko, long long& vo) {
    ko = kb + (long long)t * st.ks;
    vo = vb + (long long)t * st.vs;
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m[RPW], l[RPW], acc[RPW][DH / 32];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_BIG;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] = 0.f;
  }

  for (int t0 = k_beg; t0 < k_end; t0 += TILE) {
    __syncthreads();                     // previous tile fully consumed
    stage_tile<T, DH, THREADS>(k, v, row_off, t0, k_end, threadIdx.x, ks,
                               vs);
    __syncthreads();
    const int t = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      if (r < rows) {                    // uniform across the warp
        const int ri = r % bq;
        const int pos = q_start + i0 + ri;
        bool valid = ri < nq && t < k_end;
        if (causal) valid = valid && t <= pos;
        if (window > 0) valid = valid && pos - t < window;
        row_update<T, DH>(qs + r * DH, ks, vs, valid, scale, softcap, m[rr],
                          l[rr], acc[rr]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    if (r >= rows) continue;
    const int gi = r / bq, ri = r % bq;
    if (ri >= nq) continue;
    T* orow = o + b * st.ob + (long long)(h * g + gi) * st.oh +
              (long long)(i0 + ri) * st.os;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i)
      orow[lane + 32 * i] =
          from_f<T>(l[rr] > 0.f ? acc[rr][i] / l[rr] : 0.f);
  }
}

template <typename T, int DH, int ROWS>
int launch_rows(const void* q, const void* k, const void* v, void* o,
                const int* kv_lens, int b, int hq, int hkv, int sq, int skv,
                const Strides& st, float scale, float softcap, int causal,
                int window, cudaStream_t stream) {
  const int g = hq / hkv;
  const int bq = max(1, ROWS / g);
  const size_t smem = sizeof(float) * smem_floats<DH, ROWS>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, DH, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + bq - 1) / bq, hkv, b);
  flash_kernel<T, DH, ROWS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_lens, g, bq, sq, skv,
      st, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_lens, int b, int hq, int hkv, int sq, int skv,
           const Strides& st, float scale, float softcap, int causal,
           int window, cudaStream_t stream) {
  if (hq / hkv <= 16)
    return launch_rows<T, DH, 16>(q, k, v, o, kv_lens, b, hq, hkv, sq, skv,
                                  st, scale, softcap, causal, window, stream);
  return launch_rows<T, DH, MAX_ROWS>(q, k, v, o, kv_lens, b, hq, hkv, sq,
                                      skv, st, scale, softcap, causal, window,
                                      stream);
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                const int* kv_lens, int b, int hq, int hkv, int sq, int skv,
                const Strides& st, float scale, float softcap, int causal,
                int window, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, kv_lens, b, hq, hkv, sq, skv, st,
                           scale, softcap, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, kv_lens, b, hq, hkv, sq, skv, st,
                           scale, softcap, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, kv_lens, b, hq, hkv, sq, skv, st,
                            scale, softcap, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (b, h, s) strides of q, k, v and o in that order.  kv_lens may be null.
// Returns the launch's cudaError_t.
extern "C" int flash_attention(int dtype, int dh, const void* q,
                               const void* k, const void* v, void* o,
                               const int* kv_lens, int b, int hq, int hkv,
                               int sq, int skv, const long long* strides,
                               float scale, float softcap, int causal,
                               int window, cudaStream_t stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, o, kv_lens, b, hq, hkv, sq, skv,
                              st, scale, softcap, causal, window, stream);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, kv_lens, b, hq, hkv,
                                      sq, skv, st, scale, softcap, causal,
                                      window, stream);
  return (int)cudaErrorInvalidValue;
}
