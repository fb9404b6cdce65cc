// Paged decode attention for Hopper.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py:76
// (_paged_kernel :32, pallas_call :108).  Same contract: one query token
// per sequence, q (b, hkv, g, dh), K/V pools (n_pages, page_tokens, hkv,
// dh), block_table (b, max_pages) int32, lengths (b,) int32, optional
// tanh softcap, online softmax with f32 m / l / acc, p cast to the V
// dtype before P.V.  No sliding window, as in Pallas.  The Pallas grid
// visits all max_pages pages and masks positions >= lengths[b]; this
// kernel stops at ceil(lengths[b] / page_tokens) pages, which gives the
// same result.
//
// Bound: bytes.  Each step reads the sequence's K and V once
// (2 * len * dh * itemsize per kv head) for 4 * g * dh flops per key, far
// below the card's flop:byte ridge.  Design for this first version: one
// block per (kv head, sequence); its warps (8 at dh <= 64, 4 at dh 128, as
// shared memory allows) split the sequence's keys (warp w takes tiles w,
// w + NWARPS, ...) so several tiles are in flight per block.  Each warp
// stages its 32-key tile in its own shared-memory slot with coalesced loads
// along dh (page ids come from the block table per key), keeps
// online-softmax state for all g <= 16 rows, and the warps' partial
// (m, l, acc) are merged in shared memory at the end.  Split-K across
// blocks (flash-decoding) and vectorised loads are later work.
#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int MAXG = 16;            // query rows per (sequence, kv head)

// warps per block: as many as the per-warp tile slots fit in shared memory
template <int DH>
__host__ __device__ constexpr int nwarps() { return DH <= 64 ? 8 : 4; }

template <int DH>
__host__ __device__ constexpr int smem_floats() {
  constexpr int NWARPS = nwarps<DH>();
  // q rows, then one (K tile, V tile) slot per warp; the merge reuses the
  // slots, which are larger than NWARPS * MAXG * (DH + 2)
  return MAXG * DH + NWARPS * TILE * (2 * DH + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(32 * nwarps<DH>())
paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ table,
             const int* __restrict__ lengths, T* __restrict__ o, int hkv,
             int g, int pt, int max_pages, float scale, float softcap) {
  constexpr int NWARPS = nwarps<DH>();
  constexpr int THREADS = 32 * NWARPS;
  static_assert(NWARPS * MAXG * (DH + 2) <= NWARPS * TILE * (2 * DH + 1),
                "merge buffer must fit in the tile slots");
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem;                                   // g x DH
  float* slots = qs + MAXG * DH;
  float* ks = slots + warp * TILE * (2 * DH + 1);     // TILE x (DH + 1)
  float* vs = ks + TILE * (DH + 1);                   // TILE x DH

  const T* qb = q + ((long long)b * hkv + h) * g * DH;
  for (int idx = threadIdx.x; idx < g * DH; idx += THREADS)
    qs[idx] = to_f(qb[idx]);
  const int len = min(max(lengths[b], 0), max_pages * pt);
  const int* tb = table + (long long)b * max_pages;
  auto row_off = [&](int t, long long& ko, long long& vo) {
    const long long row = (long long)tb[t / pt] * pt + t % pt;
    ko = vo = (row * hkv + h) * DH;
  };
  __syncthreads();

  float m[MAXG], l[MAXG], acc[MAXG][DH / 32];
#pragma unroll
  for (int rr = 0; rr < MAXG; ++rr) {
    m[rr] = NEG_BIG;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] = 0.f;
  }

  for (int t0 = warp * TILE; t0 < len; t0 += NWARPS * TILE) {
    __syncwarp();                       // this warp's previous tile consumed
    stage_tile<T, DH, 32>(kp, vp, row_off, t0, len, lane, ks, vs);
    __syncwarp();
    const bool valid = t0 + lane < len;
#pragma unroll
    for (int rr = 0; rr < MAXG; ++rr)
      if (rr < g)
        row_update<T, DH>(qs + rr * DH, ks, vs, valid, scale, softcap, m[rr],
                          l[rr], acc[rr]);
  }

  // merge the warps' partial softmax states
  __syncthreads();                      // every warp is done with its slot
  float* mb = slots;                    // [NWARPS][MAXG][DH + 2]
#pragma unroll
  for (int rr = 0; rr < MAXG; ++rr) {
    if (rr >= g) continue;
    float* e = mb + (warp * MAXG + rr) * (DH + 2);
    if (lane == 0) {
      e[0] = m[rr];
      e[1] = l[rr];
    }
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) e[2 + lane + 32 * i] = acc[rr][i];
  }
  __syncthreads();
  T* ob = o + ((long long)b * hkv + h) * g * DH;
  for (int rr = warp; rr < g; rr += NWARPS) {
    float mx = NEG_BIG;
    for (int w = 0; w < NWARPS; ++w)
      mx = fmaxf(mx, mb[(w * MAXG + rr) * (DH + 2)]);
    float lsum = 0.f, a[DH / 32];
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) a[i] = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float* e = mb + (w * MAXG + rr) * (DH + 2);
      const float c = expf(e[0] - mx);
      lsum += e[1] * c;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) a[i] += e[2 + lane + 32 * i] * c;
    }
#pragma unroll
    for (int i = 0; i < DH / 32; ++i)
      ob[rr * DH + lane + 32 * i] = from_f<T>(lsum > 0.f ? a[i] / lsum : 0.f);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* o, int b, int hkv, int g, int pt,
           int max_pages, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      paged_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(hkv, b);
  paged_kernel<T, DH><<<grid, 32 * nwarps<DH>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(o), hkv, g,
      pt, max_pages, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* kp, const void* vp,
                const int* table, const int* lengths, void* o, int b, int hkv,
                int g, int pt, int max_pages, float scale, float softcap,
                cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, kp, vp, table, lengths, o, b, hkv, g, pt,
                           max_pages, scale, softcap, stream);
    case 64:
      return launch<T, 64>(q, kp, vp, table, lengths, o, b, hkv, g, pt,
                           max_pages, scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, table, lengths, o, b, hkv, g, pt,
                            max_pages, scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, pools, table, lengths and o are
// contiguous.  Returns the launch's cudaError_t.
extern "C" int paged_attention(int dtype, int dh, const void* q,
                               const void* k_pool, const void* v_pool,
                               const int* block_table, const int* lengths,
                               void* o, int b, int hkv, int g, int pt,
                               int max_pages, float scale, float softcap,
                               cudaStream_t stream) {
  if (b <= 0 || hkv <= 0) return 0;
  if (g <= 0 || g > MAXG || pt <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k_pool, v_pool, block_table, lengths,
                              o, b, hkv, g, pt, max_pages, scale, softcap,
                              stream);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k_pool, v_pool, block_table,
                                      lengths, o, b, hkv, g, pt, max_pages,
                                      scale, softcap, stream);
  return (int)cudaErrorInvalidValue;
}
