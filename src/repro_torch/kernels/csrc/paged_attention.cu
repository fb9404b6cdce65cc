// Paged decode attention for Hopper.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py:76
// (_paged_kernel :32, pallas_call :108).  Same contract: one query token
// per sequence, q (b, hkv, g, dh), K/V pools (n_pages, page_tokens, hkv,
// dh), block_table (b, max_pages) int32, lengths (b,) int32, optional
// tanh softcap, scores in f32, p cast to the V dtype before P.V, a row
// with no valid key written as 0.  The Pallas grid visits all max_pages
// pages and masks positions >= lengths[b]; this kernel visits only keys
// below lengths[b], which gives the same result.  One addition: an
// optional sliding window (window > 0 keeps key j iff
// lengths[b] - 1 - j < window), the mask of the reference model's
// decode_attend (repro/models/layers.py:242); the Pallas kernel has none.
// A split's range starts at max(split * chunk, lengths[b] - window), so
// keys outside the window are never read, and a split wholly outside it
// exits at once with l = 0, which the combine already skips.
//
// Bound: bytes.  Each step reads the sequence's K and V once
// (2 * len * dh * itemsize per kv head) for 4 * g * dh flops per key, far
// below the card's flop:byte ridge, so the design is about keeping many
// 16-byte loads in flight on every SM.
//
// Design (flash-decoding): the host splits the max_pages * page_tokens
// key positions into n_split ranges of `chunk` keys, counted in keys (any
// page size works, pages of 4 tokens included), from shapes only: lengths
// stays on the device.  One block of 4 warps per (split, kv head,
// sequence); a split that starts at or past the sequence's length exits at
// once, writing l = 0.  A block's 128 threads cover dh with 16-byte loads
// (8 bf16 or 4 f32 per lane; at dh 64 in bf16, 8 lanes per key and 16 keys
// per block step; at most 32 lanes per key, so at dh 256 in f32 each lane
// makes NV = 2 loads per key, and halves U to keep as many loads in
// flight).  A key's lanes are its row's 16-byte vectors rounded up to a
// power of two, so the shuffle reductions over them stay butterflies: at
// zamba2's dh 80, 10 vectors on 16 lanes in bf16 (8 keys a block step)
// and 20 on 32 in f32 (4 keys), the lanes past the row predicated off
// (they load nothing and hold zeros).  The block reads its range in one
// pass: each thread
// issues the K and V loads of U keys together (U = 8 at g = 1; loads
// unconditional and not kept in L1, so all 2 U NV are in flight), page ids
// from the block table, then updates every row's online softmax over
// those keys in registers (q . k reduced over a key's lanes by shuffles,
// p rounded to the V dtype before P.V).  At the end the key groups of a
// warp merge by shuffles and the warps in warp order through shared
// memory.  Registers are sized to the group by a template bucket (g = 1,
// <= 4, <= 8, <= 16); q stays in registers as its raw NV x 16 bytes per
// row.
// paged_combine_kernel merges the splits' f32 partials (m, l, acc) in
// split order, without atomics; with one split the block writes the
// output itself.
//
// Layout: one block per kv head, not per sequence over all heads.  A
// key's row for one head is dh * itemsize contiguous bytes (128 at the
// main shape), whole 32-byte sectors, so per-head blocks lose no
// coalescing.  Blocks over groups of heads, which read whole 2 KB token
// rows, loads pipelined one step ahead and U = 16 were all slower on the
// card, and launching the combine as a programmatic dependent of the
// split kernel gained nothing (PERF.md).
//
// Each instantiation's shared-memory attribute is set once, at its first
// launch, not per launch.
#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXG = 16;            // query rows per (sequence, kv head)

// shared memory, in floats: per warp and row, its (m, l, acc[DH]) after
// the warp's key groups merged
template <int G, int DH>
__host__ __device__ constexpr int smem_floats() {
  return NWARPS * G * (DH + 2);
}

// 16 bytes of K or V, read once per call: not kept in L1
__device__ __forceinline__ uint4 load_kv(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// q . k over this lane's NV x E elements of the row (q as raw 16-byte
// vectors of T)
template <typename T, int NV>
__device__ __forceinline__ float dot16(
    const uint4 (&qraw)[NV], const float (&kf)[NV][16 / sizeof(T)]) {
  constexpr int E = 16 / (int)sizeof(T);
  float d = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float qf[E];
    unpack16(qraw[v], qf);
#pragma unroll
    for (int e = 0; e < E; ++e) d = fmaf(qf[e], kf[v][e], d);
  }
  return d;
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ lengths, T* __restrict__ o,
                   float* __restrict__ pm, float* __restrict__ pl,
                   float* __restrict__ pacc, int hkv, int g, int pt,
                   int max_pages, int chunk, int n_split, float scale,
                   float softcap, int window) {
  constexpr int E = 16 / (int)sizeof(T);   // elements per 16-byte load
  constexpr int W = DH / E;                // 16-byte vectors of a row
  // lanes per key: W rounded up to a power of two, at most 32
  constexpr int LPK = W >= 32 ? 32 : W > 8 ? 16 : W > 4 ? 8 : W > 2 ? 4
                    : W > 1 ? 2 : 1;
  constexpr int NV = (W + LPK - 1) / LPK;  // 16-byte loads per lane and key
  constexpr bool FULL_LANES = W % LPK == 0;
  constexpr int KPS = THREADS / LPK;       // keys per block step
  // keys per thread-step; NV loads per key, so as many loads in flight
  // as at NV = 1
  constexpr int U0 = G == 1 ? 8 : G <= 4 ? 4 : 2;
  constexpr int U = U0 / NV > 0 ? U0 / NV : 1;
  static_assert(DH % E == 0 && 32 % LPK == 0 && NV * LPK >= W,
                "a key's lanes fit one warp, NV loads each");
  extern __shared__ float smem[];          // NWARPS x G x (m, l, acc[DH])

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kg = tid / LPK, dl = tid % LPK;
  // whether this lane holds the row's vector v * LPK + dl
  const auto on = [dl](int v) { return FULL_LANES || v * LPK + dl < W; };
  const int len = min(max(lengths[b], 0), max_pages * pt);
  // this split's keys, cut to the sequence and to its window
  const int lo = window > 0 ? max(split * chunk, len - window)
                            : split * chunk;
  const int hi = min(split * chunk + chunk, len);
  const long long row0 = ((long long)b * hkv + h) * g;
  const long long n_rows = (long long)gridDim.z * hkv * g;

  if (hi <= lo) {                          // no key of this split is seen
    if (n_split == 1) {
      for (int idx = tid; idx < g * DH; idx += THREADS)
        o[row0 * DH + idx] = from_f<T>(0.f);
    } else {
      for (int r = tid; r < g; r += THREADS) {
        pm[split * n_rows + row0 + r] = -INFINITY;
        pl[split * n_rows + row0 + r] = 0.f;
      }
    }
    return;
  }

  const int* tb = table + (long long)b * max_pages;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // this lane's slices of each row: vector v holds the E elements from
  // (v * LPK + dl) * E, so a key's lanes read contiguous 16-byte runs
  uint4 qraw[G][NV];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int v = 0; v < NV; ++v)
      qraw[r][v] = r < g && on(v)
                       ? *reinterpret_cast<const uint4*>(
                             q + (row0 + r) * DH + (v * LPK + dl) * E)
                       : zero;
  float m[G], l[G], acc[G][NV][E];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][v][e] = 0.f;
  }

  // One pass: each step loads U keys' K and V rows per thread together,
  // then updates every row's online softmax over those U keys.  The loop
  // is uniform across the block (shuffles below need whole warps).
  for (int base = lo; base < hi; base += U * KPS) {
    // unconditional loads, so all 2 U NV are in flight together: a key
    // past the range reads the range's first key instead and is masked
    // below
    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int t = base + u * KPS + kg;
      t = t < hi ? t : lo;
      const long long off =
          (((long long)tb[t / pt] * pt + t % pt) * hkv + h) * DH + dl * E;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        kr[u][v] = on(v) ? load_kv(kp + off + v * LPK * E) : zero;
        vr[u][v] = on(v) ? load_kv(vp + off + v * LPK * E) : zero;
      }
    }
    float kf[U][NV][E], vf[U][NV][E];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        unpack16(kr[u][v], kf[u][v]);
        unpack16(vr[u][v], vf[u][v]);
      }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= g) break;
      float x[U], mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = dot16<T, NV>(qraw[r], kf[u]);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(FULL, d, off);
        d *= scale;
        if (softcap > 0.f) d = tanhf(d / softcap) * softcap;
        x[u] = base + u * KPS + kg < hi ? d * LOG2E : -INFINITY;
        mx = fmaxf(mx, x[u]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[r] - mu);
      l[r] *= corr;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][v][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(x[u] - mu);
        l[r] += p;
        const float pv = to_f(from_f<T>(p));   // p in the V dtype
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][v][e] = fmaf(pv, vf[u][v][e], acc[r][v][e]);
      }
      m[r] = m_new;
    }
  }

  // merge the warp's key groups (lanes with the same dl), then write one
  // (m, l, acc) per warp and row
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= g) break;
    float mo = m[r];
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      mo = fmaxf(mo, __shfl_xor_sync(FULL, mo, off));
    const float c = exp2f(m[r] - (mo == -INFINITY ? 0.f : mo));
    float lr = l[r] * c;
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      lr += __shfl_xor_sync(FULL, lr, off);
    float* dst = smem + (warp * G + r) * (DH + 2);
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[r][v][e] * c;
#pragma unroll
        for (int off = LPK; off < 32; off <<= 1)
          a += __shfl_xor_sync(FULL, a, off);
        if (lane < LPK && on(v)) dst[2 + (v * LPK + dl) * E + e] = a;
      }
    if (lane == 0) {
      dst[0] = mo;
      dst[1] = lr;
    }
  }
  __syncthreads();

  // merge the warps, in warp order
  for (int idx = tid; idx < g * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    float mo = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      mo = fmaxf(mo, smem[(w * G + r) * (DH + 2)]);
    const float mu = mo == -INFINITY ? 0.f : mo;
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* src = smem + (w * G + r) * (DH + 2);
      const float c = exp2f(src[0] - mu);
      lsum += src[1] * c;
      a += src[2 + d] * c;
    }
    if (n_split == 1) {
      o[row0 * DH + idx] = from_f<T>(lsum > 0.f ? a / lsum : 0.f);
    } else {
      pacc[(split * n_rows + row0) * DH + idx] = a;
      if (d == 0) {
        pm[split * n_rows + row0 + r] = mo;
        pl[split * n_rows + row0 + r] = lsum;
      }
    }
  }
}

// one warp per output row (sequence, kv head, group row)
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
paged_combine_kernel(const float* __restrict__ pm,
                     const float* __restrict__ pl,
                     const float* __restrict__ pacc, T* __restrict__ o,
                     long long n_rows, int n_split) {
  combine_rows<T, DH>(pm, pl, pacc, o, n_rows, n_split, 1, 1, DH, 0, 0);
}

template <typename T, int DH, int G>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* o, float* pm, float* pl, float* pacc,
           int b, int hkv, int g, int pt, int max_pages, int n_split,
           int chunk, float scale, float softcap, int window,
           cudaStream_t stream) {
  constexpr int smem = (int)sizeof(float) * smem_floats<G, DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_split_kernel<T, DH, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(n_split, hkv, b);
  paged_split_kernel<T, DH, G><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(o), pm, pl,
      pacc, hkv, g, pt, max_pages, chunk, n_split, scale, softcap, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const long long n_rows = (long long)b * hkv * g;
  const long long blocks = (n_rows + NWARPS - 1) / NWARPS;
  paged_combine_kernel<T, DH><<<(unsigned)blocks, THREADS, 0, stream>>>(
      pm, pl, pacc, static_cast<T*>(o), n_rows, n_split);
  return (int)cudaGetLastError();
}

// the launch arguments after the dtype, head dim and group bucket
#define PAGED_ARGS                                                        \
  q, kp, vp, table, lengths, o, pm, pl, pacc, b, hkv, g, pt, max_pages,  \
      n_split, chunk, scale, softcap, window, stream

template <typename T, int DH>
int dispatch_g(const void* q, const void* kp, const void* vp,
               const int* table, const int* lengths, void* o, float* pm,
               float* pl, float* pacc, int b, int hkv, int g, int pt,
               int max_pages, int n_split, int chunk, float scale,
               float softcap, int window, cudaStream_t stream) {
  if (g == 1) return launch<T, DH, 1>(PAGED_ARGS);
  if (g <= 4) return launch<T, DH, 4>(PAGED_ARGS);
  if (g <= 8) return launch<T, DH, 8>(PAGED_ARGS);
  return launch<T, DH, MAXG>(PAGED_ARGS);
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* kp, const void* vp,
                const int* table, const int* lengths, void* o, float* pm,
                float* pl, float* pacc, int b, int hkv, int g, int pt,
                int max_pages, int n_split, int chunk, float scale,
                float softcap, int window, cudaStream_t stream) {
  switch (dh) {
    case 32: return dispatch_g<T, 32>(PAGED_ARGS);
    case 64: return dispatch_g<T, 64>(PAGED_ARGS);
    case 80: return dispatch_g<T, 80>(PAGED_ARGS);
    case 128: return dispatch_g<T, 128>(PAGED_ARGS);
    case 256: return dispatch_g<T, 256>(PAGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, pools, table, lengths and o are
// contiguous, q and the pools 16-byte aligned (the caller checks).  Keys
// are split in n_split ranges of `chunk` (n_split * chunk >= max_pages *
// pt); with n_split > 1, pm and pl hold n_split * b * hkv * g floats and
// pacc dh times as many (scratch the caller allocates).  window > 0 keeps
// the last `window` keys of each sequence (0: all of them).
// Returns the first launch error (cudaError_t), 0 on success.
extern "C" int paged_attention(int dtype, int dh, const void* q,
                               const void* kp, const void* vp,
                               const int* table, const int* lengths,
                               void* o, float* pm, float* pl, float* pacc,
                               int b, int hkv, int g, int pt, int max_pages,
                               int n_split, int chunk, float scale,
                               float softcap, int window,
                               cudaStream_t stream) {
  if (b <= 0 || hkv <= 0) return 0;
  if (g <= 0 || g > MAXG || pt <= 0 || n_split <= 0 || chunk <= 0 ||
      window < 0 || (long long)n_split * chunk < (long long)max_pages * pt)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_dh<float>(dh, PAGED_ARGS);
  if (dtype == 1) return dispatch_dh<__nv_bfloat16>(dh, PAGED_ARGS);
  return (int)cudaErrorInvalidValue;
}
