// Absorbed MLA decode attention for Hopper.
//
// Replaces the jnp einsums of the reference's absorbed decode between
// q_lat and o_lat (repro/models/mla.py:109 mla_decode, :120-131): each of
// the h = 32 heads' latent query q_lat (r = 512) and roped query q_rope
// (rd = 64) scores every cached token's latent row c (r) and roped key
// krope (rd); keys at or past the row's length are masked; the softmax
// is taken in f32 and its weights, cast to c's dtype, average the
// latent rows c themselves: o_lat (b, h, r).  The scale is the caller's
// (1 / sqrt(nope + rope) for ds27b, not 1 / sqrt(r + rd)).  Rows without
// a valid key are written as 0.
//
// Bound: per key, 32 heads x (576 + 512) x 2 flops against 1,152 bytes
// of latent row, ~60 flops a byte, under the card's ~295 bf16 ridge:
// bytes bound (8 slots of ~4,500 tokens read 41 MB, 12 us at 3.35 TB/s).
//
// bf16 design (mla_split_kernel): all 32 heads share every latent row,
// and that reuse is the point of MLA, so one block reads a tile of 32
// latent rows (c || krope, 576 wide) once for all 32 heads: the heads
// are the M dimension of a 32 x 576 by 576 x 32 product (scores) and of
// a 32 x 32 by 32 x 512 product (P.c).  Both run on the tensor cores,
// mma.sync m16n8k16 bf16 -> f32, operands through ldmatrix (.trans for
// c as the values).  4 warps: warp w owns heads (w & 1) * 16 .. +16 and
// latent columns (w >> 1) * 256 .. +256 of the output, 128 f32
// accumulators a thread; the two warps of one head half compute the
// same scores (the same arithmetic, so the same bits) and keep their
// own softmax state, which saves a shared-memory exchange.  The Q tile
// (32 x 576) stays in shared memory and its fragments are reloaded at
// every k-step (they would take 144 registers beside the 128 of the
// accumulator).  Tiles of 32 latent rows are loaded by 16-byte cp.async
// into a 2-stage ring, rows padded by 16 bytes (1,168 bytes, free of
// ldmatrix bank conflicts); rows past the block's range are zero-filled.
// The host splits the keys into ranges (build.split_plan from the batch
// and the cache length only; the lengths stay on the device); a split
// writes f32 partials (m, l, acc), one past its row's length writes
// l = 0, and mla_combine_kernel merges the splits in index order
// (attn::combine_rows): no atomics, so two calls give the same bits.
// Shared memory: (32 + 2 x 32) x 584 x 2 = 112,128 bytes, two blocks an
// SM.
//
// f32 design (mla_f32_kernel): scalar FMAs, one block of 8 warps per
// batch row, one split; tiles of 32 keys staged in shared memory as f32,
// one key a lane, each warp 4 heads, the online softmax of flash's f32
// path.  It serves the f32 identity check.
#include "attn_common.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

constexpr int H = 32;                  // heads
constexpr int R = 512;                 // kv_lora_rank
constexpr int RD = 64;                 // rope_head_dim
constexpr int DK = R + RD;             // score width
constexpr int CPR = DK / 8;            // 16-byte chunks per row
constexpr int BKEYS = 32;              // keys per tile
constexpr int STAGES = 2;
constexpr int LD = DK + 8;             // shared row, elements
constexpr int THREADS = 128;
constexpr int SMEM_BF16 = (H + STAGES * BKEYS) * LD * (int)sizeof(bf16);

struct Strides {
  long long qb, qh, rb, rh, cb, cs, kb, ks;
};

__global__ void __launch_bounds__(THREADS)
mla_split_kernel(const bf16* __restrict__ q_lat,
                 const bf16* __restrict__ q_rope, const bf16* __restrict__ c,
                 const bf16* __restrict__ krope,
                 const int* __restrict__ lengths, bf16* __restrict__ o,
                 float* __restrict__ pm, float* __restrict__ pl,
                 float* __restrict__ pacc, int s_max, int chunk, int n_split,
                 Strides st, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);   // H x LD
  bf16* ksm = qsm + H * LD;                        // STAGES x BKEYS x LD

  const int split = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), s_max);
  const int lo = split * chunk, hi = min(len, lo + chunk);
  const long long n_rows = (long long)gridDim.y * H;

  if (lo >= hi) {                        // nothing visible in this split
    if (n_split == 1) {
      for (int i = tid; i < H * R; i += THREADS)
        o[(long long)b * H * R + i] = __float2bfloat16(0.f);
    } else if (tid < H) {
      pm[split * n_rows + b * H + tid] = -INFINITY;
      pl[split * n_rows + b * H + tid] = 0.f;
    }
    return;
  }

  // Q tile: head r's row is q_lat[b, r] || q_rope[b, r]
  for (int i = tid; i < H * CPR; i += THREADS) {
    const int r = i / CPR, cc = (i % CPR) * 8;
    const bf16* src = cc < R ? q_lat + b * st.qb + r * st.qh + cc
                             : q_rope + b * st.rb + r * st.rh + (cc - R);
    cp_async16(qsm + r * LD + cc, src, true);
  }
  auto load_tile = [&](int t0, int stage) {
    bf16* kd = ksm + stage * BKEYS * LD;
    for (int i = tid; i < BKEYS * CPR; i += THREADS) {
      const int j = i / CPR, cc = (i % CPR) * 8, t = t0 + j;
      const bool ok = t < hi;
      const bf16* src = !ok ? c
                        : cc < R ? c + b * st.cb + (long long)t * st.cs + cc
                                 : krope + b * st.kb + (long long)t * st.ks +
                                       (cc - R);
      cp_async16(kd + j * LD + cc, src, ok);
    }
  };
  load_tile(lo, 0);
  cp_async_commit();

  const int rw = (warp & 1) * 16;        // the warp's heads
  const int cw = (warp >> 1) * (R / 2);  // and output columns
  float oacc[R / 16][4];
#pragma unroll
  for (int d = 0; d < R / 16; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;

  const int n_tiles = (hi - lo + BKEYS - 1) / BKEYS;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(lo + (it + 1) * BKEYS, (it + 1) % STAGES);
    cp_async_commit();                   // (empty on the last tile)
    cp_async_wait<1>();                  // tile it (and Q) have landed
    __syncthreads();
    const bf16* kt = ksm + (it % STAGES) * BKEYS * LD;
    const int t0 = lo + it * BKEYS;

    // S = Q K^T: 16 heads x 32 keys per warp
    float s[BKEYS / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKEYS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qsm + (rw + (lane & 15)) * LD + kk * 16 + ((lane >> 4) << 3));
#pragma unroll
      for (int j = 0; j < BKEYS / 16; ++j) {
        uint32_t bfr[4];
        ldsm_x4(bfr, kt + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         kk * 16 + (((lane >> 3) & 1) << 3));
        mma_bf16(s[2 * j], qa, bfr[0], bfr[1]);
        mma_bf16(s[2 * j + 1], qa, bfr[2], bfr[3]);
      }
    }

    // scale, mask (log2 domain), online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BKEYS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const float x = key < hi ? s[nt][e] * sl2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[i] - mu[i]);
      l[i] *= corr;
#pragma unroll
      for (int d = 0; d < R / 16; ++d) {
        oacc[d][2 * i] *= corr;
        oacc[d][2 * i + 1] *= corr;
      }
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BKEYS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mu[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }

    // O += P c: the S fragments of keys 16j..16j+15 are the A operand
#pragma unroll
    for (int j = 0; j < BKEYS / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int d = 0; d < R / 32; ++d) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr,
                      kt + (j * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               LD +
                          cw + d * 16 + ((lane >> 4) << 3));
        mma_bf16(oacc[2 * d], a, bfr[0], bfr[1]);
        mma_bf16(oacc[2 * d + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();                     // stage it % STAGES is free again
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const int r = rw + (lane >> 2) + 8 * i;
    const int col = cw + 2 * (lane & 3);
    if (n_split == 1) {
      bf16* orow = o + ((long long)b * H + r) * R;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int d = 0; d < R / 16; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + col) =
            __floats2bfloat162_rn(oacc[d][2 * i] * inv,
                                  oacc[d][2 * i + 1] * inv);
    } else {
      const long long pr = split * n_rows + (long long)b * H + r;
      float* arow = pacc + pr * R;
#pragma unroll
      for (int d = 0; d < R / 16; ++d)
        *reinterpret_cast<float2*>(arow + d * 8 + col) =
            make_float2(oacc[d][2 * i], oacc[d][2 * i + 1]);
      if ((lane & 3) == 0 && cw == 0) {
        pm[pr] = m[i];
        pl[pr] = l[i];
      }
    }
  }
}

// one warp per output row (b, head): merges the splits' partials
__global__ void __launch_bounds__(THREADS)
mla_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                   const float* __restrict__ pacc, bf16* __restrict__ o,
                   long long n_rows, int n_split) {
  combine_rows<bf16, R>(pm, pl, pacc, o, n_rows, n_split, H, 1,
                        (long long)H * R, R, 0);
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_WARPS = F_THREADS / 32;
constexpr int TILE = 32;               // keys per staged tile = lanes
constexpr int KLD = DK + 1;            // staged key row (+1: no conflicts)
constexpr int SMEM_F32 = (H * DK + TILE * KLD) * (int)sizeof(float);

__global__ void __launch_bounds__(F_THREADS)
mla_f32_kernel(const float* __restrict__ q_lat,
               const float* __restrict__ q_rope, const float* __restrict__ c,
               const float* __restrict__ krope,
               const int* __restrict__ lengths, float* __restrict__ o,
               int s_max, Strides st, float scale) {
  constexpr int RPW = H / F_WARPS;       // heads per warp
  extern __shared__ float fsm[];
  float* qs = fsm;                       // H x DK
  float* ks = qs + H * DK;               // TILE x KLD
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), s_max);
  for (int i = tid; i < H * DK; i += F_THREADS) {
    const int r = i / DK, d = i % DK;
    qs[i] = d < R ? q_lat[b * st.qb + r * st.qh + d]
                  : q_rope[b * st.rb + r * st.rh + d - R];
  }
  float m[RPW], l[RPW], acc[RPW][R / 32];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -1e30f;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < R / 32; ++i) acc[rr][i] = 0.f;
  }
  for (int t0 = 0; t0 < len; t0 += TILE) {
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < TILE * DK; i += F_THREADS) {
      const int j = i / DK, d = i % DK, t = t0 + j;
      float x = 0.f;
      if (t < len)
        x = d < R ? c[b * st.cb + (long long)t * st.cs + d]
                  : krope[b * st.kb + (long long)t * st.ks + d - R];
      ks[j * KLD + d] = x;
    }
    __syncthreads();
    const bool valid = t0 + lane < len;
    const float* krow = ks + lane * KLD;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float* qrow = qs + (warp * RPW + rr) * DK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < DK; ++d) s = fmaf(qrow[d], krow[d], s);
      s *= scale;
      const float m_new = fmaxf(m[rr], warp_max(valid ? s : -INFINITY));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < R / 32; ++i) acc[rr][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < TILE; ++j) {
        const float pj = __shfl_sync(FULL, p, j);
        const float* vrow = ks + j * KLD + lane;
#pragma unroll
        for (int i = 0; i < R / 32; ++i)
          acc[rr][i] = fmaf(pj, vrow[32 * i], acc[rr][i]);
      }
      m[rr] = m_new;
    }
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    float* orow = o + ((long long)b * H + warp * RPW + rr) * R;
#pragma unroll
    for (int i = 0; i < R / 32; ++i)
      orow[lane + 32 * i] = l[rr] > 0.f ? acc[rr][i] / l[rr] : 0.f;
  }
}

}  // namespace

// dtype: 0 = float32 (scalar path, one split), 1 = bfloat16 (tensor cores).
// q_lat (b, 32, 512), q_rope (b, 32, 64), c (b, s_max, 512), krope (b,
// s_max, 64), each with its last dim contiguous and its two leading
// element strides in `strides` (q_lat, q_rope, c, krope in that order);
// lengths (b,) int32; o (b, 32, 512) contiguous.  bf16 with n_split > 1:
// pm and pl hold n_split * b * 32 floats and pacc 512 times as many
// (scratch the caller allocates), keys split in ranges of `chunk` (a
// multiple of 32); the caller checked 16-byte alignment of the pointers
// and strides.  Returns the first launch error (cudaError_t), 0 on
// success.
extern "C" int mla_decode(int dtype, const void* q_lat, const void* q_rope,
                          const void* c, const void* krope,
                          const int* lengths, void* o, float* pm, float* pl,
                          float* pacc, int b, int s_max, int n_split,
                          int chunk, const long long* strides, float scale,
                          cudaStream_t stream) {
  if (b <= 0) return 0;
  if (n_split <= 0 || (long long)n_split * chunk < s_max || chunk % BKEYS)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7]};
  if (dtype == 1) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        mla_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BF16);
    if (attr != cudaSuccess) return (int)attr;
    mla_split_kernel<<<dim3(n_split, b), THREADS, SMEM_BF16, stream>>>(
        static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_rope),
        static_cast<const bf16*>(c), static_cast<const bf16*>(krope),
        lengths, static_cast<bf16*>(o), pm, pl, pacc, s_max, chunk, n_split,
        st, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || n_split == 1) return (int)e;
    const long long n_rows = (long long)b * H;
    const int warps = THREADS / 32;
    mla_combine_kernel<<<(unsigned)((n_rows + warps - 1) / warps), THREADS, 0,
                         stream>>>(pm, pl, pacc, static_cast<bf16*>(o),
                                   n_rows, n_split);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    if (n_split != 1) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        mla_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_F32);
    if (attr != cudaSuccess) return (int)attr;
    mla_f32_kernel<<<b, F_THREADS, SMEM_F32, stream>>>(
        static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
        static_cast<const float*>(c), static_cast<const float*>(krope),
        lengths, static_cast<float*>(o), s_max, st, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
