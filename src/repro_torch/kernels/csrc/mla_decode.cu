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
// bytes bound (8 slots of ~4,800 tokens read 44 MB, 13 us at 3.35 TB/s).
//
// bf16 design (mla_split_kernel), one launch per call:
// * The plan (mla_decode.plan, from the batch and the cache length only;
//   the lengths stay on the device) cuts each row's s_max key positions
//   into n_split ranges so that the grid makes about one block per SM:
//   (16, 384) for 8 slots of a 6,144-token cache on 132 SMs, half PR
//   19's 32 splits.  A split wholly past its row's length exits its key
//   loop at once.
// * All 32 heads share every latent row, and that reuse is the point of
//   MLA, so a block reads each tile of 32 latent rows (c || krope, 576
//   wide) once for all 32 heads: the heads are the M side of a 32 x 576
//   by 576 x 32 product (scores) and of a 32 x 32 by 32 x 512 product
//   (P.c), both on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
//   operands through ldmatrix, .trans for c as the values).
// * Tiles arrive by TMA into a ring of 4 tiles, 147 KB in
//   flight, each stage completing an mbarrier: one thread issues a
//   tile's 9 boxes of 32 keys x 64 columns (8 of c, 1 of krope) from 3-D
//   tensor maps over the caches (cached per layer on the host).  TMA's
//   128-byte swizzle places each box row's 16-byte chunks so that
//   ldmatrix reads 8 keys without bank conflicts.  Keys past the split's
//   range are zeroed in the last tile, so p = 0 never meets a NaN.  (Per
//   key bulk copies, 64 a tile, held an SM to ~10 GB/s: TMA serves few
//   large requests, not many small ones.)
// * 4 warps: warp w owns heads (w & 1) * 16 .. + 16, and for the scores
//   k-steps (w >> 1) * 18 .. + 18 of the 36 (half of the 576 columns),
//   so no score is computed twice and each warp reloads Q's fragments
//   for half the k-steps only (keeping all of them would take 144
//   registers beside the accumulator's 128).  The two warps of a head
//   half add their partial scores through shared memory (a + b == b + a
//   bit for bit, so both hold the same scores), then each runs the same
//   online softmax and multiplies its 256 of the 512 output columns.
// * The merge is folded into the kernel: a split writes its f32
//   partials (m, l, and the unnormalised accumulator, 64 KB per row, in
//   the threads' fragment order), fences, and counts itself on its
//   row's arrival counter; the last split to arrive resets the counter
//   to 0 for the next call and merges the row's splits that saw a key,
//   in index order (bulk copies of each partial into a 2-stage ring in
//   the freed tile ring), so the result does not depend on which split
//   came last: no float atomics, and two calls give the same bits.  The
//   counters (one per row) live with the wrapper, zeroed once.
// Shared memory: 4 x 36,864 (tiles) + 37,376 (Q, rows padded to 1,168
// bytes) + 8,192 (scores exchanged) + 1,024 (alignment) = 194,048
// bytes, one block an SM.  What holds it back: with one warp per SM
// sub-partition the tile loop waits on the latency of its ldmatrix and
// mma.sync chains (unrolling the score loop helps; 8 warps did not), and
// the merge is a serial tail of one block reading the row's partials;
// wgmma, which reads each operand tile once per warpgroup, is the next
// step.
//
// f32 design (mla_f32_kernel): scalar FMAs, one block of 8 warps per
// batch row, one split; tiles of 32 keys staged in shared memory as f32,
// one key a lane, each warp 4 heads, the online softmax of flash's f32
// path.  It serves the f32 identity check.
#include "attn_common.cuh"
#include "hopper.cuh"


namespace {

using namespace attn;
using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int H = 32;                  // heads
constexpr int R = 512;                 // kv_lora_rank
constexpr int RD = 64;                 // rope_head_dim
constexpr int DK = R + RD;             // score width
constexpr int CPR = DK / 8;            // 16-byte chunks per row
constexpr int BKEYS = 32;              // keys per tile
constexpr int STAGES = 4;              // the merge's 128 KB fit in the ring
constexpr int LD = DK + 8;             // Q's shared row, elements
constexpr int THREADS = 128;
constexpr int BOX = BKEYS * 128;       // a TMA box: 32 keys x 64 columns
constexpr int TILE_BYTES = (DK / 64) * BOX;   // 8 boxes of c, 1 of krope
constexpr int Q_BYTES = H * LD * (int)sizeof(bf16);
constexpr int X_FLOATS = 16 * BKEYS;   // a warp's 16 x 32 partial scores
constexpr int SMEM_BF16 = 1024 + STAGES * TILE_BYTES + Q_BYTES +
                          4 * X_FLOATS * (int)sizeof(float);
constexpr int PART = H * R;            // floats of one row's partial
constexpr int PART_BYTES = PART * (int)sizeof(float);
// the merge keeps every split's (m, l) in the Q tile's space
constexpr int MAX_SPLIT = Q_BYTES / (2 * H * (int)sizeof(float));
static_assert(2 * PART_BYTES <= STAGES * TILE_BYTES,
              "the merge ring lives in the tile ring");

struct Strides {
  long long qb, qh, rb, rh, cb, cs, kb, ks;
};

// byte offset of (key j, columns c .. c + 7) in a tile: box c / 64, its
// 16-byte chunk swizzled with j % 8 as TMA's 128-byte swizzle stores it
__device__ __forceinline__ int tile_off(int j, int c) {
  return (c >> 6) * BOX + j * 128 + ((((c & 63) >> 3) ^ (j & 7)) << 4);
}

__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
mla_split_kernel(const bf16* __restrict__ q_lat,
                 const bf16* __restrict__ q_rope,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap tk,
                 const int* __restrict__ lengths, bf16* __restrict__ o,
                 float* __restrict__ pm, float* __restrict__ pl,
                 float* __restrict__ pacc, unsigned* __restrict__ counters,
                 int s_max, int chunk, int n_split, Strides st, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =                            // STAGES tiles
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* qsm = reinterpret_cast<bf16*>(ring + STAGES * TILE_BYTES);  // H x LD
  float* sx = reinterpret_cast<float*>(ring + STAGES * TILE_BYTES + Q_BYTES);
  __shared__ __align__(8) uint64_t full[STAGES], mfull[2];
  __shared__ int last, n_act;

  const int split = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), s_max);
  const int lo = split * chunk, hi = min(len, lo + chunk);
  const long long n_rows = (long long)gridDim.y * H;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(&mfull[0], 1);
    mbar_init(&mfull[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int rw = (warp & 1) * 16;        // the warp's heads
  const int kh = warp >> 1;              // its half of the score columns
  const int cw = kh * (R / 2);           // and of the output columns
  float oacc[R / 16][4];
#pragma unroll
  for (int d = 0; d < R / 16; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (lo < hi) {
    // tile it (keys lo + 32 it ..) into ring stage `stage`, by thread 0:
    // 8 boxes of 64 columns of c and one of krope (keys past s_max are
    // zero-filled by TMA)
    auto issue = [&](int it, int stage) {
      const int t0 = lo + it * BKEYS;
      unsigned char* dst = ring + stage * TILE_BYTES;
      mbar_expect_tx(&full[stage], TILE_BYTES);
#pragma unroll
      for (int i = 0; i < R / 64; ++i)
        tma_load_3d(dst + i * BOX, &tc, i * 64, t0, b, &full[stage]);
      tma_load_3d(dst + (R / 64) * BOX, &tk, 0, t0, b, &full[stage]);
    };
    const int n_tiles = (hi - lo + BKEYS - 1) / BKEYS;
    if (tid == 0)
      for (int s = 0; s < STAGES && s < n_tiles; ++s) issue(s, s);
    // Q tile: head r's row is q_lat[b, r] || q_rope[b, r]
    for (int i = tid; i < H * CPR; i += THREADS) {
      const int r = i / CPR, cc = (i % CPR) * 8;
      const bf16* src = cc < R ? q_lat + b * st.qb + r * st.qh + cc
                               : q_rope + b * st.rb + r * st.rh + (cc - R);
      cp_async16(qsm + r * LD + cc, src, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const float sl2 = scale * LOG2E;
    float* sx_mine = sx + warp * X_FLOATS;
    const float* sx_pair = sx + (warp ^ 2) * X_FLOATS;
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % STAGES;
      mbar_wait(&full[stage], (it / STAGES) & 1);
      unsigned char* kt = ring + stage * TILE_BYTES;
      const int t0 = lo + it * BKEYS;
      if (hi - t0 < BKEYS) {             // the split's last tile: zero the
        const int valid = hi - t0;       // keys past its range, so p = 0
        for (int i = tid; i < (BKEYS - valid) * (DK / 8); i += THREADS) {
          const int j = valid + i / (DK / 8), cc = i % (DK / 8);
          *reinterpret_cast<uint4*>(kt + (cc >> 3) * BOX + j * 128 +
                                    ((cc & 7) << 4)) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();             // before TMA refills the stage
        __syncthreads();                 // every warp reads the zeros
      }

      // S = Q K^T over the warp's 18 k-steps: 16 heads x 32 keys
      float s[BKEYS / 8][4];
#pragma unroll
      for (int nt = 0; nt < BKEYS / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll                           // all 18: the loads of later
      for (int ks = 0; ks < DK / 32; ++ks) {   // k-steps hide earlier ones
        const int kk = kh * (DK / 32) + ks;
        uint32_t qa[4];
        ldsm_x4(qa,
                qsm + (rw + (lane & 15)) * LD + kk * 16 + ((lane >> 4) << 3));
#pragma unroll
        for (int j = 0; j < BKEYS / 16; ++j) {
          uint32_t bfr[4];
          ldsm_x4(bfr, kt + tile_off(j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     kk * 16 + (((lane >> 3) & 1) << 3)));
          mma_bf16(s[2 * j], qa, bfr[0], bfr[1]);
          mma_bf16(s[2 * j + 1], qa, bfr[2], bfr[3]);
        }
      }
      // add the pair warp's half: the same fragment slots, lane for lane
#pragma unroll
      for (int nt = 0; nt < BKEYS / 8; ++nt)
        reinterpret_cast<float4*>(sx_mine)[nt * 32 + lane] =
            make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
      pair_barrier(1 + (warp & 1));
#pragma unroll
      for (int nt = 0; nt < BKEYS / 8; ++nt) {
        const float4 v = reinterpret_cast<const float4*>(sx_pair)[nt * 32 + lane];
        s[nt][0] += v.x;
        s[nt][1] += v.y;
        s[nt][2] += v.z;
        s[nt][3] += v.w;
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
          ldsm_x4_trans(
              bfr, kt + tile_off(j * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                 cw + d * 16 + ((lane >> 4) << 3)));
          mma_bf16(oacc[2 * d], a, bfr[0], bfr[1]);
          mma_bf16(oacc[2 * d + 1], a, bfr[2], bfr[3]);
        }
      }
      __syncthreads();                   // the stage and sx are free again
      if (tid == 0 && it + STAGES < n_tiles) issue(it + STAGES, stage);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(FULL, l[i], 1);
      l[i] += __shfl_xor_sync(FULL, l[i], 2);
    }
  }

  const int g = lane >> 2;
  auto write_o = [&](float (&acc)[R / 16][4], const float (&den)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* orow = o + ((long long)b * H + rw + g + 8 * i) * R;
      const float inv = den[i] > 0.f ? 1.f / den[i] : 0.f;
      const int col = cw + 2 * (lane & 3);
#pragma unroll
      for (int d = 0; d < R / 16; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + col) =
            __floats2bfloat162_rn(acc[d][2 * i] * inv,
                                  acc[d][2 * i + 1] * inv);
    }
  };
  if (n_split == 1) {
    write_o(oacc, l);
    return;
  }

  // this split's partials: (m, l) per head, and the accumulator in
  // fragment order (float4 d of thread (warp, lane) is oacc[d])
  const long long row0 = (long long)b * H;
  if (lo < hi) {
    float4* dst = reinterpret_cast<float4*>(
        pacc + ((long long)split * gridDim.y + b) * PART);
#pragma unroll
    for (int d = 0; d < R / 16; ++d)
      dst[(warp * (R / 16) + d) * 32 + lane] =
          make_float4(oacc[d][0], oacc[d][1], oacc[d][2], oacc[d][3]);
  }
  if ((lane & 3) == 0 && kh == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long pr = split * n_rows + row0 + rw + g + 8 * i;
      pm[pr] = m[i];
      pl[pr] = l[i];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&counters[b], 1u) == (unsigned)n_split - 1;
    if (last) atomicExch(&counters[b], 0u);   // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last split of row b merges the row's splits in index order.
  // Their (m, l) go to shared memory (the Q tile's space) in one round of
  // loads; the splits that saw a key are listed in sx's space
  float* tm = reinterpret_cast<float*>(qsm);
  float* tl = tm + n_split * H;
  for (int i = tid; i < n_split * H; i += THREADS) {
    const long long pr = (i / H) * n_rows + row0 + i % H;
    tm[i] = __ldcg(pm + pr);
    tl[i] = __ldcg(pl + pr);
  }
  __syncthreads();
  int* act = reinterpret_cast<int*>(sx);
  auto fetch = [&](int j) {              // partial of act[j] -> stage j % 2
    const int stage = j & 1;
    const float* src = pacc + ((long long)act[j] * gridDim.y + b) * PART;
    mbar_expect_tx(&mfull[stage], PART_BYTES);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bulk_load(ring + stage * PART_BYTES + q * (PART_BYTES / 4),
                src + q * (PART / 4), PART_BYTES / 4, &mfull[stage]);
  };
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < n_split; ++s)
      if (tl[s * H] > 0.f) act[n++] = s;
    n_act = n;
    fence_proxy_async();
    for (int j = 0; j < 2 && j < n; ++j) fetch(j);
  }
  float mx[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
  const int h0 = rw + g;                 // the thread's heads: h0, h0 + 8
  for (int s = 0; s < n_split; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (tl[s * H + h0 + 8 * i] > 0.f)
        mx[i] = fmaxf(mx[i], tm[s * H + h0 + 8 * i]);
  for (int s = 0; s < n_split; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ls = tl[s * H + h0 + 8 * i];
      if (ls > 0.f) den[i] += ls * exp2f(tm[s * H + h0 + 8 * i] - mx[i]);
    }
  __syncthreads();                       // act and n_act are written
#pragma unroll
  for (int d = 0; d < R / 16; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  for (int j = 0; j < n_act; ++j) {
    const int s = act[j];
    float cf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cf[i] = exp2f(tm[s * H + h0 + 8 * i] - mx[i]);
    mbar_wait(&mfull[j & 1], (j >> 1) & 1);
    const float4* part =
        reinterpret_cast<const float4*>(ring + (j & 1) * PART_BYTES);
#pragma unroll
    for (int d = 0; d < R / 16; ++d) {
      const float4 v = part[(warp * (R / 16) + d) * 32 + lane];
      oacc[d][0] += cf[0] * v.x;
      oacc[d][1] += cf[0] * v.y;
      oacc[d][2] += cf[1] * v.z;
      oacc[d][3] += cf[1] * v.w;
    }
    __syncthreads();                     // stage j % 2 is free again
    if (tid == 0 && j + 2 < n_act) fetch(j + 2);
  }
  write_o(oacc, den);
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
// lengths (b,) int32; o (b, 32, 512) contiguous.  bf16 with n_split > 1
// (at most 146): pm and pl hold n_split * b * 32 floats and pacc 512
// times as many (scratch the caller allocates), counters b unsigned ints
// that are 0 (each call leaves them 0), keys split in ranges of `chunk`
// (a multiple of 32); the caller checked 16-byte alignment of the
// pointers and strides.  Returns the first launch error (cudaError_t), 0
// on success.
extern "C" int mla_decode(int dtype, const void* q_lat, const void* q_rope,
                          const void* c, const void* krope,
                          const int* lengths, void* o, float* pm, float* pl,
                          float* pacc, unsigned* counters, int b, int s_max,
                          int n_split, int chunk, const long long* strides,
                          float scale, cudaStream_t stream) {
  if (b <= 0) return 0;
  if (n_split <= 0 || n_split > MAX_SPLIT ||
      (long long)n_split * chunk < s_max || chunk % BKEYS)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7]};
  if (dtype == 1) {
    if (n_split > 1 && (pm == nullptr || counters == nullptr))
      return (int)cudaErrorInvalidValue;
    // c (b, s_max, 512) and krope (b, s_max, 64) as 3-D maps of 32-key by
    // 64-column boxes; a layer's cache outlives many calls: cached
    CUtensorMap tc, tk;
    const uint64_t cdims[3] = {(uint64_t)R, (uint64_t)s_max, (uint64_t)b};
    const uint64_t cstr[2] = {(uint64_t)st.cs * 2, (uint64_t)st.cb * 2};
    const uint64_t kdims[3] = {(uint64_t)RD, (uint64_t)s_max, (uint64_t)b};
    const uint64_t kstr[2] = {(uint64_t)st.ks * 2, (uint64_t)st.kb * 2};
    const uint32_t box[3] = {64, (uint32_t)BKEYS, 1};
    if (!bf16_map_cached(&tc, c, cdims, cstr, box) ||
        !bf16_map_cached(&tk, krope, kdims, kstr, box))
      return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        mla_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BF16);
    if (attr != cudaSuccess) return (int)attr;
    mla_split_kernel<<<dim3(n_split, b), THREADS, SMEM_BF16, stream>>>(
        static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_rope),
        tc, tk, lengths, static_cast<bf16*>(o), pm, pl, pacc, counters,
        s_max, chunk, n_split, st, scale);
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
