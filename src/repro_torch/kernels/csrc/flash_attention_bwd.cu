// The gradient of flash_attention for full-sequence attention, for Hopper.
//
// The reference trains through its jnp attention (_attend_dense_impl,
// repro/models/layers.py:100), which XLA differentiates: it has no backward
// kernel.  The port's forward runs the hand-written flash_attention.cu, so
// its gradient is written by hand as well.  Contract: q (b, hq, s, dk), k
// (b, hkv, s, dk) and v (b, hkv, s, dv) with GQA groups g = hq / hkv
// (head h reads kv head h / g), o the forward's output and dO its
// cotangent, both (b, hq, s, dv), lse (b, hq, s) f32 each query row's
// log-sum-exp as the forward
// wrote it (ln of the sum of exp(score) over the row's valid keys); every
// query sees the keys its mask allows (kv_len = s for every row: no
// kv_lens), an optional causal mask, a sliding window (query i sees key j
// iff i - j < window) and a tanh softcap on the scaled scores.  Outputs
// dq and dk (dk wide), dv (dv wide) in the input dtype, accumulated in
// f32.  The widths are (dk, dk) for every GQA model and (192, 128) for
// MLA (ds27b: nope 128 + rope 64 for q and k, 128 for v).  Tensors come
// with element strides for their three leading dims (the last dim
// contiguous), as the forward takes them.
//
// With P = exp(s - lse) (s the scaled, softcapped score), dP = dO V^T and
// D = sum(dO * o) per query row: dS = P (dP - D) f, f the softcap's
// derivative 1 - tanh^2(s / cap) (1 without a cap); dV = P^T dO, dK =
// dS^T Q and dQ = dS K, the last two times the 1/sqrt(dk) scale at the end.
// No float atomics: every output element is written once by one thread,
// in a fixed order of accumulation, so repeated calls are bit-identical.
//
// Bound: five products per valid (query, key) pair, S recomputed, dK and
// dQ of 2 * dk flops, dP and dV of 2 * dv, against q, k, v, o and dO read
// once and dq, dk, dv written once: operations bound at the training
// shapes (qwen's microbatch, 4 x 1023 tokens of 16 x 64 heads, causal:
// 21.4 GFLOP, 0.022 ms at the bf16 tensor-core rate, against 67 MB, 0.020
// ms of bytes; ds27b's, 1023 tokens of 32 heads at (192, 128): 1,664
// flops a pair, 27.9 GFLOP).
//
// bf16 design: two launches, every product on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulators), operands from
// shared memory through ldmatrix (.trans where the product takes a
// transpose), tiles staged by 16-byte cp.async into a 2-stage ring (tile
// i + 1 lands while tile i computes), rows padded by 16 bytes so ldmatrix
// is free of bank conflicts (at dh 80 rows of 88 elements, 5 k-steps of 16
// and 10 accumulator tiles of 8, as the forward), rows past s zero-filled
// by the copy and masked.  Q, K, dQ and dK rows are DK wide, V, O, dO and
// dV rows DV wide: S = Q K^T runs DK / 16 k-steps and dP = dO V^T DV / 16.
//
// (a) bwd_dq_mma_kernel, one block of 4 warps per (64 query rows, head,
//     batch row): it computes D of its rows from o and dO and writes it
//     to an f32 scratch (b, hq, s), then walks the key tiles its rows see
//     (the causal and window bounds skip the rest).  Each warp owns 16
//     rows: S = Q K^T and dP = dO V^T into accumulator fragments, P =
//     exp(s - lse), dS = P (dP - D) f, and dS rounded to bf16 is, as it
//     stands in the fragments, the A operand of dQ += dS K (K through
//     ldmatrix.trans).  dQ is written once.
// (b) bwd_dkdv_mma_kernel, one block per (key tile, kv head, batch row):
//     it holds its K and V tile and walks the g query heads of its group
//     and, for each, only the query tiles that see the tile, their Q, dO,
//     lse and D in the ring.  Each warp owns 16 keys and computes S^T = K
//     Q^T and dP^T = V dO^T, so P^T and dS^T land in the A layout of dV +=
//     P^T dO and dK += dS^T Q (dO and Q through ldmatrix.trans) and never
//     leave registers.  P is rounded to bf16 before P^T dO, as the forward
//     rounds p before P.V (repro/models/layers.py:118); dS is rounded to
//     bf16 as an operand of dK and dQ (the plain backward keeps it in f32:
//     the measured error is in PERF.md).  dK and dV are written once, the
//     GQA sum inside the block.  When the grid is under one block an SM
//     (GQA's few kv heads, a short sequence) a block has two groups of 4
//     warps, each taking half of every query tile, and group 1's sums
//     join group 0's through shared memory in a fixed order at the end;
//     the wrapper picks the groups from the shapes (bwd_groups).
//
// The element-wise step (P, dS, the masks) cost more than the products in
// a first version: a warp tests its tile once (Mask::edge) and masks the
// elements only of a tile the mask cuts (the diagonal, the window's edge,
// past s), the test is branch-free, P is ex2.approx of one FMA (the scale
// and log2 e folded), and the softcap's branch sits outside the element
// loop.
//
// Registers bound the tiles: 16 rows x dh of f32 accumulators take dh / 2
// registers a thread for each of dK and dV.  Up to dh 128 a warp owns all
// dh columns of its 16 keys (dK + dV: 128 registers at dh 128, so the
// query tile is 32 there and 64 below); at dh 256 two warps share 16 keys
// and each owns 128 of the columns, both computing the keys' S^T and
// dP^T (the key tile is 32), and (a) takes key tiles of 32 beside its 128
// registers of dQ.  MLA's (192, 128) splits as dh 256 does: 16 keys'
// dK and dV would be 96 + 64 = 160 registers, so each of two warps owns
// half of dK's columns (96) and half of dV's (64), and (a) holds dQ's 96
// registers beside key tiles of 32.  (a) is held to 168 registers (3
// blocks an SM) up to dh 128.  The A fragments of the fixed side (Q and
// dO in (a), K and V in (b)) stay in registers where they fit (dh <= 80
// in (a), dh <= 64 in (b)) and are reloaded from shared memory at each
// k-step above.  Each
// instantiation's shared-memory attribute is set once, at its first
// launch; the ptxas report is in PERF.md.
//
// Against the bound, (a) and (b) both recompute S and dP: seven products
// where five would do, for no atomics and no dS in device memory.  On an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md) qwen's microbatch takes 0.228
// ms, 9.5 % of the bound, against 2.167 ms for the first, scalar version
// and 0.126 ms for SDPA's backward.
//
// f32 design: the port's first version, scalar, kept because TF32 tensor
// cores would break the 2e-5 tolerance of phase 19 (a)'s identity check
// (and phase 20's and 21's), which is all it serves.  Three launches:
// bwd_dsum_kernel (D), then bwd_dkdv_kernel and bwd_dq_kernel, scalar f32
// FMAs on tiles staged in shared memory as f32 (rows padded by one
// float); it reads the forward's lse as the bf16 path does.  256 threads
// as 16 x 16, each owning a (rows / 16) x (cols / 16) register tile;
// tiles 64 x 64 up to a q/k width of 128, 32 x 32 above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

struct BwdStrides {
  // (batch, head, sequence) element strides of q, k, v, o, dO, dq, dk, dv
  long long t[8][3];
};

// (the gradients' names end in G: DK and DV name the widths)
enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQG = 5, DKG = 6, DVG = 7 };

struct Mask {
  int s, causal, window;
  // without branches: a short-circuit chain costs a branch per element
  __device__ __forceinline__ bool ok(int qi, int kj) const {
    return (qi < s) & (kj < s) & (!causal | (kj <= qi)) &
           ((window <= 0) | (qi - kj < window));
  }
  // whether some pair of queries [q0, q1] x keys [k0, k1] is masked: a
  // tile wholly inside the mask skips the per-element test
  __device__ __forceinline__ bool edge(int q0, int q1, int k0,
                                       int k1) const {
    return q1 >= s || k1 >= s || (causal && k1 > q0) ||
           (window > 0 && q1 - k0 >= window);
  }
};

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P = exp(s - lse) of a raw score, lse2 = lse log2(e) given; f gets the
// softcap's derivative.  The scale rides in one FMA without a cap.
template <bool CAP>
__device__ __forceinline__ float prob(float raw, float scale, float softcap,
                                     float lse2, float& f) {
  if constexpr (CAP) {
    const float t = tanhf(raw * (scale / softcap));
    f = 1.f - t * t;
    return ex2(fmaf(t, softcap * LOG2E, -lse2));
  } else {
    f = 1.f;
    return ex2(fmaf(raw, scale * LOG2E, -lse2));
  }
}

// (a)'s dS = P (dP - D) f of a warp's 16 rows x 8N keys, into s: rows
// qpos, keys k0 + 8 nt + 2 (lane & 3) + (e & 1), lse2 and D by row
template <bool CAP, bool EDGE, int N>
__device__ __forceinline__ void ds_rows(float (&s)[N][4],
                                        const float (&dp)[N][4],
                                        const Mask& mask, const int (&qpos)[2],
                                        int k0, int lane,
                                        const float (&lse2)[2],
                                        const float (&d)[2], float scale,
                                        float softcap) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float f;
      float p = prob<CAP>(s[nt][e], scale, softcap, lse2[i], f);
      if (EDGE && !mask.ok(qpos[i], k0 + nt * 8 + 2 * (lane & 3) + (e & 1)))
        p = 0.f;
      s[nt][e] = p * (dp[nt][e] - d[i]) * f;
    }
  }
}

// (b)'s P^T into s and dS^T into dp of a warp's 16 keys x 8N queries:
// keys kpos, queries q0 + col, col = 8 nt + 2 (lane & 3) + (e & 1), lse
// and D by query from shared memory
template <bool CAP, bool EDGE, int N>
__device__ __forceinline__ void ds_cols(float (&s)[N][4], float (&dp)[N][4],
                                        const Mask& mask, const int (&kpos)[2],
                                        int q0, int lane, const float* lse,
                                        const float* d, float scale,
                                        float softcap) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * (lane & 3) + (e & 1);
      float f;
      float p = prob<CAP>(s[nt][e], scale, softcap, lse[col] * LOG2E, f);
      if (EDGE && !mask.ok(q0 + col, kpos[e >> 1])) p = 0.f;
      s[nt][e] = p;
      dp[nt][e] = p * (dp[nt][e] - d[col]) * f;
    }
  }
}

constexpr int MMA_THREADS = 128;
constexpr int STAGES = 2;

// DK the width of q, k, dq and dk rows, DV of v, o, dO and dv rows
template <int DK, int DV> struct MmaCfg {
  static constexpr int LDK = DK + 8;              // smem rows, elements
  static constexpr int LDV = DV + 8;
  static constexpr int KSK = DK / 16;             // k-steps of Q K^T
  static constexpr int KSV = DV / 16;             // and of dO V^T
  static constexpr int KS = KSK > KSV ? KSK : KSV;
  // (a): 64 query rows, key tiles of BKQ
  static constexpr int BQ = 64;
  static constexpr int BKQ = DK > 128 ? 32 : 64;
  static constexpr bool DQ_A_IN_REGS = DK <= 80;  // Q's and dO's fragments
  // 3 blocks an SM (168 registers) up to a q/k width of 128; the 96 or
  // 128 registers of dQ above would spill
  static constexpr int DQ_MIN_BLOCKS = DK <= 128 ? 3 : 1;
  // (b): NS warps share 16 keys, each owning DWK of dK's columns and DWV
  // of dV's; each of G groups of 4 warps takes BQV of a stage's G * BQV
  // queries
  static constexpr int NS = DK > 128 ? 2 : 1;
  static constexpr int BKV = 64 / NS;             // keys a block
  static constexpr int BQV = DK >= 128 ? 32 : 64; // queries a group's tile
  static constexpr int DWK = DK / NS;
  static constexpr int DWV = DV / NS;
  static constexpr int DW = DWK > DWV ? DWK : DWV;
  static constexpr bool KV_A_IN_REGS = DK <= 64;  // K's and V's fragments
  static constexpr int SMEM_DQ =
      (BQ + STAGES * BKQ) * (LDK + LDV) * (int)sizeof(bf16);
  template <int G>
  static constexpr int smem_dkdv() {
    return (BKV + STAGES * G * BQV) * (LDK + LDV) * (int)sizeof(bf16) +
           STAGES * 2 * G * BQV * (int)sizeof(float);
  }
};

// the ldmatrix.x4 row address of lane for a 16 x 16 A fragment at (r0, c0)
// of a row-major tile: matrices (rows 0-7, 8-15) x (cols 0-7, 8-15)
__device__ __forceinline__ const bf16* a_frag(const bf16* t, int ld, int r0,
                                              int c0, int lane) {
  return t + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 +
         ((lane >> 4) << 3);
}

// the row address of lane for the B fragments of two n-tiles: rows n0 ..
// n0 + 15 of an (n, k) row-major tile, k-step c0 (non-transposed: the
// tile holds B^T, as K does for Q K^T)
__device__ __forceinline__ const bf16* b_frag(const bf16* t, int ld, int n0,
                                              int c0, int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
         (((lane >> 3) & 1) << 3);
}

// the row address of lane for the B fragments of two n-tiles of a (k, n)
// row-major tile (through ldmatrix.trans, as V is for P V): k rows k0 ..
// k0 + 15, columns n0 .. n0 + 15
__device__ __forceinline__ const bf16* bt_frag(const bf16* t, int ld, int k0,
                                               int n0, int lane) {
  return t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
         ((lane >> 4) << 3);
}

// accumulator fragments of keys (or queries) 16j .. 16j + 15 as the A
// operand of the next product, rounded to bf16
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[4],
                                     const float (&x)[N][4], int j) {
  a[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
  a[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
  a[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
  a[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// rows r0 .. r0 + n - 1 of an (s, W) bf16 matrix (row stride rs) into a
// shared tile of W + 8-element rows by 16-byte cp.async, zeros past s; NT
// threads copy
template <int W, int NT = MMA_THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long rs, int r0, int n, int s,
                                          const bf16* any) {
  constexpr int CPR = W / 8, LD = W + 8;
  for (int c = threadIdx.x; c < n * CPR; c += NT) {
    const int r = c / CPR, cc = c - r * CPR;
    const bool ok = r0 + r < s;
    cp_async16(dst + r * LD + cc * 8,
               ok ? src + (long long)(r0 + r) * rs + cc * 8 : any, ok);
  }
}

// (a) dQ of one query tile, and D of its rows
template <int DK, int DV>
__global__ void __launch_bounds__(MMA_THREADS, MmaCfg<DK, DV>::DQ_MIN_BLOCKS)
    bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dO,
                      const float* __restrict__ lse,
                      float* __restrict__ dsum, bf16* __restrict__ dq,
                      int hq, int hkv, BwdStrides st, Mask mask, float scale,
                      float softcap) {
  using C = MmaCfg<DK, DV>;
  constexpr int LDK = C::LDK, LDV = C::LDV, BQ = C::BQ, BK = C::BKQ,
                KSK = C::KSK, KSV = C::KSV;
  constexpr bool IN_REGS = C::DQ_A_IN_REGS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // BQ x LDK
  bf16* dos = qs + BQ * LDK;                      // BQ x LDV
  bf16* ks = dos + BQ * LDV;                      // STAGES x BK x LDK
  bf16* vs = ks + STAGES * BK * LDK;              // STAGES x BK x LDV
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * BQ, q1 = min(mask.s, q0 + BQ) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = k + b * st.t[K][0] + kvh * st.t[K][1];
  const bf16* vb = v + b * st.t[V][0] + kvh * st.t[V][1];
  copy_rows<DK>(qs, q + b * st.t[Q][0] + h * st.t[Q][1], st.t[Q][2], q0, BQ,
                mask.s, q);
  copy_rows<DV>(dos, dO + b * st.t[DO][0] + h * st.t[DO][1], st.t[DO][2], q0,
                BQ, mask.s, dO);
  int kt0, kt1;
  key_tiles(mask, q0, q1, BK, kt0, kt1);
  auto load_kv = [&](int kt, int stage) {
    copy_rows<DK>(ks + stage * BK * LDK, kb, st.t[K][2], kt * BK, BK, mask.s,
                  k);
    copy_rows<DV>(vs + stage * BK * LDV, vb, st.t[V][2], kt * BK, BK, mask.s,
                  v);
  };
  load_kv(kt0, 0);
  cp_async_commit();

  // D = sum(dO * o) of the warp's 16 rows (lane l over column pairs 2l,
  // 2l + 64, ..., every row's loads in flight together, then a fixed
  // shuffle tree), written to the scratch for (b); this thread keeps D and
  // lse of its two accumulator rows g and g + 8
  const long long row0 = ((long long)b * hq + h) * mask.s;
  const int r_w = q0 + warp * 16;
  const int qpos[2] = {r_w + (lane >> 2), r_w + (lane >> 2) + 8};
  float dr[2] = {0.f, 0.f}, lr[2], part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int qi = r_w + i;
    part[i] = 0.f;
    if (qi >= mask.s) continue;
    const bf16* orow = o + b * st.t[O][0] + h * st.t[O][1] +
                       (long long)qi * st.t[O][2];
    const bf16* grow = dO + b * st.t[DO][0] + h * st.t[DO][1] +
                       (long long)qi * st.t[DO][2];
#pragma unroll
    for (int d = 2 * lane; d < DV; d += 64) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(orow + d));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(grow + d));
      part[i] += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float acc = warp_sum(part[i]);
    if (r_w + i < mask.s && lane == 0) dsum[row0 + r_w + i] = acc;
    if (i == (lane >> 2)) dr[0] = acc;
    if (i == (lane >> 2) + 8) dr[1] = acc;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)   // lse in the log2 domain
    lr[i] = qpos[i] < mask.s ? lse[row0 + qpos[i]] * LOG2E : 0.f;

  uint32_t qf[IN_REGS ? KSK : 1][4], gf[IN_REGS ? KSV : 1][4];
  float acc[DK / 8][4];
  zero(acc);
  const int n_tiles = kt1 - kt0 + 1;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(kt0 + it + 1, (it + 1) % STAGES);
    cp_async_commit();                   // (empty on the last tile)
    cp_async_wait<1>();                  // tile it (and Q, dO) have landed
    __syncthreads();
    if constexpr (IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSK; ++kk)
          ldsm_x4(qf[kk], a_frag(qs, LDK, warp * 16, kk * 16, lane));
#pragma unroll
        for (int kk = 0; kk < KSV; ++kk)
          ldsm_x4(gf[kk], a_frag(dos, LDV, warp * 16, kk * 16, lane));
      }
    }
    const bf16* kt = ks + (it % STAGES) * BK * LDK;
    const bf16* vt = vs + (it % STAGES) * BK * LDV;
    const int k0 = (kt0 + it) * BK;

    // S = Q K^T over KSK k-steps and dP = dO V^T over KSV: 16 rows x BK
    // keys per warp (the step's guards are constants once unrolled)
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      uint32_t qa[4], ga[4];
      if constexpr (IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kk < KSK) qa[e] = qf[kk < KSK ? kk : 0][e];
          if (kk < KSV) ga[e] = gf[kk < KSV ? kk : 0][e];
        }
      } else {
        if (kk < KSK) ldsm_x4(qa, a_frag(qs, LDK, warp * 16, kk * 16, lane));
        if (kk < KSV) ldsm_x4(ga, a_frag(dos, LDV, warp * 16, kk * 16, lane));
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t bf[4];
        if (kk < KSK) {
          ldsm_x4(bf, b_frag(kt, LDK, j * 16, kk * 16, lane));
          mma_bf16(s[2 * j], qa, bf[0], bf[1]);
          mma_bf16(s[2 * j + 1], qa, bf[2], bf[3]);
        }
        if (kk < KSV) {
          ldsm_x4(bf, b_frag(vt, LDV, j * 16, kk * 16, lane));
          mma_bf16(dp[2 * j], ga, bf[0], bf[1]);
          mma_bf16(dp[2 * j + 1], ga, bf[2], bf[3]);
        }
      }
    }

    // dS = P (dP - D) f, into s; the mask only on a tile it cuts
    const bool edge = mask.edge(r_w, r_w + 15, k0, k0 + BK - 1);
    if (softcap > 0.f) {
      if (edge)
        ds_rows<true, true>(s, dp, mask, qpos, k0, lane, lr, dr, scale,
                            softcap);
      else
        ds_rows<true, false>(s, dp, mask, qpos, k0, lane, lr, dr, scale,
                             softcap);
    } else if (edge) {
      ds_rows<false, true>(s, dp, mask, qpos, k0, lane, lr, dr, scale,
                           softcap);
    } else {
      ds_rows<false, false>(s, dp, mask, qpos, k0, lane, lr, dr, scale,
                            softcap);
    }

    // dQ += dS K: dS in bf16 as the A operand, K through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      to_a(a, s, j);
#pragma unroll
      for (int d = 0; d < KSK; ++d) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bt_frag(kt, LDK, j * 16, d * 16, lane));
        mma_bf16(acc[2 * d], a, bf[0], bf[1]);
        mma_bf16(acc[2 * d + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                     // stage it % STAGES is free again
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= mask.s) continue;
    bf16* row = dq + b * st.t[DQG][0] + h * st.t[DQG][1] +
                (long long)qpos[i] * st.t[DQG][2];
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[nt][2 * i] * scale,
                                acc[nt][2 * i + 1] * scale);
  }
}

// (b) dK and dV of one key tile over every query of its kv head's group,
// by G warp groups
template <int DK, int DV, int G>
__global__ void __launch_bounds__(G * MMA_THREADS)
    bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int hq, int hkv, BwdStrides st,
                        Mask mask, float scale, float softcap) {
  using C = MmaCfg<DK, DV>;
  constexpr int LDK = C::LDK, LDV = C::LDV, BKV = C::BKV, BQ = C::BQV,
                NS = C::NS, DWK = C::DWK, DWV = C::DWV, KSK = C::KSK,
                KSV = C::KSV, NT = G * MMA_THREADS;
  constexpr int WQ = G * BQ;                      // queries a stage
  constexpr bool IN_REGS = C::KV_A_IN_REGS;
  static_assert(G == 1 || G == 2, "one or two warp groups");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // BKV x LDK
  bf16* vs = ks + BKV * LDK;                      // BKV x LDV
  bf16* qs = vs + BKV * LDV;                      // STAGES x WQ x LDK
  bf16* dos = qs + STAGES * WQ * LDK;             // STAGES x WQ x LDV
  float* ls = reinterpret_cast<float*>(dos + STAGES * WQ * LDV);
  float* dss = ls + STAGES * WQ;                  // both STAGES x WQ
  const int kvh = blockIdx.y, b = blockIdx.z, g = hq / hkv;
  const int k0 = blockIdx.x * BKV, k1 = min(mask.s, k0 + BKV) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 2, wg = warp & 3;  // warp group, warp in it
  copy_rows<DK, NT>(ks, k + b * st.t[K][0] + kvh * st.t[K][1], st.t[K][2],
                    k0, BKV, mask.s, k);
  copy_rows<DV, NT>(vs, v + b * st.t[V][0] + kvh * st.t[V][1], st.t[V][2],
                    k0, BKV, mask.s, v);
  int qt0, qt1;
  query_tiles(mask, k0, k1, WQ, qt0, qt1);
  const int per_head = qt1 - qt0 + 1, n_it = g * per_head;
  // iteration it: head kvh * g + it / per_head, queries from (qt0 + it %
  // per_head) WQ, group grp's BQ of them from grp BQ on; their Q, dO, lse
  // and D into ring stage `stage`
  auto load_q = [&](int it, int stage) {
    const int h = kvh * g + it / per_head;
    const int qq0 = (qt0 + it % per_head) * WQ;
    copy_rows<DK, NT>(qs + stage * WQ * LDK,
                      q + b * st.t[Q][0] + h * st.t[Q][1], st.t[Q][2], qq0,
                      WQ, mask.s, q);
    copy_rows<DV, NT>(dos + stage * WQ * LDV,
                      dO + b * st.t[DO][0] + h * st.t[DO][1], st.t[DO][2],
                      qq0, WQ, mask.s, dO);
    const long long row0 = ((long long)b * hq + h) * mask.s + qq0;
    for (int r = threadIdx.x; r < WQ; r += NT) {
      const bool ok = qq0 + r < mask.s;
      cp_async4(ls + stage * WQ + r, ok ? lse + row0 + r : lse, ok);
      cp_async4(dss + stage * WQ + r, ok ? dsum + row0 + r : dsum, ok);
    }
  };
  load_q(0, 0);
  cp_async_commit();                     // with the K and V tile

  const int wk = (wg / NS) * 16;         // the warp's first key in the tile
  const int wck = (wg % NS) * DWK;       // its first dK column
  const int wcv = (wg % NS) * DWV;       // and dV column
  const int kw0 = k0 + wk;               // and its first key's position
  const int kpos[2] = {kw0 + (lane >> 2), kw0 + (lane >> 2) + 8};
  uint32_t kf[IN_REGS ? KSK : 1][4], vf[IN_REGS ? KSV : 1][4];
  float ak[DWK / 8][4], av[DWV / 8][4];
  zero(ak);
  zero(av);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q(it + 1, (it + 1) % STAGES);
    cp_async_commit();                   // (empty on the last tile)
    cp_async_wait<1>();                  // tile it (and K, V) have landed
    __syncthreads();
    if constexpr (IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSK; ++kk)
          ldsm_x4(kf[kk], a_frag(ks, LDK, wk, kk * 16, lane));
#pragma unroll
        for (int kk = 0; kk < KSV; ++kk)
          ldsm_x4(vf[kk], a_frag(vs, LDV, wk, kk * 16, lane));
      }
    }
    const int stage = it % STAGES;
    const bf16* qt = qs + (stage * WQ + grp * BQ) * LDK;
    const bf16* gt = dos + (stage * WQ + grp * BQ) * LDV;
    const float* lt = ls + stage * WQ + grp * BQ;
    const float* dt = dss + stage * WQ + grp * BQ;
    const int qq0 = (qt0 + it % per_head) * WQ + grp * BQ;

    // S^T = K Q^T over KSK k-steps and dP^T = V dO^T over KSV: 16 keys x
    // BQ queries per warp
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kk < KSK) ka[e] = kf[kk < KSK ? kk : 0][e];
          if (kk < KSV) va[e] = vf[kk < KSV ? kk : 0][e];
        }
      } else {
        if (kk < KSK) ldsm_x4(ka, a_frag(ks, LDK, wk, kk * 16, lane));
        if (kk < KSV) ldsm_x4(va, a_frag(vs, LDV, wk, kk * 16, lane));
      }
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        uint32_t bf[4];
        if (kk < KSK) {
          ldsm_x4(bf, b_frag(qt, LDK, j * 16, kk * 16, lane));
          mma_bf16(s[2 * j], ka, bf[0], bf[1]);
          mma_bf16(s[2 * j + 1], ka, bf[2], bf[3]);
        }
        if (kk < KSV) {
          ldsm_x4(bf, b_frag(gt, LDV, j * 16, kk * 16, lane));
          mma_bf16(dp[2 * j], va, bf[0], bf[1]);
          mma_bf16(dp[2 * j + 1], va, bf[2], bf[3]);
        }
      }
    }

    // P^T into s, dS^T = P^T (dP^T - D) f into dp; the mask only on a
    // tile it cuts
    const bool edge = mask.edge(qq0, qq0 + BQ - 1, kw0, kw0 + 15);
    if (softcap > 0.f) {
      if (edge)
        ds_cols<true, true>(s, dp, mask, kpos, qq0, lane, lt, dt, scale,
                            softcap);
      else
        ds_cols<true, false>(s, dp, mask, kpos, qq0, lane, lt, dt, scale,
                             softcap);
    } else if (edge) {
      ds_cols<false, true>(s, dp, mask, kpos, qq0, lane, lt, dt, scale,
                           softcap);
    } else {
      ds_cols<false, false>(s, dp, mask, kpos, qq0, lane, lt, dt, scale,
                            softcap);
    }

    // dV += P^T dO over the warp's DWV columns and dK += dS^T Q over its
    // DWK, both in bf16 as the A operand; dO and Q through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t pa[4], sa[4];
      to_a(pa, s, j);
      to_a(sa, dp, j);
#pragma unroll
      for (int d = 0; d < C::DW / 16; ++d) {
        uint32_t bf[4];
        if (d < DWV / 16) {
          ldsm_x4_trans(bf, bt_frag(gt, LDV, j * 16, wcv + d * 16, lane));
          mma_bf16(av[2 * d], pa, bf[0], bf[1]);
          mma_bf16(av[2 * d + 1], pa, bf[2], bf[3]);
        }
        if (d < DWK / 16) {
          ldsm_x4_trans(bf, bt_frag(qt, LDK, j * 16, wck + d * 16, lane));
          mma_bf16(ak[2 * d], sa, bf[0], bf[1]);
          mma_bf16(ak[2 * d + 1], sa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                     // stage it % STAGES is free again
  }

  if constexpr (G == 2) {
    // group 1's sums join group 0's in the ring's memory, in fragment
    // order (consecutive lanes on consecutive words), added in one order
    float* red = reinterpret_cast<float*>(qs);
    constexpr int NFK = DWK / 8 * 4 * 32;  // a warp's floats of dK
    constexpr int NFV = DWV / 8 * 4 * 32;  // and of dV
    static_assert(4 * (NFK + NFV) * 4 <=
                      STAGES * WQ * (LDK + LDV) * (int)sizeof(bf16),
                  "the ring holds group 1's sums");
    float* mine = red + wg * (NFK + NFV) + lane;
    if (grp == 1) {
#pragma unroll
      for (int nt = 0; nt < DWK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(nt * 4 + e) * 32] = ak[nt][e];
#pragma unroll
      for (int nt = 0; nt < DWV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[NFK + (nt * 4 + e) * 32] = av[nt][e];
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int nt = 0; nt < DWK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[nt][e] += mine[(nt * 4 + e) * 32];
#pragma unroll
    for (int nt = 0; nt < DWV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[nt][e] += mine[NFK + (nt * 4 + e) * 32];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= mask.s) continue;
    bf16* dkr = dk + b * st.t[DKG][0] + kvh * st.t[DKG][1] +
                (long long)kpos[i] * st.t[DKG][2] + wck;
    bf16* dvr = dv + b * st.t[DVG][0] + kvh * st.t[DVG][1] +
                (long long)kpos[i] * st.t[DVG][2] + wcv;
#pragma unroll
    for (int nt = 0; nt < DWK / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dkr + nt * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(ak[nt][2 * i] * scale,
                                ak[nt][2 * i + 1] * scale);
#pragma unroll
    for (int nt = 0; nt < DWV / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dvr + nt * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(av[nt][2 * i], av[nt][2 * i + 1]);
  }
}

template <int DK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dO, void* dq, void* dk, void* dv,
                const float* lse, float* dsum, int b, int hq, int hkv,
                const BwdStrides& st, const Mask& mask, float scale,
                float softcap, int groups, cudaStream_t stream) {
  using C = MmaCfg<DK, DV>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq_mma_kernel<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_DQ);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dkdv_mma_kernel<DK, DV, 1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::template smem_dkdv<1>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dkdv_mma_kernel<DK, DV, 2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::template smem_dkdv<2>());
    return e;
  }();
  if (groups != 1 && groups != 2) return (int)cudaErrorInvalidValue;
  if (attr != cudaSuccess) return (int)attr;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dO);
  bwd_dq_mma_kernel<DK, DV>
      <<<dim3((mask.s + C::BQ - 1) / C::BQ, hq, b), MMA_THREADS, C::SMEM_DQ,
         stream>>>(tq, tk, tv, static_cast<const bf16*>(o), tdo, lse, dsum,
                   static_cast<bf16*>(dq), hq, hkv, st, mask, scale,
                   softcap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((mask.s + C::BKV - 1) / C::BKV, hkv, b);
  if (groups == 1)
    bwd_dkdv_mma_kernel<DK, DV, 1>
        <<<grid, MMA_THREADS, C::template smem_dkdv<1>(), stream>>>(
            tq, tk, tv, tdo, lse, dsum, static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), hq, hkv, st, mask, scale, softcap);
  else
    bwd_dkdv_mma_kernel<DK, DV, 2>
        <<<grid, 2 * MMA_THREADS, C::template smem_dkdv<2>(), stream>>>(
            tq, tk, tv, tdo, lse, dsum, static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), hq, hkv, st, mask, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;

// the scaled, softcapped score of a raw score; f gets the softcap's
// derivative (1 without a cap)
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

template <int DK, int DV> struct Cfg {
  static constexpr int B = DK > 128 ? 32 : 64;  // rows of every tile
  static constexpr int PT = B / 16;             // per thread, each way
  static constexpr int TDK = DK / 16;           // per thread, along dk
  static constexpr int TDV = DV / 16;           // and along dv
  static constexpr int LDK = DK + 1;            // padded rows, floats
  static constexpr int LDV = DV + 1;
  static constexpr int PLD = B + 1;
  static constexpr int SMEM =
      (2 * B * LDK + 2 * B * LDV + B * PLD + 2 * B) * 4;
};

// rows r0 .. r0 + B - 1 of an (s, W) matrix (row stride rs) into dst,
// rows of W + 1 floats, zeros past s
template <int W, int B>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long rs, int r0, int s) {
  for (int e = threadIdx.x; e < B * W; e += THREADS) {
    const int r = e / W, c = e - r * W;
    dst[r * (W + 1) + c] = r0 + r < s ? src[(long long)(r0 + r) * rs + c]
                                      : 0.f;
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
__device__ __forceinline__ void zero_tile(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// D = sum(dO * o) of every query row (dv wide): one warp a row
__global__ void __launch_bounds__(THREADS)
    bwd_dsum_kernel(const float* __restrict__ o,
                    const float* __restrict__ dO, float* __restrict__ dsum,
                    int dv, int hq, int s, long long n_rows, BwdStrides st) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        (threadIdx.x >> 5);
  if (row >= n_rows) return;             // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long b = row / ((long long)hq * s);
  const int h = (int)((row / s) % hq), i = (int)(row % s);
  const float* orow = o + b * st.t[O][0] + h * st.t[O][1] +
                      (long long)i * st.t[O][2];
  const float* grow = dO + b * st.t[DO][0] + h * st.t[DO][1] +
                      (long long)i * st.t[DO][2];
  float acc = 0.f;
  for (int d = lane; d < dv; d += 32) acc += orow[d] * grow[d];
  acc = warp_sum(acc);
  if (lane == 0) dsum[row] = acc;
}

// Q, dO of head h and query tile q0, with their rows' lse and D
template <int DK, int DV>
__device__ __forceinline__ void load_query_side(
    float* Qs, float* dOs, float* Ls, float* Ds, const float* q,
    const float* dO, const float* lse, const float* dsum,
    const BwdStrides& st, int b, int h, int hq, int q0, int s) {
  constexpr int B = Cfg<DK, DV>::B;
  load_tile<DK, B>(Qs, q + b * st.t[Q][0] + h * st.t[Q][1], st.t[Q][2], q0,
                   s);
  load_tile<DV, B>(dOs, dO + b * st.t[DO][0] + h * st.t[DO][1], st.t[DO][2],
                   q0, s);
  const long long row0 = ((long long)b * hq + h) * s;
  for (int r = threadIdx.x; r < B; r += THREADS) {
    Ls[r] = q0 + r < s ? lse[row0 + q0 + r] : 0.f;
    Ds[r] = q0 + r < s ? dsum[row0 + q0 + r] : 0.f;
  }
}

// P of the tile pair (q0, k0) into pf (times the softcap's derivative) and,
// with Ps, P itself to shared memory
template <int DK, int DV>
__device__ __forceinline__ void tile_p(
    float (&pf)[Cfg<DK, DV>::PT][Cfg<DK, DV>::PT], const float* Qs,
    const float* Ks, const float* Ls, float* Ps, const Mask& mask, int q0,
    int k0, float scale, float softcap) {
  using C = Cfg<DK, DV>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[C::PT][C::PT];
  zero_tile(sc);
  tile_mm(sc, DK, Qs, C::LDK, 1, Ks, C::LDK, 1);
#pragma unroll
  for (int i = 0; i < C::PT; ++i)
#pragma unroll
    for (int j = 0; j < C::PT; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      float f;
      const float s = capped(sc[i][j], scale, softcap, f);
      const float p = mask.ok(q0 + r, k0 + c) ? expf(s - Ls[r]) : 0.f;
      pf[i][j] = p * f;
      if (Ps) Ps[r * C::PLD + c] = p;
    }
}

// dS = P f (dP - D), dP = dO V^T, into Ps
template <int DK, int DV>
__device__ __forceinline__ void tile_ds(
    const float (&pf)[Cfg<DK, DV>::PT][Cfg<DK, DV>::PT], const float* dOs,
    const float* Vs, const float* Ds, float* Ps) {
  using C = Cfg<DK, DV>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float dp[C::PT][C::PT];
  zero_tile(dp);
  tile_mm(dp, DV, dOs, C::LDV, 1, Vs, C::LDV, 1);
  __syncthreads();  // every thread is done reading Ps
#pragma unroll
  for (int i = 0; i < C::PT; ++i)
#pragma unroll
    for (int j = 0; j < C::PT; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      Ps[r * C::PLD + c] = pf[i][j] * (dp[i][j] - Ds[r]);
    }
}

// dK and dV of one key tile over every query of its kv head's group
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dk,
                    float* __restrict__ dv, int hq, int hkv, BwdStrides st,
                    Mask mask, float scale, float softcap) {
  using C = Cfg<DK, DV>;
  constexpr int B = C::B, TT = C::PT, TDK = C::TDK, TDV = C::TDV,
                LDK = C::LDK, LDV = C::LDV, PLD = C::PLD;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + B * LDK;
  float* Ks = dOs + B * LDV;
  float* Vs = Ks + B * LDK;
  float* Ps = Vs + B * LDV;
  float* Ls = Ps + B * PLD;
  float* Ds = Ls + B;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kvh = blockIdx.y, b = blockIdx.z, g = hq / hkv;
  const int k0 = blockIdx.x * B, k1 = min(mask.s, k0 + B) - 1;
  load_tile<DK, B>(Ks, k + b * st.t[K][0] + kvh * st.t[K][1], st.t[K][2], k0,
                   mask.s);
  load_tile<DV, B>(Vs, v + b * st.t[V][0] + kvh * st.t[V][1], st.t[V][2], k0,
                   mask.s);
  float ak[TT][TDK], av[TT][TDV];
  zero_tile(ak);
  zero_tile(av);
  int qt0, qt1;
  query_tiles(mask, k0, k1, B, qt0, qt1);
  for (int h = kvh * g; h < (kvh + 1) * g; ++h) {
    for (int qt = qt0; qt <= qt1; ++qt) {
      const int q0 = qt * B;
      __syncthreads();
      load_query_side<DK, DV>(Qs, dOs, Ls, Ds, q, dO, lse, dsum, st, b, h,
                              hq, q0, mask.s);
      __syncthreads();
      float pf[TT][TT];
      tile_p<DK, DV>(pf, Qs, Ks, Ls, Ps, mask, q0, k0, scale, softcap);
      __syncthreads();
      // dV += P^T dO: rows are keys, columns dv, summed over the queries
      tile_mm(av, B, Ps, 1, PLD, dOs, 1, LDV);
      tile_ds<DK, DV>(pf, dOs, Vs, Ds, Ps);
      __syncthreads();
      // dK += dS^T Q
      tile_mm(ak, B, Ps, 1, PLD, Qs, 1, LDK);
    }
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= mask.s) continue;
    float* dkr =
        dk + b * st.t[DKG][0] + kvh * st.t[DKG][1] + kj * st.t[DKG][2];
    float* dvr =
        dv + b * st.t[DVG][0] + kvh * st.t[DVG][1] + kj * st.t[DVG][2];
#pragma unroll
    for (int c = 0; c < TDK; ++c) dkr[tx + 16 * c] = ak[i][c] * scale;
#pragma unroll
    for (int c = 0; c < TDV; ++c) dvr[tx + 16 * c] = av[i][c];
  }
}

// dQ of one query tile over the keys it sees
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, float* __restrict__ dq,
                  int hq, int hkv, BwdStrides st, Mask mask, float scale,
                  float softcap) {
  using C = Cfg<DK, DV>;
  constexpr int B = C::B, TT = C::PT, TDK = C::TDK, LDK = C::LDK,
                LDV = C::LDV, PLD = C::PLD;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + B * LDK;
  float* Ks = dOs + B * LDV;
  float* Vs = Ks + B * LDK;
  float* Ps = Vs + B * LDV;
  float* Ls = Ps + B * PLD;
  float* Ds = Ls + B;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * B, q1 = min(mask.s, q0 + B) - 1;
  const float* kb = k + b * st.t[K][0] + kvh * st.t[K][1];
  const float* vb = v + b * st.t[V][0] + kvh * st.t[V][1];
  load_query_side<DK, DV>(Qs, dOs, Ls, Ds, q, dO, lse, dsum, st, b, h, hq,
                          q0, mask.s);
  float aq[TT][TDK];
  zero_tile(aq);
  int kt0, kt1;
  key_tiles(mask, q0, q1, B, kt0, kt1);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * B;
    __syncthreads();
    load_tile<DK, B>(Ks, kb, st.t[K][2], k0, mask.s);
    load_tile<DV, B>(Vs, vb, st.t[V][2], k0, mask.s);
    __syncthreads();
    float pf[TT][TT];
    tile_p<DK, DV>(pf, Qs, Ks, Ls, nullptr, mask, q0, k0, scale, softcap);
    tile_ds<DK, DV>(pf, dOs, Vs, Ds, Ps);
    __syncthreads();
    // dQ += dS K: rows are queries, columns dk, summed over the keys
    tile_mm(aq, B, Ps, PLD, 1, Ks, 1, LDK);
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= mask.s) continue;
    float* dqr =
        dq + b * st.t[DQG][0] + h * st.t[DQG][1] + qi * st.t[DQG][2];
#pragma unroll
    for (int c = 0; c < TDK; ++c) dqr[tx + 16 * c] = aq[i][c] * scale;
  }
}

template <int DK, int DV>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dO, void* dq, void* dk, void* dv,
               const float* lse, float* dsum, int b, int hq, int hkv,
               const BwdStrides& st, const Mask& mask, float scale,
               float softcap, int /* groups: bf16 only */,
               cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dq_kernel<DK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (mask.s + C::B - 1) / C::B;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dO);
  const long long n_rows = (long long)b * hq * mask.s;
  bwd_dsum_kernel<<<(unsigned)((n_rows + THREADS / 32 - 1) / (THREADS / 32)),
                    THREADS, 0, stream>>>(static_cast<const float*>(o), tdo,
                                          dsum, DV, hq, mask.s, n_rows, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_kernel<DK, DV><<<dim3(tiles, hkv, b), THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<float*>(dk),
      static_cast<float*>(dv), hq, hkv, st, mask, scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<DK, DV><<<dim3(tiles, hq, b), THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<float*>(dq), hq, hkv, st, mask,
      scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 float32, 1 bfloat16; dh the width of q, k, dq and dk, dv of v,
// o, dO and dv: (d, d) for d in 32, 64, 80, 128, 256, or MLA's (192, 128);
// strides: 8 x (batch, head, sequence) of q, k, v, o, dO, dq, dk, dv; lse
// (b, hq, s) f32 is the forward's log-sum-exp of each query row, dsum (b,
// hq, s) f32 scratch for D.  bf16: the caller checked that q, k, v, o and
// dO are 16-byte aligned with strides that are multiples of 8 elements,
// and groups (1 or 2) is the dK/dV launch's warp groups a block
// (flash_attention.py's bwd_groups).
extern "C" int flash_attention_bwd(int dtype, int dh, int dv, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dO, void* dq,
                                   void* dk, void* dv_, const float* lse,
                                   float* dsum, int b, int hq, int hkv,
                                   int s, const long long* strides,
                                   float scale, float softcap, int causal,
                                   int window, int groups,
                                   cudaStream_t stream) {
  if (b <= 0 || s <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  BwdStrides st;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) st.t[i][j] = strides[3 * i + j];
  const Mask mask{s, causal, window};
#define BWD(LAUNCH, DK, DV)                                                 \
  return LAUNCH<DK, DV>(q, k, v, o, dO, dq, dk, dv_, lse, dsum, b, hq, hkv, \
                        st, mask, scale, softcap, groups, stream)
#define WIDTHS(LAUNCH)                                                      \
  if (dh == dv) {                                                           \
    switch (dh) {                                                           \
      case 32: BWD(LAUNCH, 32, 32);                                         \
      case 64: BWD(LAUNCH, 64, 64);                                         \
      case 80: BWD(LAUNCH, 80, 80);                                         \
      case 128: BWD(LAUNCH, 128, 128);                                      \
      case 256: BWD(LAUNCH, 256, 256);                                      \
    }                                                                       \
  } else if (dh == 192 && dv == 128) {                                      \
    BWD(LAUNCH, 192, 128);                                                  \
  }
  if (dtype == 0) {
    WIDTHS(launch_f32)
  } else if (dtype == 1) {
    WIDTHS(launch_bf16)
  }
#undef WIDTHS
#undef BWD
  return (int)cudaErrorInvalidValue;
}
