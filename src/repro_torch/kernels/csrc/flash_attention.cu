// Prefix-append flash attention for Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:107
// (_flash_kernel :44, pallas_call :139).  Same contract: q (b, hq, sq, dh)
// is the append chunk, k and v (b, hkv, skv, dh) hold prefix || append,
// GQA groups g = hq / hkv fold into the rows of one block, query row i of
// batch row b sits at global position kv_len_b - sq + i, keys at or past
// kv_len_b are masked, optional causal mask, tanh softcap (before the
// mask) and sliding window, online softmax with f32 m / l / acc, p cast to
// the V dtype before P.V, rows without a valid key written as 0.  One
// addition: an optional per-row kv_lens (b,); without it kv_len_b = skv
// for every row, which is the Pallas kernel exactly.  With it, the
// model's append passes its padded cache (b, S, hkv, dh) whole.  Tensors
// are passed with element strides for their three leading dims (the last
// dim contiguous), so the model hands over its (b, s, h, dh) activations
// and caches as transposed views, without a copy.
//
// Bound: about 4 * dh flops per (query, key) pair against 2 * dh * 2
// bytes of K/V per key; with 64 query rows per K/V read that is ~64
// flops a byte, under the card's ~295 bf16 ridge, so bytes bound at the
// main path's shapes (a 128-token append over a 1184-token prefix: 4.8 MB
// of K/V, 1.4 us at 3.35 TB/s; the 1024-token prefill is ~2.2 GFLOP,
// ~2 us of tensor-core peak).
//
// bf16 design (flash_split_kernel): one block of 4 warps per (tile of 64
// query rows = bq queries x g heads, kv head, batch row, key split).
// Q.K^T and P.V run on the tensor cores, mma.sync.m16n8k16 bf16 with f32
// accumulate, operands from shared memory through ldmatrix (.trans for
// V); each warp owns 16 rows, and the online softmax works on the
// accumulator fragments in registers (a row's 4 lanes reduce by
// shuffles).  The S fragments, rounded to bf16, are P.V's A operand as
// they stand: that rounding is the Pallas rule "p in the V dtype".  K/V
// tiles of 64 keys stay bf16 in shared memory, loaded by 16-byte
// cp.async.cg into a 2-stage ring (tile i+1 loads while tile i computes),
// rows padded by 16 bytes so ldmatrix is free of bank conflicts; keys
// past the block's range are zero-filled by the copy.  mma.sync rather
// than wgmma: at these shapes the kernel is bytes bound and the
// tensor-core work is a few microseconds at peak, so the 64-row warpgroup
// product would not move the time; wgmma is for a shape that makes flops
// the limit.  Loop bounds skip fully masked tiles (causal end, window
// start, kv_len); masks are applied per score fragment.  When b * hkv *
// query tiles is under one wave, the host splits the keys into n_split
// ranges of `chunk` keys (from b, hq, sq, skv only: kv_lens stays on the
// device); each split writes f32 partials (m, l, acc) to scratch, a split
// with no valid key writes l = 0, and flash_combine_kernel merges the
// splits in index order and writes bf16.  With one split the kernel
// writes the output itself.  At dh 256 (gemma2) the block takes
// (64 + 2 * 2 * 64) * 264 * 2 = 168,960 bytes of shared memory, one block
// per SM, and Q's fragments are reloaded from shared memory by ldmatrix
// at every k-step instead of held in 64 registers beside the 128 of the
// output accumulator (Q_IN_REGS); the ptxas report is in PERF.md.
//
// Widths: the kernels are templated on the q/k width DK and the v width
// DV, each a multiple of 16.  Every GQA model has DK = DV; at zamba2's dh
// 80 the bf16 block's rows are 88 elements (176 bytes, 44 words: a warp's
// 8 ldmatrix rows start at banks 0, 12, 24, 4, 16, 28, 8, 20, so they do
// not collide), 5 k-steps of 16 and 10 accumulator tiles of 8, and the
// block takes (64 x 88 + 2 x 64 x (88 + 88)) x 2 = 56,320 bytes of shared
// memory (the opt-in attribute); the f32 path's lanes hold elements l, l
// + 32 and l + 64 of a row, the last pass's lanes past 80 predicated off.
// ds27b's MLA append attends with q/k
// 192 (128 nope + 64 rope) and v 128, and the scale is 1 / sqrt(DK), as
// the reference's mla_append (repro/models/mla.py:78) scales.  At (192,
// 128) the bf16 block takes (64 x 200 + 2 x 64 x (200 + 136)) x 2 =
// 111,616 bytes of shared memory, and Q's 48 fragment registers stay
// beside the 64 of the accumulator.
//
// f32 design (flash_f32_kernel, chosen by the dtype dispatch in the entry
// point): the scalar path of the port's first version, kept because TF32
// tensor cores would break the 2e-5 tolerance and, up to dh 128, it
// beats SDPA in f32: blocks of ROWS = 16 (or 64 when g > 16) rows,
// 32-key tiles staged in shared memory as f32, scalar FMAs, one split.
// At dh 256 a block's tiles take 82 KB (ROWS 16), above the 48 KB
// default: the opt-in attribute is set for every instantiation.  There
// the path trails both SDPA and the plain version (PERF.md) and serves
// only the f32 identity check.
//
// The log-sum-exp: with a non-null lse (b, hq, sq) f32, each query row's
// ln(sum of exp(score)) over its valid keys (-inf without one) is written
// beside o, from the m and l the online softmax already holds: by the
// split kernel with one split (m is in the log2 domain there, so lse =
// (m + log2 l) ln 2), by the combine from the merged m and l with
// several, and by the f32 kernel (m + ln l).  flash's backward
// (flash_attention_bwd.cu) reads it instead of recomputing it.  Only the
// autograd forward passes it: every serving call passes null and
// launches what it did before.
//
// Each instantiation's shared-memory attribute is set once, at its first
// launch, not per launch.  Times on the card against the bound and SDPA:
// PERF.md.
#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;        // query rows (g * bq) per block, at most

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int BK = 64;              // keys per K/V tile
constexpr int STAGES = 2;

template <int DH>
__host__ __device__ constexpr int ld_elems() { return DH + 8; }  // smem row

template <int DK, int DV>
constexpr int split_smem_bytes() {
  return (MAX_ROWS * ld_elems<DK>() +
          STAGES * BK * (ld_elems<DK>() + ld_elems<DV>())) *
         (int)sizeof(bf16);
}

// DK: the q/k width, DV <= DK: the v (and output) width
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ pm, float* __restrict__ pl,
                   float* __restrict__ pacc, float* __restrict__ lse,
                   const int* __restrict__ kv_lens, int g, int bq, int sq,
                   int skv, int chunk, int n_split,
                   Strides st, float scale, float softcap, int causal,
                   int window) {
  static_assert(DV <= DK, "v no wider than q/k");
  constexpr int LDK = ld_elems<DK>(), LDV = ld_elems<DV>();
  constexpr int CPRK = DK / 8, CPRV = DV / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);   // MAX_ROWS x LDK
  bf16* ksm = qsm + MAX_ROWS * LDK;                // STAGES x BK x LDK
  bf16* vsm = ksm + STAGES * BK * LDK;             // STAGES x BK x LDV

  const int qt = blockIdx.x / n_split, split = blockIdx.x % n_split;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hq = gridDim.y * g;
  const int i0 = qt * bq;                // first query of this tile
  const int nq = min(bq, sq - i0);
  const int rows = g * bq;               // row r = gi * bq + ri
  int kv_len = kv_lens ? kv_lens[b] : skv;
  kv_len = min(max(kv_len, 0), skv);
  const int q_start = kv_len - sq;       // global position of query 0

  // keys any row of this tile can see, cut to this split's range
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_start + i0 + nq);
  const int k_beg = window > 0 ? max(0, q_start + i0 - window + 1) : 0;
  const int lo = max(k_beg, split * chunk);
  const int hi = min(k_end, split * chunk + chunk);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the two rows this thread's accumulator fragments hold
  const int wr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const long long n_rows = (long long)gridDim.z * hq * sq;

  if (lo >= hi) {                        // nothing visible in this split
    if (n_split == 1) {
      for (int idx = tid; idx < rows * DV; idx += THREADS) {
        const int r = idx / DV, d = idx % DV, gi = r / bq, ri = r % bq;
        if (ri < nq)
          o[b * st.ob + (long long)(h * g + gi) * st.oh +
            (long long)(i0 + ri) * st.os + d] = __float2bfloat16(0.f);
      }
      for (int r = tid; lse && r < rows; r += THREADS) {
        const int gi = r / bq, ri = r % bq;
        if (ri < nq)
          lse[((long long)b * hq + h * g + gi) * sq + i0 + ri] = -INFINITY;
      }
    } else {
      for (int r = tid; r < rows; r += THREADS) {
        const int gi = r / bq, ri = r % bq;
        if (ri >= nq) continue;
        const long long pr = split * n_rows +
                             ((long long)b * hq + h * g + gi) * sq + i0 + ri;
        pm[pr] = -INFINITY;
        pl[pr] = 0.f;
      }
    }
    return;
  }

  // Q tile (rows past the tile's are zero-filled), then K/V tile 0: group 0
  for (int c = tid; c < MAX_ROWS * CPRK; c += THREADS) {
    const int r = c / CPRK, cc = c % CPRK, gi = r / bq, ri = r % bq;
    const bool ok = r < rows && ri < nq;
    const bf16* src = ok ? q + b * st.qb + (long long)(h * g + gi) * st.qh +
                               (long long)(i0 + ri) * st.qs + cc * 8
                         : q;
    cp_async16(qsm + r * LDK + cc * 8, src, ok);
  }
  const bf16* kbase = k + b * st.kb + h * st.kh;
  const bf16* vbase = v + b * st.vb + h * st.vh;
  auto load_tile = [&](int t0, int stage) {
    bf16* kd = ksm + stage * BK * LDK;
    bf16* vd = vsm + stage * BK * LDV;
    // equal widths: each thread issues a K and a V chunk together; MLA's
    // narrower V in a loop of its own (a V chunk beside only the first
    // CPRV of each row's K chunks leaves the issue uneven: 13 % slower
    // at 192 / 128, PERF.md)
    for (int c = tid; c < BK * CPRK; c += THREADS) {
      const int j = c / CPRK, cc = c % CPRK, t = t0 + j;
      const bool ok = t < hi;
      cp_async16(kd + j * LDK + cc * 8,
                 ok ? kbase + (long long)t * st.ks + cc * 8 : k, ok);
      if constexpr (DK == DV)
        cp_async16(vd + j * LDV + cc * 8,
                   ok ? vbase + (long long)t * st.vs + cc * 8 : v, ok);
    }
    if constexpr (DK != DV) {
      for (int c = tid; c < BK * CPRV; c += THREADS) {
        const int j = c / CPRV, cc = c % CPRV, t = t0 + j;
        const bool ok = t < hi;
        cp_async16(vd + j * LDV + cc * 8,
                   ok ? vbase + (long long)t * st.vs + cc * 8 : v, ok);
      }
    }
  };
  load_tile(lo, 0);
  cp_async_commit();

  // query positions of this thread's two rows
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) pos[i] = q_start + i0 + wr[i] % bq;

  // Q's A fragments stay in registers up to dk 128 (and at MLA's dk 192
  // beside dv 128: 48 + 64 registers); at dh 256 they would take 64 more
  // registers beside the 128 of oacc, so each k-step reloads its fragment
  // from the Q tile, which stays in shared memory
  constexpr bool Q_IN_REGS = DK + DV <= 320;
  uint32_t qf[Q_IN_REGS ? DK / 16 : 1][4];
  const int q_r = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int q_c = (lane >> 4) << 3;
  float oacc[DV / 8][4];
#pragma unroll
  for (int d = 0; d < DV / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_tiles = (hi - lo + BK - 1) / BK;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(lo + (it + 1) * BK, (it + 1) % STAGES);
    cp_async_commit();                   // (empty on the last tile)
    cp_async_wait<1>();                  // tile it (and Q) have landed
    __syncthreads();
    if constexpr (Q_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          ldsm_x4(qf[kk], qsm + q_r * LDK + kk * 16 + q_c);
      }
    }
    const bf16* kt = ksm + (it % STAGES) * BK * LDK;
    const bf16* vt = vsm + (it % STAGES) * BK * LDV;
    const int t0 = lo + it * BK;

    // S = Q K^T: 16 rows x BK keys per warp, in BK / 8 fragments
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm_x4(qa, qsm + q_r * LDK + kk * 16 + q_c);
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t bfr[4];
        const int key = j * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = kk * 16 + (((lane >> 3) & 1) << 3);
        ldsm_x4(bfr, kt + key * LDK + c);
        mma_bf16(s[2 * j], qa, bfr[0], bfr[1]);
        mma_bf16(s[2 * j + 1], qa, bfr[2], bfr[3]);
      }
    }

    // scale, softcap, mask (log2 domain), then the online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const int p_ = pos[e >> 1];
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = key < hi;
        if (causal) ok = ok && key <= p_;
        if (window > 0) ok = ok && p_ - key < window;
        x = ok ? x * LOG2E : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
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
      for (int d = 0; d < DV / 8; ++d) {
        oacc[d][2 * i] *= corr;
        oacc[d][2 * i + 1] *= corr;
      }
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mu[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }
    }

    // O += P V: the S fragments of keys 16j..16j+15 are the A operand
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int d = 0; d < DV / 16; ++d) {
        uint32_t bfr[4];
        const int key = j * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int c = d * 16 + ((lane >> 4) << 3);
        ldsm_x4_trans(bfr, vt + key * LDV + c);
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
    const int r = wr[i], gi = r / bq, ri = r % bq;
    if (r >= rows || ri >= nq) continue;
    const int col = 2 * (lane & 3);
    if (n_split == 1) {
      bf16* orow = o + b * st.ob + (long long)(h * g + gi) * st.oh +
                   (long long)(i0 + ri) * st.os;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      if (lse && (lane & 3) == 0)
        lse[((long long)b * hq + h * g + gi) * sq + i0 + ri] =
            l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : -INFINITY;
#pragma unroll
      for (int d = 0; d < DV / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + col) =
            __floats2bfloat162_rn(oacc[d][2 * i] * inv,
                                  oacc[d][2 * i + 1] * inv);
    } else {
      const long long pr = split * n_rows +
                           ((long long)b * hq + h * g + gi) * sq + i0 + ri;
      float* arow = pacc + pr * DV;
#pragma unroll
      for (int d = 0; d < DV / 8; ++d)
        *reinterpret_cast<float2*>(arow + d * 8 + col) =
            make_float2(oacc[d][2 * i], oacc[d][2 * i + 1]);
      if ((lane & 3) == 0) {
        pm[pr] = m[i];
        pl[pr] = l[i];
      }
    }
  }
}

// one warp per output row (b, head, query): merges the splits' partials
template <int DV>
__global__ void __launch_bounds__(THREADS)
flash_combine_kernel(const float* __restrict__ pm,
                     const float* __restrict__ pl,
                     const float* __restrict__ pacc, bf16* __restrict__ o,
                     float* __restrict__ lse, long long n_rows, int n_split,
                     int hq, int sq, Strides st) {
  combine_rows<bf16, DV>(pm, pl, pacc, o, n_rows, n_split, hq, sq, st.ob,
                         st.oh, st.os, lse);
}

template <int DK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* pm, float* pl, float* pacc, float* lse,
                const int* kv_lens, int b, int hq, int hkv, int sq, int skv,
                int n_split, int chunk, const Strides& st, float scale,
                float softcap, int causal, int window, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<DK, DV>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_split_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int g = hq / hkv;
  const int bq = max(1, MAX_ROWS / g);
  const int n_qt = (sq + bq - 1) / bq;
  dim3 grid(n_qt * n_split, hkv, b);
  flash_split_kernel<DK, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), pm, pl, pacc, lse,
      kv_lens, g, bq, sq, skv, chunk, n_split, st, scale, softcap, causal,
      window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const long long n_rows = (long long)b * hq * sq;
  const long long blocks = (n_rows + NWARPS - 1) / NWARPS;
  flash_combine_kernel<DV><<<(unsigned)blocks, THREADS, 0, stream>>>(
      pm, pl, pacc, static_cast<bf16*>(o), lse, n_rows, n_split, hq, sq, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs.  Keys in tiles of 32 (one key per lane of a warp)
// staged in shared memory as float32; one query row's running max m, sum
// l and f32 accumulator acc updated per tile, as the Pallas kernel does
// per block.
// ---------------------------------------------------------------------------

constexpr int TILE = 32;            // keys per staged tile = lanes per warp
constexpr float NEG_BIG = -1e30f;   // initial running max (as in Pallas)

// a row's V elements per lane (lane l: l, l + 32, ...), and whether lane
// holds its e-th: at a width not a multiple of 32 the last pass's lanes
// past it are predicated off
template <int DV>
__host__ __device__ constexpr int per_lane() { return (DV + 31) / 32; }
template <int DV>
__device__ __forceinline__ bool owns(int lane, int e) {
  return DV % 32 == 0 || lane + 32 * e < DV;
}

// the largest divisor of per that is at most 16: the elements a thread
// loads together while staging a tile
__host__ __device__ constexpr int stage_chunk(int per) {
  int c = per < 16 ? per : 16;
  while (per % c) --c;
  return c;
}

// Stage keys [t0, t0 + TILE) into ks (TILE x (DK + 1)) and vs (TILE x DV)
// as f32; keys at or past n are zero.  NT threads cooperate (tid in
// [0, NT)); row_off(t, ko, vo) gives the element offsets of key t's K and V
// rows.  Each thread first loads a chunk of up to 16 K and 16 V elements,
// raw, into registers (unrolled, so the loads are in flight together), and
// only then converts and stores them: a load-convert-store loop makes the
// global-memory latencies add up one after another.  With DV < DK the V
// chunk is the first DV / DK of the K chunk's elements, at V's row width.
template <typename T, int DK, int DV, int NT, typename RowOff>
__device__ __forceinline__ void stage_tile(const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           RowOff row_off, int t0, int n,
                                           int tid, float* ks, float* vs) {
  static_assert(DV <= DK, "v no wider than k");
  constexpr int PER = TILE * DK / NT;   // K elements per thread
  constexpr int PER_V = TILE * DV / NT;  // V elements per thread
  constexpr int CHUNK = stage_chunk(PER);
  static_assert(PER % CHUNK == 0, "tile must split evenly");
  const T zero = from_f<T>(0.f);
#pragma unroll
  for (int c = 0; c < PER; c += CHUNK) {
    T kr[CHUNK], vr[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int idx = tid + (c + i) * NT;
      const int t = t0 + idx / DK, d = idx % DK;
      const int tv = t0 + idx / DV, dv = idx % DV;
      kr[i] = zero;
      vr[i] = zero;
      long long ko, vo;
      if (t < n) {
        row_off(t, ko, vo);
        kr[i] = k[ko + d];
      }
      if (c + i < PER_V && tv < n) {
        row_off(tv, ko, vo);
        vr[i] = v[vo + dv];
      }
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int idx = tid + (c + i) * NT;
      ks[(idx / DK) * (DK + 1) + idx % DK] = to_f(kr[i]);
      if (c + i < PER_V) vs[idx] = to_f(vr[i]);
    }
  }
}

// One query row (qrow: DK floats in shared memory) against one staged
// tile.  Lane j owns key j: its K row starts at ks + j * (DK + 1) (the +1
// pad puts the 32 lanes' reads in 32 distinct banks), its V row at
// vs + j * DV.  Rows of keys past the end of the sequence must be zero
// in ks/vs (the loaders fill them so), because p = 0 times a stale
// non-finite value would still poison acc.  `valid` masks this lane's
// key (padding, causality, window).  All 32 lanes must call together.
template <typename T, int DK, int DV>
__device__ __forceinline__ void row_update(const float* qrow,
                                           const float* ks, const float* vs,
                                           bool valid, float scale,
                                           float softcap, float& m, float& l,
                                           float (&acc)[per_lane<DV>()]) {
  const int lane = threadIdx.x & 31;
  const float* krow = ks + lane * (DK + 1);
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < DK; ++d) s = fmaf(qrow[d], krow[d], s);
  s *= scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  const float m_new = fmaxf(m, warp_max(valid ? s : -INFINITY));
  const float p = valid ? expf(s - m_new) : 0.f;
  const float corr = expf(m - m_new);
  l = l * corr + warp_sum(p);
  const float pv = to_f(from_f<T>(p));   // p in the V dtype for P.V
#pragma unroll
  for (int i = 0; i < per_lane<DV>(); ++i) acc[i] *= corr;
#pragma unroll 8
  for (int j = 0; j < TILE; ++j) {
    const float pj = __shfl_sync(FULL, pv, j);
    const float* vrow = vs + j * DV + lane;
#pragma unroll
    for (int i = 0; i < per_lane<DV>(); ++i)
      if (owns<DV>(lane, i)) acc[i] = fmaf(pj, vrow[32 * i], acc[i]);
  }
  m = m_new;
}


template <int DK, int DV, int ROWS>
constexpr int smem_floats() {
  return ROWS * DK + TILE * (DK + 1) + TILE * DV;
}

template <typename T, int DK, int DV, int ROWS>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lens,
                 int g, int bq, int sq, int skv, Strides st, float scale,
                 float softcap, int causal, int window) {
  constexpr int RPW = ROWS / NWARPS;     // rows per warp
  extern __shared__ float smem[];
  float* qs = smem;                      // ROWS x DK
  float* ks = qs + ROWS * DK;            // TILE x (DK + 1)
  float* vs = ks + TILE * (DK + 1);      // TILE x DV

  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = blockIdx.x * bq;        // first query of this tile
  const int nq = min(bq, sq - i0);
  const int rows = g * bq;               // row r = gi * bq + ri
  int kv_len = kv_lens ? kv_lens[b] : skv;
  kv_len = min(max(kv_len, 0), skv);
  const int q_start = kv_len - sq;       // global position of query 0

  for (int idx = threadIdx.x; idx < rows * DK; idx += THREADS) {
    const int r = idx / DK, d = idx % DK;
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
  float m[RPW], l[RPW], acc[RPW][per_lane<DV>()];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_BIG;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < per_lane<DV>(); ++i) acc[rr][i] = 0.f;
  }

  for (int t0 = k_beg; t0 < k_end; t0 += TILE) {
    __syncthreads();                     // previous tile fully consumed
    stage_tile<T, DK, DV, THREADS>(k, v, row_off, t0, k_end, threadIdx.x,
                                   ks, vs);
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
        row_update<T, DK, DV>(qs + r * DK, ks, vs, valid, scale, softcap,
                              m[rr], l[rr], acc[rr]);
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
    if (lse && lane == 0)
      lse[((long long)b * gridDim.y * g + h * g + gi) * sq + i0 + ri] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : -INFINITY;
#pragma unroll
    for (int i = 0; i < per_lane<DV>(); ++i)
      if (owns<DV>(lane, i))
        orow[lane + 32 * i] =
            from_f<T>(l[rr] > 0.f ? acc[rr][i] / l[rr] : 0.f);
  }
}


template <int DK, int DV, int ROWS>
int launch_f32_rows(const void* q, const void* k, const void* v, void* o,
                    float* lse, const int* kv_lens, int b, int hq, int hkv,
                    int sq, int skv, const Strides& st, float scale,
                    float softcap, int causal, int window,
                    cudaStream_t stream) {
  constexpr int smem = (int)sizeof(float) * smem_floats<DK, DV, ROWS>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<float, DK, DV, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int g = hq / hkv;
  const int bq = max(1, ROWS / g);
  dim3 grid((sq + bq - 1) / bq, hkv, b);
  flash_f32_kernel<float, DK, DV, ROWS><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, kv_lens, g,
      bq, sq, skv, st, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const int* kv_lens, int b, int hq, int hkv,
               int sq, int skv, const Strides& st, float scale,
               float softcap, int causal, int window, cudaStream_t stream) {
  if (hq / hkv <= 16)
    return launch_f32_rows<DK, DV, 16>(q, k, v, o, lse, kv_lens, b, hq, hkv,
                                       sq, skv, st, scale, softcap, causal,
                                       window, stream);
  return launch_f32_rows<DK, DV, MAX_ROWS>(q, k, v, o, lse, kv_lens, b, hq,
                                           hkv, sq, skv, st, scale, softcap,
                                           causal, window, stream);
}

}  // namespace

// dtype: 0 = float32 (scalar path, one split), 1 = bfloat16 (tensor-core
// path).  (dk, dv): the q/k and the v widths, one of (32, 32), (64, 64),
// (80, 80), (128, 128), (256, 256) and MLA's (192, 128).  strides: 12 element
// strides, the (b, h, s) strides of q, k, v and o in that order.  kv_lens
// may be null.  bf16 with n_split > 1: pm and pl hold n_split * b * hq *
// sq floats and pacc dv times as many (scratch the caller allocates),
// keys are split in ranges of `chunk` (a multiple of 64), and the caller
// checked that q, k, v, o are 16-byte aligned with strides that are
// multiples of 8 elements.  lse, null or (b, hq, sq) f32, gets each row's
// log-sum-exp.  Returns the first launch error (cudaError_t), 0 on
// success.
extern "C" int flash_attention(int dtype, int dk, int dv, const void* q,
                               const void* k, const void* v, void* o,
                               float* pm, float* pl, float* pacc, float* lse,
                               const int* kv_lens, int b, int hq, int hkv,
                               int sq, int skv, int n_split, int chunk,
                               const long long* strides, float scale,
                               float softcap, int causal, int window,
                               cudaStream_t stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > MAX_ROWS || n_split <= 0 ||
      (long long)n_split * chunk < skv || chunk % BK != 0)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7],
             strides[8], strides[9], strides[10], strides[11]};
#define FLASH_F32(DK, DV)                                                    \
  return launch_f32<DK, DV>(q, k, v, o, lse, kv_lens, b, hq, hkv, sq, skv,   \
                            st, scale, softcap, causal, window, stream)
#define FLASH_BF16(DK, DV)                                                   \
  return launch_bf16<DK, DV>(q, k, v, o, pm, pl, pacc, lse, kv_lens, b, hq,  \
                             hkv, sq, skv, n_split, chunk, st, scale,        \
                             softcap, causal, window, stream)
  const int key = dk * 1000 + dv;
  if (dtype == 0) {
    if (n_split != 1) return (int)cudaErrorInvalidValue;
    switch (key) {
      case 32032: FLASH_F32(32, 32);
      case 64064: FLASH_F32(64, 64);
      case 80080: FLASH_F32(80, 80);
      case 128128: FLASH_F32(128, 128);
      case 256256: FLASH_F32(256, 256);
      case 192128: FLASH_F32(192, 128);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    switch (key) {
      case 32032: FLASH_BF16(32, 32);
      case 64064: FLASH_BF16(64, 64);
      case 80080: FLASH_BF16(80, 80);
      case 128128: FLASH_BF16(128, 128);
      case 256256: FLASH_BF16(256, 256);
      case 192128: FLASH_BF16(192, 128);
    }
  }
#undef FLASH_F32
#undef FLASH_BF16
  return (int)cudaErrorInvalidValue;
}
