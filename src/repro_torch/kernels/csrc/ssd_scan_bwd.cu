// The gradient of the chunked SSD scan (ssd_scan.cu) for Hopper.
//
// Replaces what XLA derives for the reference's training from the chunk
// loop of repro/models/ssm.py:59 (the lax.scan at :116 of chunk_body
// :94-114): the reference trains through jax.grad, no Pallas kernel
// computes it.  Per sequence b, head h and chunk, with a_k = dt_k A,
// cs_i = sum_{k <= i} a_k (f64, rounded once, as the forward), e_ij =
// exp(cs_i - cs_j) for j <= i, u_j = dt_j x_j, h_in the state entering
// the chunk and g the cotangent of the state leaving it:
//   1. Q_c = sum_i e^{cs_i} dy_i (x) C_i per chunk, then the reverse pass
//      over the chunks, g_{c-1} = e^{cs_end} g_c + Q_c from the final
//      state's cotangent; the last g is dh0;
//   2. per chunk and head, M_ij = e_ij dt_j (dy_i . x_j) and
//        du_j = sum_{i >= j} (C_i . B_j) e_ij dy_i + e^{cs_end - cs_j} g B_j
//        dx_j = dt_j du_j + D dy_j,   ddt_j = x_j . du_j (+ da_j A below);
//   3. B and C carry no head index (n_groups 1), so the reference's
//      CB = C B^T (ssm.py:103) is one matrix per chunk, and its cotangent
//      sums over the heads: dCB_ij = sum_h M^h_ij.  Then, with the carried
//      terms contracted over (h, p), K = H P:
//        dB_j = sum_{i >= j} dCB_ij C_i + sum_{h,p} e^{cs_end - cs_j} u_j g
//        dC_i = sum_{j <= i} dCB_ij B_j + sum_{h,p} e^{cs_i} dy_i h_in;
//   4. dcs_i = sum_{j <= i} W_ij - sum_{k >= i} W_ki (W = CB o M, per head)
//      + e^{cs_i} C_i . (dy_i h_in) - v_i, v_j = e^{cs_end - cs_j} u_j .
//      g B_j, and the last row also gets sum_j v_j + e^{cs_end} <g, h_in>;
//      da_k = sum_{i >= k} dcs_i (f64), ddt_k += da_k A, dA = sum da dt,
//      dD = sum dy x.
// chip_smoke.py's ssd_bwd_plain is this split in PyTorch.
//
// Kernels, in order on the stream (one wrapper call, one launch count):
//   ssd_bwd_state_kernel per (chunk, 64 columns of N, head, sequence): Q_c;
//   ssd_bwd_pass_kernel  per (head, sequence, 1024 state elements): the
//                        reverse pass, g_c written over Q_c, dh0, and each
//                        chunk's <g_c, h_in> partial of its elements;
//   ssd_bwd_chunk_kernel per (64-row column tile j of a chunk, group of
//                        heads): for each head, du from g B_j and from each
//                        row tile i >= j, dx, x . du and v; M^h of each tile
//                        pair computed once, its e_ij taken once, W's row and
//                        column sums taken from it, and M^h added into the
//                        column's dCB tiles in shared memory; the group's
//                        dCB partial written once;
//   ssd_bwd_dcb_kernel   dCB: the groups' partials summed in group order;
//   ssd_bwd_bc_kernel    per (64-row tile, 64 columns of N, dB or dC, share
//                        of the heads): the carried term over the share's
//                        heads, a head at a time (dC's per head also dotted
//                        with C_i for dcs), then, in the last share, dCB
//                        against C or B; an f32 sum per share;
//   ssd_bwd_bc_sum_kernel dB and dC: the shares' sums in share order,
//                        rounded once to the input dtype;
//   ssd_bwd_finish_kernel per (chunk, head, sequence), one warp: dcs from
//                        its partials, the reverse cumulative sum in f64,
//                        ddt += da A, the chunk's dA partial;
//   ssd_bwd_sum_kernel   dA and dD summed over their partials in order.
// No atomics: every output and partial is written once, and every sum runs
// in a fixed order (heads in index order within a group, the groups in
// group order), so two calls agree to the bit.
//
// Each product is a 64 x 64 output tile of 8 warps over a 64-deep step,
// in the layout of a wgmma accumulator (a warpgroup 64 x 32, a warp 16 x
// 32).  With bf16 inputs every product runs on wgmma m64n32k16 (Q, g B_j,
// M, G^T dy, x g and dy h_in per head, dCB C and dCB B): a block writes
// the step's operands once into shared memory as bf16 planes, K-major
// and 128-byte swizzled (an f32 operand cut into NPF = 2 bf16 parts, hi
// and lo, 16 bits of its 24; the bf16 inputs are one part, exact),
// transposing and scaling on the way, and the products of the parts
// whose orders sum to at most one are issued, the smallest first (lo lo
// dropped, ~2^-16 of a product: the checks' f32 gradients stay under a
// tenth of their tolerance).  With f32 inputs every product is f32 FMAs
// on the same fragments.  Every operand lands in shared memory by
// cp.async in its global layout, the next step's copies in flight while
// this step's products run (a ring of two stages).  The forward's C.B^T
// (cb, stored transposed), cumulative sums (cs) and the states entering
// each chunk (S after its pass) come from the forward call, kept for the
// backward by the wrapper; rows past the sequence are zero-filled and
// masked.
//
// Bound: operations.  With t = l (l + 1) / 2 pairs j <= i in a chunk of l
// rows, the gradient needs b H (4 s P N + 2 t P) + b 2 t N multiply-adds
// (Q, g B, u g and dy h_in; M and G dy; dCB C and dCB B): 6.51 G at
// mamba2-1.3b's training microbatch (2 x 1023, H 64, N 128), 0.0263 ms at
// the TF32 peak.  What holds the kernels back: a step stages its planes
// and then runs its products, between barriers, so the tensor cores wait
// while the planes are written (a block that stages step k + 1 while step
// k's products run measured slower: its deeper ring and second set of
// planes held the dB/dC kernel to one block an SM, where it now fits two);
// and the chunk kernel, whose column's dCB tiles keep it to one block an
// SM, its longest blocks (the first column tiles) setting its time.
#include <type_traits>

#include "hopper.cuh"
#include "ssd_tile.cuh"

namespace {

constexpr int BT = 256;          // 8 warps: a 64 x 64 tile, 16 x 32 a warp
constexpr int KT = 64;           // depth of a step's contraction (= T = P)
constexpr int LDF = KT + 4;      // f32 rows read along the contraction
constexpr int LDN = KT + 8;      // f32 rows read across it
constexpr int LDH = KT + 8;      // bf16 rows, either way
constexpr int BC_AIM = 528;      // dB/dC blocks aimed at (4 x 132)
constexpr int MAX_SHARES = 16;   // shares of the heads at most (partials)
constexpr int MAX_NT = MAX_L / T;
constexpr int NPF = 2;           // bf16 parts of an f32 operand on wgmma
static_assert(KT == T && KT == P, "one step depth for every product");

// ---- copies -----------------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's latest groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, 64) x W elements of a row-major source (row stride rs) into dst
// (row stride ld), rows at or past nrows zero-filled
template <typename E, int W>
__device__ __forceinline__ void cp_tile(E* dst, int ld, const E* src,
                                        long long rs, int nrows) {
  constexpr int V = 16 / (int)sizeof(E), PER_ROW = W / V;
  for (int idx = threadIdx.x; idx < T * PER_ROW; idx += BT) {
    const int r = idx / PER_ROW, q = idx % PER_ROW;
    const bool ok = r < nrows;
    cp16(dst + r * ld + q * V, src + (ok ? r * rs : 0) + q * V, ok);
  }
}

// ---- fragments and products -------------------------------------------------

__device__ __forceinline__ float lds(const float* p) { return *p; }
__device__ __forceinline__ float lds(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// A shared-memory operand: element (mn, k) at p[mn * ld + k] when KC (the
// contraction contiguous), else p[k * ld + mn]; with SK each element is
// scaled by sk[k]
template <typename E, bool KC, bool SK = false>
struct Op {
  const E* p;
  int ld;
  const float* sk;
  __device__ __forceinline__ float at(int mn, int k) const {
    const float v = lds(KC ? p + mn * ld + k : p + k * ld + mn);
    if constexpr (SK) return v * sk[k];
    return v;
  }
};
template <typename E>
__device__ __forceinline__ Op<E, true> opk(const E* p, int ld) {
  return {p, ld, nullptr};
}
template <typename E>
__device__ __forceinline__ Op<E, false> opn(const E* p, int ld) {
  return {p, ld, nullptr};
}

// this thread's row (h: 0, 1) and column (ni: 0..3, e: 0, 1) of the tile,
// the layout of a wgmma accumulator: warpgroup wg = w / 4 takes columns
// 32 wg + [0, 32), its warp w % 4 rows 16 (w % 4) + [0, 16), and acc[ni]
// is an m16n8 fragment (rows g and g + 8, columns 2 t and 2 t + 1)
__device__ __forceinline__ int wrow() { return (threadIdx.x >> 5) & 3; }
__device__ __forceinline__ int wcol() { return threadIdx.x >> 7; }
__device__ __forceinline__ int frow(int h) {
  return wrow() * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int fcol(int ni, int e) {
  return wcol() * 32 + 8 * ni + 2 * (threadIdx.x & 3) + e;
}

// acc (rows m, columns n) += sum_k A(m, k) B(n, k) over k < KT, the
// f32 path's products: f32 FMAs summed over k in order
template <typename OA, typename OB>
__device__ __forceinline__ void fma_k(float (&acc)[4][4], const OA& A,
                                      const OB& B) {
#pragma unroll 4
  for (int k = 0; k < KT; ++k) {
    const float a0 = A.at(frow(0), k), a1 = A.at(frow(1), k);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bv = B.at(fcol(ni, e), k);
        acc[ni][e] += a0 * bv;
        acc[ni][2 + e] += a1 * bv;
      }
  }
}

// ---- wgmma on split bf16 planes (the bf16 path's products) ----------------
//
// An operand is a 64 x 64 tile (64 rows: M of A or N of B; 64 deep along
// the contraction) held as bf16 planes in shared memory, K-major and
// 128-byte swizzled (8 KB each, 1024-byte aligned): one plane for bf16
// values, NPF for f32 ones (hi = bf16(v), then bf16 of what is left, as
// many times).  stage() writes them from a tile in any layout, scaled on
// the way, once per block and step; wg_prod() runs the products on wgmma
// m64n32k16 (each warpgroup 32 of the output's 64 columns).
constexpr int PLANE = T * KT;    // bf16 elements of a plane

__device__ __forceinline__ int swz(int r, int c8) {
  return r * KT + ((c8 ^ (r & 7)) << 3);
}

// 8 values (columns 8 c8 + [0, 8) of row r) as NP parts, one 16-byte
// store a plane
template <int NP>
__device__ __forceinline__ void put8(__nv_bfloat16* pl, int r, int c8,
                                     const float (&v)[8]) {
  uint32_t w[NP][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float a = v[2 * q], b = v[2 * q + 1];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      w[i][q] = *reinterpret_cast<const uint32_t*>(&h);
      if (i + 1 < NP) {
        const float2 f = __bfloat1622float2(h);
        a -= f.x;
        b -= f.y;
      }
    }
  }
  const int off = swz(r, c8);
#pragma unroll
  for (int i = 0; i < NP; ++i)
    *reinterpret_cast<uint4*>(pl + i * PLANE + off) =
        make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
}

__device__ __forceinline__ void ld8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void ld8(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[q]));
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

// NP planes of the 64 x 64 operand (r, k) = src[r * ld + k] (KC) or
// src[k * ld + r], times ks[k] where given; every thread calls
// it, then fence_proxy_async_smem and a barrier before the products.
// Threads take consecutive rows: conflict-free for KC at ld 68 (f32) or
// 72 (bf16), and for the transposed reads at any ld.
template <int NP, bool KC, typename E>
__device__ __forceinline__ void stage(__nv_bfloat16* pl, const E* src,
                                      int ld, const float* ks = nullptr) {
#pragma unroll
  for (int q = 0; q < T * KT / 8 / BT; ++q) {
    const int idx = threadIdx.x + q * BT, r = idx & (T - 1), c8 = idx >> 6;
    float v[8];
    if constexpr (KC) {
      ld8(v, src + r * ld + 8 * c8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = lds(src + (8 * c8 + e) * ld + r);
    }
    if (ks) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= ks[8 * c8 + e];
    }
    put8<NP>(pl, r, c8, v);
  }
}

// 64 rows x 64 of a bf16 row-major source (row stride rs) by cp.async
// straight into one plane, rows at or past nrows zero-filled
__device__ __forceinline__ void cp_plane(__nv_bfloat16* pl,
                                         const __nv_bfloat16* src,
                                         long long rs, int nrows) {
  for (int idx = threadIdx.x; idx < T * KT / 8; idx += BT) {
    const int r = idx >> 3, c8 = idx & 7;
    const bool ok = r < nrows;
    cp16(pl + swz(r, c8), src + (ok ? r * rs : 0) + 8 * c8, ok);
  }
}

template <int R>
__device__ __forceinline__ void fence4(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

// d (64 x 32, f32) += A (64 x 16) B (16 x 32)^T, both K-major bf16
__device__ __forceinline__ void wgmma_m64n32(float (&d)[4][4], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

// acc (frow, fcol) += sum over 64 of A(m, k) B(n, k), A from NA planes at
// pa, B from NB at pb (this warpgroup its rows 32 wg + [0, 32)); the
// parts' products whose orders sum past max(NA, NB) - 1 are dropped
// (~2^-24 of a product), the smallest taken first
template <int NA, int NB>
__device__ __forceinline__ void wg_prod(float (&acc)[4][4],
                                        const __nv_bfloat16* pa,
                                        const __nv_bfloat16* pb) {
  constexpr int TOP = (NA > NB ? NA : NB) - 1;
  const uint32_t a = hopper::smem_addr(pa);
  const uint32_t b = hopper::smem_addr(pb) + wcol() * 32 * KT * 2;
  fence4(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int o = TOP; o >= 0; --o)
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (o - i >= 0 && o - i < NB)
          wgmma_m64n32(
              acc, hopper::sw128_desc(a + i * PLANE * 2 + 32 * kk, 16, 1024),
              hopper::sw128_desc(b + (o - i) * PLANE * 2 + 32 * kk, 16,
                                 1024));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence4(acc);
}

// the sums that make dcs (W's row and column sums, v, the carried term):
// f32 on the bf16 path, f64 on the f32 path, whose checks hold each
// gradient to 1e-4 of its largest value after several layers, where
// dcs's large, nearly cancelling sums in f32 lose too much
template <typename Tin>
using Red = std::conditional_t<sizeof(Tin) == 2, float, double>;

// the sum over the 4 lanes of a row (t = lane % 4); every lane calls it
template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dynamic shared memory above 48 KB, asked for once per kernel
template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---- 1. Q -------------------------------------------------------------------

// Q_c[:, nh * 64 + n] = sum_i e^{cs_i} dy_i (x) C_i[nh * 64 + n] for chunk
// blockIdx.x / NH, column tile blockIdx.x % NH, head blockIdx.y, sequence
// blockIdx.z -> Q (b, nc, H, P, N).  Steps of 64 rows i; dy's rows land
// as [i][p] (read as A(p, i), scaled by e^{cs_i}), C's as [i][n].
template <typename Tin>
struct StateSmem {
  static constexpr bool BF = sizeof(Tin) == 2;
  static constexpr int LDC = BF ? LDH : LDN;
  static constexpr int A = T * LDN * 4, B = T * LDC * (int)sizeof(Tin);
  static constexpr int STAGE = A + B;
  // bf16: dy's NPF planes and C's one, 1024-byte aligned after the rest
  static constexpr int O_PL = MAX_L * 4 + 2 * STAGE;
  static constexpr int TOTAL = O_PL + (BF ? (NPF + 1) * PLANE * 2 + 1024 : 0);
};

template <typename Tin, int N>
__global__ void __launch_bounds__(BT, 2)
ssd_bwd_state_kernel(const float* __restrict__ dy, const Tin* __restrict__ C,
                     const float* __restrict__ cs, float* __restrict__ Q,
                     int s, int H, int L, int nc, int lt, long long bc_bs,
                     long long bc_ts) {
  using SM = StateSmem<Tin>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ecs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* pl =
      reinterpret_cast<__nv_bfloat16*>(hopper::align1024(smem + SM::O_PL));
  constexpr int NH = N / T;
  const int c = blockIdx.x / NH, nh = blockIdx.x % NH;
  const int head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * L, len = min(L, s - c0), nsteps = (len + KT - 1) / KT;
  const long long hp = (long long)H * P;
  const float* dyg = dy + ((long long)b * s + c0) * hp + (long long)head * P;
  const Tin* Cg = C + b * bc_bs + (long long)c0 * bc_ts + nh * T;
  auto stage_a = [&](int st) {
    return reinterpret_cast<float*>(smem + MAX_L * 4 + st * SM::STAGE);
  };
  auto stage_b = [&](int st) {
    return reinterpret_cast<Tin*>(smem + MAX_L * 4 + st * SM::STAGE + SM::A);
  };
  auto load = [&](int k, int st) {
    const int r0 = k * KT, nr = min(KT, len - r0);
    cp_tile<float, P>(stage_a(st), LDN, dyg + r0 * hp, hp, nr);
    cp_tile<Tin, T>(stage_b(st), SM::LDC, Cg + r0 * bc_ts, bc_ts, nr);
  };
  load(0, 0);
  cp_commit();
  const float* csp = cs + (((long long)b * nc + c) * H + head) * lt;
  for (int i = tid; i < MAX_L; i += BT) ecs[i] = i < len ? expf(csp[i]) : 0.f;
  float acc[4][4] = {};   // rows p, columns n - nh * 64
  for (int k = 0; k < nsteps; ++k) {
    cp_wait<0>();
    __syncthreads();
    if (k + 1 < nsteps) load(k + 1, (k + 1) & 1);
    cp_commit();
    if constexpr (SM::BF) {
      // A(p, i) = e^{cs_i} dy_i[p], B(n, i) = C_i[n]
      stage<NPF, false>(pl, stage_a(k & 1), LDN, ecs + k * KT);
      stage<1, false>(pl + NPF * PLANE, stage_b(k & 1), SM::LDC);
      hopper::fence_proxy_async_smem();
      __syncthreads();
      wg_prod<NPF, 1>(acc, pl, pl + NPF * PLANE);
    } else {
      const Op<float, false, true> A{stage_a(k & 1), LDN, ecs + k * KT};
      fma_k(acc, A, opn(stage_b(k & 1), SM::LDC));
    }
  }
  float* out = Q + (((long long)b * nc + c) * H + head) * P * N + nh * T;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      store2(out + (long long)frow(h) * N + fcol(ni, 0), acc[ni][2 * h],
             acc[ni][2 * h + 1]);
}

// ---- 2. the reverse pass ----------------------------------------------------

// for head blockIdx.y, sequence blockIdx.z, 4 state elements a thread:
// from g = dh (zeros when null), over the chunks from the last, Q_c is
// replaced by g (the cotangent of the state leaving chunk c), the block's
// share of <g, h_in_c> goes to ghp (b, nc, H, gridDim.x), and g <-
// e^{cs_end} g + Q_c; the last g is dh0 (when non-null).  The loads of
// PASS_BATCH chunks are issued together, and their shares summed after.
template <int N>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_pass_kernel(const float* __restrict__ cs, const float* __restrict__ S,
                    float* __restrict__ Q, const float* __restrict__ dh,
                    float* __restrict__ dh0, float* __restrict__ ghp, int s,
                    int H, int L, int nc, int lt) {
  constexpr int W = PASS_THREADS / 32;
  __shared__ float red[PASS_BATCH][W];
  const int head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long e = (long long)blockIdx.x * PASS_THREADS + tid;
  const long long q = P * N / 4;               // float4s of one state
  const long long st = ((long long)b * H + head) * q + e;
  float4 g = dh ? reinterpret_cast<const float4*>(dh)[st]
                : make_float4(0, 0, 0, 0);
  const long long base = ((long long)b * nc * H + head) * q + e;
  float4* qp = reinterpret_cast<float4*>(Q) + base;
  const float4* hp = reinterpret_cast<const float4*>(S) + base;
  const float* csp = cs + ((long long)b * nc * H + head) * lt;
  for (int top = nc - 1; top >= 0; top -= PASS_BATCH) {
    float4 qc[PASS_BATCH], hc[PASS_BATCH];
    float cse[PASS_BATCH];
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u) {
      const int c = top - u;
      if (c >= 0) {
        const long long off = (long long)c * H * q;
        qc[u] = qp[off];
        hc[u] = hp[off];
        cse[u] = csp[(long long)c * H * lt + min(L, s - c * L) - 1];
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u) {
      const int c = top - u;
      if (c >= 0) {
        qp[(long long)c * H * q] = g;
        float part = g.x * hc[u].x + g.y * hc[u].y + g.z * hc[u].z +
                     g.w * hc[u].w;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if ((tid & 31) == 0) red[u][tid >> 5] = part;
        const float decay = expf(cse[u]);
        g = make_float4(g.x * decay + qc[u].x, g.y * decay + qc[u].y,
                        g.z * decay + qc[u].z, g.w * decay + qc[u].w);
      }
    }
    __syncthreads();
    if (tid < PASS_BATCH && top - tid >= 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) sum += red[tid][w];
      ghp[(((long long)b * nc + top - tid) * H + head) * gridDim.x +
          blockIdx.x] = sum;
    }
    __syncthreads();
  }
  if (dh0) reinterpret_cast<float4*>(dh0)[st] = g;
}

// ---- 3. per column tile and group of heads ----------------------------------

// Shared memory of the chunk kernel (bytes, from a 1024-byte aligned
// start): a ring of two stages (TA: dy of a row tile [i][p], or g [p][n]
// (bf16: 64 columns of N of it); TB: cb of the tile pair [j][i],
// overwritten in place by G = cb o e, or g's planes in bf16), the column's
// dCB tiles [i][j] (one per row tile i >= j), x of the head (two, by head
// parity; bf16: a plane), B_j (bf16: a plane per 64 columns of N; f32:
// [j][n]), bf16's planes of dy and G (four), the head's cs and dt (two),
// the reductions.
template <typename Tin, int N>
struct ChunkSmem {
  static constexpr bool BF = sizeof(Tin) == 2;
  static constexpr int STAGES = 2;
  static constexpr int LDX = BF ? LDH : LDF;
  static constexpr int LDB = N + 4;      // f32's B_j [j][n]
  static constexpr int TILE = T * LDF * 4;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int LDG = N + 4;      // f32: g of a head [p][n]
  static_assert(T * LDG * 4 <= STAGE, "g fits a stage");
  static_assert(NPF * PLANE * 2 <= TILE && TILE % 1024 == 0,
                "g's planes fit TB, 1024-byte aligned");
  static constexpr int DCB = MAX_NT * T * LDN * 4;
  static constexpr int XT = BF ? PLANE * 2 : T * LDX * (int)sizeof(Tin);
  static constexpr int PL = BF ? 2 * NPF * PLANE * 2 : 0;  // dy's, G's
  static constexpr int BJ = BF ? N / T * PLANE * 2 : T * LDB * 4;
  static constexpr int HEAD = 2 * MAX_L * 4;
  // rowred, vred, xdured, dyxred [2][64]; colred [4][64]; 4 scalars
  static constexpr int RED = (12 * T + 4) * (int)sizeof(Red<Tin>);
  static constexpr int O_DCB = STAGES * STAGE, O_X = O_DCB + DCB;
  static constexpr int O_BJ = O_X + 2 * XT, O_PL = O_BJ + BJ;
  static constexpr int O_HEAD = O_PL + PL;
  static constexpr int O_RED = O_HEAD + 2 * HEAD;
  static constexpr int TOTAL = O_RED + RED + 1024;
  static_assert(XT % 1024 == 0 && DCB % 1024 == 0,
                "B_j's planes 1024-byte aligned");
  static_assert(TOTAL <= 232448, "the chunk kernel's shared memory");
};

// Column tile jt of chunk c, sequence bi, heads [h0, h0 + hpg) of group
// grp (the block's index, jt slowest: the columns with the most row tiles
// start first).  For each head, over steps: g (bf16: 64 columns of N a
// step; du = g B_j, then v and the row scale e^{cs_end - cs_j}), then each
// row tile it >= jt (M from dy_i .
// x_j; e_ij once; G = cb o e in place of cb; W's row sums out as rowp,
// its column sums kept; M into dCB; du += G^T dy_i);
// after the last, dx, ddt's direct term, colp = -(column sums) - v, the
// tile's sums of v and dy . x.  At the end the group's dCB tiles go out
// to dcbp (b, nc, groups, lt, lt).
template <typename Tin, int N>
__global__ void __launch_bounds__(BT, 1)
ssd_bwd_chunk_kernel(const Tin* __restrict__ x, const Tin* __restrict__ B,
                     const float* __restrict__ dt, const float* __restrict__ D,
                     const float* __restrict__ dy, const float* __restrict__ cb,
                     const float* __restrict__ cs, const float* __restrict__ Qg,
                     Tin* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ rowp, float* __restrict__ colp,
                     float* __restrict__ vsum, float* __restrict__ dDp,
                     float* __restrict__ dcbp, int nb, int s, int H, int L,
                     int nc, int nt, int hpg, int groups, long long x_bs,
                     long long x_ts, long long bc_bs, long long bc_ts) {
  using SM = ChunkSmem<Tin, N>;
  // the planes need a 1024-byte aligned base; f32 keeps the declared
  // array's (a base aligned at run time cost its loops ~6 %)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (SM::BF) smem = hopper::align1024(smem_raw);
  constexpr int NG = N / KT;
  // steps of g B_j a head: bf16 64 columns of N a step (g's planes fill
  // TB), f32 all of g in one
  constexpr int NGS = SM::BF ? NG : 1;
  int rest = blockIdx.x;
  const int grp = rest % groups;
  rest /= groups;
  const int bi = rest % nb;
  rest /= nb;
  const int c = rest % nc, jt = rest / nc;
  const int c0 = c * L, len = min(L, s - c0), j0 = jt * T;
  if (j0 >= len) return;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wm = wrow(), wn = wcol(), t4 = lane & 3, g8 = lane >> 2;
  const int nJ = min(T, len - j0), n_tiles = (len + T - 1) / T, lt = nt * T;
  const int h0 = grp * hpg, nhead = min(hpg, H - h0);
  const int per_head = NGS + n_tiles - jt, nsteps = nhead * per_head;
  const long long hp = (long long)H * P;

  float* dcb = reinterpret_cast<float*>(smem + SM::O_DCB);
  Tin* bj = reinterpret_cast<Tin*>(smem + SM::O_BJ);
  __nv_bfloat16* bjp = reinterpret_cast<__nv_bfloat16*>(bj);
  __nv_bfloat16* mp = reinterpret_cast<__nv_bfloat16*>(smem + SM::O_PL);
  auto xat = [&](const Tin* xv, int j, int c) -> float {
    if constexpr (SM::BF)
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
          xv)[swz(j, c >> 3) + (c & 7)]);
    else
      return lds(xv + j * SM::LDX + c);
  };
  using R = Red<Tin>;
  R* red = reinterpret_cast<R*>(smem + SM::O_RED);
  R* rowred = red;              // [2][64]
  R* vred = red + 2 * T;        // [2][64]
  R* xdured = red + 4 * T;      // [2][64]
  R* dyxred = red + 6 * T;      // [2][64]
  R* colred = red + 8 * T;      // [4][64]
  R* scal = red + 12 * T;       // [4]
  auto ta = [&](int st) {
    return reinterpret_cast<float*>(smem + st * SM::STAGE);
  };
  auto tb = [&](int st) {
    return reinterpret_cast<float*>(smem + st * SM::STAGE + SM::TILE);
  };
  auto xs = [&](int hb) {
    return reinterpret_cast<Tin*>(smem + SM::O_X + hb * SM::XT);
  };
  auto hcs = [&](int hb) {
    return reinterpret_cast<float*>(smem + SM::O_HEAD + hb * SM::HEAD);
  };
  auto hdt = [&](int hb) { return hcs(hb) + MAX_L; };

  const long long chunk_hd = ((long long)bi * nc + c) * H;
  auto load = [&](int k, int st) {
    const int hl = k / per_head, r = k % per_head, h = h0 + hl;
    const long long chd = chunk_hd + h;
    if (r == 0) {
      const Tin* xg = x + bi * x_bs + (long long)(c0 + j0) * x_ts +
                      (long long)h * P;
      if constexpr (SM::BF)
        cp_plane(reinterpret_cast<__nv_bfloat16*>(xs(hl & 1)), xg, x_ts, nJ);
      else
        cp_tile<Tin, P>(xs(hl & 1), SM::LDX, xg, x_ts, nJ);
      float* csd = hcs(hl & 1);
      float* dtd = hdt(hl & 1);
      const float* css = cs + chd * lt;
      for (int i = tid; i < lt / 4; i += BT)
        cp16(csd + 4 * i, css + 4 * i, true);
      for (int i = tid; i < lt; i += BT)
        cp4(dtd + i, dt + ((long long)bi * s + c0 + (i < len ? i : 0)) * H + h,
            i < len);
    }
    if (r < NGS) {
      if constexpr (SM::BF)
        cp_tile<float, T>(ta(st), LDF, Qg + chd * P * N + r * T, N, P);
      else
        cp_tile<float, N>(ta(st), SM::LDG, Qg + chd * P * N, N, P);
    } else {
      const int i0 = (jt + r - NGS) * T, nI = min(T, len - i0);
      cp_tile<float, P>(ta(st), LDF, dy + ((long long)bi * s + c0 + i0) * hp +
                                         (long long)h * P,
                        hp, nI);
      cp_tile<float, T>(tb(st), LDF,
                        cb + (((long long)bi * nc + c) * lt + j0) * lt + i0,
                        lt, nJ);
    }
  };

  constexpr int NS = SM::STAGES;
  for (int i = tid; i < (n_tiles - jt) * T * LDN; i += BT) dcb[i] = 0.f;
  {
    const Tin* Bj = B + bi * bc_bs + (long long)(c0 + j0) * bc_ts;
    if constexpr (SM::BF) {
#pragma unroll
      for (int q = 0; q < NG; ++q)
        cp_plane(bjp + q * PLANE, Bj + q * T, bc_ts, nJ);
    } else {
      cp_tile<float, N>(bj, SM::LDB, Bj, bc_ts, nJ);
    }
  }
#pragma unroll
  for (int q = 0; q < NS - 1; ++q) {
    if (q < nsteps) load(q, q);
    cp_commit();
  }

  float du[4][4] = {};      // rows j, columns p
  R wcol[4][2] = {};        // this thread's columns' sums of W over i
  for (int k = 0; k < nsteps; ++k) {
    // step k's copies have landed; every thread is past step k - 1, so
    // its stage (and the head buffers of two heads back) may be refilled
    cp_wait<NS - 2>();
    __syncthreads();
    if (k + NS - 1 < nsteps) load(k + NS - 1, (k + NS - 1) % NS);
    cp_commit();
    const int hl = k / per_head, r = k % per_head, h = h0 + hl;
    const int hb = hl & 1, st = k % NS;
    const long long chd = chunk_hd + h;
    const float* csh = hcs(hb);
    const float* dth = hdt(hb);
    const Tin* xt = xs(hb);
    float* TA = ta(st);
    float* TB = tb(st);
    if (r < NGS) {
      // the head's first NGS steps: du = B_j g^T
      if (r == 0) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int q = 0; q < 4; ++q) du[ni][q] = 0.f;
          wcol[ni][0] = wcol[ni][1] = 0.f;
        }
      }
      if constexpr (SM::BF) {
        __nv_bfloat16* gp = reinterpret_cast<__nv_bfloat16*>(TB);
        stage<NPF, true>(gp, TA, LDF);
        hopper::fence_proxy_async_smem();
        __syncthreads();
        wg_prod<1, NPF>(du, bjp + r * PLANE, gp);
      } else {
#pragma unroll
        for (int q = 0; q < NG; ++q)
          fma_k(du, opk(bj + q * KT, SM::LDB), opk(TA + q * KT, SM::LDG));
      }
      if (r == NGS - 1) {
        // v_j = dt_j e^{cs_end - cs_j} x_j . (g B_j); du's rows scaled
        const float cs_end = csh[len - 1];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int j = frow(h2);
          R part = 0;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              part += (R)du[ni][2 * h2 + e] *
                      xat(xt, j, fcol(ni, e));
          part = quad_sum(part);
          const float fr = j < nJ ? expf(cs_end - csh[j0 + j]) : 0.f;
          if (t4 == 0)
            vred[wn * T + j] = j < nJ ? part * dth[j0 + j] * fr : R(0);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            du[ni][2 * h2] *= fr;
            du[ni][2 * h2 + 1] *= fr;
          }
        }
      }
      continue;
    }
    const int it = jt + r - NGS, i0 = it * T, nI = min(T, len - i0);
    // M (rows i, columns j) = dy_i . x_j
    float am[4][4] = {};
    if constexpr (SM::BF) {
      stage<NPF, true>(mp, TA, LDF);
      hopper::fence_proxy_async_smem();
      __syncthreads();
      wg_prod<NPF, 1>(am, mp, reinterpret_cast<const __nv_bfloat16*>(xt));
    } else {
      fma_k(am, opk(TA, LDF), opk(xt, SM::LDX));
    }
    float* dc = dcb + (it - jt) * T * LDN;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = frow(h2), ia = i0 + i;
      const float csi = csh[ia];
      R wr = 0;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float mv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = fcol(ni, e), ja = j0 + j;
          float gv = 0.f, m = 0.f;
          if (i < nI && j < nJ && ia >= ja) {
            const float ev = expf(csi - csh[ja]), d = dth[ja];
            const float a = am[ni][2 * h2 + e];
            gv = TB[j * LDF + i] * ev;
            m = a * ev * d;
            const R w = (R)gv * d * a;
            wr += w;
            wcol[ni][e] += w;
          }
          TB[j * LDF + i] = gv;
          mv[e] = m;
        }
        float2* dp = reinterpret_cast<float2*>(dc + i * LDN + fcol(ni, 0));
        const float2 old = *dp;
        *dp = make_float2(old.x + mv[0], old.y + mv[1]);
      }
      wr = quad_sum(wr);
      if (t4 == 0) rowred[wn * T + i] = wr;
    }
    __syncthreads();
    if (tid < nI)
      rowp[(chd * nt + jt) * lt + i0 + tid] =
          (float)(rowred[tid] + rowred[T + tid]);
    // du += G^T dy_i: A(j, i) = G at [j][i], B(p, i) = dy at [i][p]
    if constexpr (SM::BF) {
      stage<NPF, true>(mp + NPF * PLANE, TB, LDF);
      stage<NPF, false>(mp, TA, LDF);
      hopper::fence_proxy_async_smem();
      __syncthreads();
      wg_prod<NPF, NPF>(du, mp + NPF * PLANE, mp);
    } else {
      fma_k(du, opk(TB, LDF), opn(TA, LDF));
    }
    if (it != n_tiles - 1) continue;

    // ---- the head's last step: its column sums, dx, x . du, dy . x
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        R v = wcol[ni][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g8 == 0) colred[wm * T + fcol(ni, e)] = v;
      }
    const float d_h = D[h];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int j = frow(h2);
      const bool ok = j < nJ;
      const float dtj = ok ? dth[j0 + j] : 0.f;
      const long long row = (((long long)bi * s + c0 + j0 + (ok ? j : 0)) * H +
                             h) * P;
      R xd = 0, xy = 0;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int p = fcol(ni, 0);
        const float2 y = ok ? *reinterpret_cast<const float2*>(dy + row + p)
                            : make_float2(0.f, 0.f);
        const float x0 = xat(xt, j, p);
        const float x1 = xat(xt, j, p + 1);
        const float u0 = du[ni][2 * h2], u1 = du[ni][2 * h2 + 1];
        xd += (R)u0 * x0 + (R)u1 * x1;
        xy += (R)y.x * x0 + (R)y.y * x1;
        if (ok)
          store2(dx + row + p, dtj * u0 + d_h * y.x, dtj * u1 + d_h * y.y);
      }
      xd = quad_sum(xd);
      xy = quad_sum(xy);
      if (t4 == 0) {
        xdured[wn * T + j] = xd;
        dyxred[wn * T + j] = xy;
      }
    }
    __syncthreads();
    if (tid < T) {
      const int j = tid;
      R vv = 0, yx = 0;
      if (j < nJ) {
        ddt[((long long)bi * s + c0 + j0 + j) * H + h] =
            (float)(xdured[j] + xdured[T + j]);
        const R col = colred[j] + colred[T + j] + colred[2 * T + j] +
                      colred[3 * T + j];
        vv = vred[j] + vred[T + j];
        colp[chd * lt + j0 + j] = (float)(-col - vv);
        yx = dyxred[j] + dyxred[T + j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        vv += __shfl_xor_sync(0xffffffffu, vv, o);
        yx += __shfl_xor_sync(0xffffffffu, yx, o);
      }
      if (lane == 0) {
        scal[2 * (tid >> 5)] = vv;
        scal[2 * (tid >> 5) + 1] = yx;
      }
    }
    __syncthreads();
    if (tid == 0) {
      vsum[chd * nt + jt] = (float)(scal[0] + scal[2]);
      dDp[chd * nt + jt] = (float)(scal[1] + scal[3]);
    }
  }

  // the group's dCB tiles, rows i of tile it, columns j of tile jt
  __syncthreads();
  float* outp = dcbp + (((long long)bi * nc + c) * groups + grp) * lt * lt;
  for (int idx = tid; idx < (n_tiles - jt) * T * (T / 4); idx += BT) {
    const int slot = idx / (T * T / 4), rem = idx % (T * T / 4);
    const int i = rem / (T / 4), q = rem % (T / 4);
    *reinterpret_cast<float4*>(outp + (long long)((jt + slot) * T + i) * lt +
                               j0 + 4 * q) =
        *reinterpret_cast<const float4*>(dcb + (slot * T + i) * LDN + 4 * q);
  }
}

// ---- 4. dCB: the groups' partials summed ------------------------------------

// tile pair blockIdx.x (it (it + 1) / 2 + jt, jt <= it) of chunk
// blockIdx.y, sequence blockIdx.z: dcb = the groups' partials summed in
// group order, 4 elements a thread
__global__ void __launch_bounds__(256)
ssd_bwd_dcb_kernel(const float* __restrict__ dcbp, float* __restrict__ dcb,
                   int s, int L, int nc, int lt, int groups) {
  int it = 0, jt = blockIdx.x;
  while (jt > it) jt -= ++it;
  const int c = blockIdx.y, b = blockIdx.z;
  if (it * T >= min(L, s - c * L)) return;
  const long long tile = (long long)lt * lt;
  const float* src = dcbp + ((long long)b * nc + c) * groups * tile;
  float* dst = dcb + ((long long)b * nc + c) * tile;
  for (int idx = threadIdx.x; idx < T * T / 4; idx += 256) {
    const int i = idx / (T / 4), q = idx % (T / 4);
    const long long off = (long long)(it * T + i) * lt + jt * T + 4 * q;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < groups; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(src + g * tile + off);
      sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
    }
    *reinterpret_cast<float4*>(dst + off) = sum;
  }
}

// ---- 5. dB and dC -----------------------------------------------------------

// Shared memory of the dB/dC kernel (bytes, from a 1024-byte aligned
// start): a ring of two stages (A: x, dy or a dCB tile; B: g, h_in, C or
// B; the head's cs over the tile's rows and cs_end; dt over them), C's tile
// for dC's dcs term, its reductions, and on the bf16 path the step's
// operands as planes (A's NPF, then B's NPF).
template <typename Tin>
struct BcSmem {
  static constexpr bool BF = sizeof(Tin) == 2;
  static constexpr int LDT_ = BF ? LDH : LDN;
  // f32 raw tiles: bf16 reads them only to stage planes, at the narrower
  // pitch that lets two blocks share an SM
  static constexpr int LDR = BF ? LDF : LDN;
  static constexpr int A = T * LDR * 4, B = T * LDR * 4;
  static constexpr int SMALL = (2 * T + 8) * 4;   // cs [64 + 4], dt [64]
  static constexpr int STAGE = A + B + SMALL;
  static constexpr int CR = T * LDT_ * (int)sizeof(Tin);
  static constexpr int O_PL =
      (2 * STAGE + CR + 4 * T * (int)sizeof(Red<Tin>) + 1023) / 1024 * 1024;
  static constexpr int TOTAL = O_PL + (BF ? 2 * NPF * PLANE * 2 : 0) + 1024;
  static_assert(STAGE % 16 == 0 && CR % 16 == 0, "16-byte aligned regions");
};

// Row tile tt of chunk c, sequence bi (blockIdx.x = (bi nc + c) nt + tt),
// columns [nh * 64, nh * 64 + 64) of N (blockIdx.y), dB or dC and a share
// of the heads (blockIdx.z = 2 share + (dC ? 1 : 0); shares of hps heads).
// Steps: each of the share's heads h in order (dB: acc_h = x^h g^h, added
// with the rows' dt_j e^{cs_end - cs_j}; dC: acc_h = dy^h h_in^h, its rows
// dotted with C_i into carryp (b, nc, H, NH, lt), added with e^{cs_i}),
// then, in the last share, each tile pair of the row tile (dB: dCB^T C_i
// over i >= j; dC: dCB B_j over j <= i); the share's f32 sum goes to bcp
// (2, shares, b, s, N), summed in share order by ssd_bwd_bc_sum_kernel.
// bf16: each step's operands staged as planes, the products on wgmma.
template <typename Tin, int N>
__global__ void __launch_bounds__(BT, 2)
ssd_bwd_bc_kernel(const Tin* __restrict__ x, const Tin* __restrict__ B,
                  const Tin* __restrict__ C, const float* __restrict__ dt,
                  const float* __restrict__ dy, const float* __restrict__ cs,
                  const float* __restrict__ S, const float* __restrict__ Qg,
                  const float* __restrict__ dcb, float* __restrict__ bcp,
                  float* __restrict__ carryp, int nb, int s, int H, int L,
                  int nc, int nt, int hps, long long x_bs, long long x_ts,
                  long long bc_bs, long long bc_ts) {
  using SM = BcSmem<Tin>;
  // the planes need a 1024-byte aligned base; f32 keeps the declared
  // array's (a base aligned at run time cost its loops ~6 %)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (SM::BF) smem = hopper::align1024(smem_raw);
  constexpr int NH = N / T;
  constexpr int LDX = SM::LDT_;
  __nv_bfloat16* pa = reinterpret_cast<__nv_bfloat16*>(smem + SM::O_PL);
  __nv_bfloat16* pb = pa + NPF * PLANE;
  const int tt = blockIdx.x % nt, cbi = blockIdx.x / nt;
  const int c = cbi % nc, bi = cbi / nc;
  const int nh = blockIdx.y;
  const bool is_c = blockIdx.z & 1;
  const int share = blockIdx.z >> 1, shares = gridDim.z >> 1;
  const int c0 = c * L, len = min(L, s - c0), t0 = tt * T;
  if (t0 >= len) return;
  const int tid = threadIdx.x, lane = tid & 31, wn = wcol();
  const int t4 = lane & 3;
  const int nR = min(T, len - t0), n_tiles = (len + T - 1) / T, lt = nt * T;
  const int hk0 = share * hps, nhk = min(hps, H - hk0);
  const int npair = share + 1 < shares ? 0 : is_c ? tt + 1 : n_tiles - tt;
  const int nsteps = nhk + npair;
  const long long hp = (long long)H * P;
  const long long chunk_hd = ((long long)bi * nc + c) * H;
  Tin* cr = reinterpret_cast<Tin*>(smem + 2 * SM::STAGE);
  using R = Red<Tin>;
  R* red = reinterpret_cast<R*>(smem + 2 * SM::STAGE + SM::CR);
  auto sa = [&](int st) { return smem + st * SM::STAGE; };
  auto sb = [&](int st) {
    return reinterpret_cast<float*>(smem + st * SM::STAGE + SM::A);
  };
  auto scs = [&](int st) {
    return reinterpret_cast<float*>(smem + st * SM::STAGE + SM::A + SM::B);
  };
  auto sdt = [&](int st) { return scs(st) + T + 4; };
  const Tin* Bg = B + bi * bc_bs + (long long)c0 * bc_ts + nh * T;
  const Tin* Cg = C + bi * bc_bs + (long long)c0 * bc_ts + nh * T;

  auto load = [&](int kk, int st) {
    if (kk < nhk) {
      const int k = hk0 + kk;
      const long long chd = chunk_hd + k;
      const long long rows = (long long)bi * s + c0 + t0;
      if (!is_c) {
        cp_tile<Tin, P>(reinterpret_cast<Tin*>(sa(st)), LDX,
                        x + bi * x_bs + (long long)(c0 + t0) * x_ts +
                            (long long)k * P,
                        x_ts, nR);
        cp_tile<float, T>(sb(st), SM::LDR, Qg + chd * P * N + nh * T, N, P);
        float* d = sdt(st);
        for (int i = tid; i < T; i += BT)
          cp4(d + i, dt + (rows + (i < nR ? i : 0)) * H + k, i < nR);
      } else {
        cp_tile<float, P>(reinterpret_cast<float*>(sa(st)), LDF,
                          dy + rows * hp + (long long)k * P, hp, nR);
        cp_tile<float, T>(sb(st), SM::LDR, S + chd * P * N + nh * T, N, P);
      }
      float* csd = scs(st);
      const float* css = cs + chd * lt;
      if (tid < T / 4) cp16(csd + 4 * tid, css + t0 + 4 * tid, true);
      if (tid == T / 4) cp4(csd + T, css + len - 1, true);
    } else {
      const int q = kk - nhk;
      const long long tile = ((long long)bi * nc + c) * lt * lt;
      if (!is_c) {
        const int i0 = (tt + q) * T;
        cp_tile<float, T>(reinterpret_cast<float*>(sa(st)), SM::LDR,
                          dcb + tile + (long long)i0 * lt + t0, lt, T);
        cp_tile<Tin, T>(reinterpret_cast<Tin*>(sb(st)), LDX,
                        Cg + (long long)i0 * bc_ts, bc_ts,
                        min(T, len - i0));
      } else {
        const int j0 = q * T;
        cp_tile<float, T>(reinterpret_cast<float*>(sa(st)), LDF,
                          dcb + tile + (long long)t0 * lt + j0, lt, T);
        cp_tile<Tin, T>(reinterpret_cast<Tin*>(sb(st)), LDX,
                        Bg + (long long)j0 * bc_ts, bc_ts, min(T, len - j0));
      }
    }
  };

  if (is_c) cp_tile<Tin, T>(cr, LDX, Cg + (long long)t0 * bc_ts, bc_ts, nR);
  load(0, 0);
  cp_commit();
  float acc[4][4] = {};   // rows of the tile, columns n - nh * 64
  for (int k = 0; k < nsteps; ++k) {
    cp_wait<0>();
    __syncthreads();
    if (k + 1 < nsteps) load(k + 1, (k + 1) & 1);
    cp_commit();
    const int st = k & 1;
    if (is_c && k >= 1 && k - 1 < nhk && tid < nR) {
      const R* rd = red + ((k - 1) & 1) * 2 * T;
      carryp[((chunk_hd + hk0 + k - 1) * NH + nh) * lt + t0 + tid] =
          (float)(rd[tid] + rd[T + tid]);
    }
    const float* fa = reinterpret_cast<const float*>(sa(st));
    const Tin* ta_ = reinterpret_cast<const Tin*>(sa(st));
    const Tin* tb_ = reinterpret_cast<const Tin*>(sb(st));
    if constexpr (SM::BF) {
      // this step's operands as planes: A (rows of the product, 64 deep),
      // B (its columns)
      if (k < nhk) {
        if (!is_c)
          stage<1, true>(pa, ta_, LDX);           // x_j[p]
        else
          stage<NPF, true>(pa, fa, LDF);          // dy_i[p]
        stage<NPF, false>(pb, sb(st), SM::LDR);   // g or h_in [p][n]
      } else {
        if (!is_c)
          stage<NPF, false>(pa, fa, SM::LDR);     // dCB [i][j] as (j, i)
        else
          stage<NPF, true>(pa, fa, LDF);          // dCB [i][j]
        stage<1, false>(pb, tb_, LDX);            // C [i][n] or B [j][n]
      }
      hopper::fence_proxy_async_smem();
      __syncthreads();
    }
    if (k < nhk) {
      float ah[4][4] = {};
      const float* csr = scs(st);
      if constexpr (SM::BF) {
        if (!is_c)
          wg_prod<1, NPF>(ah, pa, pb);
        else
          wg_prod<NPF, NPF>(ah, pa, pb);
      } else {
        if (!is_c)
          fma_k(ah, opk(ta_, LDX), opn(sb(st), SM::LDR));
        else
          fma_k(ah, opk(fa, LDF), opn(sb(st), SM::LDR));
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = frow(h2);
        const bool ok = i < nR;
        float sc;
        if (!is_c) {
          sc = ok ? sdt(st)[i] * expf(csr[T] - csr[i]) : 0.f;
        } else {
          sc = ok ? expf(csr[i]) : 0.f;
          R part = 0;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              part += (R)ah[ni][2 * h2 + e] * lds(cr + i * LDX + fcol(ni, e));
          part = quad_sum(part);
          if (t4 == 0) red[(k & 1) * 2 * T + wn * T + i] = part;
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          acc[ni][2 * h2] += sc * ah[ni][2 * h2];
          acc[ni][2 * h2 + 1] += sc * ah[ni][2 * h2 + 1];
        }
      }
    } else if constexpr (SM::BF) {
      wg_prod<NPF, 1>(acc, pa, pb);
    } else if (!is_c) {
      // A(j, i) = dCB at [i][j]; B(n, i) = C at [i][n]
      fma_k(acc, opn(fa, SM::LDR), opn(tb_, LDX));
    } else {
      // A(i, j) = dCB at [i][j]; B(n, j) = B at [j][n]
      fma_k(acc, opk(fa, LDF), opn(tb_, LDX));
    }
  }
  if (is_c && npair == 0) {
    // the share's last head's dcs term
    __syncthreads();
    if (tid < nR) {
      const R* rd = red + ((nsteps - 1) & 1) * 2 * T;
      carryp[((chunk_hd + hk0 + nhk - 1) * NH + nh) * lt + t0 + tid] =
          (float)(rd[tid] + rd[T + tid]);
    }
  }
  float* out = bcp + ((((long long)(is_c ? shares : 0) + share) * nb + bi) *
                          s + c0 + t0) * N + nh * T;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = frow(h2);
    if (i < nR)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        store2(out + (long long)i * N + fcol(ni, 0), acc[ni][2 * h2],
               acc[ni][2 * h2 + 1]);
  }
}

// dB and dC: the shares' f32 sums in share order, rounded once to Tin, 4
// elements a thread (n4 float4s of each)
template <typename Tin>
__global__ void __launch_bounds__(256)
ssd_bwd_bc_sum_kernel(const float* __restrict__ bcp, Tin* __restrict__ dB,
                      Tin* __restrict__ dC, long long n4, int shares) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * n4) return;
  const int which = (int)(e / n4);
  const long long off = e % n4;
  const float4* src = reinterpret_cast<const float4*>(bcp) +
                      (long long)which * shares * n4 + off;
  float4 sum = src[0];
  for (int k = 1; k < shares; ++k) {
    const float4 v = src[k * n4];
    sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
  }
  Tin* out = (which ? dC : dB) + 4 * off;
  store2(out, sum.x, sum.y);
  store2(out + 2, sum.z, sum.w);
}

// ---- 6. dcs, its reverse cumulative sum, ddt and dA's partials --------------

// one warp per (chunk blockIdx.x, head blockIdx.y, sequence blockIdx.z):
// dcs_i = sum_{jt <= it} rowp + colp + e^{cs_i} (sum over N's tiles of
// carryp), the last row also sum_j v_j + e^{cs_end} <g, h_in>; da = the
// reverse cumulative sum of dcs in f64 (8 rows a lane, then a shuffle
// scan), ddt += da A, and the chunk's dA partial sum_k da_k dt_k
template <int NH>
__global__ void __launch_bounds__(32)
ssd_bwd_finish_kernel(const float* __restrict__ cs,
                      const float* __restrict__ rowp,
                      const float* __restrict__ colp,
                      const float* __restrict__ carryp,
                      const float* __restrict__ vsum,
                      const float* __restrict__ ghp,
                      const float* __restrict__ dt,
                      const float* __restrict__ A, float* __restrict__ ddt,
                      float* __restrict__ dAp, int s, int H, int L, int nc,
                      int nt, int pass_blocks) {
  const int c = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x;
  const int c0 = c * L, len = min(L, s - c0), lt = nt * T;
  const long long chd = ((long long)b * nc + c) * H + head;
  const float* csp = cs + chd * lt;
  double extra = 0.0;
  if (lane == 0) {
    double sv = 0.0, gh = 0.0;
    for (int t = 0; t < (len + T - 1) / T; ++t) sv += vsum[chd * nt + t];
    for (int k = 0; k < pass_blocks; ++k) gh += ghp[chd * pass_blocks + k];
    extra = sv + (double)expf(csp[len - 1]) * gh;
  }
  extra = __shfl_sync(0xffffffffu, extra, 0);
  constexpr int R = MAX_L / 32;
  double v[R], run = 0.0;
#pragma unroll
  for (int q = R - 1; q >= 0; --q) {
    const int r = lane * R + q;
    // dcs_r, its pieces added in f64
    double d = 0.0;
    if (r < len) {
      for (int jt = 0; jt <= r / T; ++jt) d += rowp[(chd * nt + jt) * lt + r];
      double cy = 0.0;
#pragma unroll
      for (int nh = 0; nh < NH; ++nh) cy += carryp[(chd * NH + nh) * lt + r];
      d += colp[chd * lt + r] + (double)expf(csp[r]) * cy +
           (r == len - 1 ? extra : 0.0);
    }
    run += d;
    v[q] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_down_sync(0xffffffffu, tot, off);
    if (lane + off < 32) tot += t;
  }
  const double excl = tot - run;
  const float a_h = A[head];
  float part = 0.f;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = lane * R + q;
    if (r < len) {
      const float da = (float)(v[q] + excl);
      const long long at = ((long long)b * s + c0 + r) * H + head;
      const float d = dt[at];
      ddt[at] += da * a_h;
      part += da * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) dAp[chd] = part;
}

// ---- 7. dA and dD -----------------------------------------------------------

// dA over (b, chunk) and dD over (b, chunk, tile) partials, in that order
__global__ void __launch_bounds__(256)
ssd_bwd_sum_kernel(const float* __restrict__ dAp,
                   const float* __restrict__ dDp, float* __restrict__ dA,
                   float* __restrict__ dD, int b, int s, int H, int L, int nc,
                   int nt) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float sa = 0.f, sd = 0.f;
    for (int bi = 0; bi < b; ++bi)
      for (int c = 0; c < nc; ++c) {
        const long long chd = ((long long)bi * nc + c) * H + h;
        sa += dAp[chd];
        const int n_tiles = (min(L, s - c * L) + T - 1) / T;
        for (int t = 0; t < n_tiles; ++t) sd += dDp[chd * nt + t];
      }
    dA[h] = sa;
    dD[h] = sd;
  }
}

// ---- the plan and the scratch -----------------------------------------------

// 64-row tiles over every chunk of every sequence
inline int row_tiles(int b, int s, int L) {
  const int tpc = (L + T - 1) / T, rem = s % L;
  return b * ((s / L) * tpc + (rem ? (rem + T - 1) / T : 0));
}

// heads a share of the dB/dC kernel takes: enough shares that its blocks
// (row tiles x 64-column tiles of N x dB and dC x shares) reach BC_AIM,
// at most MAX_SHARES
struct BcPlan {
  int hps, shares;
  BcPlan(int n, int b, int s, int H, int L) {
    const int blocks = row_tiles(b, s, L) * (n / T) * 2;
    const int want = min(MAX_SHARES, max(1, (BC_AIM + blocks - 1) / blocks));
    hps = (H + want - 1) / want;
    shares = (H + hps - 1) / hps;
  }
};

// the scratch's float counts, each a multiple of 4 (16-byte aligned)
struct Work {
  long long q, rowp, colp, carryp, vsum, dDp, ghp, dAp, dcbp, dcb, bcp;
  Work(int n, int b, int s, int H, int L, int groups) {
    const long long nc = (s + L - 1) / L, nt = (L + T - 1) / T, lt = nt * T;
    const long long chd = (long long)b * nc * H;
    auto r4 = [](long long v) { return (v + 3) / 4 * 4; };
    q = r4(chd * P * n);
    rowp = r4(chd * nt * lt);
    colp = r4(chd * lt);
    carryp = r4(chd * (n / T) * lt);
    vsum = r4(chd * nt);
    dDp = r4(chd * nt);
    ghp = r4(chd * (P * n / 4 / PASS_THREADS));
    dAp = r4(chd);
    dcbp = r4((long long)b * nc * groups * lt * lt);
    dcb = r4((long long)b * nc * lt * lt);
    bcp = r4(2LL * BcPlan(n, b, s, H, L).shares * b * s * n);
  }
  long long total() const {
    return q + rowp + colp + carryp + vsum + dDp + ghp + dAp + dcbp + dcb +
           bcp;
  }
};

template <typename Tin, int N>
int launch(const void* xv, const void* Bv, const void* Cv, const float* dt,
           const float* A, const float* D, const float* dy, const float* dh,
           const float* cb, const float* cs, const float* S, void* dxv,
           void* dBv, void* dCv, float* ddt, float* dA, float* dD,
           float* dh0, float* work, int b, int s, int H, int L, int hpg,
           long long x_bs, long long x_ts, long long bc_bs, long long bc_ts,
           cudaStream_t stream) {
  const Tin* x = static_cast<const Tin*>(xv);
  const Tin* B = static_cast<const Tin*>(Bv);
  const Tin* C = static_cast<const Tin*>(Cv);
  Tin* dx = static_cast<Tin*>(dxv);
  const int nc = (s + L - 1) / L, nt = (L + T - 1) / T, lt = nt * T;
  constexpr int NH = N / T, PASS_BLOCKS = P * N / 4 / PASS_THREADS;
  const int groups = (H + hpg - 1) / hpg;
  const BcPlan bplan(N, b, s, H, L);
  const Work w(N, b, s, H, L, groups);
  float* Q = work;
  float* rowp = Q + w.q;
  float* colp = rowp + w.rowp;
  float* carryp = colp + w.colp;
  float* vsum = carryp + w.carryp;
  float* dDp = vsum + w.vsum;
  float* ghp = dDp + w.dDp;
  float* dAp = ghp + w.ghp;
  float* dcbp = dAp + w.dAp;
  float* dcb = dcbp + w.dcbp;
  float* bcp = dcb + w.dcb;
  static const int attr = allow_smem(ssd_bwd_state_kernel<Tin, N>,
                                     StateSmem<Tin>::TOTAL) |
                          allow_smem(ssd_bwd_chunk_kernel<Tin, N>,
                                     ChunkSmem<Tin, N>::TOTAL) |
                          allow_smem(ssd_bwd_bc_kernel<Tin, N>,
                                     BcSmem<Tin>::TOTAL);
  if (attr) return attr;
  cudaError_t err;
  ssd_bwd_state_kernel<Tin, N><<<dim3(nc * NH, H, b), BT,
                                 StateSmem<Tin>::TOTAL, stream>>>(
      dy, C, cs, Q, s, H, L, nc, lt, bc_bs, bc_ts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_pass_kernel<N><<<dim3(PASS_BLOCKS, H, b), PASS_THREADS, 0,
                           stream>>>(cs, S, Q, dh, dh0, ghp, s, H, L, nc, lt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<Tin, N><<<nt * nc * b * groups, BT,
                                 ChunkSmem<Tin, N>::TOTAL, stream>>>(
      x, B, dt, D, dy, cb, cs, Q, dx, ddt, rowp, colp, vsum, dDp, dcbp, b, s,
      H, L, nc, nt, hpg, groups, x_bs, x_ts, bc_bs, bc_ts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dcb_kernel<<<dim3(nt * (nt + 1) / 2, nc, b), 256, 0, stream>>>(
      dcbp, dcb, s, L, nc, lt, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_bc_kernel<Tin, N><<<dim3(b * nc * nt, NH, 2 * bplan.shares), BT,
                              BcSmem<Tin>::TOTAL, stream>>>(
      x, B, C, dt, dy, cs, S, Q, dcb, bcp, carryp, b, s, H, L, nc, nt,
      bplan.hps, x_bs, x_ts, bc_bs, bc_ts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n4 = (long long)b * s * N / 4;
  ssd_bwd_bc_sum_kernel<Tin><<<(unsigned)((2 * n4 + 255) / 256), 256, 0,
                               stream>>>(bcp, static_cast<Tin*>(dBv),
                                         static_cast<Tin*>(dCv), n4,
                                         bplan.shares);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_finish_kernel<NH><<<dim3(nc, H, b), 32, 0, stream>>>(
      cs, rowp, colp, carryp, vsum, ghp, dt, A, ddt, dAp, s, H, L, nc, nt,
      PASS_BLOCKS);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_sum_kernel<<<1, 256, 0, stream>>>(dAp, dDp, dA, dD, b, s, H, L, nc,
                                            nt);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of scratch ssd_chunk_scan_bwd needs for these shapes and hpg
// heads a group
extern "C" long long ssd_chunk_scan_bwd_workspace(int n, int b, int s, int H,
                                                  int L, int hpg) {
  return Work(n, b, s, H, L, (H + hpg - 1) / hpg).total();
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and dx, dB, dC).  x, B and C as
// the forward takes them (strides x_bs, x_ts and bc_bs, bc_ts; rows
// 16-byte aligned); dt (b, s, H), A, D (H,), dy (b, s, H, P), dh and dh0
// (b, H, P, N; either may be null) f32 contiguous; cb, cs and S the
// forward's scratch after its call (S: the states entering the chunks);
// dx (b, s, H, P), dB, dC (b, s, N) contiguous in the input dtype; ddt (b,
// s, H), dA, dD (H,) f32; work ssd_chunk_scan_bwd_workspace floats,
// 16-byte aligned; hpg the heads a group of the chunk kernel takes
// (ssd_scan.bwd_plan).  P = 64, N 64 or 128, 1 <= L <= 256.  Launches the
// eight kernels on the stream; returns the first error (cudaError_t).
extern "C" int ssd_chunk_scan_bwd(int dtype, int n, const void* x,
                                  const void* B, const void* C,
                                  const float* dt, const float* A,
                                  const float* D, const float* dy,
                                  const float* dh, const float* cb,
                                  const float* cs, const float* S, void* dx,
                                  void* dB, void* dC, float* ddt, float* dA,
                                  float* dD, float* dh0, float* work, int b,
                                  int s, int H, int L, int hpg,
                                  long long x_bs, long long x_ts,
                                  long long bc_bs, long long bc_ts,
                                  cudaStream_t stream) {
  if (b <= 0 || s <= 0) return 0;
  if (L < 1 || L > MAX_L || (n != 64 && n != 128) || (dtype != 0 &&
                                                       dtype != 1) ||
      hpg < 1 || hpg > H)
    return (int)cudaErrorInvalidValue;
#define SSD_BWD_LAUNCH(Tin, N)                                              \
  return launch<Tin, N>(x, B, C, dt, A, D, dy, dh, cb, cs, S, dx, dB, dC,  \
                        ddt, dA, dD, dh0, work, b, s, H, L, hpg, x_bs, x_ts,\
                        bc_bs, bc_ts, stream)
  if (dtype == 1) {
    if (n == 64) SSD_BWD_LAUNCH(__nv_bfloat16, 64);
    SSD_BWD_LAUNCH(__nv_bfloat16, 128);
  }
  if (n == 64) SSD_BWD_LAUNCH(float, 64);
  SSD_BWD_LAUNCH(float, 128);
#undef SSD_BWD_LAUNCH
}
