// Grouped GEMM for the MoE experts, for Hopper.
//
// Replaces jax.lax.ragged_dot in the reference's moe_ragged
// (repro/models/moe.py:57, the three grouped matmuls at :64-67): x (M, K)
// holds the routed token copies sorted by expert, group_sizes (E,) int32
// (on the device) says how many rows each expert owns, in order, and w
// (E, K, N) holds the experts' weights; y[r] = x[r] @ w[e(r)] with f32
// accumulation, written in x's dtype.  Rows past the groups are written
// as 0; groups past row M are cut at M.  The host never reads the group
// sizes: the grid is sized by an upper bound of the row tiles, and each
// block finds its group from them on the device.
//
// Bound: at ds27b's append (M = 24,576 copies of 4,096 tokens, K 2,560,
// N 1,536) a projection is 193 GFLOP against ~0.2 GB of bytes, 0.20 ms
// of tensor-core peak: operations bound.  At an 8-slot decode (M = 48,
// most of the 72 groups empty) it reads each used expert's 7.9 MB once
// and does almost no arithmetic: bytes bound.
//
// bf16 design (gg_bf16_kernel): one block of 8 warps per (row tile of up
// to 128 rows of one group, column tile of 128).  Tiles never straddle a
// group, so each block multiplies by one expert's weights.  The block's
// row tile comes from the prefix of the groups' tile counts, walked by
// one thread over the E sizes; tiles past the groups cover the rows
// past them (written 0), and slots past those exit.  The grid has
// ceil(M / 128) + E + 1 row slots, enough for any sizes summing to at
// most M.  A and B tiles of 32-deep slices are copied by 16-byte
// cp.async into a 3-stage ring in shared memory (rows padded by 16
// bytes, so ldmatrix reads them without bank conflicts), and each warp
// multiplies a 64 x 32 sub-tile on the tensor cores with mma.sync
// m16n8k16 bf16 -> f32 (B through ldmatrix.trans, as flash's P.V takes
// V).  mma.sync rather than wgmma: a simple kernel that is right first,
// as for flash; the 64-row warpgroup product is left for later work.
// There is no split-K and no atomic: each output element is one
// thread's fixed-order sum, so two calls give the same bits.
//
// f32 design (gg_f32_kernel): scalar FMAs on 64 x 64 tiles, 16-deep
// slices staged in shared memory, each thread 4 x 4 outputs; the same
// tile lookup.  TF32 tensor cores would break the 2e-5 tolerance; the
// path serves the f32 identity check.
#include "attn_common.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

// The rows of row-tile slot t, for tiles of bm rows: (group, first row,
// rows).  Group -1: rows past the groups, to be zeroed; rows 0: nothing.
struct Tile {
  int e, row0, rows;
};

__device__ Tile find_tile(const int* __restrict__ gs, int n_groups, int m,
                          int t, int bm) {
  int cum = 0, off = 0;
  for (int e = 0; e < n_groups; ++e) {
    const int n = min(max(gs[e], 0), m - off);
    const int tiles = (n + bm - 1) / bm;
    if (t < cum + tiles) {
      const int r0 = off + (t - cum) * bm;
      return {e, r0, min(bm, off + n - r0)};
    }
    cum += tiles;
    off += n;
  }
  const int r0 = off + (t - cum) * bm;
  if (r0 < m) return {-1, r0, min(bm, m - r0)};
  return {-1, 0, 0};
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int LDA = BK + 8;            // shared row of an A tile, elements
constexpr int LDB = BN + 8;            // shared row of a B tile
constexpr int SMEM_BF16 = STAGES * (BM * LDA + BK * LDB) * (int)sizeof(bf16);

__global__ void __launch_bounds__(THREADS)
gg_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ y, const int* __restrict__ gs,
               int n_groups, int m, int k, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);    // STAGES x BM x LDA
  bf16* bs = as + STAGES * BM * LDA;               // STAGES x BK x LDB
  __shared__ Tile tile;
  if (threadIdx.x == 0) tile = find_tile(gs, n_groups, m, blockIdx.x, BM);
  __syncthreads();
  const int e = tile.e, row0 = tile.row0, rows = tile.rows;
  if (rows == 0) return;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (e < 0) {                           // rows past the groups
    for (int i = tid; i < rows * BN; i += THREADS) {
      const int r = i / BN, c = n0 + i % BN;
      if (c < n) y[(long long)(row0 + r) * n + c] = __float2bfloat16(0.f);
    }
    return;
  }
  const bf16* wb = w + (long long)e * k * n;
  const int wm = (warp >> 2) * 64;       // the warp's 64 rows
  const int wn = (warp & 3) * 32;        // and 32 columns

  auto load = [&](int kt, int stage) {
    const int k0 = kt * BK;
    bf16* ad = as + stage * BM * LDA;
    bf16* bd = bs + stage * BK * LDB;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + cc < k;
      cp_async16(ad + r * LDA + cc,
                 ok ? x + (long long)(row0 + r) * k + k0 + cc : x, ok);
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < k && n0 + cc < n;
      cp_async16(bd + r * LDB + cc,
                 ok ? wb + (long long)(k0 + r) * n + n0 + cc : w, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int n_kt = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();         // slice kt has landed
    __syncthreads();                     // and slice kt - 1 is consumed
    if (kt + STAGES - 1 < n_kt)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* at = as + (kt % STAGES) * BM * LDA;
    const bf16* bt = bs + (kt % STAGES) * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], at + (wm + mi * 16 + (lane & 15)) * LDA + kk * 16 +
                            ((lane >> 4) << 3));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_trans(bfr[nj],
                      bt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               LDB +
                          wn + nj * 16 + ((lane >> 4) << 3));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma_bf16(acc[mi][2 * nj], af[mi], bfr[nj][0], bfr[nj][1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[nj][2], bfr[nj][3]);
        }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + 2 * (lane & 3);
      if (c >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + (lane >> 2) + 8 * h;
        if (r < rows)
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)(row0 + r) * n +
                                             c) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                    acc[mi][ni][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(THREADS)
gg_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, const int* __restrict__ gs, int n_groups,
              int m, int k, int n) {
  __shared__ float at[FK][FM + 4];       // A slice, transposed
  __shared__ float bt[FK][FN];
  __shared__ Tile tile;
  if (threadIdx.x == 0) tile = find_tile(gs, n_groups, m, blockIdx.x, FM);
  __syncthreads();
  const int e = tile.e, row0 = tile.row0, rows = tile.rows;
  if (rows == 0) return;
  const int n0 = blockIdx.y * FN, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows 4 ty.., columns 4 tx..
  float acc[4][4] = {};
  if (e >= 0) {
    const float* wb = w + (long long)e * k * n;
    for (int k0 = 0; k0 < k; k0 += FK) {
      for (int i = tid; i < FM * FK; i += THREADS) {
        const int r = i / FK, kk = i % FK;
        at[kk][r] = r < rows && k0 + kk < k
                        ? x[(long long)(row0 + r) * k + k0 + kk] : 0.f;
      }
      for (int i = tid; i < FK * FN; i += THREADS) {
        const int kk = i / FN, c = i % FN;
        bt[kk][c] = k0 + kk < k && n0 + c < n
                        ? wb[(long long)(k0 + kk) * n + n0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = at[kk][4 * ty + i];
          b[i] = bt[kk][4 * tx + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      if (c < n) y[(long long)(row0 + r) * n + c] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 = float32 (scalar path), 1 = bfloat16 (tensor cores).  x (m, k)
// and y (m, n) row-major, w (n_groups, k, n) row-major, group_sizes
// (n_groups,) int32 on the device.  bf16 needs k and n multiples of 8 and
// 16-byte aligned x, w, y (the caller checks).  Returns the first launch
// error (cudaError_t), 0 on success.
extern "C" int grouped_gemm(int dtype, const void* x, const void* w, void* y,
                            const int* group_sizes, int n_groups, int m, int k,
                            int n, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n_groups <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (k % 8 || n % 8) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        gg_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BF16);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((m + BM - 1) / BM + n_groups + 1, (n + BN - 1) / BN);
    gg_bf16_kernel<<<grid, THREADS, SMEM_BF16, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), group_sizes, n_groups, m, k, n);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    dim3 grid((m + FM - 1) / FM + n_groups + 1, (n + FN - 1) / FN);
    gg_f32_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), group_sizes, n_groups, m, k, n);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
