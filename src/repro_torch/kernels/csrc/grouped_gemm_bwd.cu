// The grouped GEMM's backward, for Hopper.
//
// The gradient of y[r] = x[r] @ w[e(r)] (grouped_gemm.cu) for the
// cotangent dy (M, N): dx[r] = dy[r] @ w[e(r)]^T (M, K), rows past the
// groups 0, and dw[e] = x_e^T @ dy_e (E, K, N) over group e's rows, 0 for
// an empty group.  No Pallas kernel has this role: the reference trains
// its MoE through XLA's transpose of jax.lax.ragged_dot
// (repro/models/moe.py:64-67), as flash_attention_bwd.cu stands for XLA
// differentiating the jnp attention.  The host never reads the group
// sizes: both grids are sized from the shapes, and each block derives
// its group's rows from the sizes on the device (gg_walk.cuh).
//
// Bounds (granite-moe-3b-a800m's training microbatch, 2 x 1023 tokens,
// top-8 of 40: M 16,368; gate/up K 1,536 -> N 512; bf16): dX is 25.7
// GFLOP, 26 us of tensor-core peak, against dY 16.8 MB, the 40 experts'
// w 62.9 MB and dX 50.3 MB, 39 us at 3.35 TB/s; dW the same products
// against x 50.3 MB, dY 16.8 MB and dW 62.9 MB: both bound by bytes,
// though barely, so the kernels have to keep the tensor cores near their
// rate.
//
// Design: both products on mma.sync m16n8k16 (bf16 -> f32), a 128 x 128
// output tile per block of 8 warps (2 x 4, 64 x 32 each), reduction
// slices of 64 staged by cp.async through a ring of 3 stages (96 KB; two
// blocks an SM),
// every 64-column panel of a tile in shared memory with its 16-byte
// chunks swizzled by row (chunk ^ (row & 7)), so ldmatrix reads without
// bank conflicts, plain or transposed.
// * dX: the forward's tile walk over dY's rows (128-row tiles, columns of
//   K on the grid's y); A is dY's tile (rows x N, reduction-contiguous:
//   ldmatrix), B is w[e] read as it lies: stored (K, N) row-major, each
//   column of w[e]^T is a row of w[e], already reduction-contiguous for
//   mma.sync's B operand (ldmatrix without .trans).  w is never
//   transposed in memory.  Rows past the groups are written 0.
// * dW: one block per (expert, K tile, N tile) that walks its group's
//   rows in slices of 64, in order.  A = x_e^T and B = dy_e are both
//   stored rows x columns, so both load with ldmatrix.trans.  No split
//   over the rows and no float atomics: every element is one thread's
//   fixed-order sum, so two calls give the same bits.  An empty group's
//   blocks write a zero tile.
// * float32: scalar FMAs on 64 x 64 tiles, 16-deep slices in shared
//   memory, each thread 4 x 4 outputs, the same walks (TF32 tensor cores
//   would break the 2e-5 tolerance; the path serves the f32 checks).
// What holds it back: mma.sync reaches a fraction of wgmma's rate, and a
// group's last row tile (dX) or slice (dW) is partly padding.
#include "attn_common.cuh"
#include "gg_walk.cuh"

namespace {

using namespace attn;
using namespace gg;
using bf16 = __nv_bfloat16;

constexpr int BT = 128;                  // output tile: rows and columns
constexpr int BK = 64;                   // reduction slice
constexpr int STAGES = 3;
constexpr int THREADS = 256;             // 8 warps, 2 x 4 over the tile
constexpr int PANEL = 64 * 128;          // 64 rows of 64 bf16 (8 KB)
constexpr int STAGE = 4 * PANEL;         // A and B: 32 KB
constexpr int SMEM = STAGES * STAGE;
// blocks an SM: two, each 96 KB of ring and at most 128 registers a
// thread (dX alone took 136 and one block an SM, 24 % slower)
constexpr int MIN_BLOCKS = 2;

// byte offset of 16-byte chunk c of row r in a panel (64 columns a row)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// R rows of 64 columns into a panel: row r from src + r * ld, columns
// col0 .. col0 + 64; zero where r >= rows or a chunk starts at or past
// cols (cols a multiple of 8).  src must be a valid address.
template <int R>
__device__ __forceinline__ void load_panel(unsigned char* panel,
                                           const bf16* src, long long ld,
                                           int rows, int col0, int cols,
                                           int tid) {
#pragma unroll
  for (int i = tid; i < R * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < rows && col0 + 8 * c < cols;
    cp_async16(panel + swz(r, c),
               ok ? src + (long long)r * ld + col0 + 8 * c : src, ok);
  }
}

// the warp's 64 x 32 of the tile, one 16-deep step of the reduction:
// A fragments of rows wm * 64 + 16 mi, B fragments of columns wn * 32 +
// 8 ni.  TA / TB: the operand is stored reduction-major (rows of the
// reduction, ldmatrix.trans) in 64-column panels, else reduction-
// contiguous (one panel of 128 rows).
template <bool TA, bool TB>
__device__ __forceinline__ void mma_step(float (&acc)[4][4][4],
                                         const unsigned char* sa,
                                         const unsigned char* sb, int kk,
                                         int wm, int wn, int lane) {
  const int i = lane >> 3, r8 = lane & 7;
  uint32_t a[4][4], b[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (TA) {                            // stored [k][m]: panel wm
      const int r = kk * 16 + r8 + ((i >> 1) << 3);
      ldsm_x4_trans(a[mi], sa + wm * PANEL + swz(r, 2 * mi + (i & 1)));
    } else {                             // stored [m][k]
      const int r = wm * 64 + mi * 16 + (lane & 15);
      ldsm_x4(a[mi], sa + swz(r, 2 * kk + (lane >> 4)));
    }
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    uint32_t t[4];
    if (TB) {                            // stored [k][n]: panel wn / 2
      const int r = kk * 16 + r8 + ((i & 1) << 3);
      ldsm_x4_trans(t, sb + (wn >> 1) * PANEL +
                           swz(r, 4 * (wn & 1) + 2 * nj + (i >> 1)));
    } else {                             // stored [n][k]
      const int r = wn * 32 + nj * 16 + r8 + ((i >> 1) << 3);
      ldsm_x4(t, sb + swz(r, 2 * kk + (i & 1)));
    }
    b[2 * nj][0] = t[0];
    b[2 * nj][1] = t[1];
    b[2 * nj + 1][0] = t[2];
    b[2 * nj + 1][1] = t[3];
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0],
                                            b[ni][1]);
}

// the warp's accumulators as bf16 into out (row stride ld) at tile
// origin (r0, c0): rows below rows, columns below cols (even)
__device__ __forceinline__ void store_tile(const float (&acc)[4][4][4],
                                           bf16* __restrict__ out,
                                           long long ld, int rows, int c0,
                                           int cols, int wm, int wn,
                                           int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 64 + mi * 16 + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = c0 + wn * 32 + ni * 8 + 2 * q;
        if (c < cols)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * ld + c) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                    acc[mi][ni][2 * h + 1]);
      }
    }
}

// dx (m, k) = dy (m, n) . w[e]^T over the walk's 128-row tiles of dy
// (blockIdx.x) and 128-column tiles of dx (blockIdx.y)
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gg_bwd_dx_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, const int* __restrict__ gs,
                 int n_groups, int m, int k, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Walk walk;
  walk_init(walk, gs, n_groups, m, BT);
  if ((int)blockIdx.x >= walk_tiles(walk, n_groups, m, BT, 1)) return;
  const Tile tl = walk_tile(walk, n_groups, m, BT, 1, blockIdx.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, c0 = blockIdx.y * BT;
  bf16* out = dx + (long long)tl.row0 * k;
  if (tl.e < 0) {                        // rows past the groups
    const int chunks = min(BT, k - c0) / 8;
    for (int i = tid; i < tl.rows * chunks; i += THREADS)
      *reinterpret_cast<uint4*>(out + (long long)(i / chunks) * k + c0 +
                                8 * (i % chunks)) = make_uint4(0, 0, 0, 0);
    return;
  }
  const bf16* a_src = dy + (long long)tl.row0 * n;
  const bf16* b_src = w + ((long long)tl.e * k + c0) * n;
  const int b_rows = min(BT, k - c0), n_kt = (n + BK - 1) / BK;
  const auto load = [&](int kt) {
    unsigned char* st = smem + (kt % STAGES) * STAGE;
    load_panel<BT>(st, a_src, n, tl.rows, kt * BK, n, tid);
    load_panel<BT>(st + 2 * PANEL, b_src, n, b_rows, kt * BK, n, tid);
  };
  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_kt) load(kt + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kt % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_step<false, false>(acc, st, st + 2 * PANEL, kk, wm, wn, lane);
  }
  store_tile(acc, out, k, tl.rows, c0, k, wm, wn, lane);
}

// dw[e] (k, n) = x_e^T . dy_e over group e = blockIdx.y's rows, in
// slices of 64 rows; blockIdx.x the 128 x 128 tile of dw[e]
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gg_bwd_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 bf16* __restrict__ dw, const int* __restrict__ gs,
                 int n_groups, int m, int k, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Walk walk;
  walk_init(walk, gs, n_groups, m, BK);
  const int e = blockIdx.y, n_ct = (n + BT - 1) / BT;
  const int k0 = (blockIdx.x / n_ct) * BT, n0 = (blockIdx.x % n_ct) * BT;
  const int off = walk.off[e], rows = walk.off[e + 1] - off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n_kt = (rows + BK - 1) / BK;
  const auto load = [&](int kt) {
    unsigned char* st = smem + (kt % STAGES) * STAGE;
    const long long r0 = off + kt * BK;
    const int left = rows - kt * BK;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      load_panel<BK>(st + p * PANEL, x + r0 * k, k, left, k0 + 64 * p, k,
                     tid);
      load_panel<BK>(st + (2 + p) * PANEL, dy + r0 * n, n, left,
                     n0 + 64 * p, n, tid);
    }
  };
  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_kt) load(kt + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kt % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_step<true, true>(acc, st, st + 2 * PANEL, kk, wm, wn, lane);
  }
  store_tile(acc, dw + ((long long)e * k + k0) * n, n, k - k0, n0, n, wm,
             wn, lane);
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16, F_THREADS = 256;

// acc[i][j] += sum over the slice of at[kk][4 ty + i] * bt[kk][4 tx + j]
__device__ __forceinline__ void f32_step(float (&acc)[4][4],
                                         const float (&at)[FK][FM + 4],
                                         const float (&bt)[FK][FN + 4],
                                         int ty, int tx) {
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
}

__device__ __forceinline__ void f32_store(const float (&acc)[4][4],
                                          float* __restrict__ out,
                                          long long ld, int rows, int c0,
                                          int cols, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < cols) out[(long long)r * ld + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
gg_bwd_dx_f32_kernel(const float* __restrict__ dy,
                     const float* __restrict__ w, float* __restrict__ dx,
                     const int* __restrict__ gs, int n_groups, int m, int k,
                     int n) {
  __shared__ float at[FK][FM + 4];       // dy's slice, transposed
  __shared__ float bt[FK][FN + 4];       // w[e]'s rows, transposed
  __shared__ Walk walk;
  walk_init(walk, gs, n_groups, m, FM);
  if ((int)blockIdx.x >= walk_tiles(walk, n_groups, m, FM, 1)) return;
  const Tile tl = walk_tile(walk, n_groups, m, FM, 1, blockIdx.x);
  const int c0 = blockIdx.y * FN, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  if (tl.e >= 0) {
    const float* wb = w + (long long)tl.e * k * n;
    for (int j0 = 0; j0 < n; j0 += FK) {
      for (int i = tid; i < FM * FK; i += F_THREADS) {
        const int r = i / FK, kk = i % FK;
        at[kk][r] = r < tl.rows && j0 + kk < n
                        ? dy[(long long)(tl.row0 + r) * n + j0 + kk] : 0.f;
        bt[kk][r] = c0 + r < k && j0 + kk < n
                        ? wb[(long long)(c0 + r) * n + j0 + kk] : 0.f;
      }
      __syncthreads();
      f32_step(acc, at, bt, ty, tx);
      __syncthreads();
    }
  }
  f32_store(acc, dx + (long long)tl.row0 * k, k, tl.rows, c0, k, ty, tx);
}

__global__ void __launch_bounds__(F_THREADS)
gg_bwd_dw_f32_kernel(const float* __restrict__ x,
                     const float* __restrict__ dy, float* __restrict__ dw,
                     const int* __restrict__ gs, int n_groups, int m, int k,
                     int n) {
  __shared__ float at[FK][FM + 4];       // x's rows
  __shared__ float bt[FK][FN + 4];       // dy's rows
  __shared__ Walk walk;
  walk_init(walk, gs, n_groups, m, FK);
  const int e = blockIdx.y, n_ct = (n + FN - 1) / FN;
  const int k0 = (blockIdx.x / n_ct) * FM, n0 = (blockIdx.x % n_ct) * FN;
  const int off = walk.off[e], rows = walk.off[e + 1] - off;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int r0 = 0; r0 < rows; r0 += FK) {
    for (int i = tid; i < FK * FM; i += F_THREADS) {
      const int kk = i / FM, c = i % FM;
      const long long r = off + r0 + kk;
      const bool in = r0 + kk < rows;
      at[kk][c] = in && k0 + c < k ? x[r * k + k0 + c] : 0.f;
      bt[kk][c] = in && n0 + c < n ? dy[r * n + n0 + c] : 0.f;
    }
    __syncthreads();
    f32_step(acc, at, bt, ty, tx);
    __syncthreads();
  }
  f32_store(acc, dw + ((long long)e * k + k0) * n, n, k - k0, n0, n, ty,
            tx);
}

}  // namespace

// dtype: 0 = float32 (scalar path), 1 = bfloat16 (tensor cores).  x (m,
// k), dy (m, n), dx (m, k) row-major, w and dw (n_groups, k, n)
// row-major, group_sizes (n_groups,) int32 on the device.  dx or dw null:
// that gradient is not computed (one launch, else two, dX first).  At
// most 512 groups; bf16 needs k and n multiples of 8 and 16-byte aligned
// x, w, dy, dx, dw (the caller checks).  Returns the first launch error
// (cudaError_t), 0 on success.
extern "C" int grouped_gemm_bwd(int dtype, const void* x, const void* w,
                                const void* dy, void* dx, void* dw,
                                const int* group_sizes, int n_groups, int m,
                                int k, int n, cudaStream_t stream) {
  if (n_groups <= 0 || n_groups > MAX_GROUPS || k <= 0 || n <= 0 || m < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (k % 8 || n % 8) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr[2] = {
        cudaFuncSetAttribute(gg_bwd_dx_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM),
        cudaFuncSetAttribute(gg_bwd_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM)};
    for (cudaError_t a : attr)
      if (a != cudaSuccess) return (int)a;
    if (dx && m > 0) {
      dim3 grid((m + BT - 1) / BT + n_groups + 1, (k + BT - 1) / BT);
      gg_bwd_dx_kernel<<<grid, THREADS, SMEM, stream>>>(
          static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
          static_cast<bf16*>(dx), group_sizes, n_groups, m, k, n);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (dw) {
      dim3 grid(((k + BT - 1) / BT) * ((n + BT - 1) / BT), n_groups);
      gg_bwd_dw_kernel<<<grid, THREADS, SMEM, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
          static_cast<bf16*>(dw), group_sizes, n_groups, m, k, n);
    }
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    if (dx && m > 0) {
      dim3 grid((m + FM - 1) / FM + n_groups + 1, (k + FN - 1) / FN);
      gg_bwd_dx_f32_kernel<<<grid, F_THREADS, 0, stream>>>(
          static_cast<const float*>(dy), static_cast<const float*>(w),
          static_cast<float*>(dx), group_sizes, n_groups, m, k, n);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (dw) {
      dim3 grid(((k + FM - 1) / FM) * ((n + FN - 1) / FN), n_groups);
      gg_bwd_dw_f32_kernel<<<grid, F_THREADS, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(dy),
          static_cast<float*>(dw), group_sizes, n_groups, m, k, n);
    }
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
