// Grouped GEMM for the MoE experts, for Hopper.
//
// Replaces jax.lax.ragged_dot in the reference's moe_ragged
// (repro/models/moe.py:57, the three grouped matmuls at :64-67): x (M, K)
// holds the routed token copies sorted by expert, group_sizes (E,) int32
// (on the device) says how many rows each expert owns, in order, and w
// (E, K, N) holds the experts' weights; y[r] = x[r] @ w[e(r)] with f32
// accumulation, written in x's dtype.  Rows past the groups are written
// as 0; groups past row M are cut at M.  The host never reads the group
// sizes: the grid is sized from the shapes, and every block derives the
// tile list from the sizes on the device (walk_init / walk_tile, in
// gg_walk.cuh, shared with the backward's dX).
//
// The tile walk (both bf16 regimes): each group's rows are cut into row
// tiles of bm rows (128 in the append regime, 8 in the decode regime),
// the rows past the groups into tiles of their own (written 0), and
// every row tile into column tiles; tile t is (row tile t / n_ct, column
// tile t % n_ct), so a tile never straddles a group and neighbouring
// tiles share a group's rows and weights.  A persistent grid (one block
// per SM) walks t = blockIdx.x, += gridDim.x.  grouped_gemm.py keeps a
// plain-Python copy of the walk that the CPU tests check.
//
// Which regime: a pure function of the shapes (grouped_gemm.regime):
// decode when M <= 8 E, an average of at most 8 rows per expert, else
// append.  At ds27b (E 72) that is the 48-row decode against the
// 2,400-24,576-row appends.
//
// Bounds (ds27b, gate/up: K 2,560, N 1,536; bf16):
// * append, M = 24,576 copies of a 4,096-token prefill: x 0.126 GB, the
//   72 experts' w 0.566 GB and y 0.075 GB, 0.77 GB in all, 0.229 ms at
//   3.35 TB/s, against 193 GFLOP, 0.195 ms of tensor-core peak: bytes
//   bound, though barely, so the kernel has to run the tensor cores near
//   their rate and read each expert's weights from device memory once.
// * decode, M = 48 copies of 8 slots over ~38 of the 72 experts: the
//   used experts' w, 0.30 GB, 0.089 ms, and almost no arithmetic: bytes
//   bound; what counts is keeping every SM streaming distinct weight
//   bytes with enough of them in flight.
//
// Append design (gg_append_kernel): a 128 x 256 output tile, k-slices of
// 64.  Warp-specialised: warpgroup 0
// gives up registers (setmaxnreg 40) and one of its threads keeps TMA
// loads in flight through a ring of 4 slices (48 KB each, 192 KB)
// guarded by full/empty mbarriers; warpgroups 1 and 2 take
// 232 registers each and multiply rows 0-63 and 64-127 of the tile with
// wgmma m64n256k16 (bf16 -> f32, both operands from shared memory, 128-byte
// swizzled as TMA wrote them), keeping one slice's products in flight
// while the next slice's are issued.  x's tile (128 rows x 64, K-major)
// comes from a 2-D tensor map over x (M, K); w's (64 x 256, N contiguous,
// so B is MN-major and wgmma reads it through its transpose bit) from
// one 3-D tensor map over w (N, K, E) that serves every expert: boxes of
// 64 columns, 4 per slice.  Rows of the next group inside a tile
// are loaded and multiplied but never written; rows past M and columns
// past N are zero-filled by TMA.  A warpgroup whose 64 rows are all past
// the tile's rows skips its products.  What holds it back: every row tile
// streams its group's whole weight strip from L2, so a group of two row
// tiles, one of them nearly empty (the 1,697- and 2,399-token appends),
// pulls twice the strip for little work, and the kernel is then bound by
// L2-to-SM traffic; two CTAs of a cluster sharing the strip (TMA
// multicast) would halve it.
//
// Decode design (gg_decode_kernel): the roles are swapped so that no
// tile pads to 128 token rows: y[e]^T = w[e]^T x[e]^T, the expert's
// columns on the M side of mma.sync m16n8k16 and up to 8 token rows on
// its N side.  A work unit is (8-row chunk of one group, 64 columns);
// units exist only for rows that exist, so unused experts cost no weight
// read.  One producer warp streams each unit's 64 x 64 weight boxes (8
// KB, the same tensor map) and its 8 x 64 token box (1 KB) through a
// 16-stage ring (147 KB in flight per SM), running ahead across unit
// boundaries; 4 consumer warps each own 16 of the unit's columns
// (ldmatrix.trans of the swizzled weight box, ldmatrix of the token box).
//
// Both: no split-K and no atomic: each output element is one thread's
// fixed-order sum, so two calls give the same bits.  The weights' tensor
// maps are cached on the host by (pointer, E, K, N); x's is encoded per
// call (cuTensorMapEncodeTiled, fetched from the CUDA driver through the
// runtime: no -lcuda).
//
// f32 design (gg_f32_kernel): scalar FMAs on 64 x 64 tiles, 16-deep
// slices staged in shared memory, each thread 4 x 4 outputs; one block
// per row-tile slot of the same walk (column tiles on the grid's y).  TF32 tensor cores would
// break the 2e-5 tolerance; the path serves the f32 identity check.
#include "attn_common.cuh"
#include "gg_walk.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;
using namespace gg;
using namespace hopper;
using bf16 = __nv_bfloat16;

// rows past the groups: y[row0 .. row0 + rows, c0 .. c0 + cols) = 0
// (cols a multiple of 8, y rows 16-byte aligned)
__device__ void zero_tile(bf16* __restrict__ y, int row0, int rows, int c0,
                          int cols, int n, int tid, int n_threads) {
  const int chunks = cols / 8;
  for (int i = tid; i < rows * chunks; i += n_threads) {
    const int r = i / chunks, c = c0 + (i % chunks) * 8;
    *reinterpret_cast<uint4*>(y + (long long)(row0 + r) * n + c) =
        make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// append: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int A_THREADS = 384;           // producer warpgroup + 2 consumers
constexpr int A_BYTES = BM * BK * 2;     // x: 128 rows x 128 B
constexpr int A_STAGE = A_BYTES + BK * BN * 2;   // + w: 4 boxes of 64 cols
constexpr int A_SMEM = STAGES * A_STAGE + 1024;

__global__ void __launch_bounds__(A_THREADS, 1)
gg_append_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 bf16* __restrict__ y, const int* __restrict__ gs,
                 int n_groups, int m, int k, int n) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __shared__ Walk walk;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int tid = threadIdx.x;
  walk_init(walk, gs, n_groups, m, BM);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);           // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_ct = (n + BN - 1) / BN, n_kt = (k + BK - 1) / BK;
  const int total = walk_tiles(walk, n_groups, m, BM, n_ct);

  if (tid < 128) {                       // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tl = walk_tile(walk, n_groups, m, BM, n_ct, t);
        if (tl.e < 0) continue;
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], ph ^ 1);
          mbar_expect_tx(&full[stage], A_STAGE);
          unsigned char* sa = smem + stage * A_STAGE;
          tma_load_2d(sa, &tx, kt * BK, tl.row0, &full[stage]);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load_3d(sa + A_BYTES + h * 8192, &tw, tl.ct * BN + h * 64,
                        kt * BK, tl.e, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = (tid >> 7) - 1;          // rows c * 64 .. + 64 of a tile
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  int stage = 0;
  uint32_t ph = 0;
  float acc[BN / 2];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = walk_tile(walk, n_groups, m, BM, n_ct, t);
    const int n0 = tl.ct * BN;
    if (tl.e < 0) {
      zero_tile(y, tl.row0, tl.rows, n0, min(BN, n - n0), n, tid - 128, 256);
      continue;
    }
    const bool active = c * 64 < tl.rows;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < n_kt; ++kt) {
      mbar_wait(&full[stage], ph);
      if (active) {
        const uint32_t sa = smem_addr(smem + stage * A_STAGE);
        const uint64_t da = sw128_desc(sa + c * 8192, 16, 1024);
        const uint64_t db = sw128_desc(sa + A_BYTES, 8192, 1024);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)   // 32 bytes of x's rows, 16
          wgmma_m64n256<0, 1>(acc, da + 2 * kk,  // rows (2 KB) of w's
                              db + 128 * kk);    // boxes
        wgmma_commit();
        wgmma_wait<1>();                 // the previous slice's products
        fence_acc(acc);
      }
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        ph ^= 1;
      }
    }
    if (active) {
      wgmma_wait<0>();
      fence_acc(acc);
    }
    if (lane == 0) mbar_arrive(&empty[prev]);
    if (!active) continue;
    // accumulator layout: d[4 j + i] is row warp * 16 + lane / 4 + 8 (i / 2)
    // and column 8 j + 2 (lane % 4) + i % 2 of the warpgroup's 64 x BN
    const int r_lo = c * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        if (r < tl.rows)
          *reinterpret_cast<__nv_bfloat162*>(
              y + (long long)(tl.row0 + r) * n + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode: swapped roles, mma.sync
// ---------------------------------------------------------------------------

constexpr int D_BM = 8, D_BN = 64, D_STAGES = 16;
constexpr int D_W = BK * D_BN * 2;       // 8 KB: 64 k-rows x 64 columns
constexpr int D_STAGE = D_W + D_BM * BK * 2;   // + 1 KB: 8 tokens x 64 k
constexpr int D_SMEM = D_STAGES * D_STAGE + 1024;
constexpr int D_THREADS = 160;           // 4 consumer warps + a producer

__global__ void __launch_bounds__(D_THREADS, 1)
gg_decode_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 bf16* __restrict__ y, const int* __restrict__ gs,
                 int n_groups, int m, int k, int n) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __shared__ Walk walk;
  __shared__ __align__(8) uint64_t full[D_STAGES], empty[D_STAGES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  walk_init(walk, gs, n_groups, m, D_BM);
  if (tid == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_ct = (n + D_BN - 1) / D_BN, n_kt = (k + BK - 1) / BK;
  const int total = walk_tiles(walk, n_groups, m, D_BM, n_ct);

  if (warp == 4) {                       // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tl = walk_tile(walk, n_groups, m, D_BM, n_ct, t);
        if (tl.e < 0) continue;
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], ph ^ 1);
          mbar_expect_tx(&full[stage], D_STAGE);
          unsigned char* sw = smem + stage * D_STAGE;
          tma_load_3d(sw, &tw, tl.ct * D_BN, kt * BK, tl.e, &full[stage]);
          tma_load_2d(sw + D_W, &tx, kt * BK, tl.row0, &full[stage]);
          if (++stage == D_STAGES) {
            stage = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  int stage = 0;
  uint32_t ph = 0;
  // ldmatrix rows: the weight box's k-row and 16-byte chunk for A
  // (.trans: matrix i = lane / 8 is k-half i / 2, column half i % 2 of
  // the warp's 16 columns), the token box's row for B
  const int mi = lane >> 3, mr = lane & 7;
  const int a_chunk = 2 * warp + (mi & 1);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = walk_tile(walk, n_groups, m, D_BM, n_ct, t);
    const int n0 = tl.ct * D_BN;
    if (tl.e < 0) {
      zero_tile(y, tl.row0, tl.rows, n0, min(D_BN, n - n0), n, tid, 128);
      continue;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kt = 0; kt < n_kt; ++kt) {
      mbar_wait(&full[stage], ph);
      const unsigned char* sw = smem + stage * D_STAGE;
      const unsigned char* sx = sw + D_W;
#pragma unroll
      for (int k2 = 0; k2 < BK / 32; ++k2) {
        uint32_t b[4];                   // tokens x k 32 k2 .. + 32
        ldsm_x4(b, sx + mr * 128 + (((4 * k2 + mi) ^ mr) << 4));
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int kr = (2 * k2 + s) * 16 + mr + ((mi >> 1) << 3);
          uint32_t a[4];
          ldsm_x4_trans(a, sw + kr * 128 + ((a_chunk ^ (kr & 7)) << 4));
          mma_bf16(acc, a, b[2 * s], b[2 * s + 1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == D_STAGES) {
        stage = 0;
        ph ^= 1;
      }
    }
    // acc: columns g and g + 8 of the warp's 16, tokens 2 q and 2 q + 1
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = n0 + 16 * warp + g + 8 * (i >> 1);
      const int tok = 2 * q + (i & 1);
      if (tok < tl.rows && col < n)
        y[(long long)(tl.row0 + tok) * n + col] = __float2bfloat16(acc[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
gg_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, const int* __restrict__ gs, int n_groups,
              int m, int k, int n) {
  __shared__ float at[FK][FM + 4];       // A slice, transposed
  __shared__ float bt[FK][FN];
  __shared__ Walk walk;
  walk_init(walk, gs, n_groups, m, FM);
  if ((int)blockIdx.x >= walk_tiles(walk, n_groups, m, FM, 1)) return;
  const Tile tile = walk_tile(walk, n_groups, m, FM, 1, blockIdx.x);
  const int e = tile.e, row0 = tile.row0, rows = tile.rows;
  const int n0 = blockIdx.y * FN, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows 4 ty.., columns 4 tx..
  float acc[4][4] = {};
  if (e >= 0) {
    const float* wb = w + (long long)e * k * n;
    for (int k0 = 0; k0 < k; k0 += FK) {
      for (int i = tid; i < FM * FK; i += F_THREADS) {
        const int r = i / FK, kk = i % FK;
        at[kk][r] = r < rows && k0 + kk < k
                        ? x[(long long)(row0 + r) * k + k0 + kk] : 0.f;
      }
      for (int i = tid; i < FK * FN; i += F_THREADS) {
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

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

namespace {

template <typename K>
cudaError_t smem_attr(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// dtype: 0 = float32 (scalar path), 1 = bfloat16 (tensor cores); regime
// (bf16 only): 0 = append, 1 = decode (grouped_gemm.regime).  x (m, k)
// and y (m, n) row-major, w (n_groups, k, n) row-major, group_sizes
// (n_groups,) int32 on the device; n_sm: the card's SMs (the persistent
// grid).  At most 512 groups; bf16 needs k and n multiples of 8 and
// 16-byte aligned x, w, y (the caller checks).  Returns the first launch
// error (cudaError_t), 0 on success.
extern "C" int grouped_gemm(int dtype, int regime, const void* x,
                            const void* w, void* y, const int* group_sizes,
                            int n_groups, int m, int k, int n, int n_sm,
                            cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n_groups <= 0 || n_groups > MAX_GROUPS || k <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (k % 8 || n % 8 || n_sm <= 0 || (regime != 0 && regime != 1))
      return (int)cudaErrorInvalidValue;
    CUtensorMap tw, tx;
    const int bm = regime == 0 ? BM : D_BM;
    const uint64_t xdims[2] = {(uint64_t)k, (uint64_t)m};
    const uint64_t xstride[1] = {(uint64_t)k * 2};
    const uint32_t xbox[2] = {(uint32_t)BK, (uint32_t)bm};
    // w (E, K, N) as a 3-D map (N, K, E) of 64 x 64 boxes, fixed per
    // layer: cached
    const uint64_t wdims[3] = {(uint64_t)n, (uint64_t)k, (uint64_t)n_groups};
    const uint64_t wstride[2] = {(uint64_t)n * 2, (uint64_t)k * n * 2};
    const uint32_t wbox[3] = {64, (uint32_t)BK, 1};
    if (!bf16_map_cached(&tw, w, wdims, wstride, wbox) ||
        !bf16_map(&tx, x, 2, xdims, xstride, xbox))
      return (int)cudaErrorInvalidValue;
    const int bn = regime == 0 ? BN : D_BN;
    const long long slots =
        (long long)((m + bm - 1) / bm + n_groups + 1) * ((n + bn - 1) / bn);
    const int grid = (int)(slots < n_sm ? slots : n_sm);
    const auto yb = static_cast<bf16*>(y);
    if (regime == 0) {
      static const cudaError_t attr = smem_attr(gg_append_kernel, A_SMEM);
      if (attr != cudaSuccess) return (int)attr;
      gg_append_kernel<<<grid, A_THREADS, A_SMEM, stream>>>(
          tx, tw, yb, group_sizes, n_groups, m, k, n);
    } else {
      static const cudaError_t attr = smem_attr(gg_decode_kernel, D_SMEM);
      if (attr != cudaSuccess) return (int)attr;
      gg_decode_kernel<<<grid, D_THREADS, D_SMEM, stream>>>(
          tx, tw, yb, group_sizes, n_groups, m, k, n);
    }
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    dim3 grid((m + FM - 1) / FM + n_groups + 1, (n + FN - 1) / FN);
    gg_f32_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), group_sizes, n_groups, m, k, n);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
