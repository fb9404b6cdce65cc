// The grouped GEMM's backward, for Hopper.
//
// The gradient of y[r] = x[r] @ w[e(r)] (grouped_gemm.cu) for the
// cotangent dy (M, N): dx[r] = dy[r] @ w[e(r)]^T (M, K), rows past the
// groups 0, and dw[e] = x_e^T @ dy_e (E, K, N) over group e's rows, 0 for
// an empty group.  No Pallas kernel has this role: the reference trains
// its MoE through XLA's transpose of jax.lax.ragged_dot
// (repro/models/moe.py:64-67), as flash_attention_bwd.cu stands for XLA
// differentiating the jnp attention.  The host never reads the group
// sizes: the grid is sized from the shapes, and every block derives the
// work list from the sizes on the device (gg_walk.cuh).
//
// Bounds (granite-moe-3b-a800m's training microbatch, 2 x 1023 tokens,
// top-8 of 40: M 16,368; gate/up K 1,536 -> N 512; bf16): dX is 25.7
// GFLOP, 26 us of tensor-core peak, against dY 16.8 MB, the 40 experts'
// w 62.9 MB and dX 50.3 MB, 39 us at 3.35 TB/s; dW the same products
// against x 50.3 MB, dY 16.8 MB and dW 62.9 MB; the call, dY read once,
// 243 MB and 51.5 GFLOP: 73 us, bound by bytes, though barely, so the
// kernel has to keep the tensor cores near their rate.  At llama4's
// 4,096-token prefill (128 experts, ~32 rows a group) dW is its 10.7 GB
// write.
//
// Design (bf16): one persistent, warp-specialised launch, in the shape of
// the forward's append regime.  One block an SM walks a work list,
// item t = blockIdx.x, += gridDim.x: first dW's units, then dX's tiles,
// so dX's work fills dW's last wave (bwd_work in grouped_gemm.py is its
// plain-Python copy, which the CPU tests check; dX first left llama4's
// prefill ~5 % slower, its read-bound and write-bound halves meeting
// worse).  Warpgroup 0 gives up
// registers and one of its threads keeps TMA loads in flight through a
// ring of 4 stages of 48 KB (full/empty mbarriers), running ahead across
// items; warpgroups 1 and 2 take 232 registers each and own 64 rows of
// the item's 128 x 256 output tile, running wgmma m64n256k16 (bf16 ->
// f32, both operands from 128-byte-swizzled shared memory as TMA wrote
// them), one slice's products in flight while the next slice's are
// issued.  Every operand is a 64 x 64 TMA box (8 KB): a stage is A's two
// boxes (one per warpgroup) and B's four.  ptxas keeps wgmma asynchronous
// only if every branch around it is warp-uniform to the compiler, which
// cannot see that values read from shared memory, or taken from
// threadIdx per warpgroup, are: so the consumers broadcast them from lane
// 0 (uniform(), __shfl_sync), walk dX's tiles and dW's units in two
// loops, each with one fixed wgmma, put an idle warpgroup's hand-backs in
// a branch of their own, and wait and hand back through barriers whose
// loop or predicate lies inside the asm.  Without that ptxas serialises
// the products (C7520; the forward's append kernel still reads C7518).
// * dX, a tile of the forward's walk (128 dY rows of one group, 256
//   columns of dx), reduction over N in slices of 64: A is dY's rows
//   (N contiguous: K-major), B is w[e] read as it lies, (K, N) row-major,
//   so a column of w[e]^T is a row of w[e], N contiguous: K-major too.
//   Neither transpose bit, and w's 3-D map (N, K, E) is the forward's,
//   cached on the host.  A warpgroup whose 64 rows all lie past the
//   group skips its products and its half of A is not loaded.  Rows past
//   the groups are written 0.
// * dW, a unit (expert e, 128 rows of K, 256 columns of N) that walks
//   group e's rows in slices of 64, in order: A = x_e^T and B = dy_e are
//   both stored rows x columns, so both are MN-major (both transpose
//   bits).  A box is cut by the tensor's edge, not the group's, so the
//   slice holding a group's last rows also holds the next group's first:
//   each warpgroup zeroes those rows of its own A box (predicated
//   stores), fences the async proxy (wgmma reads shared memory through
//   it) and meets its other warps on a named barrier before the products.
//   Zeroed rows of x contribute exact zeros as long as dy is finite
//   there.
// * Epilogue: each warpgroup rounds its 64 x 256 accumulators to bf16
//   once, a 64 x 64 box at a time, into an 8 KB buffer of its own in
//   TMA's swizzled layout, and one thread stores the box with TMA (the
//   tensor's edge clips it); the last box drains while the next item's
//   products run, and a store is waited for (bulk wait_group.read) only
//   before the buffer is written again.  One box, not the whole 32 KB,
//   leaves room for a fourth stage.  dX's half-tiles past a group's last
//   row are copied out with 16-byte stores, row by row, instead.
// * Determinism: no split over the reduction and no atomics; each output
//   element is one thread's sum in a fixed order, whichever block takes
//   its item, so two calls give the same bits.
// * float32: scalar FMAs on 64 x 64 tiles, 16-deep slices in shared
//   memory, each thread 4 x 4 outputs, two launches over the same walks
//   (TF32 tensor cores would break the 2e-5 tolerance; the path serves
//   the f32 checks).
// What holds it back: the card's power.  Unserialised, its products
// hold the SM clock at ~1.5-1.6 GHz at 700 W, where the tensor peak is
// ~830 TFLOP/s, and granite's and ds27b's calls issue their products
// (padding included) at ~60-70 % of that.
// The two consumer warpgroups share one tile, so its epilogue stalls
// their products (the loads run on); every group's last row tile (dX) or
// slice (dW) multiplies padding; dW at ~32 rows a group (llama4) writes
// dw at ~74 % of a plain write's rate.  A pair of CTAs sharing an operand
// by TMA multicast (a third fewer L2 bytes per product) was 5-7 % slower.
#include <cuda_bf16.h>

#include "gg_walk.cuh"
#include "hopper.cuh"

namespace {

using namespace gg;
using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;                  // tile rows: two warpgroups of 64
constexpr int BN = 256;                  // tile columns
constexpr int BK = 64;                   // reduction slice
constexpr int STAGES = 4;
constexpr int THREADS = 384;             // producer warpgroup + 2 consumers
constexpr int BOX = 64 * 128;            // a 64 x 64 bf16 TMA box
constexpr int A_BYTES = 2 * BOX;         // A: a box per consumer
constexpr int STAGE = A_BYTES + 4 * BOX;  // + B: four boxes of 64 columns
// the ring, a box buffer for each consumer's stores, alignment slack
constexpr int SMEM = STAGES * STAGE + 2 * BOX + 1024;

// item t of the work list (the first n_w dW's): a dW unit (dw true) of
// dw[e] rows [c0, c0 + BM) and columns [n0, n0 + BN) over group e's rows
// [r0, r0 + rows), or a dX tile (dw false; e -1 for rows past the groups,
// to be zeroed) of rows [r0, r0 + rows) and dx columns [c0, c0 + BN);
// `slices` reduction slices of BK
struct Item {
  bool dw;
  int e, r0, rows, c0, n0, slices;
};

__device__ __forceinline__ Item item_at(const Walk& w, int t, int n_w,
                                        int n_groups, int m, int k, int n) {
  if (t >= n_w) {
    const Tile tl =
        walk_tile(w, n_groups, m, BM, (k + BN - 1) / BN, t - n_w);
    return {false, tl.e, tl.row0, tl.rows, tl.ct * BN, 0,
            (n + BK - 1) / BK};
  }
  const int kt = (k + BM - 1) / BM, nt = (n + BN - 1) / BN;
  const int e = t / (kt * nt), r = t - e * kt * nt;
  const int r0 = w.off[e], rows = w.off[e + 1] - r0;
  return {true, e, r0, rows, (r / nt) * BM, (r % nt) * BN,
          (rows + BK - 1) / BK};
}

// the item as lane 0 of the warp holds it: every thread computes the
// same item, but from shared memory, so the compiler cannot know that.
// Control flow around wgmma must be provably warp-uniform, or ptxas
// serialises the products
__device__ __forceinline__ Item uniform(const Item& it) {
  return {it.dw, __shfl_sync(~0u, it.e, 0), __shfl_sync(~0u, it.r0, 0),
          __shfl_sync(~0u, it.rows, 0), __shfl_sync(~0u, it.c0, 0),
          __shfl_sync(~0u, it.n0, 0), __shfl_sync(~0u, it.slices, 0)};
}

// 16 zero bytes at shared address p where pred is set (predicated inside
// the asm: no branch)
__device__ __forceinline__ void st_zero16_if(const void* p, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p st.shared.v4.u32 [%0], {%2, %2, %2, %2};\n}\n" ::"r"(
          smem_addr(p)),
      "r"((int)pred), "r"(0)
      : "memory");
}

// one item's products on warpgroup c, its slices taken through the ring
// (stage, ph), each slice's stage handed back once its products are done,
// one slice's products in flight while the next slice's are issued.  DW:
// both operands MN-major (x_e^T, dy_e; 16 rows, 2 KB, a step), the next
// group's rows of the group's last slice zeroed in this warpgroup's box of
// x first; else both K-major (dY's rows, w[e]'s rows; 32 bytes a step)
template <bool DW>
__device__ __forceinline__ void products(float (&acc)[BN / 2],
                                         unsigned char* smem, uint64_t* full,
                                         uint64_t* empty, int& stage,
                                         uint32_t& ph, const Item& it, int c,
                                         int wt, int lane) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int prev = stage;
  for (int s = 0; s < it.slices; ++s) {
    mbar_wait_converged(&full[stage], ph);
    unsigned char* st = smem + stage * STAGE;
    const int left = it.rows - s * BK;
    if (DW && left < BK) {
#pragma unroll
      for (int j = 0; j < BK * 8 / 128; ++j) {   // chunk i is row i / 8
        const int i = wt + 128 * j;
        st_zero16_if(st + c * BOX + 16 * i, i >= 8 * left);
      }
      fence_proxy_async_smem();
      named_bar(1 + c, 128);
    }
    const uint32_t sa = smem_addr(st);
    const uint64_t da = sw128_desc(sa + c * BOX, DW ? BOX : 16, 1024);
    const uint64_t db = sw128_desc(sa + A_BYTES, DW ? BOX : 16, 1024);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256<DW, DW>(acc, da + (DW ? 128 : 2) * kk,
                            db + (DW ? 128 : 2) * kk);
    wgmma_commit();
    wgmma_wait<1>();                     // the previous slice's products
    fence_acc(acc);
    mbar_arrive_if(&empty[prev], s > 0 && lane == 0);
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  mbar_arrive_if(&empty[prev], it.slices > 0 && lane == 0);
}

// a warpgroup with no rows in the item: its slices handed back as they
// land
__device__ __forceinline__ void drain(uint64_t* full, uint64_t* empty,
                                      int& stage, uint32_t& ph, int slices,
                                      int lane) {
  for (int s = 0; s < slices; ++s) {
    mbar_wait_converged(&full[stage], ph);
    mbar_arrive_if(&empty[stage], lane == 0);
    if (++stage == STAGES) {
      stage = 0;
      ph ^= 1;
    }
  }
}

// warpgroup c's 64 x 256 of the item out, a 64 x 64 box at a time: each
// rounded to bf16 once into the warpgroup's buffer in TMA's swizzled
// layout, then stored by TMA when its 64 rows are all the item's (the
// tensor's edge clips the box), else row by row (dX past the group's
// last row).  The buffer is written again once the last store has read
// it
template <bool DW>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2],
                                         unsigned char* out, const Item& it,
                                         const CUtensorMap* tout,
                                         bf16* __restrict__ dx, int c, int wt,
                                         int k, int n) {
  const int warp = wt >> 5, lane = wt & 31;
  const int rows = DW ? 64 : min(64, it.rows - 64 * c);
  const int c0 = DW ? it.n0 : it.c0, cols = DW ? n : k;
  // accumulator layout: acc[4 j + i] is row warp * 16 + lane / 4 + 8 (i
  // / 2) and column 8 j + 2 (lane % 4) + i % 2 of the warpgroup's 64 x
  // 256; column 8 j is 16-byte chunk j % 8 of box j / 8, swizzled by row
  const int r_lo = warp * 16 + (lane >> 2);
#pragma unroll
  for (int b = 0; b < BN / 64; ++b) {
    if (wt == 0) bulk_wait<true>();
    named_bar(1 + c, 128);
#pragma unroll
    for (int j = 8 * b; j < 8 * b + 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(
            out + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    fence_proxy_async_smem();
    named_bar(1 + c, 128);
    const int col = c0 + 64 * b;
    if (col >= cols) continue;
    if (rows == 64) {
      if (wt == 0) {
        tma_store_3d(tout, out, col, DW ? it.c0 + 64 * c : it.r0 + 64 * c,
                     DW ? it.e : 0);
        bulk_commit();
      }
    } else {                             // 16 bytes a thread
      for (int i = wt; i < rows * 8; i += 128) {
        const int r = i >> 3, q = i & 7;
        if (col + 8 * q < k)
          *reinterpret_cast<uint4*>(dx + (long long)(it.r0 + 64 * c + r) * k +
                                    col + 8 * q) =
              *reinterpret_cast<const uint4*>(out + r * 128 +
                                              ((q ^ (r & 7)) << 4));
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gg_bwd_kernel(const __grid_constant__ CUtensorMap tdy,
              const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tdx,
              const __grid_constant__ CUtensorMap tdw,
              bf16* __restrict__ dx, const int* __restrict__ gs,
              int n_groups, int m, int k, int n, int do_dx, int do_dw) {
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
  const int n_w =
      do_dw ? n_groups * ((k + BM - 1) / BM) * ((n + BN - 1) / BN) : 0;
  const int total =
      n_w + (do_dx ? walk_tiles(walk, n_groups, m, BM, (k + BN - 1) / BN)
                   : 0);

  if (tid < 128) {                       // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Item it = item_at(walk, t, n_w, n_groups, m, k, n);
        if (it.e < 0) continue;
        // A: dX's dY rows, a box per 64 rows in the tile; dW's x columns,
        // a box per 64 columns inside K.  B: dX's w[e] rows (dx columns)
        // inside K; dW's dY columns inside N
        const int n_a = it.dw ? min(2, (k - it.c0 + 63) / 64)
                              : min(2, (it.rows + 63) / 64);
        const int n_b = it.dw ? min(4, (n - it.n0 + 63) / 64)
                              : min(4, (k - it.c0 + 63) / 64);
        for (int s = 0; s < it.slices; ++s) {
          mbar_wait(&empty[stage], ph ^ 1);
          mbar_expect_tx(&full[stage], (n_a + n_b) * BOX);
          unsigned char* st = smem + stage * STAGE;
          const int j = s * BK;
          for (int a = 0; a < n_a; ++a) {
            if (it.dw)
              tma_load_3d(st + a * BOX, &tx, it.c0 + 64 * a, it.r0 + j, 0,
                          &full[stage]);
            else
              tma_load_3d(st + a * BOX, &tdy, j, it.r0 + 64 * a, 0,
                          &full[stage]);
          }
          for (int b = 0; b < n_b; ++b) {
            if (it.dw)
              tma_load_3d(st + A_BYTES + b * BOX, &tdy, it.n0 + 64 * b,
                          it.r0 + j, 0, &full[stage]);
            else
              tma_load_3d(st + A_BYTES + b * BOX, &tw, j, it.c0 + 64 * b,
                          it.e, &full[stage]);
          }
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
  // warp-uniform to the compiler (uniform() above)
  const int c = __shfl_sync(~0u, (tid >> 7) - 1, 0);  // the tile's rows
  const int wt = tid & 127, lane = tid & 31;           // c * 64 .. + 64
  const int nw = __shfl_sync(~0u, n_w, 0), all = __shfl_sync(~0u, total, 0);
  unsigned char* out = smem + STAGES * STAGE + c * BOX;
  int stage = 0;
  uint32_t ph = 0;
  float acc[BN / 2];
  int t = blockIdx.x;
  for (; t < nw; t += gridDim.x) {       // dW's units
    const Item it = uniform(item_at(walk, t, nw, n_groups, m, k, n));
    if (it.c0 + 64 * c < k) {
      products<true>(acc, smem, full, empty, stage, ph, it, c, wt, lane);
      epilogue<true>(acc, out, it, &tdw, dx, c, wt, k, n);
    } else {
      drain(full, empty, stage, ph, it.slices, lane);
    }
  }
  for (; t < all; t += gridDim.x) {      // dX's tiles
    const Item it = uniform(item_at(walk, t, nw, n_groups, m, k, n));
    if (it.e < 0) {                      // rows past the groups
      const int chunks = min(BN, k - it.c0) / 8;
      for (int i = tid - 128; i < it.rows * chunks; i += 256)
        *reinterpret_cast<uint4*>(dx + (long long)(it.r0 + i / chunks) * k +
                                  it.c0 + 8 * (i % chunks)) =
            make_uint4(0, 0, 0, 0);
    } else if (64 * c < it.rows) {
      products<false>(acc, smem, full, empty, stage, ph, it, c, wt, lane);
      epilogue<false>(acc, out, it, &tdx, dx, c, wt, k, n);
    } else {
      drain(full, empty, stage, ph, it.slices, lane);
    }
  }
  if (wt == 0) bulk_wait<false>();    // the stores out of shared memory
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
// that gradient is not computed (bf16: one launch either way; f32: dX's
// then dW's).  At most 512 groups; bf16 needs k and n multiples of 8 and
// 16-byte aligned x, w, dy, dx, dw (the caller checks).  Returns the
// first launch error (cudaError_t), 0 on success.
extern "C" int grouped_gemm_bwd(int dtype, const void* x, const void* w,
                                const void* dy, void* dx, void* dw,
                                const int* group_sizes, int n_groups, int m,
                                int k, int n, cudaStream_t stream) {
  if (n_groups <= 0 || n_groups > MAX_GROUPS || k <= 0 || n <= 0 || m < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (k % 8 || n % 8) return (int)cudaErrorInvalidValue;
    const bool do_dx = dx && m > 0;
    const long long slots =
        (do_dx ? (long long)((m + BM - 1) / BM + n_groups + 1) *
                     ((k + BN - 1) / BN)
               : 0) +
        (dw ? (long long)n_groups * ((k + BM - 1) / BM) * ((n + BN - 1) / BN)
            : 0);
    if (slots == 0) return 0;
    static const cudaError_t attr = cudaFuncSetAttribute(
        gg_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr != cudaSuccess) return (int)attr;
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
    // every operand as a 3-D map of 64 x 64 boxes, cached by pointer,
    // shape and box (w's is the forward's map; a call's dy, x, dx and dw
    // come back from the allocator at the same addresses step after
    // step); x's and dy's only when there are rows to read
    CUtensorMap tdy{}, tw{}, tx{}, tdx{}, tdw{};
    const uint32_t box[3] = {64, 64, 1};
    const auto map2 = [&](CUtensorMap* map, const void* p, int cols) {
      const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)m, 1};
      const uint64_t strides[2] = {(uint64_t)cols * 2,
                                   (uint64_t)cols * m * 2};
      return bf16_map_cached(map, p, dims, strides, box);
    };
    const uint64_t wdims[3] = {(uint64_t)n, (uint64_t)k, (uint64_t)n_groups};
    const uint64_t wstrides[2] = {(uint64_t)n * 2, (uint64_t)k * n * 2};
    if ((m > 0 && (!map2(&tdy, dy, n) || (dw && !map2(&tx, x, k)))) ||
        (do_dx && (!bf16_map_cached(&tw, w, wdims, wstrides, box) ||
                   !map2(&tdx, dx, k))) ||
        (dw && !bf16_map_cached(&tdw, dw, wdims, wstrides, box)))
      return (int)cudaErrorInvalidValue;
    const int grid = (int)(slots < n_sm ? slots : n_sm);
    gg_bwd_kernel<<<grid, THREADS, SMEM, stream>>>(
        tdy, tw, tx, tdx, tdw, static_cast<bf16*>(dx), group_sizes,
        n_groups, m, k, n, do_dx, dw != nullptr);
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
