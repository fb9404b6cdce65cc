// The chunked SSD scan of Mamba2 for Hopper.
//
// Replaces the chunk loop of repro/models/ssm.py:59 (ssd_scan: a
// jax.lax.scan over chunks at :116 of chunk_body :94-114), which the
// reference leaves to XLA as jnp.  For each sequence b and SSD head h,
// over the chunks of L rows in order (the last one short), with the
// carried state h (P, N) f32:
//   cs_i      = sum_{k <= i} dt_k * A   (within the chunk; f64, rounded)
//   y_i      += sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//             + exp(cs_i) sum_n C_i[n] h[:, n]
//   h        <- h exp(cs_end) + sum_j exp(cs_end - cs_j) dt_j x_j (x) B_j
// then y += D x.  x (b, s, H, P), B and C (b, s, N) in bf16 or f32, cast
// to f32 as the reference casts them; dt (b, s, H) f32 after softplus; A
// (= -exp(A_log)) and D (H,) f32; h0 (b, H, P, N) f32 or null (zeros);
// y (b, s, H, P) f32; h_final (b, H, P, N) f32, which may be h0 itself
// (a block reads its own state first and writes it last).  Every step is
// f32 on the CUDA cores: no TF32.  The reference pads the last chunk with
// dt = 0; here rows past the sequence are masked instead, and only
// j <= i is computed (exp(cs_i - cs_j) for j > i may overflow; the
// reference masks it with `where`).  The chunk length L comes at run
// time: min(chunk_size, s), as the reference's ssm.py:69 takes it.
//
// Bound: operations at the main path's shapes.  Per chunk of 256 rows and
// head: C.B^T over j <= i (~256^2/2 x 128 FMAs, recomputed per head: the
// reference shares it across heads, but one block per head keeps every
// head's chain of chunks inside one block), the weighted x (~256^2/2 x
// 64), the carried state's term (256 x 64 x 128) and the state update
// (256 x 64 x 128): ~12 M FMAs against ~100 KB of inputs, ~120 flops a
// byte, above the f32 ridge (~20).
//
// Design (the simple one first): one block of 8 warps per (head,
// sequence), looping over the chunks in order, the state transposed in
// shared memory (hT[n][p], 34 KB).  A chunk is cut into tiles of 64 rows.
// For each query tile I: C_I (transposed) is loaded, the carried state's
// term is a 64 x 64 x 128 product from shared memory, then for each key
// tile J <= I, B_J (transposed) and x_J are loaded, G^T = (B_J C_I^T)
// masked, times exp(cs_i - cs_j) dt_j, goes to shared memory and y_I +=
// G x_J.  Then a second pass over the key tiles accumulates the state
// update (B_J natural, x_J scaled by exp(cs_end - cs_j) dt_j) in
// registers and folds it into hT.  Every product is a 4 x 4 (or 8 x 4)
// register tile per thread fed by 16-byte shared-memory loads.  The
// shared memory (141 KB) holds one block per SM; at b = 1 the 64 heads
// leave half of the 132 SMs idle (the engine appends one request at a
// time).  Splitting the work into a chunk-parallel kernel and a
// state-passing one is the way to fill the card, left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int P = 64;          // SSD head dim (mamba2-1.3b's)
constexpr int N = 128;         // state dim (d_state x n_groups)
constexpr int T = 64;          // rows of a tile
constexpr int MAX_L = 256;     // longest chunk
constexpr int THREADS = 256;
constexpr int LDT = T + 4;     // row strides in shared memory (floats),
constexpr int LDP = P + 4;     // padded: 16-byte aligned rows, fewer
constexpr int LDN = N + 4;     // bank conflicts on the transposed stores

constexpr int SZ_H = N * LDP;                         // hT[n][p]
constexpr int SZ_C = N * LDT;                         // Ct[n][i]
constexpr int SZ_B = N * LDT > T * LDN ? N * LDT : T * LDN;  // Bt / Bn
constexpr int SZ_X = T * LDP;                         // Xs[j][p]
constexpr int SZ_G = T * LDT;                         // Gt[j][i]
constexpr int SMEM_FLOATS = SZ_H + SZ_C + SZ_B + SZ_X + SZ_G + 2 * MAX_L;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rows [0, T) x cols [0, W) of a row-major source (row stride rs; rows at
// or past nrows read as 0) into shared memory, transposed:
// dst[c * ld + r].  Consecutive threads take consecutive rows, so the
// shared-memory stores do not conflict.
template <typename Tin, int W>
__device__ __forceinline__ void load_t(float* dst, int ld, const Tin* src,
                                       long long rs, int nrows) {
  for (int idx = threadIdx.x; idx < T * W; idx += THREADS) {
    const int r = idx % T, c = idx / T;
    dst[c * ld + r] = r < nrows ? to_f32(src[r * rs + c]) : 0.f;
  }
}

// the same, natural layout: dst[r * ld + c]; coalesced reads
template <typename Tin, int W>
__device__ __forceinline__ void load_n(float* dst, int ld, const Tin* src,
                                       long long rs, int nrows) {
  for (int idx = threadIdx.x; idx < T * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    dst[r * ld + c] = r < nrows ? to_f32(src[r * rs + c]) : 0.f;
  }
}

// acc[a][c] += sum_k At[k][m0 + a] * Bk[k][n0 + c], a, c < 4: a 4 x 4
// register tile of a product whose operands sit k-major in shared memory
__device__ __forceinline__ void mma4x4(float (&acc)[4][4], const float* At,
                                       int lda, int m0, const float* Bk,
                                       int ldb, int n0, int K) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * lda + m0);
    const float4 b = *reinterpret_cast<const float4*>(Bk + k * ldb + n0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

template <typename Tin>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const Tin* __restrict__ x, const Tin* __restrict__ B,
                const Tin* __restrict__ C, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ D,
                const float* h0, float* __restrict__ y, float* h_out,
                int s, int H, int L, long long x_bs, long long x_ts,
                long long bc_bs, long long bc_ts) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;
  float* Ct = hT + SZ_H;
  float* Bb = Ct + SZ_C;         // Bt[n][j] for y, Bn[j][n] for the state
  float* Xs = Bb + SZ_B;
  float* Gt = Xs + SZ_X;
  float* cs = Gt + SZ_G;
  float* dts = cs + MAX_L;

  const int head = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = tid / 16, tx = tid % 16;     // 16 x 16 thread tiles
  const float a_h = A[head], d_h = D[head];
  const long long state = ((long long)b * H + head) * P * N;
  const Tin* xb = x + b * x_bs + (long long)head * P;
  const Tin* Bb_g = B + b * bc_bs;
  const Tin* Cb_g = C + b * bc_bs;
  const float* dtb = dt + (long long)b * s * H + head;
  float* yb = y + ((long long)b * s * H + head) * P;

  // the carried state, transposed: hT[n][p] = h[p][n]
  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx % P, n = idx / P;
    hT[n * LDP + p] = h0 ? h0[state + (long long)p * N + n] : 0.f;
  }

  for (int c0 = 0; c0 < s; c0 += L) {
    const int len = min(L, s - c0);
    const int nt = (len + T - 1) / T;
    __syncthreads();   // the previous chunk is done with cs, dts, tiles
    // cs = inclusive cumsum of the f32 products dt * A over the chunk
    // (rows past len: 0), accumulated in f64 and rounded once, as the
    // plain version does: cs_i - cs_j of two sums in the hundreds is the
    // scan's one ill-conditioned step, and sums rounded once agree to the
    // bit whatever their order.  One warp, 8 consecutive rows a lane,
    // then a shuffle scan.
    if (warp == 0) {
      double v[MAX_L / 32], run = 0.0;
#pragma unroll
      for (int q = 0; q < MAX_L / 32; ++q) {
        const int i = lane * (MAX_L / 32) + q;
        const float d = i < len ? dtb[(long long)(c0 + i) * H] : 0.f;
        dts[i] = d;
        run += (double)(d * a_h);
        v[q] = run;
      }
      double tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += t;
      }
      const double excl = tot - run;
#pragma unroll
      for (int q = 0; q < MAX_L / 32; ++q)
        cs[lane * (MAX_L / 32) + q] = (float)(v[q] + excl);
    }
    __syncthreads();
    const float cs_end = cs[len - 1];

    // y, one query tile at a time
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T, ni = min(T, len - i0);
      __syncthreads();
      load_t<Tin, N>(Ct, LDT, Cb_g + (c0 + i0) * bc_ts, bc_ts, ni);
      __syncthreads();
      float acc[4][4] = {};
      // the carried state's term: (C_I . h^T) exp(cs_i)
      mma4x4(acc, Ct, LDT, ty * 4, hT, LDP, tx * 4, N);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = expf(cs[i0 + ty * 4 + a]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] *= e;
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T, nj = min(T, len - j0);
        __syncthreads();
        load_t<Tin, N>(Bb, LDT, Bb_g + (c0 + j0) * bc_ts, bc_ts, nj);
        load_n<Tin, P>(Xs, LDP, xb + (c0 + j0) * x_ts, x_ts, nj);
        __syncthreads();
        // G^T[j][i] = (B_j . C_i) exp(cs_i - cs_j) dt_j for j <= i, rows
        // j = ty*4 + a and columns i = tx*4 + c of this thread
        float g[4][4] = {};
        mma4x4(g, Bb, LDT, ty * 4, Ct, LDT, tx * 4, N);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = j0 + ty * 4 + a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + tx * 4 + c;
            g[a][c] = (j <= i && j < len && i < len)
                          ? g[a][c] * expf(cs[i] - cs[j]) * dts[j]
                          : 0.f;
          }
          *reinterpret_cast<float4*>(Gt + (ty * 4 + a) * LDT + tx * 4) =
              make_float4(g[a][0], g[a][1], g[a][2], g[a][3]);
        }
        __syncthreads();
        // y_I += G x_J
        mma4x4(acc, Gt, LDT, ty * 4, Xs, LDP, tx * 4, T);
      }
      // Xs holds x_I (the last key tile was I): y = acc + D x
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
        if (i < ni) {
          const float* xr = Xs + i * LDP + tx * 4;
          *reinterpret_cast<float4*>(yb + (long long)(c0 + i0 + i) * H * P +
                                     tx * 4) =
              make_float4(acc[a][0] + xr[0] * d_h, acc[a][1] + xr[1] * d_h,
                          acc[a][2] + xr[2] * d_h, acc[a][3] + xr[3] * d_h);
        }
      }
    }

    // the state update: hT[n][p] <- hT exp(cs_end) + sum_j B_j[n] w_j x_j[p]
    // with w_j = exp(cs_end - cs_j) dt_j; rows n = ty*8 + r, cols p = tx*4
    float hacc[8][4] = {};
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * T, nj = min(T, len - j0);
      __syncthreads();
      load_n<Tin, N>(Bb, LDN, Bb_g + (c0 + j0) * bc_ts, bc_ts, nj);
      load_n<Tin, P>(Xs, LDP, xb + (c0 + j0) * x_ts, x_ts, nj);
      __syncthreads();
      for (int idx = tid; idx < T * P; idx += THREADS) {
        const int j = idx / P, p = idx % P;
        const float w = j < nj ? expf(cs_end - cs[j0 + j]) * dts[j0 + j]
                               : 0.f;
        Xs[j * LDP + p] *= w;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < T; ++k) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(Bb + k * LDN + ty * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(Bb + k * LDN + ty * 8 + 4);
        const float4 bx =
            *reinterpret_cast<const float4*>(Xs + k * LDP + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {bx.x, bx.y, bx.z, bx.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) hacc[r][c] += av[r] * bv[c];
      }
    }
    __syncthreads();   // every query tile has read the old hT
    const float decay = expf(cs_end);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* row = hT + (ty * 8 + r) * LDP + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) row[c] = row[c] * decay + hacc[r][c];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int n = idx % N, p = idx / N;
    h_out[state + (long long)p * N + n] = hT[n * LDP + p];
  }
}

template <typename Tin>
int launch(const void* x, const void* B, const void* C, const float* dt,
           const float* A, const float* D, const float* h0, float* y,
           float* h_out, int b, int s, int H, int L, long long x_bs,
           long long x_ts, long long bc_bs, long long bc_ts,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<Tin><<<dim3(H, b), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(B),
      static_cast<const Tin*>(C), dt, A, D, h0, y, h_out, s, H, L, x_bs,
      x_ts, bc_bs, bc_ts);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C).  x's rows are x_ts elements
// apart and its sequences x_bs, with (H, P) contiguous; B and C share
// bc_ts and bc_bs, with N contiguous; dt (b, s, H), A, D (H,), y (b, s,
// H, P) and h0 / h_out (b, H, P, N) f32 contiguous; h0 may be null and
// may equal h_out.  P = 64, N = 128, 1 <= L <= 256.  Returns the launch's
// cudaError_t.
extern "C" int ssd_chunk_scan(int dtype, const void* x, const void* B,
                              const void* C, const float* dt, const float* A,
                              const float* D, const float* h0, float* y,
                              float* h_out, int b, int s, int H, int L,
                              long long x_bs, long long x_ts,
                              long long bc_bs, long long bc_ts,
                              cudaStream_t stream) {
  if (b <= 0 || s <= 0) return 0;
  if (L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, B, C, dt, A, D, h0, y, h_out, b, s, H,
                                 L, x_bs, x_ts, bc_bs, bc_ts, stream);
  return launch<float>(x, B, C, dt, A, D, h0, y, h_out, b, s, H, L, x_bs,
                       x_ts, bc_bs, bc_ts, stream);
}
