// The chunked SSD scan of Mamba2 for Hopper, as a chunk-parallel kernel set.
//
// Replaces the chunk loop of repro/models/ssm.py:59 (ssd_scan: a
// jax.lax.scan over chunks at :116 of chunk_body :94-114), which the
// reference leaves to XLA as jnp.  For each sequence b and SSD head h,
// over the chunks of L rows (the last one short), with the carried state
// h (P, N) f32:
//   cs_i      = sum_{k <= i} dt_k * A   (within the chunk; f64, rounded)
//   y_i       = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//             + exp(cs_i) sum_n C_i[n] h[:, n] + D x_i
//   h        <- h exp(cs_end) + sum_j exp(cs_end - cs_j) dt_j x_j (x) B_j
// x (b, s, H, P), B and C (b, s, N) in bf16 or f32, cast to f32 as the
// reference casts them; dt (b, s, H) f32 after softplus; A (=
// -exp(A_log)) and D (H,) f32; h0 (b, H, P, N) f32 or null (zeros); y
// (b, s, H, P) f32; h_final (b, H, P, N) f32, which may be h0 itself.
// With bf16 inputs the products run on the tensor cores as split TF32
// with f32 accumulators, never as plain TF32; with f32 inputs as f32 FMAs
// (see mma_tile).  The reference pads the last chunk with dt = 0; here
// rows past the sequence are masked instead, and only j <= i is computed
// (exp(cs_i - cs_j) for j > i may overflow; the reference masks it with
// `where`).  The chunk length L comes at run time: min(chunk_size, s), as
// ssm.py:69 takes it.
//
// Bound: operations at the main path's shapes.  Per chunk of 256 rows:
// C.B^T over j <= i once (~256^2/2 x 128 FMAs, shared by the heads, as
// the reference shares it), then per head the weighted x (~256^2/2 x
// 64), the carried state's term (256 x 64 x 128) and the state update
// (256 x 64 x 128): ~6 M FMAs a head against ~50 KB of its inputs, far
// above the f32 ridge (~20 flops a byte).  With f32 inputs the bound
// counts these FMAs at the f32 CUDA cores' peak; with bf16 inputs as the
// kernel issues them, TF32 MMAs at the TF32 peak (C.B^T one a product,
// the others two: an f32 operand in two parts), ~3.7x less time.
//
// Design: the SSD paper's four steps (arXiv:2405.21060 sec. 6), each over
// every chunk at once, in three launches on the stream:
//   1. C_c.B_c^T per chunk and pair of 64-row tiles j <= i, once for all
//      heads -> cb (b, nc, Lt, Lt) f32, stored transposed (cb[j][i]);
//   2. per (chunk, half of N, head, sequence): cs in f64 (-> cs (b, nc, H,
//      Lt)) and the chunk's own state S_c = sum_j w_j x_j (x) B_j -> S (b,
//      nc, H, P, N).  1 and 2 are independent: ssd_chunk_kernel runs
//      both, side by side in one grid;
//   3. ssd_pass_kernel, per (head, sequence, 1024 state elements), over
//      the chunks in order: h_c = h_{c-1} exp(cs_end) + S_c, writing the
//      state entering chunk c over S_c and the last state to h_final;
//   4. ssd_out_kernel, per (64-row query tile, chunk, head, sequence):
//      the carried state's term from the state entering the chunk, then
//      the query tile against each key tile j <= i (cb from 1), plus D x.
// The sequential part is step 3 alone, elementwise over the state: at one
// 4000-token sequence steps 1 and 2 run 160 + 2048 blocks and step 4
// 4096, where one block per (head, sequence) ran 64 on 132 SMs.  Each
// product is a 64 x 64 output tile of 4 warps, a 32 x 32 quarter each in
// mma.sync m16n8k8 fragments (the f32 path keeps the same fragments), over
// 32-row slices of f32 in shared memory (~20 KB a block, so several blocks
// share an SM).  Why the tensor cores (an H100 80GB HBM3 at 700 W): the
// f32 CUDA cores ran these tiles at ~40 % of their peak with 4 x 4 or 8 x
// 4 register tiles, 0.58 ms for a 4000-token append against 0.40 here;
// staging the next slice in registers during the products, or 8 warps a
// tile, cost more than they hid.  Step 4 walks its query tiles from the
// last (the most key tiles) down, so the long blocks start first.  No
// atomics: every output is written once, in a fixed order, so two calls
// agree to the bit.  cb, cs and S come from the wrapper (PyTorch's caching
// allocator); h0 is read (step 3, each element by the thread that writes
// it to h_final) before h_final is written.
#include "ssd_tile.cuh"

namespace {

// 1. cb[j][i] = B_j . C_i for the 64-row tiles (jt, it), jt <= it, of
// chunk c of sequence b (tile pair = it (it + 1) / 2 + jt); rows past the
// chunk are zeros.  Bt and Ct: KS x LDT floats of shared memory each.
template <typename Tin, int N>
__device__ __forceinline__ void cb_block(
    int pair, int c, int b, float* Bt, float* Ct, const Tin* __restrict__ B,
    const Tin* __restrict__ C, float* __restrict__ cb, int s, int L, int nc,
    int nt, long long bc_bs, long long bc_ts) {
  int it = 0, jt = pair;
  while (jt > it) jt -= ++it;
  const int c0 = c * L, len = min(L, s - c0);
  const int i0 = it * T, j0 = jt * T;
  if (i0 >= len) return;
  const int ni = min(T, len - i0), nj = min(T, len - j0);
  const Tin* Bg = B + b * bc_bs + (long long)(c0 + j0) * bc_ts;
  const Tin* Cg = C + b * bc_bs + (long long)(c0 + i0) * bc_ts;
  float acc[2][4][4] = {};
  for (int n0 = 0; n0 < N; n0 += KS) {
    __syncthreads();
    load_t(Bt, Bg + n0, bc_ts, nj);
    load_t(Ct, Cg + n0, bc_ts, ni);
    __syncthreads();
    product<Tin, false, false>(acc, Bt, Ct);
  }
  const int lt = nt * T;
  float* out = cb + ((long long)b * nc + c) * lt * lt + (long long)j0 * lt +
               i0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (long long)frag_row(mi, h) * lt +
                                   frag_col(nf)) =
            make_float2(acc[mi][nf][2 * h], acc[mi][nf][2 * h + 1]);
}

// 2. for chunk c, column tile nh of N, head and sequence b: the
// cumulative sum cs (written out by the first tile) and the columns
// [nh * 64, nh * 64 + 64) of the chunk's own state
// S[p][n] = sum_j exp(cs_end - cs_j) dt_j x_j[p] B_j[n].  Xs and Bs: KS x
// LDT floats of shared memory each; cs, dts, w: MAX_L floats each.
template <typename Tin, int N>
__device__ __forceinline__ void state_block(
    int c, int nh, int head, int b, float* Xs, float* Bs, float* cs,
    float* dts, float* w, const Tin* __restrict__ x,
    const Tin* __restrict__ B, const float* __restrict__ dt,
    const float* __restrict__ A, float* __restrict__ cs_out,
    float* __restrict__ S, int s, int H, int L, int nc, int lt,
    long long x_bs, long long x_ts, long long bc_bs, long long bc_ts) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = c * L, len = min(L, s - c0);
  const float a_h = A[head];
  const float* dtb = dt + ((long long)b * s + c0) * H + head;
  // cs = inclusive cumsum of the f32 products dt * A over the chunk (rows
  // past len: 0), accumulated in f64 and rounded once, as the plain
  // version does: cs_i - cs_j of two sums in the hundreds is the scan's
  // one ill-conditioned step, and sums rounded once agree to the bit
  // whatever their order.  One warp, 8 consecutive rows a lane, then a
  // shuffle scan.
  if (warp == 0) {
    double v[MAX_L / 32], run = 0.0;
#pragma unroll
    for (int q = 0; q < MAX_L / 32; ++q) {
      const int i = lane * (MAX_L / 32) + q;
      const float d = i < len ? dtb[(long long)i * H] : 0.f;
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
  for (int i = tid; i < MAX_L; i += THREADS)
    w[i] = i < len ? expf(cs_end - cs[i]) * dts[i] : 0.f;
  if (nh == 0) {
    float* out = cs_out + (((long long)b * nc + c) * H + head) * lt;
    for (int i = tid; i < lt; i += THREADS) out[i] = cs[i];
  }
  const Tin* xg = x + b * x_bs + (long long)c0 * x_ts + (long long)head * P;
  const Tin* Bg = B + b * bc_bs + (long long)c0 * bc_ts + nh * T;
  float acc[2][4][4] = {};   // rows p, columns n - nh * 64
  for (int k0 = 0; k0 < len; k0 += KS) {
    const int nk = min(KS, len - k0);
    __syncthreads();      // w is written; the previous slice is consumed
    load_n(Xs, xg + k0 * x_ts, x_ts, nk, w + k0);
    load_n(Bs, Bg + k0 * bc_ts, bc_ts, nk, (const float*)nullptr);
    __syncthreads();
    product<Tin, true, false>(acc, Xs, Bs);
  }
  float* out = S + (((long long)b * nc + c) * H + head) * P * N + nh * T;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (long long)frag_row(mi, h) * N +
                                   frag_col(ni)) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

// 1 and 2 in one launch: blocks x < nc NH take the chunk states of (x /
// NH, x % NH, head y, sequence z); the rest take C.B^T's tile pairs, as
// many as there are (nc pairs a sequence), spread over y, so the two run
// side by side
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const Tin* __restrict__ x, const Tin* __restrict__ B,
                 const Tin* __restrict__ C, const float* __restrict__ dt,
                 const float* __restrict__ A, float* __restrict__ cb,
                 float* __restrict__ cs_out, float* __restrict__ S, int s,
                 int H, int L, int nc, int nt, long long x_bs,
                 long long x_ts, long long bc_bs, long long bc_ts) {
  __shared__ __align__(16) float As[KS * LDT], Bs[KS * LDT];
  __shared__ float cs[MAX_L], dts[MAX_L], w[MAX_L];
  static_assert(N % T == 0, "N a multiple of the 64-column tile");
  constexpr int NH = N / T;
  const int n_state = nc * NH;
  if ((int)blockIdx.x < n_state) {
    state_block<Tin, N>(blockIdx.x / NH, blockIdx.x % NH, blockIdx.y,
                     blockIdx.z, As, Bs, cs, dts, w, x, B, dt, A, cs_out, S,
                     s, H, L, nc, nt * T, x_bs, x_ts, bc_bs, bc_ts);
    return;
  }
  const int pairs = nt * (nt + 1) / 2;
  const int id = (blockIdx.x - n_state) * H + blockIdx.y;
  if (id < nc * pairs)
    cb_block<Tin, N>(id % pairs, id / pairs, blockIdx.z, As, Bs, B, C, cb, s,
                  L, nc, nt, bc_bs, bc_ts);
}

// 3. state passing for head blockIdx.y, sequence blockIdx.z, 4 state
// elements a thread: over the chunks in order, S_c is replaced by the
// state entering chunk c, and the state after the last chunk goes to
// h_out.  h0 may be h_out: each thread reads its elements of h0 before it
// writes them.
template <int N>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(const float* __restrict__ cs, float* __restrict__ S,
                const float* h0, float* h_out, int s, int H, int L, int nc,
                int lt) {
  const int head = blockIdx.y, b = blockIdx.z;
  const long long e = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  const long long q = P * N / 4;               // float4s of one state
  const long long st = ((long long)b * H + head) * q + e;
  float4 h = h0 ? reinterpret_cast<const float4*>(h0)[st]
                : make_float4(0, 0, 0, 0);
  float4* sp = reinterpret_cast<float4*>(S) +
               ((long long)b * nc * H + head) * q + e;
  const float* csp = cs + ((long long)b * nc * H + head) * lt;
  // PASS_BATCH chunks at a time: their loads first, all in flight, then
  // the chain of updates and stores
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float4 sc[PASS_BATCH];
    float cse[PASS_BATCH];
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        sc[u] = sp[(long long)c * H * q];
        cse[u] = csp[(long long)c * H * lt + min(L, s - c * L) - 1];
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        sp[(long long)c * H * q] = h;
        const float decay = expf(cse[u]);
        h = make_float4(h.x * decay + sc[u].x, h.y * decay + sc[u].y,
                        h.z * decay + sc[u].z, h.w * decay + sc[u].w);
      }
    }
  }
  reinterpret_cast<float4*>(h_out)[st] = h;
}

// 4. y for query tile it (the last first) of chunk blockIdx.x / nt, head
// blockIdx.y, sequence blockIdx.z: exp(cs_i) (C_i . h_in) + the key tiles
// j <= i of cb exp(cs_i - cs_j) dt_j x_j + D x_i, h_in the state entering
// the chunk (S after step 3)
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS)
ssd_out_kernel(const Tin* __restrict__ x, const Tin* __restrict__ C,
               const float* __restrict__ dt, const float* __restrict__ D,
               const float* __restrict__ cb, const float* __restrict__ cs,
               const float* __restrict__ S, float* __restrict__ y, int s,
               int H, int L, int nc, int nt, long long x_bs, long long x_ts,
               long long bc_bs, long long bc_ts) {
  __shared__ __align__(16) float As[KS * LDT], Bs[KS * LDT];
  __shared__ float csc[MAX_L], dtc[MAX_L];
  const int c = blockIdx.x / nt, it = nt - 1 - blockIdx.x % nt;
  const int head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * L, len = min(L, s - c0), i0 = it * T;
  if (i0 >= len) return;
  const int ni = min(T, len - i0), lt = nt * T;
  const float* csp = cs + (((long long)b * nc + c) * H + head) * lt;
  for (int i = tid; i < lt; i += THREADS) {
    csc[i] = csp[i];
    dtc[i] = i < len ? dt[((long long)b * s + c0 + i) * H + head] : 0.f;
  }
  // the carried state's term: acc[i][p] = sum_n C_i[n] h_in[p][n]
  const Tin* Cg = C + b * bc_bs + (long long)(c0 + i0) * bc_ts;
  const float* hg = S + (((long long)b * nc + c) * H + head) * P * N;
  float acc[2][4][4] = {};   // rows i - i0, columns p
  for (int n0 = 0; n0 < N; n0 += KS) {
    __syncthreads();
    load_t(As, Cg + n0, bc_ts, ni);
    load_t(Bs, hg + n0, (long long)N, P);
    __syncthreads();
    product<Tin, false, true>(acc, As, Bs);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e = expf(csc[i0 + frag_row(mi, h)]);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        acc[mi][nf][2 * h] *= e;
        acc[mi][nf][2 * h + 1] *= e;
      }
    }
  // the chunk's own term, one KS-row slice of a key tile at a time:
  // G^T[j][i] = cb[j][i] exp(cs_i - cs_j) dt_j for j <= i, both in the
  // chunk, then y_I += G x_J
  const float* cbp = cb + ((long long)b * nc + c) * lt * lt + i0;
  const Tin* xg = x + b * x_bs + (long long)c0 * x_ts + (long long)head * P;
  const int k_end = min(i0 + T, len);
  for (int k0 = 0; k0 < k_end; k0 += KS) {
    const int nk = min(KS, len - k0);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PIECES; ++q) {
      const int idx = tid + q * THREADS;
      const int r = idx / (T / 4), g = idx % (T / 4);
      const int j = k0 + r;
      float4 v = make_float4(0, 0, 0, 0);
      if (r < nk) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            cbp + (long long)j * lt + 4 * g);
        const float csj = csc[j], dj = dtc[j];
        float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 4 * g + e;
          wv[e] = (j <= i && i < len) ? wv[e] * expf(csc[i] - csj) * dj
                                      : 0.f;
        }
        v = make_float4(wv[0], wv[1], wv[2], wv[3]);
      }
      *reinterpret_cast<float4*>(As + r * LDT + 4 * g) = v;
    }
    load_n(Bs, xg + k0 * x_ts, x_ts, nk, (const float*)nullptr);
    __syncthreads();
    product<Tin, true, false>(acc, As, Bs);
  }
  const float d_h = D[head];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = frag_row(mi, h);
      if (i < ni) {
        const Tin* xr = xg + (long long)(i0 + i) * x_ts;
        float* yr = y + (((long long)b * s + c0 + i0 + i) * H + head) * P;
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          const int p = frag_col(nf);
          *reinterpret_cast<float2*>(yr + p) =
              make_float2(acc[mi][nf][2 * h] + to_f32(xr[p]) * d_h,
                          acc[mi][nf][2 * h + 1] + to_f32(xr[p + 1]) * d_h);
        }
      }
    }
}

template <typename Tin, int N>
int launch(const void* xv, const void* Bv, const void* Cv, const float* dt,
           const float* A, const float* D, const float* h0, float* y,
           float* h_out, float* cb, float* cs, float* S, int b, int s,
           int H, int L, long long x_bs, long long x_ts, long long bc_bs,
           long long bc_ts, cudaStream_t stream) {
  const Tin* x = static_cast<const Tin*>(xv);
  const Tin* B = static_cast<const Tin*>(Bv);
  const Tin* C = static_cast<const Tin*>(Cv);
  const int nc = (s + L - 1) / L, nt = (L + T - 1) / T, lt = nt * T;
  cudaError_t err;
  const int cb_x = (nc * (nt * (nt + 1) / 2) + H - 1) / H;
  constexpr int NH = N / T, PASS_BLOCKS = P * N / 4 / PASS_THREADS;
  ssd_chunk_kernel<Tin, N><<<dim3(nc * NH + cb_x, H, b), THREADS, 0,
                             stream>>>(x, B, C, dt, A, cb, cs, S, s, H, L, nc,
                                    nt, x_bs, x_ts, bc_bs, bc_ts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_pass_kernel<N><<<dim3(PASS_BLOCKS, H, b), PASS_THREADS, 0, stream>>>(
      cs, S, h0, h_out, s, H, L, nc, lt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_out_kernel<Tin, N><<<dim3(nc * nt, H, b), THREADS, 0, stream>>>(
      x, C, dt, D, cb, cs, S, y, s, H, L, nc, nt, x_bs, x_ts, bc_bs, bc_ts);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C).  x's rows are x_ts elements
// apart and its sequences x_bs, with (H, P) contiguous; B and C share
// bc_ts and bc_bs, with N contiguous; x, B and C 4-element aligned (16
// bytes in f32, 8 in bf16, strides included); dt (b, s, H), A, D (H,), y
// (b, s, H, P) and h0 / h_out (b, H, P, N) f32 contiguous; h0 may be null
// and may equal h_out.  Scratch, f32 contiguous, with nc = ceil(s / L),
// lt = 64 ceil(L / 64): cb (b, nc, lt, lt), cs (b, nc, H, lt), S (b, nc,
// H, P, N).  P = 64, N 64 or 128, 1 <= L <= 256.  Launches the three
// kernels on the stream; returns the first launch's error (cudaError_t).
extern "C" int ssd_chunk_scan(int dtype, int n, const void* x,
                              const void* B, const void* C, const float* dt,
                              const float* A, const float* D,
                              const float* h0, float* y, float* h_out,
                              float* cb, float* cs, float* S, int b, int s,
                              int H, int L, long long x_bs, long long x_ts,
                              long long bc_bs, long long bc_ts,
                              cudaStream_t stream) {
  if (b <= 0 || s <= 0) return 0;
  if (L < 1 || L > MAX_L || (n != 64 && n != 128) || (dtype != 0 &&
                                                       dtype != 1))
    return (int)cudaErrorInvalidValue;
#define SSD_LAUNCH(Tin, N)                                                  \
  return launch<Tin, N>(x, B, C, dt, A, D, h0, y, h_out, cb, cs, S, b, s,  \
                        H, L, x_bs, x_ts, bc_bs, bc_ts, stream)
  if (dtype == 1) {
    if (n == 64) SSD_LAUNCH(__nv_bfloat16, 64);
    SSD_LAUNCH(__nv_bfloat16, 128);
  }
  if (n == 64) SSD_LAUNCH(float, 64);
  SSD_LAUNCH(float, 128);
#undef SSD_LAUNCH
}
