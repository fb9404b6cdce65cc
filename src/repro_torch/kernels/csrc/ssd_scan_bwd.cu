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
//   2. per chunk, M_ij = e_ij (dy_i . u_j) and
//        du_j = sum_{i >= j} (C_i . B_j) e_ij dy_i + e^{cs_end - cs_j} g B_j
//        dx_j = dt_j du_j + D dy_j,   ddt_j = x_j . du_j (+ da_j A below)
//        dB_j = sum_h [sum_{i >= j} M_ij C_i + e^{cs_end - cs_j} u_j g]
//        dC_i = sum_h [sum_{j <= i} M_ij B_j + e^{cs_i} dy_i h_in]
//   3. dcs_i = sum_{j <= i} W_ij - sum_{k >= i} W_ki (W = (C.B) o M)
//      + e^{cs_i} dy_i . (h_in C_i) - v_i, v_j = e^{cs_end - cs_j} u_j .
//      g B_j, and the last row also gets sum_j v_j + e^{cs_end} <g, h_in>;
//      da_k = sum_{i >= k} dcs_i (f64), ddt_k += da_k A, dA = sum da dt,
//      dD = sum dy x.
// chip_smoke.py's ssd_bwd_plain is this split in PyTorch.
//
// Kernels, in order on the stream (one wrapper call, one launch count):
//   ssd_bwd_state_kernel  per (chunk, 64 columns of N, head, sequence): Q_c;
//   ssd_bwd_pass_kernel   per (head, sequence, 1024 state elements): the
//                         reverse pass, g_c written over Q_c, dh0, and each
//                         chunk's <g_c, h_in> partial of its elements;
//   ssd_bwd_chunk_kernel  per (64-row tile, chunk, head, sequence): du, dx,
//                         x . du, v, the tile's dB and dC for this head (f32
//                         partials), and its rows' dcs;
//   ssd_bwd_finish_kernel per (chunk, head, sequence), one warp: the last
//                         row's terms, the reverse cumulative sum in f64,
//                         ddt += da A, the chunk's dA partial;
//   ssd_bwd_reduce_kernel dB and dC summed over the heads, dA and dD over
//                         their partials, each in a fixed order.
// No atomics: every output and partial is written once, and every sum runs
// in a fixed order, so two calls agree to the bit.
//
// The forward's C.B^T (cb, stored transposed), cumulative sums (cs) and
// the states entering each chunk (S after its pass) come from the forward
// call, kept for the backward by the wrapper; rows past the sequence are
// masked.  The products are ssd_tile.cuh's 64 x 64 tiles: split TF32 on
// the tensor cores with bf16 inputs (an operand holding f32 values in two
// parts, three products when both do), f32 FMAs with f32 inputs.
//
// Bound: operations.  Per chunk of l rows and head, with t = l (l + 1) / 2
// pairs j <= i: 4 l P N FMAs (Q, g B, u g and dy h_in, each an l x P x N
// product) + t P (G dy) + 2 (N / 64) t P (dy . u, for M's columns beside
// dB and for its rows beside dC, once per 64 columns of N) + 2 t N (M C,
// M B): ~27 M FMAs at l 256, P 64, N 128.
#include "ssd_tile.cuh"

namespace {

// 4 floats of f32 or bf16 stored from f32
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// the block's 64 x 64 tile acc into shared memory, dst[row * LDT + col]
__device__ __forceinline__ void stage(const float (&acc)[2][4][4],
                                      float* dst) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dst + frag_row(mi, h) * LDT +
                                   frag_col(ni)) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

// each row of acc times f[row] (f in shared memory, rows of the tile)
__device__ __forceinline__ void scale_rows(float (&acc)[2][4][4],
                                           const float* f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e = f[frag_row(mi, h)];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        acc[mi][ni][2 * h] *= e;
        acc[mi][ni][2 * h + 1] *= e;
      }
    }
}

// the tile acc (rows r < nrows) to a row-major f32 destination, row
// stride rs
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4],
                                           float* dst, long long rs,
                                           int nrows) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(mi, h);
      if (r < nrows)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<float2*>(dst + r * rs + frag_col(ni)) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

// sum over the two threads of a pair (lanes 2 r and 2 r + 1): every lane
// of the warp calls it
__device__ __forceinline__ float pair_sum(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// 1. Q_c[:, nh * 64 + n] = sum_i e^{cs_i} dy_i (x) C_i[nh * 64 + n] for
// chunk blockIdx.x / NH, column tile blockIdx.x % NH, head blockIdx.y,
// sequence blockIdx.z -> Q (b, nc, H, P, N)
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_kernel(const float* __restrict__ dy, const Tin* __restrict__ C,
                     const float* __restrict__ cs, float* __restrict__ Q,
                     int s, int H, int L, int nc, int lt, long long bc_bs,
                     long long bc_ts) {
  __shared__ __align__(16) float As[KS * LDT], Bs[KS * LDT];
  __shared__ float ecs[MAX_L];
  constexpr int NH = N / T;
  const int c = blockIdx.x / NH, nh = blockIdx.x % NH;
  const int head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * L, len = min(L, s - c0);
  const long long hp = (long long)H * P;
  const float* csp = cs + (((long long)b * nc + c) * H + head) * lt;
  for (int i = tid; i < MAX_L; i += THREADS)
    ecs[i] = i < len ? expf(csp[i]) : 0.f;
  const float* dyg = dy + ((long long)b * s + c0) * hp + (long long)head * P;
  const Tin* Cg = C + b * bc_bs + (long long)c0 * bc_ts + nh * T;
  float acc[2][4][4] = {};   // rows p, columns n - nh * 64
  for (int k0 = 0; k0 < len; k0 += KS) {
    const int nk = min(KS, len - k0);
    __syncthreads();
    load_n(As, dyg + k0 * hp, hp, nk, ecs + k0);
    load_n(Bs, Cg + k0 * bc_ts, bc_ts, nk, (const float*)nullptr);
    __syncthreads();
    product<Tin, true, false>(acc, As, Bs);
  }
  store_tile(acc, Q + (((long long)b * nc + c) * H + head) * P * N + nh * T,
             N, P);
}

// 2. the reverse pass for head blockIdx.y, sequence blockIdx.z, 4 state
// elements a thread: from g = dh (zeros when null), over the chunks from
// the last, Q_c is replaced by g (the cotangent of the state leaving chunk
// c), the block's share of <g, h_in_c> goes to ghp (b, nc, H, gridDim.x),
// and g <- e^{cs_end} g + Q_c; the last g is dh0 (when non-null)
template <int N>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_pass_kernel(const float* __restrict__ cs, const float* __restrict__ S,
                    float* __restrict__ Q, const float* __restrict__ dh,
                    float* __restrict__ dh0, float* __restrict__ ghp, int s,
                    int H, int L, int nc, int lt) {
  __shared__ float red[PASS_THREADS / 32];
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
  for (int c = nc - 1; c >= 0; --c) {
    const long long off = (long long)c * H * q;
    const float4 qc = qp[off], hc = hp[off];
    const float cse = csp[(long long)c * H * lt + min(L, s - c * L) - 1];
    qp[off] = g;
    float part = g.x * hc.x + g.y * hc.y + g.z * hc.z + g.w * hc.w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < PASS_THREADS / 32; ++w) sum += red[w];
      ghp[(((long long)b * nc + c) * H + head) * gridDim.x + blockIdx.x] =
          sum;
    }
    __syncthreads();
    const float decay = expf(cse);
    g = make_float4(g.x * decay + qc.x, g.y * decay + qc.y,
                    g.z * decay + qc.z, g.w * decay + qc.w);
  }
  if (dh0) reinterpret_cast<float4*>(dh0)[st] = g;
}

// 3. rows [t0, t0 + 64) of chunk blockIdx.x / nt (tile blockIdx.x % nt),
// head blockIdx.y, sequence blockIdx.z, against the state entering the
// chunk (S) and the cotangent leaving it (Q after the pass): dx, ddt's
// direct term x . du, the tile's sum of v and of dy . x, the rows' dcs
// (without the last row's chunk terms), and this head's dB and dC rows
// (f32 partials, Bp and Cp (b, H, s, N))
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const Tin* __restrict__ x, const Tin* __restrict__ B,
                     const Tin* __restrict__ C, const float* __restrict__ dt,
                     const float* __restrict__ D, const float* __restrict__ dy,
                     const float* __restrict__ cb, const float* __restrict__ cs,
                     const float* __restrict__ S, const float* __restrict__ Qg,
                     Tin* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dcs, float* __restrict__ vsum,
                     float* __restrict__ dDp, float* __restrict__ Bp,
                     float* __restrict__ Cp, int s, int H, int L, int nc,
                     int nt, long long x_bs, long long x_ts, long long bc_bs,
                     long long bc_ts) {
  __shared__ __align__(16) float As[KS * LDT], Bs[KS * LDT], Ms[T * LDT];
  __shared__ float csc[MAX_L], dtc[MAX_L];
  __shared__ float fr[T], rv[T], rdyx[T];
  constexpr int NH = N / T;
  const int c = blockIdx.x / nt, tt = blockIdx.x % nt;
  const int head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * L, len = min(L, s - c0), t0 = tt * T;
  if (t0 >= len) return;
  const int nT = min(T, len - t0), lt = nt * T, n_tiles = (len + T - 1) / T;
  const long long hp = (long long)H * P;
  const long long chd = ((long long)b * nc + c) * H + head;
  const float* csp = cs + chd * lt;
  for (int i = tid; i < MAX_L; i += THREADS) {
    csc[i] = i < lt ? csp[i] : 0.f;
    dtc[i] = i < len ? dt[((long long)b * s + c0 + i) * H + head] : 0.f;
  }
  const Tin* xg = x + b * x_bs + (long long)c0 * x_ts + (long long)head * P;
  const float* dyg = dy + ((long long)b * s + c0) * hp + (long long)head * P;
  const Tin* Bg = B + b * bc_bs + (long long)c0 * bc_ts;
  const Tin* Cg = C + b * bc_bs + (long long)c0 * bc_ts;
  const float* hg = S + chd * P * N;      // h_in (P, N)
  const float* gg = Qg + chd * P * N;     // g (P, N)
  const float* cbp = cb + ((long long)b * nc + c) * lt * lt;
  __syncthreads();
  const float cs_end = csc[len - 1];
  // the pair of threads (2 r, 2 r + 1) that reduce row r, each over half
  const int pr = tid >> 1, half = tid & 1;
  const bool row_ok = pr < nT;
  if (tid < T) fr[tid] = tid < nT ? expf(cs_end - csc[t0 + tid]) : 0.f;

  // --- du: g B_t, then v, then the quadratic term over key tiles i >= t
  float acc[2][4][4] = {};   // rows t, columns p
  for (int n0 = 0; n0 < N; n0 += KS) {
    __syncthreads();
    load_t(As, Bg + (long long)t0 * bc_ts + n0, bc_ts, nT);
    load_t(Bs, gg + n0, (long long)N, P);
    __syncthreads();
    product<Tin, false, true>(acc, As, Bs);
  }
  stage(acc, Ms);
  __syncthreads();
  {
    // v_t = e^{cs_end - cs_t} dt_t x_t . (g B_t)
    float v = 0.f;
    if (row_ok)
      for (int p = half * 32; p < half * 32 + 32; ++p)
        v += to_f32(xg[(long long)(t0 + pr) * x_ts + p]) * Ms[pr * LDT + p];
    v = pair_sum(v);
    if (half == 0 && row_ok) rv[pr] = v * dtc[t0 + pr] * fr[pr];
    if (half == 0 && !row_ok && pr < T) rv[pr] = 0.f;
  }
  scale_rows(acc, fr);
  for (int it = tt; it < n_tiles; ++it) {
    const int i0 = it * T, nI = min(T, len - i0);
    for (int k0 = 0; k0 < nI; k0 += KS) {
      const int nk = min(KS, nI - k0);
      __syncthreads();
      // At[k][t] = G[i][t] = cb[t][i] e^{cs_i - cs_t}, i = i0 + k0 + k >= t
#pragma unroll
      for (int q = 0; q < PIECES; ++q) {
        const int idx = tid + q * THREADS;
        const int r = idx % T, g4 = idx / T;
        const int ta = t0 + r;
        const float4 w4 = *reinterpret_cast<const float4*>(
            cbp + (long long)ta * lt + i0 + k0 + 4 * g4);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * g4 + e, ia = i0 + k0 + k;
          As[k * LDT + r] = (r < nT && k < nk && ia >= ta)
                                ? wv[e] * expf(csc[ia] - csc[ta])
                                : 0.f;
        }
      }
      load_n(Bs, dyg + (i0 + k0) * hp, hp, nk, (const float*)nullptr);
      __syncthreads();
      product<Tin, true, true>(acc, As, Bs);
    }
  }
  __syncthreads();
  stage(acc, Ms);
  __syncthreads();
  {
    // dx = dt du + D dy; x . du and dy . x per row
    const float d_h = D[head];
    for (int idx = tid; idx < T * P / 4; idx += THREADS) {
      const int r = idx / (P / 4), p = 4 * (idx % (P / 4));
      if (r < nT) {
        const float dtr = dtc[t0 + r];
        const float4 g4 = *reinterpret_cast<const float4*>(
            dyg + (long long)(t0 + r) * hp + p);
        const float* m = Ms + r * LDT + p;
        store4(dx + ((long long)b * s + c0 + t0 + r) * hp +
                   (long long)head * P + p,
               dtr * m[0] + d_h * g4.x, dtr * m[1] + d_h * g4.y,
               dtr * m[2] + d_h * g4.z, dtr * m[3] + d_h * g4.w);
      }
    }
    float xdu = 0.f, dyx = 0.f;
    if (row_ok)
      for (int p = half * 32; p < half * 32 + 32; ++p) {
        const float xv = to_f32(xg[(long long)(t0 + pr) * x_ts + p]);
        xdu += xv * Ms[pr * LDT + p];
        dyx += xv * dyg[(long long)(t0 + pr) * hp + p];
      }
    xdu = pair_sum(xdu);
    dyx = pair_sum(dyx);
    if (half == 0 && row_ok)
      ddt[((long long)b * s + c0 + t0 + pr) * H + head] = xdu;
    if (half == 0 && pr < T) rdyx[pr] = row_ok ? dyx : 0.f;
  }

  // --- dB: u_t g, then sum_{i >= t} M_it C_i; the columns' W sums
  float wcol = 0.f;   // this pair's share of sum_i W_it, t = pr
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) {
    float accb[2][4][4] = {};   // rows t, columns n - nh * 64
    for (int p0 = 0; p0 < P; p0 += KS) {
      __syncthreads();
      load_t(As, xg + (long long)t0 * x_ts + p0, x_ts, nT);
      load_n(Bs, gg + (long long)p0 * N + nh * T, (long long)N, KS,
             (const float*)nullptr);
      __syncthreads();
      product<Tin, false, true>(accb, As, Bs);
    }
    __syncthreads();
    if (tid < T) fr[tid] = tid < nT ? dtc[t0 + tid] *
                                          expf(cs_end - csc[t0 + tid])
                                    : 0.f;
    __syncthreads();
    scale_rows(accb, fr);
    for (int it = tt; it < n_tiles; ++it) {
      const int i0 = it * T, nI = min(T, len - i0);
      // M[i][t] = e_it dt_t (dy_i . x_t)
      float accm[2][4][4] = {};   // rows i, columns t
      for (int p0 = 0; p0 < P; p0 += KS) {
        __syncthreads();
        load_t(As, dyg + (long long)i0 * hp + p0, hp, nI);
        load_t(Bs, xg + (long long)t0 * x_ts + p0, x_ts, nT);
        __syncthreads();
        product<Tin, true, false>(accm, As, Bs);
      }
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = frag_row(mi, h), ia = i0 + i;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = frag_col(ni) + e, ta = t0 + t;
              Ms[i * LDT + t] =
                  (i < nI && t < nT && ia >= ta)
                      ? accm[mi][ni][2 * h + e] * dtc[ta] *
                            expf(csc[ia] - csc[ta])
                      : 0.f;
            }
        }
      __syncthreads();
      if (nh == 0) {
        float w = 0.f;
        if (row_ok)
          for (int i = half * 32; i < min(nI, half * 32 + 32); ++i)
            w += Ms[i * LDT + pr] * cbp[(long long)(t0 + pr) * lt + i0 + i];
        wcol += w;
      }
      for (int k0 = 0; k0 < nI; k0 += KS) {
        const int nk = min(KS, nI - k0);
        __syncthreads();
        load_n(Bs, Cg + (long long)(i0 + k0) * bc_ts + nh * T, bc_ts, nk,
               (const float*)nullptr);
        __syncthreads();
        product<Tin, true, false>(accb, Ms + k0 * LDT, Bs);
      }
    }
    store_tile(accb,
               Bp + (((long long)b * H + head) * s + c0 + t0) * N + nh * T,
               N, nT);
  }
  wcol = pair_sum(wcol);

  // --- dC: e^{cs_t} dy_t h_in, then sum_{j <= t} M_tj B_j; the rows' W
  // sums and the carried state's dcs term
  float wrow = 0.f, carry = 0.f;
  __syncthreads();
  if (tid < T) fr[tid] = tid < nT ? expf(csc[t0 + tid]) : 0.f;
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) {
    float accc[2][4][4] = {};   // rows t, columns n - nh * 64
    for (int p0 = 0; p0 < P; p0 += KS) {
      __syncthreads();
      load_t(As, dyg + (long long)t0 * hp + p0, hp, nT);
      load_n(Bs, hg + (long long)p0 * N + nh * T, (long long)N, KS,
             (const float*)nullptr);
      __syncthreads();
      product<Tin, true, true>(accc, As, Bs);
    }
    // carried: e^{cs_t} C_t . (dy_t h_in)
    __syncthreads();
    stage(accc, Ms);
    __syncthreads();
    {
      float w = 0.f;
      if (row_ok)
        for (int n = half * 32; n < half * 32 + 32; ++n)
          w += to_f32(Cg[(long long)(t0 + pr) * bc_ts + nh * T + n]) *
               Ms[pr * LDT + n];
      carry += w;
    }
    scale_rows(accc, fr);
    for (int jt = 0; jt <= tt; ++jt) {
      const int j0 = jt * T, nJ = min(T, len - j0);
      // M[t][j], stored [j][t]: e_tj dt_j (dy_t . x_j)
      float accm[2][4][4] = {};   // rows j, columns t
      for (int p0 = 0; p0 < P; p0 += KS) {
        __syncthreads();
        load_t(As, xg + (long long)j0 * x_ts + p0, x_ts, nJ);
        load_t(Bs, dyg + (long long)t0 * hp + p0, hp, nT);
        __syncthreads();
        product<Tin, false, true>(accm, As, Bs);
      }
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = frag_row(mi, h), ja = j0 + j;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = frag_col(ni) + e, ta = t0 + t;
              Ms[j * LDT + t] =
                  (j < nJ && t < nT && ja <= ta)
                      ? accm[mi][ni][2 * h + e] * dtc[ja] *
                            expf(csc[ta] - csc[ja])
                      : 0.f;
            }
        }
      __syncthreads();
      if (nh == 0) {
        float w = 0.f;
        if (row_ok)
          for (int j = half * 32; j < min(nJ, half * 32 + 32); ++j)
            w += Ms[j * LDT + pr] * cbp[(long long)(j0 + j) * lt + t0 + pr];
        wrow += w;
      }
      for (int k0 = 0; k0 < nJ; k0 += KS) {
        const int nk = min(KS, nJ - k0);
        __syncthreads();
        load_n(Bs, Bg + (long long)(j0 + k0) * bc_ts + nh * T, bc_ts, nk,
               (const float*)nullptr);
        __syncthreads();
        product<Tin, true, false>(accc, Ms + k0 * LDT, Bs);
      }
    }
    store_tile(accc,
               Cp + (((long long)b * H + head) * s + c0 + t0) * N + nh * T,
               N, nT);
  }
  wrow = pair_sum(wrow);
  carry = pair_sum(carry);
  __syncthreads();
  if (half == 0 && row_ok)
    dcs[chd * lt + t0 + pr] = wrow - wcol + fr[pr] * carry - rv[pr];
  if (tid == 0) {
    float sv = 0.f, sd = 0.f;
    for (int r = 0; r < nT; ++r) {
      sv += rv[r];
      sd += rdyx[r];
    }
    vsum[chd * nt + tt] = sv;
    dDp[chd * nt + tt] = sd;
  }
}

// 4. one warp per (chunk blockIdx.x, head blockIdx.y, sequence
// blockIdx.z): the last row's dcs gets sum_j v_j + e^{cs_end} <g, h_in>;
// da = the reverse cumulative sum of dcs in f64 (8 rows a lane, then a
// shuffle scan), ddt += da A, and the chunk's dA partial sum_k da_k dt_k
__global__ void __launch_bounds__(32)
ssd_bwd_finish_kernel(const float* __restrict__ cs,
                      const float* __restrict__ dcs,
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
  float extra = 0.f;
  if (lane == 0) {
    float sv = 0.f, gh = 0.f;
    for (int t = 0; t < (len + T - 1) / T; ++t) sv += vsum[chd * nt + t];
    for (int k = 0; k < pass_blocks; ++k) gh += ghp[chd * pass_blocks + k];
    extra = sv + expf(cs[chd * lt + len - 1]) * gh;
  }
  extra = __shfl_sync(0xffffffffu, extra, 0);
  constexpr int R = MAX_L / 32;
  double v[R], run = 0.0;
#pragma unroll
  for (int q = R - 1; q >= 0; --q) {
    const int r = lane * R + q;
    const float d = r < len ? dcs[chd * lt + r] + (r == len - 1 ? extra : 0.f)
                            : 0.f;
    run += (double)d;
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

// 5. dB and dC: the heads' partials summed in head order, 4 elements a
// thread, in the input dtype; the grid's last block sums dA over (b,
// chunk) and dD over (b, chunk, tile) partials, in that order
template <typename Tin, int N>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_kernel(const float* __restrict__ Bp,
                      const float* __restrict__ Cp, Tin* __restrict__ dB,
                      Tin* __restrict__ dC, const float* __restrict__ dAp,
                      const float* __restrict__ dDp, float* __restrict__ dA,
                      float* __restrict__ dD, int b, int s, int H, int L,
                      int nc, int nt) {
  const long long row4 = (long long)s * N / 4;   // float4s of a sequence
  if (blockIdx.x == gridDim.x - 1) {
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
    return;
  }
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= b * row4) return;
  const long long bi = e / row4, rem = e % row4;
  const float4* bp = reinterpret_cast<const float4*>(Bp) + bi * H * row4 +
                     rem;
  const float4* cp = reinterpret_cast<const float4*>(Cp) + bi * H * row4 +
                     rem;
  float4 sb = make_float4(0, 0, 0, 0), sc = sb;
  for (int h = 0; h < H; ++h) {
    const float4 u = bp[h * row4], w = cp[h * row4];
    sb = make_float4(sb.x + u.x, sb.y + u.y, sb.z + u.z, sb.w + u.w);
    sc = make_float4(sc.x + w.x, sc.y + w.y, sc.z + w.z, sc.w + w.w);
  }
  store4(dB + 4 * e, sb.x, sb.y, sb.z, sb.w);
  store4(dC + 4 * e, sc.x, sc.y, sc.z, sc.w);
}

// the scratch's float counts, each a multiple of 4 (16-byte aligned)
struct Work {
  long long q, dcs, vsum, ghp, dDp, dAp, part;
  Work(int n, int b, int s, int H, int L) {
    const long long nc = (s + L - 1) / L, nt = (L + T - 1) / T;
    const long long chd = (long long)b * nc * H;
    auto r4 = [](long long v) { return (v + 3) / 4 * 4; };
    q = r4(chd * P * n);
    dcs = r4(chd * nt * T);
    vsum = r4(chd * nt);
    ghp = r4(chd * (P * n / 4 / PASS_THREADS));
    dDp = r4(chd * nt);
    dAp = r4(chd);
    part = r4((long long)b * H * s * n);
  }
  long long total() const { return q + dcs + vsum + ghp + dDp + dAp + 2 * part; }
};

template <typename Tin, int N>
int launch(const void* xv, const void* Bv, const void* Cv, const float* dt,
           const float* A, const float* D, const float* dy, const float* dh,
           const float* cb, const float* cs, const float* S, void* dxv,
           void* dBv, void* dCv, float* ddt, float* dA, float* dD,
           float* dh0, float* work, int b, int s, int H, int L,
           long long x_bs, long long x_ts, long long bc_bs, long long bc_ts,
           cudaStream_t stream) {
  const Tin* x = static_cast<const Tin*>(xv);
  const Tin* B = static_cast<const Tin*>(Bv);
  const Tin* C = static_cast<const Tin*>(Cv);
  Tin* dx = static_cast<Tin*>(dxv);
  const int nc = (s + L - 1) / L, nt = (L + T - 1) / T, lt = nt * T;
  constexpr int NH = N / T, PASS_BLOCKS = P * N / 4 / PASS_THREADS;
  const Work w(N, b, s, H, L);
  float* Q = work;
  float* dcs = Q + w.q;
  float* vsum = dcs + w.dcs;
  float* ghp = vsum + w.vsum;
  float* dDp = ghp + w.ghp;
  float* dAp = dDp + w.dDp;
  float* Bp = dAp + w.dAp;
  float* Cp = Bp + w.part;
  cudaError_t err;
  ssd_bwd_state_kernel<Tin, N><<<dim3(nc * NH, H, b), THREADS, 0, stream>>>(
      dy, C, cs, Q, s, H, L, nc, lt, bc_bs, bc_ts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_pass_kernel<N><<<dim3(PASS_BLOCKS, H, b), PASS_THREADS, 0,
                           stream>>>(cs, S, Q, dh, dh0, ghp, s, H, L, nc, lt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<Tin, N><<<dim3(nc * nt, H, b), THREADS, 0, stream>>>(
      x, B, C, dt, D, dy, cb, cs, S, Q, dx, ddt, dcs, vsum, dDp, Bp, Cp, s,
      H, L, nc, nt, x_bs, x_ts, bc_bs, bc_ts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_finish_kernel<<<dim3(nc, H, b), 32, 0, stream>>>(
      cs, dcs, vsum, ghp, dt, A, ddt, dAp, s, H, L, nc, nt, PASS_BLOCKS);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n4 = (long long)b * s * N / 4;
  ssd_bwd_reduce_kernel<Tin, N><<<(unsigned)((n4 + 255) / 256 + 1), 256, 0,
                                  stream>>>(
      Bp, Cp, static_cast<Tin*>(dBv), static_cast<Tin*>(dCv), dAp, dDp, dA,
      dD, b, s, H, L, nc, nt);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of scratch ssd_chunk_scan_bwd needs for these shapes
extern "C" long long ssd_chunk_scan_bwd_workspace(int n, int b, int s, int H,
                                                  int L) {
  return Work(n, b, s, H, L).total();
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and dx, dB, dC).  x, B and C as
// the forward takes them (strides x_bs, x_ts and bc_bs, bc_ts, 4-element
// aligned); dt (b, s, H), A, D (H,), dy (b, s, H, P), dh and dh0 (b, H, P,
// N; either may be null) f32 contiguous; cb, cs and S the forward's
// scratch after its call (S: the states entering the chunks); dx (b, s,
// H, P), dB, dC (b, s, N) contiguous in the input dtype; ddt (b, s, H),
// dA, dD (H,) f32; work ssd_chunk_scan_bwd_workspace floats, 16-byte
// aligned.  P = 64, N 64 or 128, 1 <= L <= 256.  Launches the five
// kernels on the stream; returns the first launch's error (cudaError_t).
extern "C" int ssd_chunk_scan_bwd(int dtype, int n, const void* x,
                                  const void* B, const void* C,
                                  const float* dt, const float* A,
                                  const float* D, const float* dy,
                                  const float* dh, const float* cb,
                                  const float* cs, const float* S, void* dx,
                                  void* dB, void* dC, float* ddt, float* dA,
                                  float* dD, float* dh0, float* work, int b,
                                  int s, int H, int L, long long x_bs,
                                  long long x_ts, long long bc_bs,
                                  long long bc_ts, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return 0;
  if (L < 1 || L > MAX_L || (n != 64 && n != 128) || (dtype != 0 &&
                                                       dtype != 1))
    return (int)cudaErrorInvalidValue;
#define SSD_BWD_LAUNCH(Tin, N)                                              \
  return launch<Tin, N>(x, B, C, dt, A, D, dy, dh, cb, cs, S, dx, dB, dC,  \
                        ddt, dA, dD, dh0, work, b, s, H, L, x_bs, x_ts,     \
                        bc_bs, bc_ts, stream)
  if (dtype == 1) {
    if (n == 64) SSD_BWD_LAUNCH(__nv_bfloat16, 64);
    SSD_BWD_LAUNCH(__nv_bfloat16, 128);
  }
  if (n == 64) SSD_BWD_LAUNCH(float, 64);
  SSD_BWD_LAUNCH(float, 128);
#undef SSD_BWD_LAUNCH
}
