// The Mamba2 decode step for Hopper, one token per sequence, in place: the
// token's causal conv with SiLU, then the recurrent step, in one launch.
//
// Replaces the decode half of repro/models/ssm.py:31 (_causal_conv at
// s = 1, over x, B and C) and the recurrence of repro/models/ssm.py:138
// (ssm_decode_step, :150-157), which the reference leaves to XLA as jnp.
// For each sequence b, with the pre-conv token x (b, H P), B, C (b, N)
// and the conv tails (b, cw - 1, .) of the activation dtype (bf16 or
// f32):
//   u        = silu(sum_{i < cw - 1} tail[i] w[i] + token w[cw - 1]),
//              summed in f32 from i = 0 and rounded once to the
//              activation dtype (as the prefill conv rounds its output)
//   tail    <- tail[1:] || token
// and then for each SSD head h, on the conv outputs x', B', C':
//   h[b,h] <- h[b,h] * exp(dt[b,h] * A[h]) + (dt[b,h] * x'[b,h,:]) (x) B'[b,:]
//   y[b,h,p] = sum_n h[b,h,p,n] * C'[b,n] + D[h] * x'[b,h,p]
// with the state h (b, H, P, N) f32 and all three tails updated in place,
// dt (b, H) f32 after softplus, A = -exp(A_log) and D as f32 (H,), y (b,
// H, P) f32.  The recurrence is f32; nvcc contracts the multiply-adds
// into FMAs, which round once where the reference rounds twice.
//
// Bound: bytes.  Each state element is read once and written once (8
// bytes) for 2 FMAs of update and one of the y product: 3 flops a 8
// bytes, far under the card's f32 ridge.  mamba2-1.3b's decode over 8
// slots moves 2 x 8 x 64 x 64 x 128 x 4 = 33.5 MB a layer, ~10 us at
// 3.35 TB/s (zamba2-2.7b's, 80 heads at N 64, 21 MB); the conv's inputs,
// weights and tails add ~0.2 MB.  So the design streams the whole state
// at once: one block of 256 threads per (head, sequence), one wave at the
// main shapes (launch bounds), and each thread's copies of the head's
// state issued before anything else waits.  The block walks the head's
// state as one run of P N / 4 float4s, thread t taking float4s t, t +
// 256, ...: a row is a segment of N / 4 lanes (32 at N 128, 16 at N 64,
// every lane busy at any N a multiple of 4 up to 128; past 128 a lane
// takes several float4s of its row, and N / 4 not a power of two leaves
// the segment's last lanes idle), and the walk advances by adding, with
// no division.  A thread's float4s (8 at mamba2's shape, 4 at zamba2's;
// batches of 8 past that) go to shared memory by its own cp.async
// copies, so no register is held across the conv and no barrier guards
// them (a thread reads back only its own).  The rows' y sums are reduced
// within their segments by a reduce-scatter butterfly (8 rows in 9
// shuffles at N 128).
//
// The conv rides in the same launch (one of its own moves ~0.2 MB in a
// launch's ~5 us floor).  Every block convolves the whole of B and C (2 x
// N channels x cw taps) and its head's P channels of x into shared
// memory, one channel a thread, every tap load of a channel issued at
// once, before the state's copies; x's tail is shifted in place (each
// channel belongs to one head's block, which reads its old rows first).
// B's and C's tails are read by every head's block, so the last block of
// each sequence writes them: after the conv's barrier one thread per
// block adds to the sequence's arrival counter with one acquire-release
// atomic (ordering the block's reads of the old rows before it, and the
// other blocks' reads before the last one's writes), and the block that
// arrives H-th writes the new rows, kept in shared memory, in place
// and sets the counter back to 0 for the next launch.  The wrapper owns
// the counters (one int32 per sequence, device and stream, each on its
// own 128-byte line, zeroed once).  Nothing of the state is read twice
// or written twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_N = 1024;
constexpr int MAX_P = 1024;
constexpr int MAX_CW = 4;       // longest conv (the prefill conv's)
constexpr unsigned FULL = 0xffffffffu;
// a sequence's arrival counter is arrivals[b * ARRIVAL_STRIDE]: one
// 128-byte line each, so the slots' atomics do not queue on one line
constexpr int ARRIVAL_STRIDE = 32;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}
// dynamic shared memory: B' and C' (N f32 each) and x' (P f32) at 0, the
// new B and C tails ((cw - 1, N) of T each, as they lie in global memory)
// at tails_at, and the state's staging from stage_at
__host__ __device__ constexpr size_t tails_at(int N, int P) {
  return align16((size_t)(2 * N + P) * 4);
}
__host__ __device__ constexpr size_t stage_at(int N, int P, int tr,
                                              size_t elem) {
  return align16(tails_at(N, P) + (size_t)2 * tr * N * elem);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to the activation dtype, back in f32
__device__ __forceinline__ float rounded(float v, float) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 bytes from global to shared memory, asynchronously (cp.async; L2
// only), and the wait for all of this thread's copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one channel's conv inputs: its cw - 1 tail rows, cw taps and the token
template <typename T, int CW>
struct Taps {
  T tail[CW - 1], w[CW], cur;
};

// every load of one channel's taps issued at once (rows rs apart)
template <typename T, int CW>
__device__ __forceinline__ void load_taps(Taps<T, CW>& a, const T* tail,
                                          const T* w, const T* cur,
                                          long long rs) {
#pragma unroll
  for (int i = 0; i < CW - 1; ++i) a.tail[i] = tail[i * rs];
#pragma unroll
  for (int i = 0; i < CW; ++i) a.w[i] = w[i * rs];
  a.cur = *cur;
}

// silu(sum_i tail[i] w[i] + cur w[cw - 1]), summed in f32 from i = 0 and
// rounded once to T
template <typename T, int CW>
__device__ __forceinline__ float conv_silu(const Taps<T, CW>& a) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < CW - 1; ++i) acc += to_f32(a.tail[i]) * to_f32(a.w[i]);
  acc += to_f32(a.cur) * to_f32(a.w[CW - 1]);
  return rounded(acc * (1.f / (1.f + expf(-acc))), T());
}

// A thread's walk over its head's state, without a division: a row is a
// segment of seg = 2^lg_seg lanes (N / 4 rounded up to a power of two, at
// most 32; lanes past N / 4 idle), a lane taking float4s lane + seg j of
// its row for j < per_row, and a pass covers THREADS / seg rows.  Where
// N / 4 is a power of two up to 32 this is the flat walk: a thread's item
// k is float4 t + THREADS k of the head's run.
struct Walk {
  int lg_seg, per_row, items;
};

// row p and float4 column n4 of a thread's current item; ONE: per_row is
// 1 (N <= 128), so the column never moves
template <bool ONE>
struct Cursor {
  int p, n4, j;
  __device__ __forceinline__ Cursor(const Walk& w, int t)
      : p(t >> w.lg_seg), n4(t & ((1 << w.lg_seg) - 1)), j(0) {}
  __device__ __forceinline__ bool in(int P, int n4s) const {
    return p < P && n4 < n4s;
  }
  __device__ __forceinline__ bool row_done(const Walk& w) const {
    return ONE || j == w.per_row - 1;
  }
  __device__ __forceinline__ void next(const Walk& w) {
    if (ONE) {
      p += THREADS >> w.lg_seg;
    } else if (++j == w.per_row) {
      j = 0;
      p += THREADS >> w.lg_seg;
      n4 -= (w.per_row - 1) << w.lg_seg;
    } else {
      n4 += 1 << w.lg_seg;
    }
  }
};

// one wave at the main shapes: 4 blocks an SM (528 >= mamba2's 512
// blocks) with 8 float4s a thread in flight, 5 (660 >= zamba2's 640) with 4
template <typename T, int CW, int K, bool ONE>
__global__ void __launch_bounds__(THREADS, K == 4 ? 5 : 4)
ssm_step_kernel(float* __restrict__ h, const T* __restrict__ x,
                const T* __restrict__ B, const T* __restrict__ C,
                const T* __restrict__ wx, const T* __restrict__ wB,
                const T* __restrict__ wC, T* __restrict__ tx,
                T* __restrict__ tB, T* __restrict__ tC,
                int* __restrict__ arrivals, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ D,
                float* __restrict__ y, int H, int P, int N,
                long long x_stride, long long bc_stride, Walk walk) {
  constexpr int tr = CW - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  float* Cs = Bs + N;
  float* xs = Cs + N;
  T* nt = reinterpret_cast<T*>(smem + tails_at(N, P));
  const int head = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int n4s = N / 4;
  const long long di = (long long)H * P;       // x's channels
  float4* hh = reinterpret_cast<float4*>(
      h + ((long long)b * H + head) * P * N);
  // the conv's jobs: B's and C's 2 N channels, then this head's P
  // channels of x; thread t takes jobs t, t + THREADS, ...  A job's
  // inputs: the tails' rows, the taps and the token
  const int jobs = 2 * N + P;
  const auto taps = [&](Taps<T, CW>& a, int j) {
    if (j < 2 * N) {
      const bool is_c = j >= N;
      const int n = is_c ? j - N : j;
      load_taps(a, (is_c ? tC : tB) + (long long)b * tr * N + n,
                (is_c ? wC : wB) + n, (is_c ? C : B) + b * bc_stride + n,
                (long long)N);
    } else {
      const long long ch = (long long)head * P + (j - 2 * N);
      load_taps(a, tx + (long long)b * tr * di + ch, wx + ch,
                x + b * x_stride + ch, di);
    }
  };
  // the conv's output into shared memory; B's and C's new tails there
  // too, x's shifted in place (each x channel is this block's alone)
  const auto conv = [&](int j, const Taps<T, CW>& a) {
    const float u = conv_silu(a);
    T* row;
    long long rs;
    if (j < 2 * N) {
      const bool is_c = j >= N;
      const int n = is_c ? j - N : j;
      (is_c ? Cs : Bs)[n] = u;
      row = nt + (is_c ? tr * N : 0) + n;
      rs = N;
    } else {
      const int p = j - 2 * N;
      xs[p] = u;
      row = tx + (long long)b * tr * di + (long long)head * P + p;
      rs = di;
    }
#pragma unroll
    for (int i = 0; i + 1 < tr; ++i) row[i * rs] = a.tail[i + 1];
    row[(tr - 1) * rs] = a.cur;
  };
  // this thread's first two jobs' inputs, then the state, all in flight
  // at once
  Taps<T, CW> a0, a1;
  if (t < jobs) taps(a0, t);
  if (t + THREADS < jobs) taps(a1, t + THREADS);
  // thread t's k-th float4 of a batch, staged at sb[k * THREADS + t] by its
  // own cp.async: no register is held across the conv
  float4* sb = reinterpret_cast<float4*>(smem + stage_at(N, P, tr, sizeof(T)));
  Cursor<ONE> ld(walk, t);                     // the next item to load
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < walk.items && ld.in(P, n4s))
      cp_async16(sb + k * THREADS + t, hh + (long long)ld.p * n4s + ld.n4);
    ld.next(walk);
  }

  if (t < jobs) conv(t, a0);
  for (int j = t + THREADS; j < jobs; j += THREADS) {
    if (j >= t + 2 * THREADS) taps(a1, j);
    conv(j, a1);
  }
  __syncthreads();
  // every thread of this block has read the old B and C tails: the last
  // thread (whose warp, at the main shapes, stores no tail rows) arrives
  // by one acquire-release atomic, ordering the block's reads before it
  // and, in the block that arrives last, every earlier block's reads
  // before its tail writes
  constexpr int ARRIVER = THREADS - 1;
  int arrived = 0;
  if (t == ARRIVER)
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
                 : "=r"(arrived)
                 : "l"(arrivals + b * ARRIVAL_STRIDE), "r"(1)
                 : "memory");

  const float dtv = dt[(long long)b * H + head];
  const float decay = expf(dtv * A[head]);
  const float d = D[head];
  float* yr = y + ((long long)b * H + head) * P;
  const float4* B4 = reinterpret_cast<const float4*>(Bs);
  const float4* C4 = reinterpret_cast<const float4*>(Cs);
  const int seg = 1 << walk.lg_seg;
  Cursor<ONE> up(walk, t);                     // the next item to update
  const int lane_s = t & (seg - 1), rows = THREADS >> walk.lg_seg;
  float acc = 0.f, part[K];
  for (int base = 0; base < walk.items; base += K) {
    if (base > 0) {             // the first batch is in flight already
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (base + k < walk.items && ld.in(P, n4s))
          cp_async16(sb + k * THREADS + t,
                     hh + (long long)ld.p * n4s + ld.n4);
        ld.next(walk);
      }
    }
    cp_async_wait_all();        // this thread's own copies only
    const int p0 = up.p;                        // the batch's first row
#pragma unroll
    for (int k = 0; k < K; ++k) {
      part[k] = 0.f;
      if (base + k >= walk.items) break;        // the same for every thread
      if (up.in(P, n4s)) {
        float4 s = sb[k * THREADS + t];
        const float dx = dtv * xs[up.p];
        const float4 bb = B4[up.n4], cc = C4[up.n4];
        s.x = s.x * decay + dx * bb.x;
        s.y = s.y * decay + dx * bb.y;
        s.z = s.z * decay + dx * bb.z;
        s.w = s.w * decay + dx * bb.w;
        hh[(long long)up.p * n4s + up.n4] = s;
        part[k] = s.x * cc.x + s.y * cc.y + s.z * cc.z + s.w * cc.w;
      }
      if constexpr (!ONE) {
        acc += part[k];
        if (up.row_done(walk)) {                // the same for every thread
          for (int off = seg >> 1; off > 0; off >>= 1)
            acc += __shfl_xor_sync(FULL, acc, off);
          if (lane_s == 0 && up.p < P) yr[up.p] = acc + xs[up.p] * d;
          acc = 0.f;
        }
      }
      up.next(walk);
    }
    if constexpr (ONE) {
      // every item is a whole row's part: the batch's K rows reduced
      // together by a reduce-scatter butterfly.  At each of the first
      // levels a lane keeps half of its sums and trades the other half
      // with its partner, so 32 lanes sum 8 rows in 4 + 2 + 1 + 1 + 1
      // shuffles (40 one row at a time); `first` is the lane's first row
      int first = 0, off = seg >> 1, split = 0;
#pragma unroll
      for (int half = K / 2; half >= 1; half /= 2) {
        if (off == 0) break;                    // a narrower segment
        const bool upper = lane_s & off;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = upper ? part[i] : part[i + half];
          part[i] = (upper ? part[i + half] : part[i]) +
                    __shfl_xor_sync(FULL, send, off);
        }
        first += upper ? half : 0;
        off >>= 1;
        ++split;
      }
      const int mask = off ? 2 * off - 1 : 0;   // the plain levels' lanes
      for (; off > 0; off >>= 1)
        part[0] += __shfl_xor_sync(FULL, part[0], off);
      if ((lane_s & mask) == 0) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int k = first + i, p = p0 + k * rows;
          if (i < (K >> split) && base + k < walk.items && p < P)
            yr[p] = part[i] + xs[p] * d;
        }
      }
    }
  }
  // the sequence's last block writes B's and C's new tails in place (the
  // arriving thread's warp, whose barrier passes the arriver's acquire on
  // to its other lanes)
  if ((t >> 5) == (ARRIVER >> 5)) {
    if (__shfl_sync(FULL, arrived, ARRIVER & 31) == H - 1) {
      __syncwarp();
      const int n_tail = tr * N;
      T* gB = tB + (long long)b * n_tail;
      T* gC = tC + (long long)b * n_tail;
      const int n16 = n_tail * (int)sizeof(T) / 16;
      if (n_tail * sizeof(T) % 16 == 0 &&
          (reinterpret_cast<uintptr_t>(gB) |
           reinterpret_cast<uintptr_t>(gC)) % 16 == 0) {
        const uint4* src = reinterpret_cast<const uint4*>(nt);
        for (int e = t & 31; e < 2 * n16; e += 32)
          reinterpret_cast<uint4*>(e < n16 ? gB : gC)[e % n16] = src[e];
      } else {
        for (int e = t & 31; e < 2 * n_tail; e += 32)
          (e < n_tail ? gB : gC)[e % n_tail] = nt[e];
      }
      if (t == ARRIVER) arrivals[b * ARRIVAL_STRIDE] = 0;
    }
  }
}

Walk walk_of(int P, int N) {
  Walk w;
  const int n4s = N / 4;
  w.lg_seg = 0;
  while ((1 << w.lg_seg) < n4s && w.lg_seg < 5) ++w.lg_seg;
  w.per_row = (n4s + (1 << w.lg_seg) - 1) >> w.lg_seg;
  const int rows = THREADS >> w.lg_seg;
  w.items = (P + rows - 1) / rows * w.per_row;
  return w;
}

template <typename T, int CW, int K, bool ONE>
int launch(float* h, const void* x, const void* B, const void* C,
           const void* wx, const void* wB, const void* wC, void* tx,
           void* tB, void* tC, int* arrivals, const float* dt,
           const float* A, const float* D, float* y, int b, int H, int P,
           int N, long long x_stride, long long bc_stride, Walk walk,
           cudaStream_t stream) {
  // past 48 KB (N 512 and up) the launch needs the opt-in: granted once
  // per instantiation for the largest head it takes (68 KB at f32, cw 4)
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_step_kernel<T, CW, K, ONE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(stage_at(MAX_N, MAX_P, CW - 1, sizeof(T)) +
            (size_t)K * THREADS * 16));
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem =
      stage_at(N, P, CW - 1, sizeof(T)) + (size_t)K * THREADS * 16;
  ssm_step_kernel<T, CW, K, ONE><<<dim3(H, b), THREADS, smem, stream>>>(
      h, static_cast<const T*>(x), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(wx),
      static_cast<const T*>(wB), static_cast<const T*>(wC),
      static_cast<T*>(tx), static_cast<T*>(tB), static_cast<T*>(tC),
      arrivals, dt, A, D, y, H, P, N, x_stride, bc_stride, walk);
  return (int)cudaGetLastError();
}

// the instantiation for cw and the state's walk: 4 float4s a thread in
// flight where the head's state takes no more (zamba2's), else 8
// (mamba2's; batches of 8 past that)
template <typename T, int CW>
int launch_k(float* h, const void* x, const void* B, const void* C,
             const void* wx, const void* wB, const void* wC, void* tx,
             void* tB, void* tC, int* arrivals, const float* dt,
             const float* A, const float* D, float* y, int b, int H, int P,
             int N, long long x_stride, long long bc_stride,
             cudaStream_t stream) {
  const Walk w = walk_of(P, N);
  if (w.per_row > 1)
    return launch<T, CW, 8, false>(h, x, B, C, wx, wB, wC, tx, tB, tC,
                                   arrivals, dt, A, D, y, b, H, P, N,
                                   x_stride, bc_stride, w, stream);
  if (w.items <= 4)
    return launch<T, CW, 4, true>(h, x, B, C, wx, wB, wC, tx, tB, tC,
                                  arrivals, dt, A, D, y, b, H, P, N,
                                  x_stride, bc_stride, w, stream);
  return launch<T, CW, 8, true>(h, x, B, C, wx, wB, wC, tx, tB, tC,
                                arrivals, dt, A, D, y, b, H, P, N, x_stride,
                                bc_stride, w, stream);
}

template <typename T>
int launch_for(float* h, const void* x, const void* B, const void* C,
               const void* wx, const void* wB, const void* wC, void* tx,
               void* tB, void* tC, int* arrivals, const float* dt,
               const float* A, const float* D, float* y, int b, int H,
               int P, int N, int cw, long long x_stride,
               long long bc_stride, cudaStream_t stream) {
  switch (cw) {
    case 2:
      return launch_k<T, 2>(h, x, B, C, wx, wB, wC, tx, tB, tC, arrivals,
                            dt, A, D, y, b, H, P, N, x_stride, bc_stride,
                            stream);
    case 3:
      return launch_k<T, 3>(h, x, B, C, wx, wB, wC, tx, tB, tC, arrivals,
                            dt, A, D, y, b, H, P, N, x_stride, bc_stride,
                            stream);
    default:
      return launch_k<T, 4>(h, x, B, C, wx, wB, wC, tx, tB, tC, arrivals,
                            dt, A, D, y, b, H, P, N, x_stride, bc_stride,
                            stream);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C, the conv weights and tails).  h
// (b, H, P, N) f32 contiguous and 16-byte aligned, N a multiple of 4 up
// to MAX_N, P up to MAX_P, 2 <= cw <= MAX_CW; x (b, H P) rows b apart by
// x_stride elements, H P contiguous; B and C rows b apart by bc_stride, N
// contiguous; the weights wx (cw, H P), wB and wC (cw, N) and the tails
// tx (b, cw - 1, H P), tB and tC (b, cw - 1, N) contiguous, the tails
// updated in place; arrivals (b - 1) ARRIVAL_STRIDE + 1 int32 counters
// (sequence b's at b ARRIVAL_STRIDE), all 0, used by no other launch in
// flight (each launch leaves them 0); dt (b, H), A, D
// (H,) and y (b, H, P) f32 contiguous.  Returns the launch's cudaError_t.
extern "C" int ssm_step(int dtype, float* h, const void* x, const void* B,
                        const void* C, const void* wx, const void* wB,
                        const void* wC, void* tx, void* tB, void* tC,
                        int* arrivals, const float* dt, const float* A,
                        const float* D, float* y, int b, int H, int P, int N,
                        int cw, long long x_stride, long long bc_stride,
                        cudaStream_t stream) {
  if (b <= 0) return 0;
  if (N <= 0 || N % 4 || N > MAX_N || P <= 0 || P > MAX_P || cw < 2 ||
      cw > MAX_CW)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_for<__nv_bfloat16>(h, x, B, C, wx, wB, wC, tx, tB, tC,
                                     arrivals, dt, A, D, y, b, H, P, N, cw,
                                     x_stride, bc_stride, stream);
  return launch_for<float>(h, x, B, C, wx, wB, wC, tx, tB, tC, arrivals, dt,
                           A, D, y, b, H, P, N, cw, x_stride, bc_stride,
                           stream);
}
