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
// with the state h (b, H, P, N) f32 updated in place, dt (b, H) f32 after
// softplus, A = -exp(A_log) and D as f32 (H,), y (b, H, P) f32.  The
// recurrence is f32; nvcc contracts the multiply-adds into FMAs, which
// round once where the reference rounds twice.
//
// Bound: bytes.  Each state element is read once and written once (8
// bytes) for 2 FMAs of update and one of the y product: 3 flops a 8
// bytes, far under the card's f32 ridge.  mamba2-1.3b's decode over 8
// slots moves 2 x 8 x 64 x 64 x 128 x 4 = 33.5 MB a layer, ~10 us at
// 3.35 TB/s; the conv's inputs, weights and tails add ~0.2 MB.  A conv
// launch of its own at s = 1 moves ~0.2 MB in a launch's ~5 us floor, so
// the conv rides in this launch: one block of 8 warps per (head,
// sequence) = 512 blocks at 8 slots.  Each block first convolves the
// whole of B and C (2 x 128 channels x 4 taps: cheaper than a second
// launch) and its head's 64 channels of x into shared memory.  x's tail
// is written in place (each channel belongs to one head's block, which
// reads its old rows first); every block reads all of the old B and C
// tails, so head 0's block writes their new tails out of place.  Then
// each warp owns rows p of the head's (P, N) state, a lane reads and
// writes 4 consecutive f32 of a row as one 16-byte access (a warp covers
// 128 of N per pass: coalesced), updates them, folds them into its part
// of the row's y, and the warp reduces y by shuffles.  Nothing is read
// twice, nothing is written twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_N = 1024;     // shared memory for B and C
constexpr int MAX_P = 1024;     // shared memory for the head's x
constexpr int MAX_CW = 4;       // longest conv (the prefill conv's)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to the activation dtype, back in f32
__device__ __forceinline__ float rounded(float v, float) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// silu(sum_i tail[i * rs] w[i * rs] + cur w[(cw - 1) * rs]) of one
// channel, rounded once to T
template <typename T>
__device__ __forceinline__ float conv_silu(const T* tail, const T* w,
                                           T cur, int cw, long long rs) {
  float acc = 0.f;
  for (int i = 0; i < cw - 1; ++i)
    acc += to_f32(tail[i * rs]) * to_f32(w[i * rs]);
  acc += to_f32(cur) * to_f32(w[(cw - 1) * rs]);
  return rounded(acc * (1.f / (1.f + expf(-acc))), T());
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
ssm_step_kernel(float* __restrict__ h, const T* __restrict__ x,
                const T* __restrict__ B, const T* __restrict__ C,
                const T* __restrict__ wx, const T* __restrict__ wB,
                const T* __restrict__ wC, T* __restrict__ tx,
                const T* __restrict__ tB, const T* __restrict__ tC,
                T* __restrict__ ntB, T* __restrict__ ntC,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ D, float* __restrict__ y, int H,
                int P, int N, int cw, long long x_stride,
                long long bc_stride) {
  __shared__ float Bs[MAX_N], Cs[MAX_N], xs[MAX_P];
  const int head = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long di = (long long)H * P;       // x's channels
  const int tr = cw - 1;                       // tail rows
  // B and C: the conv of every channel; head 0's block writes the new
  // tails out of place
  for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) {
    const bool is_c = k >= N;
    const int n = is_c ? k - N : k;
    const T* tail = (is_c ? tC : tB) + (long long)b * tr * N + n;
    const T cur = (is_c ? C : B)[b * bc_stride + n];
    (is_c ? Cs : Bs)[n] = conv_silu(tail, (is_c ? wC : wB) + n, cur, cw,
                                    (long long)N);
    if (head == 0) {
      T* nt = (is_c ? ntC : ntB) + (long long)b * tr * N + n;
      for (int i = 0; i + 1 < tr; ++i) nt[(long long)i * N] =
          tail[(long long)(i + 1) * N];
      nt[(long long)(tr - 1) * N] = cur;
    }
  }
  // this head's channels of x: the conv, then the tail shifted in place
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const long long ch = (long long)head * P + p;
    T* tail = tx + (long long)b * tr * di + ch;
    const T cur = x[b * x_stride + ch];
    xs[p] = conv_silu(tail, wx + ch, cur, cw, di);
    for (int i = 0; i + 1 < tr; ++i) tail[i * di] = tail[(i + 1) * di];
    tail[(tr - 1) * di] = cur;
  }
  __syncthreads();
  const float dtv = dt[(long long)b * H + head];
  const float decay = expf(dtv * A[head]);
  const float d = D[head];
  float* hh = h + ((long long)b * H + head) * P * N;
  float* yr = y + ((long long)b * H + head) * P;
  for (int p = warp; p < P; p += WARPS) {
    const float xv = xs[p];
    const float dx = dtv * xv;
    float4* row = reinterpret_cast<float4*>(hh + (long long)p * N);
    float acc = 0.f;
    for (int n4 = lane; n4 < N / 4; n4 += 32) {
      float4 v = row[n4];
      const int n = 4 * n4;
      v.x = v.x * decay + dx * Bs[n];
      v.y = v.y * decay + dx * Bs[n + 1];
      v.z = v.z * decay + dx * Bs[n + 2];
      v.w = v.w * decay + dx * Bs[n + 3];
      row[n4] = v;
      acc += v.x * Cs[n] + v.y * Cs[n + 1] + v.z * Cs[n + 2] +
             v.w * Cs[n + 3];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) yr[p] = acc + xv * d;
  }
}

template <typename T>
void launch(float* h, const void* x, const void* B, const void* C,
            const void* wx, const void* wB, const void* wC, void* tx,
            const void* tB, const void* tC, void* ntB, void* ntC,
            const float* dt, const float* A, const float* D, float* y,
            int b, int H, int P, int N, int cw, long long x_stride,
            long long bc_stride, cudaStream_t stream) {
  ssm_step_kernel<T><<<dim3(H, b), WARPS * 32, 0, stream>>>(
      h, static_cast<const T*>(x), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(wx),
      static_cast<const T*>(wB), static_cast<const T*>(wC),
      static_cast<T*>(tx), static_cast<const T*>(tB),
      static_cast<const T*>(tC), static_cast<T*>(ntB), static_cast<T*>(ntC),
      dt, A, D, y, H, P, N, cw, x_stride, bc_stride);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C, the conv weights and tails).  h
// (b, H, P, N) f32 contiguous and 16-byte aligned, N a multiple of 4 up
// to MAX_N, P up to MAX_P, 2 <= cw <= MAX_CW; x (b, H P) rows b apart by
// x_stride elements, H P contiguous; B and C rows b apart by bc_stride, N
// contiguous; the weights wx (cw, H P), wB and wC (cw, N), the tails tx
// (b, cw - 1, H P), tB and tC (b, cw - 1, N) and the new tails ntB and
// ntC (b, cw - 1, N) contiguous; tx is updated in place, ntB and ntC
// must not overlap tB and tC; dt (b, H), A, D (H,) and y (b, H, P) f32
// contiguous.  Returns the launch's cudaError_t.
extern "C" int ssm_step(int dtype, float* h, const void* x, const void* B,
                        const void* C, const void* wx, const void* wB,
                        const void* wC, void* tx, const void* tB,
                        const void* tC, void* ntB, void* ntC,
                        const float* dt, const float* A, const float* D,
                        float* y, int b, int H, int P, int N, int cw,
                        long long x_stride, long long bc_stride,
                        cudaStream_t stream) {
  if (b <= 0) return 0;
  if (N % 4 || N > MAX_N || P > MAX_P || cw < 2 || cw > MAX_CW)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    launch<__nv_bfloat16>(h, x, B, C, wx, wB, wC, tx, tB, tC, ntB, ntC, dt,
                          A, D, y, b, H, P, N, cw, x_stride, bc_stride,
                          stream);
  else
    launch<float>(h, x, B, C, wx, wB, wC, tx, tB, tC, ntB, ntC, dt, A, D,
                  y, b, H, P, N, cw, x_stride, bc_stride, stream);
  return (int)cudaGetLastError();
}
