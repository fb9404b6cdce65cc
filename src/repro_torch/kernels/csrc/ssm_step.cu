// The Mamba2 recurrent step for Hopper, one token per sequence, in place.
//
// Replaces the recurrence of repro/models/ssm.py:138 (ssm_decode_step,
// :150-157), which the reference leaves to XLA as jnp: for each sequence b
// and SSD head h,
//   h[b,h] <- h[b,h] * exp(dt[b,h] * A[h]) + (dt[b,h] * x[b,h,:]) (x) B[b,:]
//   y[b,h,p] = sum_n h[b,h,p,n] * C[b,n] + D[h] * x[b,h,p]
// with the state h (b, H, P, N) f32 updated in place, x (b, H, P) and B, C
// (b, N) in bf16 or f32 (cast to f32 as the reference casts them), dt
// (b, H) f32 after softplus, A = -exp(A_log) and D as f32 (H,), y (b, H,
// P) f32.  All arithmetic in f32; nvcc contracts the multiply-adds into
// FMAs, which rounds once where the reference rounds twice (the card's
// check holds it within 2e-5).
//
// Bound: bytes.  Each state element is read once and written once (8
// bytes) for 2 FMAs of update and one of the y product: 3 flops a 8
// bytes, far under the card's f32 ridge.  mamba2-1.3b's decode over 8
// slots moves 2 x 8 x 64 x 64 x 128 x 4 = 33.5 MB a layer, ~10 us at
// 3.35 TB/s.  Design: one block of 8 warps per (head, sequence) = 512
// blocks at 8 slots; B and C go to shared memory once, converted to f32;
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
ssm_step_kernel(float* __restrict__ h, const T* __restrict__ x,
                const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ D, float* __restrict__ y, int H,
                int P, int N, long long x_stride, long long bc_stride) {
  __shared__ float Bs[MAX_N], Cs[MAX_N];
  const int head = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    Bs[n] = to_f32(B[b * bc_stride + n]);
    Cs[n] = to_f32(C[b * bc_stride + n]);
  }
  __syncthreads();
  const float dtv = dt[(long long)b * H + head];
  const float decay = expf(dtv * A[head]);
  const float d = D[head];
  const T* xr = x + b * x_stride + (long long)head * P;
  float* hh = h + ((long long)b * H + head) * P * N;
  float* yr = y + ((long long)b * H + head) * P;
  for (int p = warp; p < P; p += WARPS) {
    const float xv = to_f32(xr[p]);
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

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C).  h (b, H, P, N) f32 contiguous
// and 16-byte aligned, N a multiple of 4 up to MAX_N; x rows b apart by
// x_stride elements, (H, P) contiguous; B and C rows b apart by
// bc_stride, N contiguous; dt (b, H), A, D (H,) and y (b, H, P) f32
// contiguous.  Returns the launch's cudaError_t.
extern "C" int ssm_step(int dtype, float* h, const void* x, const void* B,
                        const void* C, const float* dt, const float* A,
                        const float* D, float* y, int b, int H, int P, int N,
                        long long x_stride, long long bc_stride,
                        cudaStream_t stream) {
  if (b <= 0) return 0;
  if (N % 4 || N > MAX_N) return (int)cudaErrorInvalidValue;
  dim3 grid(H, b);
  if (dtype == 1)
    ssm_step_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, stream>>>(
        h, static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), dt, A, D, y, H, P, N,
        x_stride, bc_stride);
  else
    ssm_step_kernel<float><<<grid, WARPS * 32, 0, stream>>>(
        h, static_cast<const float*>(x), static_cast<const float*>(B),
        static_cast<const float*>(C), dt, A, D, y, H, P, N, x_stride,
        bc_stride);
  return (int)cudaGetLastError();
}
