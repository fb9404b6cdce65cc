// Tile helpers of the SSD scan's kernels, forward (ssd_scan.cu) and
// backward (ssd_scan_bwd.cu): the constants of their 64 x 64 output tiles,
// the TF32 split and the MMA both use, and the forward's own: its tiles of
// 4 warps, the loads of 32-row slices of f32 into shared memory, and the
// products over a slice (split TF32 on the tensor cores for bf16 inputs,
// f32 FMAs for f32 ones).  Each source includes it once; an anonymous
// namespace keeps every helper internal to that source.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;          // SSD head dim (mamba2-1.3b's, zamba2's)
constexpr int T = 64;          // rows of a tile
constexpr int KS = 32;         // rows of a slice of the contraction
constexpr int MAX_L = 256;     // longest chunk
constexpr int THREADS = 128;   // 4 warps, each a 32 x 32 quarter of a
                               // 64 x 64 output tile
constexpr int PIECES = T * KS / 4 / THREADS;    // a slice's 4-element
                                                // pieces a thread moves
constexpr int LDT = T + 8;     // padded slice row (floats): 16-byte aligned
                               // rows, and a warp's fragment loads (rows
                               // t, columns g: 8 t + g) hit 32 banks
// The state dim N (d_state x n_groups) is a template parameter of every
// kernel: 128 (mamba2-1.3b) or 64 (zamba2-2.7b).  The state kernel cuts N
// into NH = N / T column tiles of 64 (two at N 128, one at N 64), and the
// pass takes P N / 4 / PASS_THREADS blocks a head (8 or 4).
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 8;  // chunks whose loads the pass issues at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive elements as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A slice goes from global memory to shared memory as f32 in PIECES
// 4-element pieces a thread.  Slices are T x KS read transposed or KS x T
// read in their natural layout: T * KS / 4 = PIECES * THREADS pieces
// either way.

// rows [0, T) x cols [0, KS) of a row-major source (row stride rs; rows at
// or past nrows read as 0) into dst transposed: dst[c * LDT + r].  A piece
// is 4 consecutive columns of a row; consecutive threads take consecutive
// rows, so the shared-memory stores do not conflict.
template <typename Tin>
__device__ __forceinline__ void load_t(float* dst, const Tin* src,
                                       long long rs, int nrows) {
#pragma unroll
  for (int q = 0; q < PIECES; ++q) {
    const int idx = threadIdx.x + q * THREADS;
    const int r = idx % T, g = idx / T;
    const float4 v =
        r < nrows ? load4(src + r * rs + 4 * g) : make_float4(0, 0, 0, 0);
    dst[(4 * g + 0) * LDT + r] = v.x;
    dst[(4 * g + 1) * LDT + r] = v.y;
    dst[(4 * g + 2) * LDT + r] = v.z;
    dst[(4 * g + 3) * LDT + r] = v.w;
  }
}

// rows [0, KS) x cols [0, T) of a row-major source, rows at or past nrows
// read as 0, into dst as they are (dst[r * LDT + c]), row r scaled by
// wr[r] when wr is given
template <typename Tin>
__device__ __forceinline__ void load_n(float* dst, const Tin* src,
                                       long long rs, int nrows,
                                       const float* wr) {
#pragma unroll
  for (int q = 0; q < PIECES; ++q) {
    const int idx = threadIdx.x + q * THREADS;
    const int r = idx / (T / 4), g = idx % (T / 4);
    float4 v = make_float4(0, 0, 0, 0);
    if (r < nrows) {
      v = load4(src + r * rs + 4 * g);
      if (wr) {
        const float w = wr[r];
        v = make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
      }
    }
    *reinterpret_cast<float4*>(dst + r * LDT + 4 * g) = v;
  }
}

// The products.  With bf16 inputs they run on the tensor cores as split
// TF32 (mma.sync m16n8k8, f32 accumulators): an f32 operand is cut into
// two TF32 parts, hi = tf32(v) and lo = tf32(v - hi), and a bf16 operand
// is exact in TF32, so a product is lo.b + hi.b (or a.lo + a.hi), each
// TF32 product exact in f32, ~2^-22 of it dropped; C.B^T of two bf16
// operands is one product.  The MMA's own accumulation then costs ~5e-5
// against the plain version, well inside bf16's 2e-2.  With f32 inputs
// (the f32 identity checks, held to 2e-5) the same fragments are summed
// by f32 FMAs on the CUDA cores: split TF32 there erred by up to 8.4e-5
// on an H100, two or three parts a side, from the MMA's accumulation, and
// still by several times f32's error with a fresh accumulator per slice.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v's NP TF32 parts, coarsest first (NP = 1: v holds a bf16 value)
template <int NP>
__device__ __forceinline__ void split(float v, uint32_t (&part)[NP]) {
  part[0] = NP == 1 ? __float_as_uint(v) : tf32(v);
  if (NP == 2) part[NP - 1] = tf32(v - __uint_as_float(part[0]));
}

// acc += A B over one slice of KS for this warp's 32 x 32 quarter of the
// block's 64 x 64 tile, A = At^T and B = Bk with both operands k-major in
// shared memory (ld LDT), cut into NA and NB TF32 parts: acc[mi][ni] is
// the m16n8 fragment at rows 16 mi, columns 8 ni of the quarter (this
// thread: rows g and g + 8, columns 2 t and 2 t + 1, g = lane / 4, t =
// lane % 4; frag_row and frag_col)
template <int NA, int NB>
__device__ __forceinline__ void mma_tile(float (&acc)[2][4][4],
                                         const float* At, const float* Bk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
#pragma unroll
  for (int k = 0; k < KS; k += 8) {
    uint32_t a[2][NA][4], b[4][NB][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* p = At + (k + t) * LDT + m0 + 16 * mi + g;
      const int off[4] = {0, 8, 4 * LDT, 4 * LDT + 8};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t part[NA];
        split<NA>(p[off[e]], part);
#pragma unroll
        for (int i = 0; i < NA; ++i) a[mi][i][e] = part[i];
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* p = Bk + (k + t) * LDT + n0 + 8 * ni + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t part[NB];
        split<NB>(p[e * 4 * LDT], part);
#pragma unroll
        for (int j = 0; j < NB; ++j) b[ni][j][e] = part[j];
      }
    }
    // the lo parts' products first, then hi's (two f32 operands: lo.hi,
    // hi.lo, hi.hi; lo.lo, ~2^-22 of a product, is dropped)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if constexpr (NA == 2 && NB == 2) {
          mma_tf32(acc[mi][ni], a[mi][1], b[ni][0]);
          mma_tf32(acc[mi][ni], a[mi][0], b[ni][1]);
        } else {
          mma_tf32(acc[mi][ni], a[mi][NA - 1], b[ni][NB - 1]);
        }
        if (NA + NB >= 3) mma_tf32(acc[mi][ni], a[mi][0], b[ni][0]);
      }
  }
}

// acc += A B as mma_tile computes it, fragment for fragment, by f32 FMAs
// on the CUDA cores, summed over k in order
__device__ __forceinline__ void fma_tile(float (&acc)[2][4][4],
                                         const float* At, const float* Bk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
#pragma unroll 4
  for (int k = 0; k < KS; ++k) {
    float a[2][2];
    float2 b[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mi][h] = At[k * LDT + m0 + 16 * mi + 8 * h + g];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      b[ni] = *reinterpret_cast<const float2*>(Bk + k * LDT + n0 + 8 * ni +
                                               2 * t);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[mi][ni][2 * h] += a[mi][h] * b[ni].x;
          acc[mi][ni][2 * h + 1] += a[mi][h] * b[ni].y;
        }
  }
}

// one slice's product for inputs of Tin: A_F32 / B_F32, the operand
// holds values computed in f32 (not Tin's)
template <typename Tin, bool A_F32, bool B_F32>
__device__ __forceinline__ void product(float (&acc)[2][4][4],
                                        const float* At, const float* Bk) {
  if constexpr (sizeof(Tin) == 2)
    mma_tile<A_F32 ? 2 : 1, B_F32 ? 2 : 1>(acc, At, Bk);
  else
    fma_tile(acc, At, Bk);
}

// the row and column, in the block's 64 x 64 tile, of values 2 h and
// 2 h + 1 (column + 1) of this thread's fragment (mi, ni)
__device__ __forceinline__ int frag_row(int mi, int h) {
  return (threadIdx.x >> 6) * 32 + 16 * mi + ((threadIdx.x & 31) >> 2) +
         8 * h;
}
__device__ __forceinline__ int frag_col(int ni) {
  return ((threadIdx.x >> 5) & 1) * 32 + 8 * ni + 2 * (threadIdx.x & 3);
}

}  // namespace
