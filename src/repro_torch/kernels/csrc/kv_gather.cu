// kv_layer_gather for Hopper: out[i] = pool[table[i], layer].
//
// Replaces the Pallas kernel repro/kernels/kv_gather.py:30
// (_gather_kernel :25, pallas_call :45).  pool is the stacked FullBlock
// pool (n_pool, layers, page_tokens, feat) of any dtype; one page of one
// layer is a contiguous run of page_bytes, so the kernel is a dtype-blind
// byte copy and is bit-exact for uint8, bf16 and f32 alike.
//
// Bound: bytes.  It reads and writes n * page_bytes each, so its least
// time is 2 * n * page_bytes over the device memory rate.  Design: a 2-D
// grid, blockIdx.y = output page, blockIdx.x = a slice of that page, and
// 16-byte (uint4) loads and stores with neighbouring threads on
// neighbouring addresses, so every access is a full coalesced sector.
// Page ids are read by each block itself (no scalar prefetch on this
// card).  An id outside the pool trips a device-side assert, which
// surfaces as an error at the caller's next synchronisation, as
// PyTorch's own index kernels do: checking the ids on the host would
// cost a device sync per layer.  The wrapper checks that page_bytes and
// the pointers are 16-byte aligned.
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECS_PER_THREAD = 4;   // one block copies 16 KB of a page

__global__ void __launch_bounds__(THREADS)
gather_kernel(const uint4* __restrict__ pool, const int* __restrict__ table,
              uint4* __restrict__ out, long long page_vecs,
              long long page_stride_vecs, long long layer_off_vecs,
              int n_pool) {
  const long long i = blockIdx.y;
  const int page = table[i];
  assert(page >= 0 && page < n_pool);
  const uint4* src = pool + (long long)page * page_stride_vecs +
                     layer_off_vecs;
  uint4* dst = out + i * page_vecs;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < page_vecs; v += (long long)gridDim.x * blockDim.x) {
    dst[v] = src[v];
  }
}

}  // namespace

// page_bytes: bytes of one (page, layer) slab = page_tokens * feat * itemsize;
// n_pool, n_layers: the pool's page and layer counts.  Returns the
// launch's cudaError_t.
extern "C" int kv_layer_gather(const void* pool, const int* table, void* out,
                               int n, long long page_bytes, int n_pool,
                               int n_layers, int layer, cudaStream_t stream) {
  if (n <= 0 || page_bytes <= 0) return 0;
  const long long page_vecs = page_bytes / 16;
  long long per_block = (long long)THREADS * VECS_PER_THREAD;
  long long gx = (page_vecs + per_block - 1) / per_block;
  dim3 grid((unsigned)gx, (unsigned)n);
  gather_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const uint4*>(pool), table, static_cast<uint4*>(out),
      page_vecs, page_vecs * n_layers, page_vecs * layer, n_pool);
  return (int)cudaGetLastError();
}
