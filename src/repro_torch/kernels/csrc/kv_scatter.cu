// kv_layer_scatter for Hopper: pool[table[i], layer] = stream[i], in place.
//
// Replaces the Pallas kernel repro/kernels/kv_gather.py:61
// (_scatter_kernel :56, pallas_call :79), the inverse of kv_layer_gather:
// one layer's LayerBlock stream (n, page_tokens, feat) is written back
// into its FullBlock pages of the stacked pool (n_pool, layers,
// page_tokens, feat).  The pool is updated in place (the Pallas kernel
// aliases it with its output), so pages outside the table keep their
// bytes.  One (page, layer) slab is a contiguous run of page_bytes in
// both arrays, so the kernel is a dtype-blind byte copy and is bit-exact
// for uint8, bf16 and f32 alike.
//
// Bound: bytes.  It reads and writes n * page_bytes each, so its least
// time is 2 * n * page_bytes over the device memory rate.  Design, as
// the gather's: a 2-D grid, blockIdx.y = stream page, blockIdx.x = a
// slice of that page, 16-byte (uint4) loads and stores with neighbouring
// threads on neighbouring addresses.  Each block reads its own page id.
// An id outside the pool trips a device-side assert, reported at the
// caller's next synchronisation (no host check, no sync).  The ids must
// be distinct: two stream pages aimed at one pool page race, as they are
// undefined in Pallas too.  The wrapper checks 16-byte alignment.
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECS_PER_THREAD = 4;   // one block copies 16 KB of a page

__global__ void __launch_bounds__(THREADS)
scatter_kernel(uint4* __restrict__ pool, const int* __restrict__ table,
               const uint4* __restrict__ stream, long long page_vecs,
               long long page_stride_vecs, long long layer_off_vecs,
               int n_pool) {
  const long long i = blockIdx.y;
  const int page = table[i];
  assert(page >= 0 && page < n_pool);
  uint4* dst = pool + (long long)page * page_stride_vecs + layer_off_vecs;
  const uint4* src = stream + i * page_vecs;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < page_vecs; v += (long long)gridDim.x * blockDim.x) {
    dst[v] = src[v];
  }
}

}  // namespace

// page_bytes: bytes of one (page, layer) slab = page_tokens * feat * itemsize;
// n_pool, n_layers: the pool's page and layer counts.  Returns the
// launch's cudaError_t.
extern "C" int kv_layer_scatter(void* pool, const int* table,
                                const void* stream, int n,
                                long long page_bytes, int n_pool,
                                int n_layers, int layer,
                                cudaStream_t cu_stream) {
  if (n <= 0 || page_bytes <= 0) return 0;
  const long long page_vecs = page_bytes / 16;
  long long per_block = (long long)THREADS * VECS_PER_THREAD;
  long long gx = (page_vecs + per_block - 1) / per_block;
  dim3 grid((unsigned)gx, (unsigned)n);
  scatter_kernel<<<grid, THREADS, 0, cu_stream>>>(
      static_cast<uint4*>(pool), table, static_cast<const uint4*>(stream),
      page_vecs, page_vecs * n_layers, page_vecs * layer, n_pool);
  return (int)cudaGetLastError();
}
