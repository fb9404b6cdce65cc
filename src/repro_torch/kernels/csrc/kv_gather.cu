// kv_layer_gather for Hopper: out[i] = pool[table[i], layer].
//
// Replaces the Pallas kernel repro/kernels/kv_gather.py:30
// (_gather_kernel :25, pallas_call :45).  pool is the stacked FullBlock
// pool (n_pool, layers, page_tokens, feat) of any dtype; one page of one
// layer is a contiguous slab of page_tokens * feat * itemsize bytes, so
// the kernel is a dtype-blind byte copy and is bit-exact for uint8, bf16
// and f32 alike.
//
// Bound: bytes (each slab read once and written once).  The copy runs on
// the engine of kv_copy.cuh: work items of up to 32 KiB on a persistent
// grid of a few blocks per SM, each thread's 16-byte loads of an item all
// in flight before its stores, page ids read once per work item.  One
// layer per launch, as layerwise loading (paper §4.1) needs:
// kvio.layer_stream gathers layer l + 1 while layer l is installed.
#include "kv_copy.cuh"

namespace {

__global__ void __launch_bounds__(kvcopy::THREADS)
gather_kernel(kvcopy::Job job) {
  kvcopy::copy<false>(job);
}

}  // namespace

// slab_bytes: page_tokens * feat * itemsize; n_pool, n_layers: the pool's
// page and layer counts; chunk, n_chunks, grid: the plan of
// kernels/kv_copy.py.  Returns the launch's cudaError_t.
extern "C" int kv_layer_gather(const void* pool, const int* table, void* out,
                               int n, long long slab_bytes, int n_pool,
                               int n_layers, int layer, long long chunk,
                               int n_chunks, int grid, cudaStream_t stream) {
  if (n <= 0 || slab_bytes <= 0) return 0;
  kvcopy::Job job{const_cast<unsigned char*>(
                      static_cast<const unsigned char*>(pool)),
                  static_cast<unsigned char*>(out),
                  table, slab_bytes, chunk, n_chunks, n, 1, layer,
                  n_layers, n_pool};
  return kvcopy::launch<gather_kernel>(job, grid, stream);
}
