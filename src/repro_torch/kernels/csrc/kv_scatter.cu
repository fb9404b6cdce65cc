// kv_layer_scatter for Hopper: pool[table[i], layer] = stream[i], in place,
// for one layer or for each layer of a range in one launch.
//
// Replaces the Pallas kernel repro/kernels/kv_gather.py:61
// (_scatter_kernel :56, pallas_call :79), the inverse of kv_layer_gather:
// LayerBlock streams are written back into their FullBlock pages of the
// stacked pool (n_pool, layers, page_tokens, feat).  The pool is updated
// in place (the Pallas kernel aliases it with its output), so pages and
// layers outside the call keep their bytes.  A range of n_layers
// consecutive layers from layer0, with stream (n_layers, n, page_tokens,
// feat), is the Pallas kernel applied to each of them: the DE's persist
// turns a round's layer-major KV into block-major FullBlocks with one
// launch.  One (page, layer) slab is a contiguous run of bytes in both
// arrays, so the kernel is a dtype-blind byte copy, bit-exact for uint8,
// bf16 and f32 alike.
//
// Bound: bytes (each slab read once and written once).  The copy runs on
// the engine of kv_copy.cuh: work items of up to 32 KiB on a persistent
// grid of a few blocks per SM, each thread's 16-byte loads of an item all
// in flight before its stores, page ids read once per work item.  The
// ids must be distinct: two stream pages aimed at one pool page race, as
// they are undefined in Pallas too.
#include "kv_copy.cuh"

namespace {

__global__ void __launch_bounds__(kvcopy::THREADS)
scatter_kernel(kvcopy::Job job) {
  kvcopy::copy<true>(job);
}

}  // namespace

// slab_bytes: page_tokens * feat * itemsize; n_pool, pool_layers: the
// pool's page and layer counts; layers layer0 .. layer0 + n_layers - 1;
// chunk, n_chunks, grid: the plan of kernels/kv_copy.py.
// Returns the launch's cudaError_t.
extern "C" int kv_layer_scatter(void* pool, const int* table,
                                const void* stream, int n,
                                long long slab_bytes, int n_pool,
                                int pool_layers, int layer0, int n_layers,
                                long long chunk, int n_chunks, int grid,
                                cudaStream_t cu_stream) {
  if (n <= 0 || n_layers <= 0 || slab_bytes <= 0) return 0;
  kvcopy::Job job{static_cast<unsigned char*>(pool),
                  const_cast<unsigned char*>(
                      static_cast<const unsigned char*>(stream)),
                  table, slab_bytes, chunk, n_chunks, n, n_layers, layer0,
                  pool_layers, n_pool};
  return kvcopy::launch<scatter_kernel>(job, grid, cu_stream);
}
