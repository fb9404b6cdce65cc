// The copy engine of kv_layer_gather and kv_layer_scatter.
//
// Both kernels move whole (page, layer) slabs between the stacked
// FullBlock pool (n_pool, pool_layers, slab bytes) and a dense stream
// (n_layers, n, slab bytes): slab s = j * n + i of the stream is layer
// layer0 + j of pool page table[i].  The gather reads the pool and writes
// the stream, the scatter the reverse.  A slab is a contiguous run of
// bytes on both sides, so the engine is a dtype-blind byte copy and is
// bit-exact for every dtype.
//
// Bound: bytes.  Each slab is read once and written once, so the least
// time is 2 * n_layers * n * slab over the device memory rate.  What held
// the first kernels back was one 16-byte load per thread before its
// store, on a grid sized by the pages.  The design here:
//
// * Work items.  Slab s is cut into n_chunks chunks of `chunk` bytes (the
//   last may be short; a slab smaller than a chunk is one chunk).  Item q
//   is (slab q / n_chunks, chunk q % n_chunks).  The host's plan
//   (kernels/kv_copy.py) picks chunk, n_chunks and the grid.  Items are
//   counted in 32 bits (launch refuses 2^31 or more), so the divisions
//   ahead of the page-id read are 32-bit.
// * A persistent grid of a few blocks per SM, capped by the items.  Block
//   b takes items b, b + grid, b + 2 grid, ...  No grid dimension depends
//   on n, so there is no 65535-page limit.
// * Register-staged copies: each of the block's 256 threads issues all of
//   its 16-byte loads of an item (up to 8: a 32 KiB chunk) before any
//   store, neighbouring threads on neighbouring addresses.
// * Page ids.  Each item's id is read once per thread, right after the
//   index arithmetic (all threads of a block read the same word).  An id
//   outside the pool trips a device-side assert, reported at the caller's
//   next synchronisation (no host check, no sync).
//
// A bulk-copy design (one warp a block issuing cp.async.bulk copies
// through a ring of shared-memory stages, each completing an mbarrier)
// was held against this one on the H100 (PERF.md): it tied on whole
// persists and lost about 0.5-0.9 us of fixed cost per one-layer launch.
//
// Both kernels need 16-byte aligned addresses and sizes that are whole multiples
// of 16 bytes: the wrappers check that the slab bytes and the base
// pointers are, and the plan's chunk is.
#pragma once

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvcopy {

struct Job {
  unsigned char* pool;        // (n_pool, pool_layers, slab)
  unsigned char* dense;       // (n_layers, n, slab)
  const int* table;           // (n,) pool page of stream page i
  long long slab;             // bytes of one (page, layer) slab
  long long chunk;            // bytes of one item (the slab's last may be short)
  int n_chunks;               // items per slab
  int n;                      // pages
  int n_layers;               // layers in this launch
  int layer0;                 // pool layer of stream layer 0
  int pool_layers;
  int n_pool;

  __host__ __device__ __forceinline__ long long items() const {
    return (long long)n_layers * n * n_chunks;
  }
  // The pool page of item q: read once, checked on the device.
  __device__ __forceinline__ int page_of(uint32_t q) const {
    const int page = table[(q / (uint32_t)n_chunks) % (uint32_t)n];
    assert(page >= 0 && page < n_pool);
    return page;
  }
  // Source, destination and bytes of item q, given its pool page.
  template <bool kScatter>
  __device__ __forceinline__ void span(uint32_t q, int page,
                                       unsigned char** src,
                                       unsigned char** dst,
                                       uint32_t* bytes) const {
    const uint32_t s = q / (uint32_t)n_chunks;
    const long long off = (long long)(q - s * (uint32_t)n_chunks) * chunk;
    const uint32_t j = s / (uint32_t)n;
    unsigned char* d = dense + (long long)s * slab + off;
    unsigned char* p =
        pool + ((long long)page * pool_layers + layer0 + j) * slab + off;
    *src = kScatter ? d : p;
    *dst = kScatter ? p : d;
    *bytes = (uint32_t)(slab - off < chunk ? slab - off : chunk);
  }
};

constexpr int THREADS = 256;
constexpr int VECS = 8;     // 16-byte loads in flight per thread
constexpr long long MAX_CHUNK = (long long)THREADS * VECS * 16;   // 32 KiB

// Host checks of a plan: items countable in 32 bits, 16-byte chunks of at
// most MAX_CHUNK, and chunks that cover each slab exactly,
// (n_chunks - 1) * chunk < slab <= n_chunks * chunk, so no item starts
// past its slab and an item's byte count cannot wrap.
inline bool bad_job(const Job& job, int grid) {
  return grid <= 0 || job.items() >= (1LL << 31) || job.chunk <= 0 ||
         job.chunk > MAX_CHUNK || job.chunk % 16 || job.slab % 16 ||
         job.n_chunks <= 0 ||
         (long long)(job.n_chunks - 1) * job.chunk >= job.slab ||
         (long long)job.n_chunks * job.chunk < job.slab;
}

// The body of a copy kernel (gather_kernel, scatter_kernel), launched
// with THREADS threads a block.
template <bool kScatter>
__device__ __forceinline__ void copy(const Job& job) {
  const uint32_t n_items = (uint32_t)job.items();
  for (uint32_t q = blockIdx.x; q < n_items; q += gridDim.x) {
    unsigned char *src, *dst;
    uint32_t bytes;
    job.span<kScatter>(q, job.page_of(q), &src, &dst, &bytes);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int vecs = (int)(bytes / 16);
    uint4 r[VECS];
#pragma unroll
    for (int u = 0; u < VECS; ++u) {
      const int v = threadIdx.x + u * THREADS;
      if (v < vecs) r[u] = s[v];
    }
#pragma unroll
    for (int u = 0; u < VECS; ++u) {
      const int v = threadIdx.x + u * THREADS;
      if (v < vecs) d[v] = r[u];
    }
  }
}

// Launch Kernel (whose body is copy<>) on `stream`; returns the
// cudaError_t.
template <void (*Kernel)(Job)>
int launch(const Job& job, int grid, cudaStream_t stream) {
  if (job.items() <= 0) return 0;
  if (bad_job(job, grid)) return (int)cudaErrorInvalidValue;
  Kernel<<<grid, THREADS, 0, stream>>>(job);
  return (int)cudaGetLastError();
}


}  // namespace kvcopy
