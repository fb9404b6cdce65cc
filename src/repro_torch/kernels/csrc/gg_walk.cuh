// The grouped GEMM's tile walk, shared by grouped_gemm.cu (the forward)
// and grouped_gemm_bwd.cu (dX walks dY's rows the same way).
//
// Each group's rows (sizes clamped to [0, rows left]) are cut into row
// tiles of bm rows, the rows past the groups into tiles of their own (to
// be written 0), and every row tile into n_ct column tiles; tile t is
// (row tile t / n_ct, column tile t % n_ct), so a tile never straddles a
// group.  Every block derives the walk from the group sizes on the
// device (walk_init), so the host never reads them.  grouped_gemm.py's
// tile_walk is its plain-Python copy, which the CPU tests check.
#pragma once

namespace gg {

constexpr int MAX_GROUPS = 512;

// rt[e]: first row tile of group e (rt[E]: the first past the groups);
// off[e]: first row of group e (off[E]: the first row past the groups)
struct Walk {
  int rt[MAX_GROUPS + 1];
  int off[MAX_GROUPS + 1];
};

// the rows and columns of one tile: group e (-1: rows past the groups,
// to be zeroed), rows [row0, row0 + rows), column tile ct
struct Tile {
  int e, row0, rows, ct;
};

// all threads; ends with a __syncthreads
__device__ inline void walk_init(Walk& w, const int* __restrict__ gs,
                                 int n_groups, int m, int bm) {
  for (int e = threadIdx.x; e < n_groups; e += blockDim.x)
    w.rt[e + 1] = gs[e];
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0, rt = 0;
    w.rt[0] = 0;
    w.off[0] = 0;
    for (int e = 0; e < n_groups; ++e) {
      const int rows = min(max(w.rt[e + 1], 0), m - off);
      off += rows;
      rt += (rows + bm - 1) / bm;
      w.rt[e + 1] = rt;
      w.off[e + 1] = off;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int walk_tiles(const Walk& w, int n_groups, int m,
                                          int bm, int n_ct) {
  return (w.rt[n_groups] + (m - w.off[n_groups] + bm - 1) / bm) * n_ct;
}

__device__ inline Tile walk_tile(const Walk& w, int n_groups, int m, int bm,
                                 int n_ct, int t) {
  const int rt = t / n_ct, ct = t - rt * n_ct;
  if (rt >= w.rt[n_groups]) {
    const int r0 = w.off[n_groups] + (rt - w.rt[n_groups]) * bm;
    return {-1, r0, min(bm, m - r0), ct};
  }
  int lo = 0, hi = n_groups - 1;         // the last group starting at or
  while (lo < hi) {                      // before row tile rt
    const int mid = (lo + hi + 1) >> 1;
    if (w.rt[mid] <= rt)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int r0 = w.off[lo] + (rt - w.rt[lo]) * bm;
  return {lo, r0, min(bm, w.off[lo + 1] - r0), ct};
}

}  // namespace gg
