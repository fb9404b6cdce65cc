"""KV LayerBlock gather — the layerwise-install data movement.

``out[i] = pool[table[i], layer]``: one layer's KV for every hit page of
a request, gathered from the stacked FullBlock pool into a contiguous
(n, page_tokens, feat) stream right before that layer is installed
(paper §4.1).  On a CUDA tensor this launches ``csrc/kv_gather.cu``, the
Hopper kernel that replaces the Pallas ``kv_layer_gather``
(``repro/kernels/kv_gather.py:30``), on the copy engine planned by
``kv_copy``; on a CPU tensor it computes the plain version.  Bit-exact
for every dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, kv_copy, ref


@functools.cache
def _fn():
    fn = build.library("kv_gather").kv_layer_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kv_layer_gather(pool: torch.Tensor, table: torch.Tensor, *,
                    layer: int) -> torch.Tensor:
    """pool (n_pool, layers, pt, feat); table (n,) int32 ->
    gathered (n, pt, feat) LayerBlock stream for ``layer``."""
    n_pool, n_layers, pt, feat = pool.shape
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside [0, {n_layers})")
    if pool.device.type == "cpu":
        return ref.kv_layer_gather_ref(pool, table, layer=layer)
    n = table.shape[0]
    out = torch.empty((n, pt, feat), dtype=pool.dtype, device=pool.device)
    slab = kv_copy.check_operands("kv_layer_gather", pool, out, table)
    if n == 0:
        return out
    chunk, n_chunks, grid = kv_copy.plan(n, slab,
                                         build.sm_count(pool.device.index))
    # page ids outside [0, n_pool) trip the kernel's device-side assert
    # (reported at the next synchronisation, like PyTorch's indexing)
    rc = _fn()(pool.data_ptr(), table.data_ptr(), out.data_ptr(), n, slab,
               n_pool, n_layers, layer, chunk, n_chunks, grid,
               build.stream_of(pool))
    build.check(rc, "kv_layer_gather")
    kv_layer_gather.launches += 1
    return out


kv_layer_gather.launches = 0
