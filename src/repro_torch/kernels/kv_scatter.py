"""KV LayerBlock scatter — the persist-side data movement.

``pool[table[i], layer] = stream[i]``, in place: LayerBlock streams
written back into their FullBlock pages, the inverse of
``kv_layer_gather``.  ``layer`` is one layer, with stream (n, pt, feat)
(the Pallas contract), or a ``range`` of consecutive layers, with stream
(len(range), n, pt, feat): the same function for each layer of the range,
in one launch.  The DE's persist (``kvio.serialize_blocks``) calls it
once with every layer to turn the layer-major KV of a finished round
into block-major FullBlocks.  On a CUDA tensor this launches
``csrc/kv_scatter.cu``, the Hopper kernel that replaces the Pallas
``kv_layer_scatter`` (``repro/kernels/kv_gather.py:61``), on the copy
engine planned by ``kv_copy``; on a CPU tensor it computes the
plain version.  Bit-exact for every dtype.  The table's ids must be
distinct.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.kernels import build, kv_copy, ref


@functools.cache
def _fn():
    fn = build.library("kv_scatter").kv_layer_scatter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kv_layer_scatter(pool: torch.Tensor, table: torch.Tensor,
                     stream: torch.Tensor, *,
                     layer: Union[int, range]) -> torch.Tensor:
    """pool (n_pool, layers, pt, feat); table (n,) int32, ids distinct;
    stream (n, pt, feat) for an int ``layer``, (len(layer), n, pt, feat)
    for a range of consecutive layers -> ``pool``, written in place (the
    port's form of the Pallas kernel's input/output aliasing)."""
    n_pool, n_layers, pt, feat = pool.shape
    n = table.shape[0]
    if isinstance(layer, range):
        if layer.step != 1 or len(layer) == 0:
            raise ValueError(f"kv_layer_scatter: {layer} is not a non-empty "
                             "range of consecutive layers")
        first, count, want = layer.start, len(layer), (len(layer), n, pt, feat)
    else:
        first, count, want = layer, 1, (n, pt, feat)
    if not (0 <= first and first + count <= n_layers):
        raise IndexError(f"layer {layer} outside [0, {n_layers})")
    if tuple(stream.shape) != want or stream.dtype != pool.dtype:
        raise ValueError(f"kv_layer_scatter: stream {tuple(stream.shape)} "
                         f"{stream.dtype} does not match {want} {pool.dtype}")
    if pool.device.type == "cpu":
        return ref.kv_layer_scatter_ref(pool, table, stream, layer=layer)
    slab = kv_copy.check_operands("kv_layer_scatter", pool, stream, table)
    if n == 0:
        return pool
    chunk, n_chunks, grid = kv_copy.plan(count * n, slab,
                                         build.sm_count(pool.device.index))
    # page ids outside [0, n_pool) trip the kernel's device-side assert
    # (reported at the next synchronisation, like PyTorch's indexing)
    rc = _fn()(pool.data_ptr(), table.data_ptr(), stream.data_ptr(), n,
               slab, n_pool, n_layers, first, count, chunk, n_chunks, grid,
               build.stream_of(pool))
    build.check(rc, "kv_layer_scatter")
    kv_layer_scatter.launches += 1
    return pool


kv_layer_scatter.launches = 0
