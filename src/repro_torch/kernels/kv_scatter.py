"""KV LayerBlock scatter — the persist-side data movement.

``pool[table[i], layer] = stream[i]``, in place: one layer's LayerBlock
stream written back into its FullBlock pages, the inverse of
``kv_layer_gather``.  The DE's persist (``kvio.serialize_blocks``) calls
it once per layer to turn the layer-major KV of a finished round into
block-major FullBlocks.  On a CUDA tensor this launches
``csrc/kv_scatter.cu``, the Hopper kernel that replaces the Pallas
``kv_layer_scatter`` (``repro/kernels/kv_gather.py:61``); on a CPU
tensor it computes the plain version.  Bit-exact for every dtype.  The
table's ids must be distinct.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


@functools.cache
def _fn():
    fn = build.library("kv_scatter").kv_layer_scatter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kv_layer_scatter(pool: torch.Tensor, table: torch.Tensor,
                     stream: torch.Tensor, *, layer: int) -> torch.Tensor:
    """pool (n_pool, layers, pt, feat); table (n,) int32, ids distinct;
    stream (n, pt, feat) -> ``pool``, written in place (the port's form
    of the Pallas kernel's input/output aliasing)."""
    n_pool, n_layers, pt, feat = pool.shape
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside [0, {n_layers})")
    n = table.shape[0]
    if tuple(stream.shape) != (n, pt, feat) or stream.dtype != pool.dtype:
        raise ValueError(f"kv_layer_scatter: stream {tuple(stream.shape)} "
                         f"{stream.dtype} does not match ({n}, {pt}, "
                         f"{feat}) {pool.dtype}")
    if pool.device.type == "cpu":
        return ref.kv_layer_scatter_ref(pool, table, stream, layer=layer)
    build.require_cuda("kv_layer_scatter", pool, table, stream)
    if table.dtype != torch.int32 or table.dim() != 1:
        raise ValueError("kv_layer_scatter: table must be 1-D int32")
    if not pool.is_contiguous():
        raise ValueError("kv_layer_scatter: the pool is written in place "
                         "and must be contiguous")
    stream, table = stream.contiguous(), table.contiguous()
    page_bytes = pt * feat * pool.element_size()
    if page_bytes % 16 or pool.data_ptr() % 16 or stream.data_ptr() % 16:
        raise ValueError("kv_layer_scatter: pages must be whole 16-byte "
                         f"vectors (page bytes {page_bytes})")
    if n == 0:
        return pool
    if n > 65535:
        raise ValueError(f"kv_layer_scatter: {n} pages exceed one grid")
    # page ids outside [0, n_pool) trip the kernel's device-side assert
    # (reported at the next synchronisation, like PyTorch's indexing)
    rc = _fn()(pool.data_ptr(), table.data_ptr(), stream.data_ptr(), n,
               page_bytes, n_pool, n_layers, layer, build.stream_of(pool))
    build.check(rc, "kv_layer_scatter")
    kv_layer_scatter.launches += 1
    return pool


kv_layer_scatter.launches = 0
