"""The plan of the copy engine that ``kv_layer_gather`` and
``kv_layer_scatter`` share (``csrc/kv_copy.cuh``).

A launch copies ``n_slabs`` (page, layer) slabs of ``slab_bytes`` each.
Each slab is cut into even chunks of at most ``CHUNK_BYTES`` (a smaller
slab is one chunk, and a slab's last chunk may be short by the rounding
to 16 bytes); a work item is one chunk of
one slab, which a block of 256 threads copies with all its 16-byte loads
in flight before any store (32 KiB at most).  A persistent grid of
``BLOCKS_PER_SM`` blocks per SM, capped by the items, walks them.  Pure
functions of shapes, tested on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

CHUNK_BYTES = 32 << 10
BLOCKS_PER_SM = 8


def plan(n_slabs: int, slab_bytes: int, n_sm: int) -> tuple:
    """(chunk, n_chunks, grid) for ``n_slabs`` slabs of ``slab_bytes``
    (a whole number of 16-byte vectors) on ``n_sm`` SMs: the fewest
    chunks of at most ``CHUNK_BYTES``, of even size rounded up to 16
    bytes, so ``(n_chunks - 1) * chunk < slab_bytes <= n_chunks *
    chunk``."""
    n_chunks = -(-slab_bytes // CHUNK_BYTES)
    chunk = -(-slab_bytes // n_chunks)
    chunk = -(-chunk // 16) * 16
    return chunk, n_chunks, max(1, min(n_slabs * n_chunks,
                                       n_sm * BLOCKS_PER_SM))


def check_operands(kernel: str, pool: torch.Tensor, dense: torch.Tensor,
                   table: torch.Tensor) -> int:
    """Raise unless the operands suit the engine; returns the slab bytes.
    The pool and the dense stream are contiguous and 16-byte aligned, a
    slab is a whole number of 16-byte vectors, the table is 1-D int32,
    and all three share one CUDA device."""
    build.require_cuda(kernel, pool, table, dense)
    if table.dtype != torch.int32 or table.dim() != 1:
        raise ValueError(f"{kernel}: table must be 1-D int32")
    if not (pool.is_contiguous() and dense.is_contiguous()
            and table.is_contiguous()):
        raise ValueError(f"{kernel}: pool, stream and table must be "
                         "contiguous")
    slab = pool.shape[2] * pool.shape[3] * pool.element_size()
    if slab % 16 or pool.data_ptr() % 16 or dense.data_ptr() % 16:
        raise ValueError(f"{kernel}: pages must be whole 16-byte vectors "
                         f"at 16-byte aligned addresses (slab bytes {slab})")
    return slab
