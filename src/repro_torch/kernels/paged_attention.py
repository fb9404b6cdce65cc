"""Paged decode attention.

One new token per sequence attends over its pages: q (b, hkv, g, dh),
K/V pools (n_pages, page_tokens, hkv, dh), block_table (b, max_pages)
int32 and lengths (b,) int32 valid tokens per sequence.  On CUDA tensors
this launches ``csrc/paged_attention.cu``, the Hopper kernel that
replaces the Pallas ``paged_attention``
(``repro/kernels/paged_attention.py:76``); on CPU tensors it computes the
plain version.  An optional sliding window masks keys ``window`` or
more positions behind the query, as the reference model's
``decode_attend`` does (``repro/models/layers.py:242``); the Pallas
kernel has no window.

The kernel splits the ``max_pages * page_tokens`` key positions into
ranges (``plan``, from shapes only: ``lengths`` stays on the device) and
a second kernel merges the ranges' f32 partials: still one call, one
launch count.  Its 16-byte loads need q and the pools 16-byte aligned;
the wrapper checks and raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 80, 128, 256)
MAX_GROUP = 16     # query heads per kv head held in one block's registers
BLOCKS_PER_SM = 8  # the split plan's aim
KEY_UNIT = 128     # a split's keys are a multiple of this


@functools.cache
def _fn():
    fn = build.library("paged_attention").paged_attention
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 +
                   [ctypes.c_int] * 7 +
                   [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                    ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *,
                    softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """q (b,hkv,g,dh); pools (n_pages,pt,hkv,dh); block_table
    (b,max_pages) i32; lengths (b,) i32 -> (b,hkv,g,dh).  ``window`` > 0
    keeps only the last ``window`` keys of each sequence."""
    b, hkv, g, dh = q.shape
    n_pages, pt, _, _ = k_pool.shape
    max_pages = block_table.shape[1]
    if v_pool.shape != k_pool.shape or k_pool.shape[2:] != (hkv, dh) \
            or block_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} table "
                         f"{tuple(block_table.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    build.require_no_grad("paged_attention", build.DECODE_ONLY, q, k_pool, v_pool)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_table,
                                       lengths, softcap=softcap,
                                       window=window)
    build.require_cuda("paged_attention", q, k_pool, v_pool, block_table,
                       lengths)
    if q.dtype not in build.ATTN_DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention: dtypes {q.dtype} "
                         f"{k_pool.dtype} {v_pool.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: block_table and lengths must "
                         "be int32")
    if dh not in HEAD_DIMS or not 0 < g <= MAX_GROUP:
        raise ValueError(f"paged_attention: head dim {dh} (need one of "
                         f"{HEAD_DIMS}) or group {g} > {MAX_GROUP}")
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), \
        v_pool.contiguous()
    block_table, lengths = block_table.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    build.require_aligned(
        "paged_attention", {"q": q.data_ptr(), "k_pool": k_pool.data_ptr(),
                            "v_pool": v_pool.data_ptr()}, {},
        q.element_size())
    n_split, chunk = plan(b, hkv, pt, max_pages,
                          build.sm_count(q.get_device()))
    pm, pl, pacc = build.split_scratch(n_split, b * hkv * g, dh, q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _fn()(build.ATTN_DTYPES[q.dtype], dh, q.data_ptr(),
               k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), ptr(pm), ptr(pl),
               ptr(pacc), b, hkv, g, pt, max_pages, n_split, chunk,
               1.0 / math.sqrt(dh), float(softcap), int(window),
               build.stream_of(q))
    build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def plan(b: int, hkv: int, pt: int, max_pages: int, n_sm: int) -> tuple:
    """(n_split, chunk) of one call: enough key splits for about
    ``BLOCKS_PER_SM`` blocks per SM over the ``b * hkv`` (sequence, kv
    head) blocks, in chunks of a multiple of ``KEY_UNIT`` keys (the best
    of 2-16 blocks per SM and 64-688-key chunks on the card, PERF.md)."""
    return build.split_plan(max_pages * pt, b * hkv, BLOCKS_PER_SM * n_sm,
                            unit=KEY_UNIT)
