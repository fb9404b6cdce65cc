"""Absorbed MLA decode attention — one decode query per sequence against
the latent cache.

``o_lat[b, h] = softmax_j(scale · (q_lat[b, h]·c[b, j] + q_rope[b, h]·
krope[b, j])) · c[b, j]`` over keys j < ``lengths[b]``: the part of the
reference's absorbed decode between ``q_lat`` and ``o_lat``
(``repro/models/mla.py:109``, ``mla_decode``).  q_lat (b, h, r), q_rope
(b, h, rd), the padded caches c (b, S, r) and krope (b, S, rd), lengths
(b,) int32; returns o_lat (b, h, r) in c's dtype.  On CUDA tensors this
launches ``csrc/mla_decode.cu`` (h 32, r 512, rd 64: ds27b's), which in
bf16 splits the keys into ranges when one block per sequence would
leave the card idle (``plan``, from shapes only); the last split of a row
to finish merges the row's f32 partials in index order, inside the same
kernel: one call, one launch.  The splits find the last of them through
one arrival counter per row, which the wrapper keeps on the device
(zeroed once) and each call leaves at 0.  On CPU tensors it computes
the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

HEADS, RANK, ROPE = 32, 512, 64    # the shapes the kernel is built for
KEY_TILE = 32                      # keys per tile; a split is a multiple
BLOCKS_PER_SM = 1                  # the split plan's aim
_COUNTERS: dict = {}               # device -> the rows' arrival counters


@functools.cache
def _fn():
    fn = build.library("mla_decode").mla_decode
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10 +
                   [ctypes.c_int] * 4 +
                   [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                    ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _counters(device: torch.device, b: int) -> torch.Tensor:
    """At least ``b`` arrival counters on ``device``, all 0: zeroed when
    allocated (grown only when a call has more rows than ever before),
    and every call leaves the counters it used at 0."""
    have = _COUNTERS.get(device)
    if have is None or have.numel() < b:
        have = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
        _COUNTERS[device] = have
    return have


def mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor, c: torch.Tensor,
               krope: torch.Tensor, lengths: torch.Tensor, *,
               scale: float) -> torch.Tensor:
    """q_lat (b,h,r); q_rope (b,h,rd); c (b,S,r); krope (b,S,rd); lengths
    (b,) int32.  Returns o_lat (b,h,r)."""
    b, h, r = q_lat.shape
    s_max, rd = c.shape[1], krope.shape[2]
    if q_rope.shape != (b, h, rd) or c.shape != (b, s_max, r) \
            or krope.shape != (b, s_max, rd) or lengths.shape != (b,):
        raise ValueError(f"mla_decode: shapes q_lat {tuple(q_lat.shape)} "
                         f"q_rope {tuple(q_rope.shape)} c {tuple(c.shape)} "
                         f"krope {tuple(krope.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    build.require_no_grad("mla_decode", build.DECODE_ONLY, q_lat, q_rope, c, krope)
    if q_lat.device.type == "cpu":
        return ref.mla_decode_ref(q_lat, q_rope, c, krope, lengths,
                                  scale=scale)
    ts = (q_lat, q_rope, c, krope)
    build.require_cuda("mla_decode", *ts, lengths)
    if q_lat.dtype not in build.ATTN_DTYPES or \
            any(t.dtype != q_lat.dtype for t in ts) or \
            lengths.dtype != torch.int32:
        raise ValueError(f"mla_decode: dtypes {[t.dtype for t in ts]} "
                         f"{lengths.dtype}; need one of float32, bfloat16 "
                         f"and int32 lengths")
    if (h, r, rd) != (HEADS, RANK, ROPE):
        raise ValueError(f"mla_decode: built for (h, r, rd) = "
                         f"{(HEADS, RANK, ROPE)}, got {(h, r, rd)}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("mla_decode: the last dim must be contiguous")
    lengths = lengths.contiguous()
    out = torch.empty((b, h, r), dtype=c.dtype, device=c.device)
    if b == 0:
        return out
    bf16 = c.dtype == torch.bfloat16
    n_split, chunk = plan(b, s_max, build.sm_count(c.get_device()), bf16)
    names = ("q_lat", "q_rope", "c", "krope")
    if bf16:
        build.require_aligned(
            "mla_decode", {n: t.data_ptr() for n, t in zip(names, ts)},
            {n: t.stride()[:2] for n, t in zip(names, ts)},
            c.element_size())
    pm, pl, pacc = build.split_scratch(n_split, b * h, r, c.device)
    counters = _counters(c.device, b) if n_split > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    strides = (ctypes.c_longlong * 8)(*(x for t in ts for x in t.stride()[:2]))
    rc = _fn()(build.ATTN_DTYPES[c.dtype], *(t.data_ptr() for t in ts),
               lengths.data_ptr(), out.data_ptr(), ptr(pm), ptr(pl),
               ptr(pacc), ptr(counters), b, s_max, n_split, chunk, strides,
               float(scale), build.stream_of(c))
    build.check(rc, "mla_decode")
    mla_decode.launches += 1
    return out


mla_decode.launches = 0


def plan(b: int, s_max: int, n_sm: int, bf16: bool = True) -> tuple:
    """(n_split, chunk) of one call: bf16 splits the cache's ``s_max``
    key positions so that the ``b`` sequences make about
    ``BLOCKS_PER_SM`` blocks per SM (the kernel fits one an SM); float32
    never splits.  ds27b's 8 slots of a 6144-token cache on 132 SMs:
    (16, 384)."""
    target = BLOCKS_PER_SM * n_sm if bf16 else 0
    return build.split_plan(s_max, b, target, unit=KEY_TILE)
