"""Prefix-append flash attention — the prefill compute pattern.

q (b, hq, sq, dk), the append chunk, attends over k (b, hkv, skv, dk)
and v (b, hkv, skv, dv), prefix || append, with query i of row b at
global position ``kv_lens[b] - sq + i`` (``kv_lens`` defaults to ``skv``
for every row, the Pallas kernel's contract).  Keys at or past
``kv_lens[b]`` are padding.  The widths are one of ``WIDTHS``: dk = dv
for every GQA model, and (192, 128) for ds27b's MLA append; scores are
scaled by 1/sqrt(dk).  On CUDA tensors this launches
``csrc/flash_attention.cu``, the Hopper kernel that replaces the Pallas
``flash_attention`` (``repro/kernels/flash_attention.py:107``); on CPU
tensors it computes the plain version.

In bf16 the kernel runs on the tensor cores and, when the grid of
64-row query tiles is under one wave of the card's SMs, splits the keys
into ranges (``build.split_plan``, from shapes only) whose f32 partials a
second kernel merges: still one call, one launch count.  Its 16-byte
copies need q, k, v 16-byte aligned with strides that are multiples of 8
elements; the wrapper checks and raises.  float32 runs the scalar path in
one split.

The CUDA path takes strided views: any tensor whose last dim is
contiguous, so the model passes its (b, s, h, dh) activations and caches
transposed, without a copy.  The output is allocated (b, sq, hq, dv) in
memory and returned as its (b, hq, sq, dv) view, so the model's
transpose back is free.

Training: when grad mode is on and q, k or v requires grad, the call goes
through an autograd Function whose backward is ``flash_attention_bwd``,
``csrc/flash_attention_bwd.cu`` on CUDA tensors (the reference has no
backward kernel: XLA differentiates its jnp attention) and
``ref.flash_attention_bwd_ref`` on CPU tensors.  It covers full-sequence
attention (sq = skv, no ``kv_lens``) at every pair of ``WIDTHS``, MLA's
(192, 128) included (any widths on CPU tensors); an append with
``kv_lens`` raises under grad.  Its
forward has the kernel also write each query row's log-sum-exp
(``lse``, (b, hq, s) f32, from the online softmax's own m and l: no
launch of its own) and saves it beside q, k, v and o; the backward
reads it instead of recomputing it.  In bf16 the backward is two
launches on the tensor cores (dQ with D = sum(dO * o), then dK and dV),
in float32 three scalar ones (D, dK and dV, dQ); either counts as one
call.  Without grad the call is the forward alone, launch for launch,
and no ``lse`` is written.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 80, 128, 256)
# (q/k width, v width) pairs the kernel is built for
WIDTHS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
MAX_GROUP = 64     # query heads per kv head that fit one block's rows
ROWS = 64          # query rows (queries x group) per bf16 block
KEY_TILE = 64      # keys per K/V tile; a split's range is a multiple
SPLIT_BLOCKS_PER_SM = 4   # the split plan's aim, under one wave of tiles


@functools.cache
def _fn():
    fn = build.library("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 +
                   [ctypes.c_int] * 7 +
                   [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                    ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = build.library("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10 +
                   [ctypes.c_int] * 4 +
                   [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    window: int = 0,
                    kv_lens: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q (b,hq,sq,dk); k (b,hkv,skv,dk); v (b,hkv,skv,dv); kv_lens (b,)
    int32 or None.  Returns (b,hq,sq,dv), differentiable in q, k and v
    for full-sequence attention (see the module's docstring).  With
    ``return_lse``, returns (o, lse), lse (b,hq,sq) f32 each query row's
    log-sum-exp, from the forward alone (no autograd)."""
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[3]
    if hq % hkv or v.shape[:3] != k.shape[:3] or k.shape[0] != b \
            or k.shape[3] != dh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if return_lse:
        if grad:
            raise ValueError("flash_attention: return_lse is the forward "
                             "alone; run it without grad")
        return _forward(q, k, v, causal, softcap, window, kv_lens,
                        return_lse=True)
    if grad:
        if kv_lens is not None or sq != skv:
            raise NotImplementedError(
                "flash_attention's backward covers full-sequence attention "
                "(sq = skv, no kv_lens): training runs no append")
        return _Flash.apply(q, k, v, causal, float(softcap), int(window))
    return _forward(q, k, v, causal, softcap, window, kv_lens)


class _Flash(torch.autograd.Function):
    """Full-sequence flash attention with ``flash_attention_bwd`` as its
    backward; the forward's inputs, output and log-sum-exp are saved for
    it (under remat the recomputed forward saves them again)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, window):
        o, lse = _forward(q, k, v, causal, softcap, window, None,
                          return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, softcap, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, softcap, window = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse=lse,
                                         causal=causal, softcap=softcap,
                                         window=window)
        return dq, dk, dv, None, None, None


def _forward(q, k, v, causal, softcap, window, kv_lens, return_lse=False):
    """The forward alone: the kernel on CUDA tensors, the plain version on
    CPU tensors; with ``return_lse``, (o, lse)."""
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[3]
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       softcap=softcap, window=window,
                                       kv_lens=kv_lens, return_lse=return_lse)
    args = (q, k, v) if kv_lens is None else (q, k, v, kv_lens)
    build.require_cuda("flash_attention", *args)
    if q.dtype not in build.ATTN_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype} {k.dtype} "
                         f"{v.dtype}; need one of float32, bfloat16")
    if (dh, dv) not in WIDTHS or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_attention: widths {(dh, dv)} (need one "
                         f"of {WIDTHS}) or group {hq // hkv} > {MAX_GROUP}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if kv_lens is not None:
        if kv_lens.dtype != torch.int32 or kv_lens.shape != (b,):
            raise ValueError("flash_attention: kv_lens must be (b,) int32")
        kv_lens = kv_lens.contiguous()
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    if b == 0 or sq == 0:
        return (out, lse) if return_lse else out
    n_split, chunk = plan(b, hq, hkv, sq, skv,
                          build.sm_count(q.get_device()),
                          q.dtype == torch.bfloat16)
    if q.dtype == torch.bfloat16:
        build.require_aligned(
            "flash_attention",
            {n: t.data_ptr() for n, t in (("q", q), ("k", k), ("v", v))},
            {n: t.stride()[:3] for n, t in (("q", q), ("k", k), ("v", v))},
            q.element_size())
    pm, pl, pacc = build.split_scratch(n_split, b * hq * sq, dv, q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    rc = _fn()(build.ATTN_DTYPES[q.dtype], dh, dv, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr(pm), ptr(pl),
               ptr(pacc), ptr(lse), ptr(kv_lens), b, hq, hkv, sq, skv,
               n_split, chunk, strides, 1.0 / math.sqrt(dh), float(softcap),
               int(causal), int(window), build.stream_of(q))
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        lse: Optional[torch.Tensor] = None,
                        causal: bool = True, softcap: float = 0.0,
                        window: int = 0) -> tuple:
    """The gradient of full-sequence :func:`flash_attention`: q (b,hq,s,dk),
    k (b,hkv,s,dk), v (b,hkv,s,dv), o and do (b,hq,s,dv), (dk, dv) in
    ``WIDTHS`` on the card, o the forward's output, do its cotangent and
    lse (b,hq,s) f32 the log-sum-exp the forward wrote (``return_lse``).
    Returns (dq, dk, dv) in the input dtype, dq and dk dk wide and dv dv
    wide, each allocated (b, s, h, width) in memory and returned as its
    (b, h, s, width) view.  On CUDA tensors one call runs the launches of
    ``csrc/flash_attention_bwd.cu`` (two in bf16, three in float32,
    counted once) and needs ``lse``; on CPU tensors it is
    ``ref.flash_attention_bwd_ref`` at any widths (``o`` and ``lse``
    unused).  An ``lse`` of another shape or dtype is refused on either
    device."""
    b, hq, s, dh = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    if hq % hkv or k.shape != (b, hkv, s, dh) \
            or v.shape != (b, hkv, s, dv) or o.shape != (b, hq, s, dv) \
            or do.shape != o.shape:
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} o "
                         f"{tuple(o.shape)} do {tuple(do.shape)}")
    if lse is not None and (lse.shape != (b, hq, s)
                            or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}; need {(b, hq, s)} float32")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                           softcap=softcap, window=window)
    if lse is None:
        raise ValueError("flash_attention_bwd: CUDA tensors need the "
                         "forward's lse (flash_attention(..., "
                         "return_lse=True))")
    build.require_cuda("flash_attention_bwd", q, k, v, o, do, lse)
    if q.dtype not in build.ATTN_DTYPES or any(
            t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError(f"flash_attention_bwd: dtypes "
                         f"{[t.dtype for t in (q, k, v, o, do)]}; need all "
                         f"float32 or all bfloat16")
    if (dh, dv) not in WIDTHS or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_attention_bwd: widths {(dh, dv)} (need one "
                         f"of {WIDTHS}) or group {hq // hkv} > {MAX_GROUP}")
    if any(t.stride(-1) != 1 for t in (q, k, v, o)):
        raise ValueError("flash_attention_bwd: the head dim must be "
                         "contiguous")
    per = 16 // q.element_size()
    if do.stride(-1) != 1 or do.data_ptr() % 16 or any(
            x % per for x in do.stride()[:3]):
        # autograd's cotangent in a layout the kernel does not read
        do = do.contiguous()
    if q.dtype == torch.bfloat16:
        named = (("q", q), ("k", k), ("v", v), ("o", o))
        build.require_aligned(
            "flash_attention_bwd",
            {n: t.data_ptr() for n, t in named},
            {n: t.stride()[:3] for n, t in named}, q.element_size())
    grads = [torch.empty((b, s, h, w), dtype=q.dtype,
                         device=q.device).transpose(1, 2)
             for h, w in ((hq, dh), (hkv, dh), (hkv, dv))]
    if b == 0 or s == 0:
        return tuple(grads)
    lse = lse.contiguous()
    dsum = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        x for t in (q, k, v, o, do, *grads) for x in t.stride()[:3]))
    rc = _bwd_fn()(build.ATTN_DTYPES[q.dtype], dh, dv, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                   *(g.data_ptr() for g in grads), lse.data_ptr(),
                   dsum.data_ptr(), b, hq, hkv, s, strides,
                   1.0 / math.sqrt(dh), float(softcap), int(causal),
                   int(window),
                   bwd_groups(b, hkv, s, dh, build.sm_count(q.get_device())),
                   build.stream_of(q))
    build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return tuple(grads)


flash_attention_bwd.launches = 0


def bwd_groups(b: int, hkv: int, s: int, dh: int, n_sm: int) -> int:
    """Warp groups a block of the bf16 backward's dK/dV launch: 2 when its
    ``b * hkv * ceil(s / key tile)`` blocks (key tiles of 64, 32 at q/k
    widths over 128) fit one block an SM, so the query tiles split
    between two groups of 4 warps and each SM holds 8 warps; 1 above,
    where the blocks fill the SMs two at a time (the timings are in
    PERF.md)."""
    tile = 32 if dh > 128 else 64
    return 2 if b * hkv * -(-s // tile) <= n_sm else 1


def plan(b: int, hq: int, hkv: int, sq: int, skv: int, n_sm: int,
         bf16: bool = True) -> tuple:
    """(n_split, chunk) of one call: bf16 splits the keys when the
    ``b * hkv * ceil(sq / bq)`` query tiles are under one wave of ``n_sm``
    SMs, aiming at ``SPLIT_BLOCKS_PER_SM`` blocks per SM; float32 never
    splits."""
    bq = max(1, ROWS // (hq // hkv))
    n_tiles = b * hkv * -(-sq // bq)
    target = SPLIT_BLOCKS_PER_SM * n_sm if bf16 and n_tiles < n_sm else 0
    return build.split_plan(skv, n_tiles, target, unit=KEY_TILE)
