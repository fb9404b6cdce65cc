"""Plain PyTorch versions of the four kernels (port of
``repro.kernels.ref``).

Each wrapper computes these for CPU tensors; the tests hold them against
the JAX kernels, and ``chip_smoke.py`` holds the CUDA kernels against them
on the card.  Scores and softmax are f32 and ``p`` is cast to the V dtype
before P.V, as the Pallas kernels and the reference model's attention do,
so bf16 results round where theirs round.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, softcap=0.0, window=0,
                        kv_lens=None):
    """q (b,hq,sq,dh); k,v (b,hkv,skv,dh); kv_lens (b,) or None (= skv).
    Query i of row b sits at position kv_lens[b] - sq + i."""
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, dh).float()
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) * (1.0 / math.sqrt(dh))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if kv_lens is None:
        lens = torch.full((b,), skv, dtype=torch.long, device=q.device)
    else:
        lens = kv_lens.to(torch.long)
    rows = (lens - sq)[:, None] + torch.arange(sq, device=q.device)  # (b,sq)
    cols = torch.arange(skv, device=q.device)
    ok = (cols[None, None, :] < lens[:, None, None]).expand(b, sq, skv)
    if causal:
        ok = ok & (cols[None, None, :] <= rows[:, :, None])
    if window > 0:
        ok = ok & ((rows[:, :, None] - cols[None, None, :]) < window)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, hq, sq, dh).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_table, lengths, *,
                        softcap=0.0):
    """q (b,hkv,g,dh); pools (n,pt,hkv,dh); table (b,np); lengths (b,)."""
    b, hkv, g, dh = q.shape
    _, pt, _, _ = k_pool.shape
    np_ = block_table.shape[1]
    tbl = block_table.to(torch.long)
    k = k_pool[tbl].reshape(b, np_ * pt, hkv, dh)
    v = v_pool[tbl].reshape(b, np_ * pt, hkv, dh)
    s = torch.einsum("bngd,bknd->bngk", q.float(), k.float()) * (
        1.0 / math.sqrt(dh))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = torch.arange(np_ * pt, device=q.device)[None, :] < \
        lengths.to(torch.long)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngk,bknd->bngd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def kv_layer_gather_ref(pool, table, *, layer: int):
    return pool[table.to(torch.long), layer]


def kv_layer_scatter_ref(pool, table, stream, *, layer: int):
    """In place: ``pool[table[i], layer] = stream[i]``; returns pool."""
    pool[table.to(torch.long), layer] = stream
    return pool
