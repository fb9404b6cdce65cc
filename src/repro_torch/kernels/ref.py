"""Plain PyTorch versions of the kernels: the four Pallas kernels' (port
of ``repro.kernels.ref``), the MoE grouped GEMM's (``jax.lax.ragged_dot``
in ``repro.models.moe``) and the absorbed MLA decode's
(``repro.models.mla.mla_decode``), and the key-split arithmetic of the
attention kernels (partials per key range, then the merge that their
combine kernels compute).

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


def _flash_scores(q, k, *, causal, softcap, window, kv_lens):
    """Scaled, softcapped f32 scores (b, hkv, g, sq, skv) and the mask of
    valid keys (b, sq, skv) of the flash contract."""
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
    return s, ok


def flash_attention_ref(q, k, v, *, causal=True, softcap=0.0, window=0,
                        kv_lens=None):
    """q (b,hq,sq,dk); k (b,hkv,skv,dk); v (b,hkv,skv,dv); kv_lens (b,)
    or None (= skv).  Query i of row b sits at position kv_lens[b] - sq +
    i; scores are scaled by 1/sqrt(dk)."""
    b, hq, sq, _ = q.shape
    s, ok = _flash_scores(q, k, causal=causal, softcap=softcap,
                          window=window, kv_lens=kv_lens)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def split_partials_ref(s, valid, v, chunk: int):
    """Per key range, what a split-K attention kernel writes before the
    merge.  s (n, r, K) f32 scores of r query rows of each of n heads,
    valid (n, r, K) bool, v (n, K, dh); keys [i * chunk, (i + 1) * chunk)
    form split i.  Returns (m, l, acc): m, l (n_split, n, r), acc
    (n_split, n, r, dh) f32, with p = exp(s - m) over the split's valid
    keys, l its sum, acc = p (in the V dtype) . v.  A split with no valid
    key for a row has l = 0 there (and m = -inf, acc = 0)."""
    out = ([], [], [])
    for lo in range(0, s.shape[-1], chunk):
        x = s[..., lo:lo + chunk].masked_fill(~valid[..., lo:lo + chunk],
                                              float("-inf"))
        m = x.amax(-1)
        p = torch.exp(x - torch.where(torch.isinf(m), 0.0, m)[..., None])
        acc = torch.einsum("nrk,nkd->nrd", p.to(v.dtype).float(),
                           v[:, lo:lo + chunk].float())
        for lst, t in zip(out, (m, p.sum(-1), acc)):
            lst.append(t)
    return tuple(torch.stack(lst) for lst in out)


def combine_ref(m, l, acc):
    """The combine kernels' merge of :func:`split_partials_ref`'s
    partials, over the splits: rows with no valid key in any split are
    0 (the kernels' contract)."""
    has = l > 0
    mx = torch.where(has, m, float("-inf")).amax(0)
    mx = torch.where(torch.isinf(mx), 0.0, mx)
    c = torch.where(has, torch.exp(m - mx), 0.0)
    lsum = (l * c).sum(0)[..., None]
    a = (acc * c[..., None]).sum(0)
    return torch.where(lsum > 0, a / lsum.clamp_min(1e-30), 0.0)


def flash_attention_split_ref(q, k, v, *, chunk: int, causal=True,
                              softcap=0.0, window=0, kv_lens=None):
    """:func:`flash_attention_ref` computed as the bf16 kernel does with
    its keys split in ranges of ``chunk``: partials, then the merge."""
    b, hq, sq, _ = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    s, ok = _flash_scores(q, k, causal=causal, softcap=softcap,
                          window=window, kv_lens=kv_lens)
    n = b * hkv
    parts = split_partials_ref(
        s.reshape(n, g * sq, skv),
        ok[:, None, None].expand(b, hkv, g, sq, skv).reshape(n, g * sq, skv),
        v.reshape(n, skv, dv), chunk)
    return combine_ref(*parts).reshape(b, hq, sq, dv).to(q.dtype)


def paged_attention_split_ref(q, k_pool, v_pool, block_table, lengths, *,
                              chunk: int, softcap=0.0, window=0):
    """:func:`paged_attention_ref` computed as the kernel does with its
    key positions split in ranges of ``chunk``: partials, then the
    merge."""
    b, hkv, g, dh = q.shape
    s, valid, v = _paged_scores(q, k_pool, v_pool, block_table, lengths,
                                softcap=softcap, window=window)
    n, K = b * hkv, s.shape[-1]
    parts = split_partials_ref(
        s.reshape(n, g, K),
        valid[:, None, None].expand(b, hkv, g, K).reshape(n, g, K),
        v.transpose(1, 2).reshape(n, K, dh), chunk)
    return combine_ref(*parts).reshape(b, hkv, g, dh).to(q.dtype)


def _paged_scores(q, k_pool, v_pool, block_table, lengths, *, softcap,
                  window=0):
    """Scaled, softcapped f32 scores (b, hkv, g, K) over the K = max_pages
    * pt key positions, the mask of valid positions (b, K) and the gathered
    V (b, K, hkv, dh).  Position j is valid iff j < len and, with a
    window, len - 1 - j < window (the reference's ``decode_attend``)."""
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
    cols = torch.arange(np_ * pt, device=q.device)[None, :]
    lens = lengths.to(torch.long)[:, None]
    valid = cols < lens
    if window > 0:
        valid = valid & (lens - 1 - cols < window)
    return s, valid, v


def paged_attention_ref(q, k_pool, v_pool, block_table, lengths, *,
                        softcap=0.0, window=0):
    """q (b,hkv,g,dh); pools (n,pt,hkv,dh); table (b,np); lengths (b,);
    ``window`` > 0 masks keys ``window`` or more behind the query."""
    s, valid, v = _paged_scores(q, k_pool, v_pool, block_table, lengths,
                                softcap=softcap, window=window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngk,bknd->bngd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def kv_layer_gather_ref(pool, table, *, layer: int):
    return pool[table.to(torch.long), layer]


def kv_layer_scatter_ref(pool, table, stream, *, layer):
    """In place: ``pool[table[i], layer] = stream[i]``; returns pool.  For
    a ``range`` of layers, stream (len(layer), n, pt, feat) and the same
    for each layer of the range."""
    if isinstance(layer, range):
        for j, li in enumerate(layer):
            kv_layer_scatter_ref(pool, table, stream[j], layer=li)
        return pool
    pool[table.to(torch.long), layer] = stream
    return pool


def grouped_gemm_ref(x, w, group_sizes):
    """``jax.lax.ragged_dot``: x (M, K) rows sorted by group, w (E, K, N),
    group_sizes (E,) ints -> y (M, N) in x's dtype, ``y[r] = x[r] @
    w[e(r)]`` with group e owning the next ``group_sizes[e]`` rows; rows
    past the groups are 0.  One matmul per group, which reads the sizes
    on the host."""
    m = x.shape[0]
    y = torch.zeros((m, w.shape[2]), dtype=x.dtype, device=x.device)
    lo = 0
    for e, n in enumerate(group_sizes.tolist()):
        hi = min(lo + int(n), m)
        if hi > lo:
            y[lo:hi] = x[lo:hi] @ w[e]
        lo = hi
    return y


def _mla_scores(q_lat, q_rope, c, krope, lengths, scale):
    """f32 scores (b, h, S) of the absorbed decode and the mask of valid
    keys (b, S): key j counts iff j < lengths[b]."""
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c.float()) +
         torch.einsum("bhd,bsd->bhs", q_rope.float(), krope.float())) * scale
    valid = torch.arange(c.shape[1], device=c.device)[None, :] < \
        lengths.to(torch.long)[:, None]
    return s, valid


def mla_decode_ref(q_lat, q_rope, c, krope, lengths, *, scale):
    """The absorbed MLA decode between ``q_lat`` and ``o_lat``
    (``repro.models.mla.mla_decode``): q_lat (b, h, r) and q_rope (b, h,
    rd) against the padded latent cache c (b, S, r) and krope (b, S, rd);
    the values are c itself.  Scores in f32, times ``scale``, keys at
    ``lengths`` and past masked, softmax in f32, p cast to c's dtype
    before P.c.  Returns o_lat (b, h, r) in c's dtype."""
    s, valid = _mla_scores(q_lat, q_rope, c, krope, lengths, scale)
    p = torch.softmax(torch.where(valid[:, None], s, NEG_INF), dim=-1)
    o = torch.einsum("bhs,bsr->bhr", p.to(c.dtype).float(), c.float())
    return o.to(c.dtype)


def mla_decode_split_ref(q_lat, q_rope, c, krope, lengths, *, scale,
                         chunk: int):
    """:func:`mla_decode_ref` computed as the bf16 kernel does with the
    keys split in ranges of ``chunk``: partials, then the merge."""
    s, valid = _mla_scores(q_lat, q_rope, c, krope, lengths, scale)
    parts = split_partials_ref(s, valid[:, None].expand_as(s), c, chunk)
    return combine_ref(*parts).to(c.dtype)
