"""Plain PyTorch versions of the kernels: the four Pallas kernels' (port
of ``repro.kernels.ref``), the MoE grouped GEMM's (``jax.lax.ragged_dot``
in ``repro.models.moe``), the absorbed MLA decode's
(``repro.models.mla.mla_decode``), the Mamba2 block's three pieces of
device work (``repro.models.ssm``: the causal conv, the chunked SSD scan,
also split as the card's kernel set splits it, and the decode step, the
token's conv folded into the recurrence), the gradients of the conv and
the scan (autograd of their plain forwards), and the key-split arithmetic
of the attention kernels (partials per key range, then the merge that
their combine kernels compute).

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
                        kv_lens=None, return_lse=False):
    """q (b,hq,sq,dk); k (b,hkv,skv,dk); v (b,hkv,skv,dv); kv_lens (b,)
    or None (= skv).  Query i of row b sits at position kv_lens[b] - sq +
    i; scores are scaled by 1/sqrt(dk).  With ``return_lse``, also each
    query row's log-sum-exp (b,hq,sq) f32: ln of the sum of exp(score)
    over its valid keys, -inf for a row without one (what the kernel
    writes for flash's backward)."""
    b, hq, sq, _ = q.shape
    s, ok = _flash_scores(q, k, causal=causal, softcap=softcap,
                          window=window, kv_lens=kv_lens)
    valid = ok[:, None, None]
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), v.float())
    o = o.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(torch.where(valid, s, float("-inf")), dim=-1)
    return o, lse.reshape(b, hq, sq)


def flash_attention_bwd_ref(q, k, v, do, *, causal=True, softcap=0.0,
                            window=0):
    """The gradient of :func:`flash_attention_ref` for full-sequence
    attention (every row's kv_len = s): (dq, dk, dv) for the cotangent
    ``do`` of its output, by ``torch.autograd.grad``, in the input dtype."""
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash_attention_ref(qg, kg, vg, causal=causal, softcap=softcap,
                                window=window)
        return torch.autograd.grad(o, (qg, kg, vg), do)


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


def grouped_gemm_bwd_ref(x, w, group_sizes, dy, need_dx=True,
                         need_dw=True):
    """The gradient of :func:`grouped_gemm_ref` for the cotangent ``dy``
    (M, N): (dx (M, K), ``dy[r] @ w[e(r)].T``, rows past the groups 0, in
    x's dtype; dw (E, K, N), ``x_e.T @ dy_e`` over each group's rows, 0
    for an empty group, in w's dtype), each accumulated in f32 and
    rounded once; None for a gradient not asked for.  One matmul per
    group, which reads the sizes on the host."""
    m = x.shape[0]
    dx = torch.zeros_like(x) if need_dx else None
    dw = torch.zeros_like(w) if need_dw else None
    lo = 0
    for e, n in enumerate(group_sizes.tolist()):
        hi = min(lo + max(int(n), 0), m)
        if hi > lo:
            g = dy[lo:hi].float()
            if need_dx:
                dx[lo:hi] = (g @ w[e].float().T).to(x.dtype)
            if need_dw:
                dw[e] = (x[lo:hi].float().T @ g).to(w.dtype)
        lo = hi
    return dx, dw


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


def causal_conv_ref(x, w, tail, *, f32_sum: bool = False):
    """``repro.models.ssm._causal_conv`` in its own rounding order: x (b,
    s, c), w (cw, c), tail (b, cw-1, c), all of one dtype.  ``out[t] =
    silu(sum_i xp[t + i] * w[i])`` over ``xp = tail ‖ x``, each product
    and each partial sum rounded to the dtype, the terms added one after
    another from i = 0 (the reference's Python ``sum``), then ``silu`` as
    ``out * sigmoid(out)``.  With ``f32_sum`` the terms are summed in f32
    in the same order and the SiLU taken in f32, rounded once to the
    dtype: the card's kernels' arithmetic (in bf16 each product is exact
    in f32, so only the SiLU's last bit can differ).  Returns (out (b, s,
    c), the new tail: the last cw-1 rows of xp)."""
    cw, s = w.shape[0], x.shape[1]
    xp = torch.cat([tail, x], dim=1)
    new_tail = xp[:, xp.shape[1] - (cw - 1):] if cw > 1 else tail
    if f32_sum:
        xp, w = xp.float(), w.float()
    out = xp[:, :s] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * w[i]
    return (out * torch.sigmoid(out)).to(x.dtype), new_tail


def ssd_chunk_scan_ref(x, B, C, dt, A, D, h0, chunk: int):
    """The chunked SSD scan of ``repro.models.ssm.ssd_scan`` between the
    conv and the gated norm: x (b, s, H, P), B and C (b, s, N), dt (b, s,
    H) f32 after softplus, A and D (H,), h0 (b, H, P, N) or None (zeros).
    Chunks of ``L = min(chunk, s)`` rows, the last padded with dt = 0;
    within a chunk the quadratic term ``C_i·B_j · exp(cs_i - cs_j) · dt_j``
    over j <= i applied to x, across chunks the carried state h, plus
    ``D·x``; every step in f32 but one: the cumulative sum ``cs`` of the
    f32 products ``dt·A`` is accumulated in f64 and rounded once (the
    reference sums in f32).  ``cs_i - cs_j`` of two sums in the hundreds
    is the scan's ill-conditioned step; a sum rounded once is the same
    f32 number whatever order the kernel adds in, so the kernel and this
    version agree there to the bit.  Returns (y (b, s, H, P) f32,
    h_final (b, H, P, N) f32)."""
    return _ssd_scan(x, B, C, dt, A, D, h0, chunk)


def ssd_chunk_scan_bwd_ref(x, B, C, dt, A, D, h0, chunk: int, dy, dh=None):
    """The gradient of :func:`ssd_chunk_scan_ref` for the cotangents ``dy``
    (b, s, H, P) of y and ``dh`` (b, H, P, N) of the final state (None:
    zeros), by ``torch.autograd.grad`` of the masked plain forward: (dx,
    dB, dC, ddt, dA, dD, dh0), each in its input's dtype; dh0 is None when
    h0 is."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, B, C, dt, A, D)]
        h = None if h0 is None else h0.detach().requires_grad_(True)
        y, h_final = ssd_chunk_scan_ref(*ins, h, chunk)
        outs, cots = [y], [dy]
        if dh is not None:
            outs.append(h_final)
            cots.append(dh)
        wrt = ins + ([] if h is None else [h])
        got = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(got, wrt)]
    return (*got[:6], None if h is None else got[6])


def causal_conv_bwd_ref(x, w, tail, dout, dnew_tail=None, *,
                        f32_sum: bool = False):
    """The gradient of :func:`causal_conv_ref` (with its ``f32_sum``) for
    the cotangents ``dout`` (b, s, c) of the output and ``dnew_tail`` (b,
    cw-1, c) of the new tail (None: zeros), by ``torch.autograd.grad``:
    (dx, dw, dtail) in the input dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, w, tail)]
        out, new_tail = causal_conv_ref(*ins, f32_sum=f32_sum)
        outs, cots = [out], [dout]
        if dnew_tail is not None:
            outs.append(new_tail)
            cots.append(dnew_tail)
        got = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(got, ins))


def _tf32(t):
    """f32 values rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) &
            ~0x1FFF).view(torch.float32)


def _ssd_scan(x, B, C, dt, A, D, h0, chunk: int, *, carry: bool = True,
              shift: int = 0, tf32: bool = False):
    """:func:`ssd_chunk_scan_ref`; ``carry=False`` drops the carried state
    (each chunk starts from zeros), ``shift`` moves the cumulative sum
    down by that many rows, and ``tf32`` rounds each product's f32-valued
    operand to TF32 (the weighted x, the carried state), as the card's
    split-TF32 products would without their low parts: the planted faults
    the card's check must see fail."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    L = min(chunk, s)
    pad = (-s) % L
    nc = (s + pad) // L
    f32 = lambda t: t.float()
    padded = lambda t: torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
    xh = padded(f32(x).reshape(b, s, H * P)).reshape(b, nc, L, H, P)
    Bc = padded(f32(B)).reshape(b, nc, L, N)
    Cc = padded(f32(C)).reshape(b, nc, L, N)
    dtc = padded(f32(dt)).reshape(b, nc, L, H)
    A = f32(A)
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else f32(h0)
    idx = torch.arange(L, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]          # (i, j, 1)
    ys = []
    for c in range(nc):
        xc, Bj, Ci, dtj = xh[:, c], Bc[:, c], Cc[:, c], dtc[:, c]
        if not carry:
            h = torch.zeros_like(h)
        dA = dtj * A                                              # (b,L,H)
        # accumulated in f64, rounded once: see ssd_chunk_scan_ref
        cs = torch.cumsum(dA.double(), dim=1).float()
        if shift:
            cs = torch.cat([torch.zeros_like(cs[:, :shift]),
                            cs[:, :-shift]], dim=1)
        seg = cs[:, :, None, :] - cs[:, None, :, :]               # (b,i,j,H)
        # exponentiate the kept entries only: seg for j > i may pass 88,
        # and exp(inf) masked by where would make its gradient 0 * inf
        Lmat = torch.exp(torch.where(causal[None], seg, float("-inf")))
        CB = torch.einsum("bin,bjn->bij", Ci, Bj)
        rnd = _tf32 if tf32 else (lambda t: t)
        w = rnd(CB[..., None] * Lmat * dtj[:, None, :, :])
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + torch.einsum("bin,bhpn,bih->bihp", Ci, rnd(h), torch.exp(cs))
        decay_to_end = torch.exp(cs[:, -1:, :] - cs)              # (b,L,H)
        if tf32:
            S = torch.einsum("blhp,bln->bhpn", rnd(
                (decay_to_end * dtj)[..., None] * xc), Bj)
        else:
            S = torch.einsum("blh,bln,blhp->bhpn", decay_to_end * dtj, Bj,
                             xc)
        h = h * torch.exp(cs[:, -1, :])[:, :, None, None] + S
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * L, H, P)[:, :s]
    return y + f32(x) * f32(D)[None, None, :, None], h


def ssd_chunk_parallel_ref(x, B, C, dt, A, D, h0, chunk: int,
                           out_state=None):
    """:func:`ssd_chunk_scan_ref` split as the card's kernel set splits it
    (``csrc/ssd_scan.cu``; the SSD paper's four steps), for the tests:
    chunks of ``L = min(chunk, s)`` rows, the last one short and masked
    rather than padded.  (1) ``CB_c = C_c·B_cᵀ`` once per chunk, shared by
    the heads; (2) each chunk's own state ``S_c = Σ_j exp(cs_end - cs_j)
    dt_j x_j ⊗ B_j`` from zeros, with ``cs`` the chunk's cumulative sum of
    ``dt·A`` (f64, rounded once); (3) the state passing, sequential over
    chunks only: ``h_c = h_{c-1}·exp(cs_end_c) + S_c``, keeping the state
    that enters each chunk and writing the last to ``out_state`` (which
    may be h0 itself: h0 is read first); (4) each chunk's output from
    ``CB_c``, its cumulative sum and the state entering it, plus ``D·x``.
    Returns (y (b, s, H, P) f32, h_final (b, H, P, N) f32)."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    L = min(chunk, s)
    xf, Bf, Cf, dtf = x.float(), B.float(), C.float(), dt.float()
    A = A.float()
    spans = [(r0, min(s, r0 + L)) for r0 in range(0, s, L)]
    # (1) and (2), each chunk on its own
    CB, cs, S = [], [], []
    for r0, r1 in spans:
        Bc, Cc, dtc = Bf[:, r0:r1], Cf[:, r0:r1], dtf[:, r0:r1]
        CB.append(torch.einsum("bin,bjn->bij", Cc, Bc))
        c = torch.cumsum((dtc * A).double(), dim=1).float()     # (b,len,H)
        cs.append(c)
        w = torch.exp(c[:, -1:, :] - c) * dtc
        S.append(torch.einsum("blh,bln,blhp->bhpn", w, Bc, xf[:, r0:r1]))
    # (3) the state entering each chunk, then the final state
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float().clone()
    h_in = []
    for c, Sc in zip(cs, S):
        h_in.append(h)
        h = h * torch.exp(c[:, -1, :])[:, :, None, None] + Sc
    if out_state is not None:
        h = out_state.copy_(h)
    # (4) the outputs, every chunk against the state entering it
    ys = []
    for (r0, r1), cb, c, hc in zip(spans, CB, cs, h_in):
        n = r1 - r0
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        seg = c[:, :, None, :] - c[:, None, :, :]                # (b,i,j,H)
        Lmat = torch.exp(torch.where(causal, seg, float("-inf")))
        w = cb[..., None] * Lmat * dtf[:, r0:r1][:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", w, xf[:, r0:r1])
        ys.append(y + torch.einsum("bin,bhpn,bih->bihp", Cf[:, r0:r1], hc,
                                   torch.exp(c)))
    y = torch.cat(ys, dim=1)
    return y + xf * D.float()[None, None, :, None], h


def ssm_step_ref(h, x, B, C, dt, A, D, *, decay_after: bool = False):
    """``repro.models.ssm.ssm_decode_step``'s recurrence, one token per
    sequence: h (b, H, P, N) f32, updated in place to ``h·exp(dt·A) +
    (dt·x) ⊗ B``; x (b, H, P); B and C (b, N); dt (b, H) f32; A and D
    (H,).  Returns y (b, H, P) f32 = ``h·C + D·x`` of the new h.
    ``decay_after`` applies the decay after the update instead (a planted
    fault for the card's check)."""
    x, B, C = x.float(), B.float(), C.float()
    decay = torch.exp(dt * A.float())[:, :, None, None]
    upd = (dt[:, :, None] * x)[..., None] * B[:, None, None, :]
    h.copy_((h + upd) * decay if decay_after else h * decay + upd)
    return torch.einsum("bhpn,bn->bhp", h, C) + x * D.float()[None, :, None]


def ssm_conv_step_ref(h, x, B, C, w_x, w_B, w_C, tail_x, tail_B, tail_C, dt,
                      A, D, *, decay_after: bool = False,
                      f32_conv: bool = False):
    """The decode step of ``repro.models.ssm.ssm_decode_step`` after the
    projections: the token's causal conv with SiLU over x, B and C
    (:func:`causal_conv_ref`, the reference's bf16 order), then
    :func:`ssm_step_ref` on its outputs.  x (b, H, P), B and C (b, N) are
    the token's pre-conv values; w_x (cw, H·P), w_B and w_C (cw, N) the
    conv weights; the tails tail_x (b, cw-1, H·P), tail_B and tail_C (b,
    cw-1, N) and h are updated in place.  Returns y (b, H, P) f32.
    ``decay_after`` as in :func:`ssm_step_ref`; ``f32_conv`` sums the
    conv as the card's kernel does (:func:`causal_conv_ref`'s
    ``f32_sum``)."""
    b, H, P = x.shape
    conv = lambda v, w, t: causal_conv_ref(v, w, t, f32_sum=f32_conv)
    xo, new_x = conv(x.reshape(b, 1, H * P), w_x, tail_x)
    Bo, new_B = conv(B[:, None], w_B, tail_B)
    Co, new_C = conv(C[:, None], w_C, tail_C)
    for tail, new in ((tail_x, new_x), (tail_B, new_B), (tail_C, new_C)):
        tail.copy_(new)
    return ssm_step_ref(h, xo.view(b, H, P), Bo[:, 0], Co[:, 0], dt, A, D,
                        decay_after=decay_after)
