"""Model assembly for the dense, MoE, VLM and encoder families, GQA or
MLA attention, the SSM family's Mamba2 blocks and the hybrid's Mamba2
backbone with its shared attention block (port of
``repro.models.model``).

Inputs are token ids (b, s) or, for a config with ``frontend_embed_dim``
(the VLM's patch embeddings, the encoder's frame embeddings), float
embeddings (b, s, frontend_embed_dim) that the connector
``embed["frontend_proj"]`` projects to d_model.  The encoder attends
bidirectionally (``cfg.causal`` False) and has only ``forward``: its
``decode_step``, ``append_step`` and ``init_decode_state`` raise, as the
reference asserts ``supports_decode``.

* ``forward``       — full sequence; optionally returns the KV it made,
                      or recomputes each block in the backward (remat).
* ``lm_loss``       — next-token cross-entropy of the logits.
* ``decode_step``   — one token per sequence against a decode state.
* ``append_step``   — prefill an appended chunk against existing padded
                      caches (the engine's prefill step).

Decode state: GQA ``{"kv": {"k", "v": (L, b, S, hkv, dh)}}``, the
reference's layout; MLA ``{"mla": {"c": (L, b, S, r), "krope": (L, b, S,
rd)}}`` over every layer; SSM ``{"mamba": {"ssm": (L, b, H, P, N) f32,
"conv_x" / "conv_B" / "conv_C": (L, b, conv_width-1, dim)}}``, the
reference's layout; hybrid ``{"mamba": {...(L, b, ...)}, "shared": {"k",
"v": (n_apps, b, S, hkv, dh)}}``, the reference's with its (n_super,
period) Mamba2 stacks flattened.  The reference splits an MoE model's
state as
its parameters, ``{"dense": ..., "moe": ...}``
(``bridge.state_from_jax`` joins them).  Where the reference scans over
stacked layers, the port loops over ``params["blocks"]``; a block with
an ``"moe"`` entry runs the routed experts (``models.moe``) in place of
the dense FFN.  ``decode_step`` and ``append_step`` write the new
tokens' K/V into the state's buffers in place and return the same state
object: the reference returns fresh arrays, the port saves a copy of the
whole cache per step.  Writes past the cache raise (JAX would drop them
silently).  The SSM family's state is constant-size: the steps update
each layer's slice of it in place (``models.ssm``) and ignore
``lengths``, as the reference does.  The hybrid runs the shared block
(``params["shared_block"]``) after every ``hybrid_period``-th Mamba2
layer against that application's K/V; its Mamba2 half ignores
``lengths`` and its attention half reads them, as the dense family's.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import require_decode, require_ported


def embed(params, cfg: ModelConfig, inputs):
    """Token ids (b, s) -> (b, s, d); or precomputed frontend embeddings
    (b, s, frontend_dim), cast to the embedding dtype, through the
    connector projection -> (b, s, d)."""
    e = params["embed"]
    if inputs.dim() == 3:
        if not cfg.frontend_embed_dim:
            raise ValueError(f"{cfg.name}: embeddings given to a model "
                             f"without a frontend")
        h = inputs.to(e["tok"].dtype) @ e["frontend_proj"]
    else:
        # F.embedding, not e["tok"][inputs]: its CUDA backward sums a
        # token's rows in a fixed order, so training steps are
        # bit-reproducible
        h = torch.nn.functional.embedding(inputs, e["tok"])
    if cfg.embed_scale != 1.0:
        # the scale rounds to the activation dtype first, as in JAX
        h = h * torch.tensor(cfg.embed_scale, dtype=h.dtype, device=h.device)
    return h


def logits_from_hidden(params, cfg: ModelConfig, h):
    """The product runs in the parameter dtype and is cast to f32
    afterwards, as the reference does (``model.py:59-62``)."""
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_embeddings:
        out = h @ params["embed"]["tok"].T
    else:
        out = h @ params["lm_head"]
    return layers._softcap(out.float(), cfg.final_logit_softcap)


def layer_windows(cfg: ModelConfig):
    """Each layer's attention window: ``local_window`` on 'local_attn'
    layers, 0 (no window) on global ones.  The reference gives global
    layers ``BIG_WINDOW = 1 << 30`` (``model.py:33``, ``_window_for``
    :71); the two agree while sequences stay under 2**30 tokens."""
    return [cfg.local_window if kind == "local_attn" else 0
            for kind in cfg.layer_kinds()]


def _block(p, cfg: ModelConfig, h, attn_fn):
    """One transformer block; ``attn_fn(p_attn, xn)`` is the attention
    flavour (full, append or decode)."""
    xn = rms_norm(h, p["ln1"], cfg.rms_norm_eps)
    attn = attn_fn(p["attn"], xn)
    if cfg.post_attn_norm:
        attn = rms_norm(attn, p["ln1b"], cfg.rms_norm_eps)
    h = h + attn * cfg.ffn_mult
    xn = rms_norm(h, p["ln2"], cfg.rms_norm_eps)
    f = moe.moe_ffn(p["moe"], cfg, xn) if "moe" in p \
        else layers.ffn(p["ffn"], cfg, xn)
    if cfg.post_attn_norm:
        f = rms_norm(f, p["ln2b"], cfg.rms_norm_eps)
    return h + f * cfg.ffn_mult


def _mamba_block(p, cfg: ModelConfig, h, step, state=None):
    """One Mamba2 block, ``step`` the SSD flavour (``ssm.ssd_scan``,
    ``ssd_scan_with_tails`` or ``ssm_decode_step``): returns (h + out,
    the layer's state)."""
    xn = rms_norm(h, p["ln"], cfg.rms_norm_eps)
    out, st = step(p, cfg, xn) if state is None else step(p, cfg, xn, state)
    return h + out, st


def _mamba_layers(state):
    """Each layer's state dict of views into the stacked ``{"mamba":
    ...}`` state (writes go through to the stack)."""
    m = state["mamba"]
    return [{k: v[li] for k, v in m.items()}
            for li in range(m["ssm"].shape[0])]


def _check_fits(lengths, s: int, max_seq: int) -> int:
    """The longest row's length after writing ``s`` tokens (one host read
    per step), or raise past the cache."""
    top = int(lengths.max()) + s if lengths.numel() else 0
    if top > max_seq:
        raise IndexError(f"writing up to position {top} past the cache "
                         f"length {max_seq}")
    return top


def _cache(state, cfg: ModelConfig):
    """The state's two stacks: (k, v) for GQA, (c, krope) for MLA, the
    shared block's (k, v) over its applications for the hybrid."""
    if cfg.family == "hybrid":
        return state["shared"]["k"], state["shared"]["v"]
    if cfg.attn_variant == "mla":
        return state["mla"]["c"], state["mla"]["krope"]
    return state["kv"]["k"], state["kv"]["v"]


def _shared_app(cfg: ModelConfig, li: int):
    """The hybrid's shared-block application that follows layer ``li``
    (after every ``hybrid_period``-th layer), or None."""
    if cfg.family != "hybrid" or (li + 1) % cfg.hybrid_period:
        return None
    return li // cfg.hybrid_period


REMAT_POLICIES = ("full", "dots", "dots_no_batch")


def _maybe_remat(fn, remat):
    """remat: False | True ('full') | a policy of ``REMAT_POLICIES``.
    'full' recomputes each block in the backward (``checkpoint`` without
    reentry), as the reference wraps each scanned body in
    ``jax.checkpoint(..., nothing_saveable)`` (``model.py:165-171``)."""
    if not remat:
        return fn
    name = "full" if remat is True else remat
    if name in ("dots", "dots_no_batch"):
        raise NotImplementedError(
            f"remat policy {name!r} comes with the mesh layer (ROADMAP "
            f"Queue 1 item 4), where the dry run uses it")
    if name != "full":
        raise ValueError(f"remat {remat!r}: one of False, True, "
                         f"{REMAT_POLICIES}")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward(params, cfg: ModelConfig, tokens, *, return_state: bool = False,
            last_only: bool = False, remat=False):
    """Full-sequence forward over tokens (b, s) or frontend embeddings
    (b, s, frontend_dim).  Returns (logits,
    state_or_None); the state holds the exact-length KV (L, b, s, hkv, dh)
    or, for MLA, latents (L, b, s, r) and (L, b, s, rd); the hybrid's
    holds its Mamba2 states and its shared block's KV per application.
    ``remat`` (False, True or 'full') recomputes each block's activations
    in the backward instead of keeping them (see :func:`_maybe_remat`);
    it does not combine with ``return_state``."""
    require_ported(cfg)
    if remat and return_state:
        raise ValueError("forward: remat recomputes the blocks, so it "
                         "cannot also return their state")
    block, mamba_block = (_maybe_remat(f, remat)
                          for f in (_block, _mamba_block))
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    h = embed(params, cfg, tokens)
    ks, vs = [], []

    def full(window):
        def attn(p, x):
            if cfg.attn_variant == "mla":
                o, (c, kr) = mla.mla_full(p, cfg, x, positions,
                                          causal=cfg.causal)
                if return_state:
                    ks.append(c)
                    vs.append(kr)
                return o
            q, k, v = layers.gqa_qkv(p, cfg, x, positions)
            if return_state:
                ks.append(k)
                vs.append(v)
            o = layers.attend(q, k, v, causal=cfg.causal,
                              softcap=cfg.attn_logit_softcap, window=window)
            return layers.attn_out(p, o)
        return attn

    state = None
    if cfg.family in ("ssm", "hybrid"):
        sts = []
        for li, blk in enumerate(params["blocks"]):
            h, st = mamba_block(blk, cfg, h, ssm.ssd_scan)
            sts.append(st)
            if _shared_app(cfg, li) is not None:
                h = block(params["shared_block"], cfg, h, full(0))
        if return_state:
            state = {"mamba": {k: torch.stack([st[k] for st in sts])
                               for k in sts[0]}}
            if ks:
                state["shared"] = {"k": torch.stack(ks),
                                   "v": torch.stack(vs)}
    else:
        for blk, window in zip(params["blocks"], layer_windows(cfg)):
            h = block(blk, cfg, h, full(window))
        if return_state:
            state = {"mla": {"c": torch.stack(ks), "krope": torch.stack(vs)}} \
                if cfg.attn_variant == "mla" else \
                {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    if last_only:
        h = h[:, -1:]
    return logits_from_hidden(params, cfg, h), state


def lm_loss(logits, labels, mask=None):
    """Mean next-token cross-entropy.  logits (b,s,v), labels (b,s); with
    ``mask`` (b,s), the mean over its nonzero entries (the reference's
    ``model.py:628``): log-softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> Dict:
    """Zero decode caches on ``device`` (``"meta"`` gives shapes only)."""
    require_decode(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve(device)
    dtype = getattr(torch, cfg.kv_cache_dtype)
    zeros = lambda n, *s: torch.zeros((n, batch, max_seq) + s, dtype=dtype,
                                      device=dev)
    if cfg.family in ("ssm", "hybrid"):
        st = ssm.init_ssm_state(cfg, batch, dev)
        out = {"mamba": {k: v[None].repeat((cfg.n_layers,) +
                                           (1,) * v.dim())
                         for k, v in st.items()}}
        if cfg.family == "hybrid":
            n_apps = cfg.n_layers // cfg.hybrid_period
            out["shared"] = {"k": zeros(n_apps, cfg.n_kv_heads, cfg.head_dim),
                             "v": zeros(n_apps, cfg.n_kv_heads, cfg.head_dim)}
        return out
    if cfg.attn_variant == "mla":
        return {"mla": {"c": zeros(cfg.n_layers, cfg.mla.kv_lora_rank),
                        "krope": zeros(cfg.n_layers, cfg.mla.rope_head_dim)}}
    return {"kv": {"k": zeros(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim),
                   "v": zeros(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)}}


def _layers(params, cfg: ModelConfig, state):
    """(block, its Mamba2 state or None, the attention cache's stack index
    or None, window) of each block of the walk; a hybrid's shared block
    follows its period's last Mamba2 layer, with that application's
    index into the ``shared`` stacks."""
    if cfg.family not in ("ssm", "hybrid"):
        for li, (blk, window) in enumerate(zip(params["blocks"],
                                               layer_windows(cfg))):
            yield blk, None, li, window
        return
    for li, (blk, st) in enumerate(zip(params["blocks"],
                                       _mamba_layers(state))):
        yield blk, st, None, 0
        app = _shared_app(cfg, li)
        if app is not None:
            yield params["shared_block"], None, app, 0


def decode_step(params, cfg: ModelConfig, tokens, state, lengths):
    """One decode step.  tokens (b,) int; lengths (b,) = tokens already
    cached.  Writes each token's K/V (or latent) at index ``lengths`` and
    attends over ``lengths + 1``.  Returns (logits (b, vocab), state)."""
    require_decode(cfg)
    h = embed(params, cfg, tokens[:, None])
    if cfg.family != "ssm":
        kc_all, vc_all = _cache(state, cfg)
        lengths = lengths.to(torch.long)
        _check_fits(lengths, 1, kc_all.shape[2])
        bidx = torch.arange(tokens.shape[0], device=tokens.device)

    def dec(kc, vc, window):
        def attn(p, x):
            if cfg.attn_variant == "mla":
                c_new, kr_new = mla.mla_latent(p, cfg, x, lengths[:, None])
                kc[bidx, lengths] = c_new[:, 0].to(kc.dtype)
                vc[bidx, lengths] = kr_new[:, 0].to(vc.dtype)
                return mla.mla_decode(p, cfg, x, kc, vc, lengths + 1)
            q, k, v = layers.gqa_qkv(p, cfg, x, lengths[:, None])
            kc[bidx, lengths] = k[:, 0].to(kc.dtype)
            vc[bidx, lengths] = v[:, 0].to(vc.dtype)
            o = layers.decode_attend(q, kc, vc, lengths + 1,
                                     softcap=cfg.attn_logit_softcap,
                                     window=window)
            return layers.attn_out(p, o)
        return attn

    for blk, st, ci, window in _layers(params, cfg, state):
        if st is not None:
            h, _ = _mamba_block(blk, cfg, h, ssm.ssm_decode_step, st)
        else:
            h = _block(blk, cfg, h, dec(kc_all[ci], vc_all[ci], window))
    return logits_from_hidden(params, cfg, h)[:, 0], state


def append_step(params, cfg: ModelConfig, tokens, state, lengths):
    """Prefill an append chunk against existing decode state.

    tokens (b, s_app) int, or (b, s_app, frontend_dim) embeddings;
    lengths (b,) = tokens already cached.  Writes the chunk's K/V (or
    latents) at [lengths, lengths + s_app).  Returns (logits (b, s_app,
    vocab), state)."""
    require_decode(cfg)
    b, s = tokens.shape[:2]
    h = embed(params, cfg, tokens)
    if cfg.family != "ssm":
        kc_all, vc_all = _cache(state, cfg)
        lengths = lengths.to(torch.long)
        top = _check_fits(lengths, s, kc_all.shape[2])
        bidx = torch.arange(b, device=tokens.device)[:, None]
        positions = lengths[:, None] + torch.arange(s, device=tokens.device)

    def app(kc, vc, window):
        def attn(p, x):
            if cfg.attn_variant == "mla":
                return mla.mla_append(p, cfg, x, kc, vc, lengths, top)
            q, k, v = layers.gqa_qkv(p, cfg, x, positions)
            kc[bidx, positions] = k.to(kc.dtype)
            vc[bidx, positions] = v.to(vc.dtype)
            o = layers.append_attend(q, kc, vc, lengths,
                                     softcap=cfg.attn_logit_softcap,
                                     window=window)
            return layers.attn_out(p, o)
        return attn

    for blk, st, ci, window in _layers(params, cfg, state):
        if st is not None:
            h, _ = _mamba_block(blk, cfg, h, ssm.ssd_scan_with_tails, st)
        else:
            h = _block(blk, cfg, h, app(kc_all[ci], vc_all[ci], window))
    return logits_from_hidden(params, cfg, h), state
