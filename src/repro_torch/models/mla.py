"""Multi-head latent attention, DeepSeek style (port of
``repro.models.mla``), for the paper's own ds27b.

The cache holds per token only the normalised latent ``c`` (r) and the
roped key ``krope`` (rd), which all heads share: that is what DualPath
moves (a FullBlock row is c ‖ krope).

* Prefill and append expand the latent to per-head K (nope ‖ rope, 192
  at full width) and V (128) and attend with the flash kernel at those
  two widths.  The append expands only ``[0, top)``, where ``top`` is
  the longest row's new length: the kernel reads no key past a row's
  ``kv_lens``, so the result is the reference's, which expands the
  whole padded cache.
* Decode is **absorbed**: the query is projected into the latent space
  (``q_nope · W_uk``), the ``mla_decode`` kernel attends against the
  cached latent rows themselves, and ``W_uv`` is applied after the
  softmax.

The scale is 1/sqrt(nope + rope) in both, as the reference's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import mla_decode as mla_decode_kernel
from repro_torch.models.layers import _proj, append_attend, apply_rope, \
    attend, rms_norm


def _split_q(cfg: ModelConfig, q):
    m = cfg.mla
    return q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]


def mla_latent(p, cfg: ModelConfig, x, positions):
    """The cacheable latent: c_kv (b, s, r) and roped k_rope (b, s, rd)."""
    c_kv = rms_norm(_proj(x, p["w_dkv"]), p["kv_norm"], cfg.rms_norm_eps)
    k_rope = _proj(x, p["w_krope"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_q(p, cfg: ModelConfig, x, positions):
    """Per-head queries: q_nope (b, s, h, nope), roped q_rope (b, s, h,
    rd)."""
    q_nope, q_rope = _split_q(cfg, _proj(x, p["wq"]))
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _expanded(p, cfg: ModelConfig, c, k_rope):
    """Per-head K (b, S, h, nope + rd) and V (b, S, h, vd) from the
    latent rows."""
    k_nope = _proj(c, p["w_uk"])
    v = _proj(c, p["w_uv"])
    kr = k_rope[:, :, None, :].expand(*k_nope.shape[:3], k_rope.shape[-1])
    return torch.cat([k_nope, kr], dim=-1), v


def _out(p, o):
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ p["wo"]


def mla_full(p, cfg: ModelConfig, x, positions, *, causal=True):
    """Prefill path over a whole sequence.  Returns (attn_out (b, s, d),
    (c_kv, k_rope) of its tokens)."""
    q_nope, q_rope = mla_q(p, cfg, x, positions)
    c_kv, k_rope = mla_latent(p, cfg, x, positions)
    k, v = _expanded(p, cfg, c_kv, k_rope)
    o = attend(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=causal)
    return _out(p, o), (c_kv, k_rope)


def mla_append(p, cfg: ModelConfig, x, c_cache, krope_cache, lengths,
               top: int):
    """Engine append: write the chunk's latents into the padded caches
    (b, S, r) and (b, S, rd) at [lengths, lengths + s) in place, expand
    ``[0, top)`` to per-head K/V and attend with ragged causal masking.
    ``top`` >= max(lengths) + s.  Returns attn_out (b, s, d)."""
    b, s, _ = x.shape
    positions = lengths[:, None] + torch.arange(s, device=x.device)
    q_nope, q_rope = mla_q(p, cfg, x, positions)
    c_new, kr_new = mla_latent(p, cfg, x, positions)
    bidx = torch.arange(b, device=x.device)[:, None]
    c_cache[bidx, positions] = c_new.to(c_cache.dtype)
    krope_cache[bidx, positions] = kr_new.to(krope_cache.dtype)
    k, v = _expanded(p, cfg, c_cache[:, :top], krope_cache[:, :top])
    o = append_attend(torch.cat([q_nope, q_rope], dim=-1), k, v, lengths)
    return _out(p, o)


def mla_decode(p, cfg: ModelConfig, x, c_cache, krope_cache, lengths):
    """Absorbed decode step.  x (b, 1, d); caches (b, S, r), (b, S, rd)
    with the current token's latent already written at lengths - 1;
    lengths (b,).  Returns attn_out (b, 1, d)."""
    m = cfg.mla
    b = x.shape[0]
    q_nope, q_rope = mla_q(p, cfg, x, (lengths - 1)[:, None])
    # absorb W_uk: q_lat[b, h, r] = sum_d q_nope[b, 0, h, d] W_uk[r, h, d]
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], p["w_uk"])
    o_lat = mla_decode_kernel(
        q_lat, q_rope[:, 0], c_cache, krope_cache, lengths.to(torch.int32),
        scale=1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim))
    o = torch.einsum("bhr,rhk->bhk", o_lat, p["w_uv"])
    return (o.reshape(b, -1) @ p["wo"])[:, None, :].to(x.dtype)
