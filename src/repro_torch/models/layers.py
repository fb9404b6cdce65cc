"""Transformer layers: norms, RoPE, attention, FFN (port of
``repro.models.layers``).

Layout at every public function is the reference's: activations
(batch, seq, d_model), per-head tensors (batch, seq, heads, head_dim).
Matmuls run in the parameter dtype, softmax and norm statistics in f32.

Attention goes through the kernel wrappers: on CUDA tensors the Hopper
kernels (``flash_attention`` for full and append attention,
``paged_attention`` for decode), on CPU tensors their plain versions.
The activations and caches are handed over as transposed views (the
flash kernel takes strides), so no (b, h, s, dh) copy is made.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention, paged_attention

# page size of the paged view of a decode cache: the largest power of two
# up to this that divides the cache length
DECODE_PAGE_TOKENS = 64


def rms_norm(x, w, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope_angles(positions, dim: int, theta: float):
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    return positions[..., None].float() * freqs


def apply_rope(x, positions, theta: float):
    """x: (b, s, h, dh); positions: (s,) or (b, s).  Half-split rotation
    (not interleaved pairs) with f32 angles, as the reference."""
    ang = _rope_angles(positions, x.shape[-1], theta)
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(s, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(s / cap) * cap
    return s


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attend(q, k, v, *, causal=True, softcap=0.0, window=0):
    """Full attention over a whole sequence: q (b,s,hq,dh), k,v
    (b,s,hkv,dh) -> (b,s,hq,dh).  ``window`` > 0 masks keys ``window``
    or more positions behind each query (0: no window)."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, softcap=softcap,
                        window=window)
    return o.transpose(1, 2)


def append_attend(q, k_cache, v_cache, lengths, *, softcap=0.0, window=0):
    """Multi-token append attention against padded caches.

    q: (b, s_app, hq, dh), already written into the caches at
    [lengths, lengths + s_app); caches (b, S, hkv, dh); lengths (b,) =
    tokens present before the append.  Row r attends to kv index
    < lengths + r + 1, which is the flash kernel's contract with
    ``kv_lens = lengths + s_app``, and, with ``window`` > 0, to the last
    ``window`` of those."""
    s_app = q.shape[1]
    kv_lens = (lengths + s_app).to(torch.int32)
    o = flash_attention(q.transpose(1, 2), k_cache.transpose(1, 2),
                        v_cache.transpose(1, 2), causal=True,
                        softcap=softcap, window=window, kv_lens=kv_lens)
    return o.transpose(1, 2)


def decode_attend(q, k_cache, v_cache, lengths, *, softcap=0.0, window=0):
    """Single-token decode attention over a padded cache viewed as pages.

    q: (b, 1, hq, dh); caches (b, S, hkv, dh), contiguous; lengths (b,)
    valid length (the new token already written at lengths - 1); with
    ``window`` > 0 only keys j with lengths - 1 - j < window count.  The
    cache is viewed as (b·S/pt, pt, hkv, dh) pages with an ``arange``
    block table, so the paged kernel reads it in place."""
    b, _, hq, dh = q.shape
    S, hkv = k_cache.shape[1], k_cache.shape[2]
    pt = math.gcd(S, DECODE_PAGE_TOKENS)
    n_pages = b * S // pt
    k_pool = k_cache.view(n_pages, pt, hkv, dh)
    v_pool = v_cache.view(n_pages, pt, hkv, dh)
    table = torch.arange(n_pages, dtype=torch.int32,
                         device=q.device).view(b, S // pt)
    o = paged_attention(q.reshape(b, hkv, hq // hkv, dh), k_pool, v_pool,
                        table, lengths.to(torch.int32), softcap=softcap,
                        window=window)
    return o.reshape(b, 1, hq, dh)


# ---------------------------------------------------------------------------
# GQA block plumbing and FFN
# ---------------------------------------------------------------------------


def _proj(x, w):
    """einsum('bsd,d...->bs...') as one matmul in the parameter dtype."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def gqa_qkv(p, cfg: ModelConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, x_heads):
    b, s = x_heads.shape[:2]
    return x_heads.reshape(b, s, -1) @ p["wo"]


def ffn(p, cfg: ModelConfig, x):
    act = cfg.ffn_activation
    if act in ("silu_gated", "gelu_gated"):
        gate = x @ p["wi_gate"]
        up = x @ p["wi_up"]
        # x * sigmoid(x) with the reference's rounding (jax.nn.silu)
        g = gate * torch.sigmoid(gate) if act == "silu_gated" \
            else torch.nn.functional.gelu(gate, approximate="tanh")
        h = g * up
    else:
        h = x @ p["wi"]
        if act == "squared_relu":
            h = torch.relu(h).square()
        else:
            h = torch.nn.functional.gelu(h, approximate="tanh")
    return h @ p["wo"]
