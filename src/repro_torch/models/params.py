"""Parameter schema and init for the dense family.

Port of ``repro.models.params`` (``attn_schema`` :63, ``ffn_schema`` :93,
``dense_block_schema`` :153, ``model_schema`` :184, ``init_params``
:252).  The reference stacks every block along a leading layer axis for
``lax.scan``; here ``params["blocks"]`` is a list with one dict per
layer, which the model walks in a Python loop.  Leaf names and shapes
inside a block are the reference's, so ``bridge.params_from_jax`` is a
plain unstacking.

Values come from a ``torch.Generator`` and do not match ``jax.random``;
tests that compare the two packages convert the JAX parameters through
the bridge instead.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve

# family / feature -> the port slice that brings it
_LATER_SLICES = {
    "moe": "the MoE slice",
    "ssm": "the SSM/hybrid slice",
    "hybrid": "the SSM/hybrid slice",
    "vlm": "the VLM slice",
    "encoder": "the encoder slice",
}


def require_ported(cfg: ModelConfig) -> None:
    """Raise for any architecture feature this slice does not port."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} arrives with "
            f"{_LATER_SLICES[cfg.family]} of the port")
    if cfg.attn_variant != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attn_variant!r} arrives with the "
            f"MLA slice of the port")
    if cfg.frontend_embed_dim:
        raise NotImplementedError(
            f"{cfg.name}: frontend embeddings arrive with the VLM slice")


class PSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones
    std: float = 0.02


def _norm(d: int) -> PSpec:
    return PSpec((d,), "ones")


def _proj(d_in: int, *out) -> PSpec:
    return PSpec((d_in,) + tuple(out), "normal", 1.0 / math.sqrt(d_in))


def attn_schema(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    s = {
        "wq": _proj(d, cfg.n_heads, cfg.head_dim),
        "wk": _proj(d, cfg.n_kv_heads, cfg.head_dim),
        "wv": _proj(d, cfg.n_kv_heads, cfg.head_dim),
        "wo": _proj(cfg.n_heads * cfg.head_dim, d),
    }
    if cfg.qkv_bias:
        s["bq"] = PSpec((cfg.n_heads, cfg.head_dim), "zeros")
        s["bk"] = PSpec((cfg.n_kv_heads, cfg.head_dim), "zeros")
        s["bv"] = PSpec((cfg.n_kv_heads, cfg.head_dim), "zeros")
    return s


def ffn_schema(cfg: ModelConfig, d_ff: int) -> Dict:
    d = cfg.d_model
    if cfg.ffn_activation in ("silu_gated", "gelu_gated"):
        return {"wi_gate": _proj(d, d_ff), "wi_up": _proj(d, d_ff),
                "wo": _proj(d_ff, d)}
    return {"wi": _proj(d, d_ff), "wo": _proj(d_ff, d)}


def dense_block_schema(cfg: ModelConfig) -> Dict:
    s = {
        "ln1": _norm(cfg.d_model),
        "attn": attn_schema(cfg),
        "ln2": _norm(cfg.d_model),
        "ffn": ffn_schema(cfg, cfg.d_ff),
    }
    if cfg.post_attn_norm:
        s["ln1b"] = _norm(cfg.d_model)
        s["ln2b"] = _norm(cfg.d_model)
    return s


def model_schema(cfg: ModelConfig) -> Dict:
    require_ported(cfg)
    d = cfg.d_model
    s = {
        "embed": {"tok": PSpec((cfg.vocab_size, d), "normal", 1.0)},
        "final_norm": _norm(d),
        "blocks": [dense_block_schema(cfg) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = _proj(d, cfg.vocab_size)
    return s


def _leaves(tree):
    if isinstance(tree, PSpec):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def count_params_analytic(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) for s in _leaves(model_schema(cfg)))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn in
    float32 from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)

    def make(tree):
        if isinstance(tree, PSpec):
            if tree.init == "zeros":
                return torch.zeros(tree.shape, dtype=dtype, device=dev)
            if tree.init == "ones":
                return torch.ones(tree.shape, dtype=dtype, device=dev)
            x = torch.randn(tree.shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return (x * tree.std).to(dtype)
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        return [make(v) for v in tree]

    return make(model_schema(cfg))
