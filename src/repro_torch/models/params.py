"""Parameter schema and init for the dense, MoE, SSM, hybrid, VLM and
encoder families.

Port of ``repro.models.params`` (``attn_schema`` :63, ``ffn_schema`` :93,
``moe_schema`` :107, ``mamba_schema`` :127, ``dense_block_schema`` :153,
``moe_block_schema`` :166, ``model_schema`` :184, ``init_params`` :252,
``count_active_params_analytic`` :277).  The reference stacks every block
along a leading layer axis for ``lax.scan`` (the MoE family in up to
three stacks, ``dense_blocks``, ``super_blocks.pre`` (n_super, period -
1) and ``super_blocks.moe``; the hybrid's Mamba2 blocks as (n_super,
period)); here ``params["blocks"]`` is a list with one dict per layer,
in layer order, which the model walks in a Python loop: for the MoE
family a dense or an MoE block as ``cfg.moe_layer_mask()`` says (the
first ``first_k_dense`` layers dense, then each period's last layer
MoE); for the SSM and hybrid families one Mamba2 block per layer; for
the dense, VLM and encoder families (no MoE config, so no MoE layer)
one dense block per layer.  The hybrid adds
``params["shared_block"]``, one dense block (attention + FFN of width
``hybrid_d_ff``) applied after every ``hybrid_period``-th layer.  A
config with ``frontend_embed_dim`` adds ``embed["frontend_proj"]``, the
connector that projects precomputed patch or frame embeddings.  Leaf
names and shapes inside a block are the reference's, so
``bridge.params_from_jax`` is a plain unstacking.

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

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encoder")


def require_ported(cfg: ModelConfig) -> None:
    """Raise for any architecture the port does not run: an unknown
    family, an SSM or hybrid family without its SSM config, a hybrid
    whose shared block is not GQA or whose period does not divide its
    layers, an MoE family without its MoE config or whose layers after
    ``first_k_dense`` are not a multiple of its period (the reference
    asserts the same), and MLA together with windows or softcaps (no
    config has both)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")
    if cfg.family in ("ssm", "hybrid") and cfg.ssm is None:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {cfg.family.upper()} family "
            f"with an SSM config (Mamba2 blocks), not without one")
    if cfg.family == "ssm":
        return
    if cfg.family == "hybrid" and (
            cfg.attn_variant != "gqa" or not cfg.hybrid_period
            or cfg.n_layers % cfg.hybrid_period):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the hybrid family with a GQA "
            f"shared block and a period dividing the layers")
    if cfg.family == "moe" and (
            cfg.moe is None or cfg.moe.period < 1
            or (cfg.n_layers - cfg.moe.first_k_dense) % cfg.moe.period):
        raise NotImplementedError(
            f"{cfg.name}: the port runs MoE with an MoE config whose period "
            f"divides the layers after first_k_dense, not {cfg.moe} over "
            f"{cfg.n_layers} layers")
    if cfg.attn_variant not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attn_variant!r} outside the SSM "
            f"family is not ported")
    if cfg.attn_variant == "mla" and (
            cfg.mla is None or cfg.local_global_period or cfg.local_window
            or cfg.attn_logit_softcap):
        raise NotImplementedError(
            f"{cfg.name}: the port runs MLA attention with an MLA config "
            f"and without windows or softcaps")


def require_decode(cfg: ModelConfig) -> None:
    """Raise for a model whose ``supports_decode`` is False (the encoder
    family): the reference asserts ``cfg.supports_decode`` in
    ``decode_step`` and has no encoder state."""
    require_ported(cfg)
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name}: supports_decode is False, so it has "
                         f"no decode state, decode step or append step")


class PSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones | ssm_a | ssm_dt
    std: float = 0.02


def _norm(d: int) -> PSpec:
    return PSpec((d,), "ones")


def _proj(d_in: int, *out) -> PSpec:
    return PSpec((d_in,) + tuple(out), "normal", 1.0 / math.sqrt(d_in))


def attn_schema(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    if cfg.attn_variant == "mla":
        m = cfg.mla
        return {
            "wq": _proj(d, cfg.n_heads, m.nope_head_dim + m.rope_head_dim),
            "w_dkv": _proj(d, m.kv_lora_rank),
            "w_krope": _proj(d, m.rope_head_dim),
            "kv_norm": PSpec((m.kv_lora_rank,), "ones"),
            "w_uk": _proj(m.kv_lora_rank, cfg.n_heads, m.nope_head_dim),
            "w_uv": _proj(m.kv_lora_rank, cfg.n_heads, m.v_head_dim),
            "wo": _proj(cfg.n_heads * m.v_head_dim, d),
        }
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


def moe_schema(cfg: ModelConfig) -> Dict:
    """Router and routed experts (stacked on a leading expert axis), plus
    the shared experts as one FFN ``n_shared_experts`` times as wide."""
    d, m = cfg.d_model, cfg.moe
    s = {
        "router": PSpec((d, m.n_experts), "normal", 1.0 / math.sqrt(d)),
        "wg": PSpec((m.n_experts, d, m.d_ff_expert), "normal",
                    1.0 / math.sqrt(d)),
        "wu": PSpec((m.n_experts, d, m.d_ff_expert), "normal",
                    1.0 / math.sqrt(d)),
        "wd": PSpec((m.n_experts, m.d_ff_expert, d), "normal",
                    1.0 / math.sqrt(m.d_ff_expert)),
    }
    if m.n_shared_experts:
        s["shared"] = ffn_schema(cfg, m.n_shared_experts * m.d_ff_expert)
    return s


def mamba_schema(cfg: ModelConfig) -> Dict:
    """One Mamba2 block: the five input projections, the depthwise conv
    weights of x, B and C, the SSD head parameters, the gated norm and
    the output projection."""
    d, s = cfg.d_model, cfg.ssm
    d_inner = s.expand * d
    n_heads = d_inner // s.head_dim
    bc = s.n_groups * s.d_state
    conv = lambda c: PSpec((s.conv_width, c), "normal",
                           1.0 / math.sqrt(s.conv_width))
    return {
        "ln": _norm(d),
        "w_z": _proj(d, d_inner),
        "w_x": _proj(d, d_inner),
        "w_B": _proj(d, bc),
        "w_C": _proj(d, bc),
        "w_dt": _proj(d, n_heads),
        "conv_x": conv(d_inner),
        "conv_B": conv(bc),
        "conv_C": conv(bc),
        "A_log": PSpec((n_heads,), "ssm_a"),
        "D": PSpec((n_heads,), "ones"),
        "dt_bias": PSpec((n_heads,), "ssm_dt"),
        "out_norm": PSpec((d_inner,), "ones"),
        "out_proj": _proj(d_inner, d),
    }


def _block_schema(cfg: ModelConfig, ffn_key: str, ffn: Dict) -> Dict:
    s = {
        "ln1": _norm(cfg.d_model),
        "attn": attn_schema(cfg),
        "ln2": _norm(cfg.d_model),
        ffn_key: ffn,
    }
    if cfg.post_attn_norm:
        s["ln1b"] = _norm(cfg.d_model)
        s["ln2b"] = _norm(cfg.d_model)
    return s


def dense_block_schema(cfg: ModelConfig, d_ff: int = 0) -> Dict:
    return _block_schema(cfg, "ffn", ffn_schema(cfg, d_ff or cfg.d_ff))


def moe_block_schema(cfg: ModelConfig) -> Dict:
    return _block_schema(cfg, "moe", moe_schema(cfg))


def model_schema(cfg: ModelConfig) -> Dict:
    require_ported(cfg)
    d = cfg.d_model
    s = {
        "embed": {"tok": PSpec((cfg.vocab_size, d), "normal", 1.0)},
        "final_norm": _norm(d),
        "blocks": [mamba_schema(cfg) for _ in range(cfg.n_layers)]
        if cfg.family in ("ssm", "hybrid") else
        [moe_block_schema(cfg) if is_moe else dense_block_schema(cfg)
         for is_moe in cfg.moe_layer_mask()],
    }
    if cfg.frontend_embed_dim:
        # the connector of the stubbed modality frontend (patch or frame
        # embeddings -> d_model)
        s["embed"]["frontend_proj"] = _proj(cfg.frontend_embed_dim, d)
    if cfg.family == "hybrid":
        s["shared_block"] = dense_block_schema(cfg, cfg.hybrid_d_ff)
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


def count_active_params_analytic(cfg: ModelConfig) -> int:
    """Parameters one token uses: all but the routed experts it is not
    sent to (``n_experts - top_k`` per MoE layer)."""
    total = count_params_analytic(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert       # wg + wu + wd
    n_moe_layers = sum(cfg.moe_layer_mask())
    return total - n_moe_layers * (m.n_experts - m.top_k) * per_expert


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
            if tree.init == "ssm_a":
                # A in [1, 16], stored as log(A); discretised as
                # exp(-exp(A_log) * dt)
                u = torch.rand(tree.shape, generator=gen, device=dev)
                return torch.log(1.0 + 15.0 * u).to(dtype)
            if tree.init == "ssm_dt":
                # dt_bias = softplus^-1(dt), dt ~ logU[1e-3, 1e-1]
                lo, hi = math.log(1e-3), math.log(1e-1)
                u = torch.rand(tree.shape, generator=gen, device=dev)
                return torch.log(torch.expm1(
                    torch.exp(lo + u * (hi - lo)))).to(dtype)
            x = torch.randn(tree.shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return x.mul_(tree.std).to(dtype)
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        return [make(v) for v in tree]

    return make(model_schema(cfg))
