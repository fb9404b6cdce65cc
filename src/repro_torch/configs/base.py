"""Model configuration: the port's copy of ``repro.configs.base``.

``ModelConfig`` is the same flat, frozen dataclass as the reference's,
field for field, so a config written for one package reads the same in
the other.  Every architecture the reference registers is registered
here too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    period: int = 1          # MoE every `period` layers (2 = alternate dense/MoE)
    first_k_dense: int = 0   # leading dense layers before any MoE layer
    router_logit_softcap: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD configuration."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk_size: int = 256    # SSD chunk length for the chunked-scan algorithm


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-style) configuration."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0      # 0 = no Q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")
_ATTN_VARIANTS = ("gqa", "mla", "none")
_FFN_ACTS = ("silu_gated", "gelu_gated", "squared_relu", "gelu")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # one of _FAMILIES
    n_layers: int
    d_model: int
    vocab_size: int

    # --- attention ---
    attn_variant: str = "gqa"       # gqa | mla | none (ssm)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # sliding-window / local-global alternation (gemma2): period 0 = all global.
    local_window: int = 0
    local_global_period: int = 0    # e.g. 2 -> layers alternate local, global
    rope_theta: float = 10000.0
    causal: bool = True             # False => encoder-only (bidirectional)

    # --- FFN ---
    d_ff: int = 0
    ffn_activation: str = "silu_gated"

    # --- optional subsystems ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None

    # --- hybrid (zamba2-style) shared attention block ---
    hybrid_period: int = 0
    hybrid_d_ff: int = 0

    # --- embeddings / head ---
    tie_embeddings: bool = False
    frontend_embed_dim: int = 0

    # --- norm ---
    embed_scale: float = 1.0        # gemma2 multiplies embeddings by sqrt(d)
    rms_norm_eps: float = 1e-5
    post_attn_norm: bool = False    # gemma2-style extra norms
    ffn_mult: float = 1.0           # minicpm-style residual scaling (mup)

    # --- dtype / training policy ---
    param_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"
    optimizer: str = "adamw"        # adamw | adafactor
    opt_state_dtype: str = "float32"
    microbatches_train_4k: int = 8

    sharding_profile: str = "tp"    # tp | fsdp | ep_fsdp

    # --- capability flags ---
    supports_decode: bool = True
    sub_quadratic: bool = False
    source: str = ""                # provenance tag

    def __post_init__(self):
        assert self.family in _FAMILIES, self.family
        assert self.attn_variant in _ATTN_VARIANTS, self.attn_variant
        assert self.ffn_activation in _FFN_ACTS, self.ffn_activation
        if self.attn_variant == "gqa" and self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
                f"{self.name}: n_heads {self.n_heads} not a multiple of "
                f"n_kv_heads {self.n_kv_heads}")

    # --- derived quantities -------------------------------------------------
    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Per-token KV bytes that must be *loaded* on a cache hit (SSM
        layers carry O(1) state per sequence and contribute 0)."""
        total = 0
        for kind in self.layer_kinds():
            if kind in ("attn", "local_attn"):
                if self.attn_variant == "mla":
                    total += (self.mla.kv_lora_rank +
                              self.mla.rope_head_dim) * dtype_bytes
                else:
                    total += 2 * self.kv_dim * dtype_bytes
        if self.hybrid_period:
            n_apps = self.n_layers // self.hybrid_period
            total += n_apps * 2 * self.kv_dim * dtype_bytes
        return total

    def ssm_state_bytes(self, dtype_bytes: int = 4) -> int:
        """Constant per-sequence recurrent state bytes (SSM/hybrid archs),
        every leaf counted at ``dtype_bytes`` as the reference counts
        them."""
        if self.ssm is None:
            return 0
        d_inner = self.ssm.expand * self.d_model
        n_ssm_heads = d_inner // self.ssm.head_dim
        per_layer = (n_ssm_heads * self.ssm.head_dim * self.ssm.d_state
                     + (self.ssm.conv_width - 1) *
                     (d_inner + 2 * self.ssm.n_groups * self.ssm.d_state))
        n_ssm_layers = sum(1 for k in self.layer_kinds() if k == "ssm")
        return n_ssm_layers * per_layer * dtype_bytes

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind: 'attn' | 'local_attn' | 'ssm'."""
        kinds = []
        for i in range(self.n_layers):
            if self.family in ("ssm", "hybrid"):
                kinds.append("ssm")
            elif self.local_global_period and (
                    i % self.local_global_period != self.local_global_period - 1):
                kinds.append("local_attn")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        """Per layer: whether its FFN is the routed MoE."""
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        m = []
        for i in range(self.n_layers):
            if i < self.moe.first_k_dense:
                m.append(False)
            else:
                m.append((i - self.moe.first_k_dense) % self.moe.period
                         == self.moe.period - 1)
        return tuple(m)

    def param_count(self) -> int:
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_active_params_analytic
        return count_active_params_analytic(self)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests (same rule as the
        reference, so both packages reduce a config identically)."""
        kw = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            vocab_size=max(min(self.vocab_size, 512), 128),
        )
        if self.attn_variant != "none":
            kw.update(n_heads=4,
                      n_kv_heads=min(max(self.n_kv_heads * 4 //
                                         max(self.n_heads, 1), 1), 4),
                      head_dim=32)
        if self.d_ff:
            kw.update(d_ff=256)
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                first_k_dense=min(self.moe.first_k_dense, 1))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=32)
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=32, rope_head_dim=16,
                nope_head_dim=32, v_head_dim=32)
        if self.hybrid_period:
            kw.update(hybrid_period=2, hybrid_d_ff=256)
        if self.local_global_period:
            kw.update(local_window=64)
        if self.frontend_embed_dim:
            kw.update(frontend_embed_dim=128)
        kw.update(microbatches_train_4k=1)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = ("qwen1.5-0.5b", "gemma2-2b", "ds27b", "granite-moe-3b-a800m",
            "minicpm-2b", "nemotron-4-15b", "mamba2-1.3b", "zamba2-2.7b",
            "llama4-maverick-400b-a17b", "llava-next-34b", "hubert-xlarge")

_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def _load_all():
    import importlib
    for arch in ARCH_IDS:
        importlib.import_module("repro_torch.configs." +
                                arch.replace("-", "_").replace(".", "_"))
