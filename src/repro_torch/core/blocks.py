"""KV-Cache block layouts (port of ``repro.core.blocks``, paper §A.5).

* ``LayerBlock`` — bytes ``[1, tokens, bytes]``: one layer's KV for
  ``block_tokens`` tokens; the unit of layerwise streaming.
* ``FullBlock``  — ``[layers, tokens, bytes]``: all layers for the same
  tokens; the only unit persistent storage sees.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig

DEFAULT_BLOCK_TOKENS = 64


@dataclass(frozen=True)
class BlockLayout:
    """Geometry of KV blocks for one model."""

    n_layers: int                 # layers that carry loadable per-token state
    block_tokens: int             # tokens per block (paper: e.g. 64)
    bytes_per_token_layer: int    # KV bytes per token per layer

    @property
    def layer_block_bytes(self) -> int:
        return self.block_tokens * self.bytes_per_token_layer

    @property
    def full_block_bytes(self) -> int:
        return self.n_layers * self.layer_block_bytes

    def full_block_shape(self):
        return (self.n_layers, self.block_tokens, self.bytes_per_token_layer)


def layout_for(cfg: ModelConfig, block_tokens: int = DEFAULT_BLOCK_TOKENS,
               kv_dtype_bytes: int = 2) -> BlockLayout:
    """Block geometry from a model config and the KV dtype's itemsize."""
    per_token = cfg.kv_bytes_per_token(kv_dtype_bytes)
    attn_layers = sum(1 for k in cfg.layer_kinds() if k != "ssm")
    if cfg.hybrid_period:
        attn_layers += cfg.n_layers // cfg.hybrid_period
    if attn_layers == 0:
        return BlockLayout(1, block_tokens, 0)
    return BlockLayout(attn_layers, block_tokens, per_token // attn_layers)
