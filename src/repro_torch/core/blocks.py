"""KV-Cache block layouts (port of ``repro.core.blocks``, paper §A.5).

* ``LayerBlock`` — bytes ``[1, tokens, bytes]``: one layer's KV for
  ``block_tokens`` tokens; the unit of layerwise streaming.
* ``FullBlock``  — ``[layers, tokens, bytes]``: all layers for the same
  tokens; the only unit persistent storage sees.

``n`` LayerBlocks concatenate on axis 0 into a FullBlock with no layout
conversion, and a FullBlock slices into LayerBlock views the same way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

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

    def n_blocks(self, n_tokens: int) -> int:
        """Whole blocks covering n_tokens (a partial tail is not
        persisted)."""
        return n_tokens // self.block_tokens


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


def full_from_layer_blocks(layer_blocks: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate n LayerBlocks -> FullBlock.  No layout conversion."""
    for lb in layer_blocks:
        assert lb.ndim == 3 and lb.shape[0] == 1, lb.shape
    return np.concatenate(list(layer_blocks), axis=0)


def layer_blocks_from_full(full: np.ndarray) -> List[np.ndarray]:
    """Split a FullBlock into LayerBlock views (zero-copy slices)."""
    return [full[i:i + 1] for i in range(full.shape[0])]


def pack_kv_to_blocks(kv_bytes: np.ndarray,
                      layout: BlockLayout) -> List[np.ndarray]:
    """(layers, tokens, bytes_per_token_layer) -> the FullBlocks covering
    the whole-block prefix; tail tokens that fill no block are dropped."""
    n_l, n_t, row = kv_bytes.shape
    assert n_l == layout.n_layers and row == layout.bytes_per_token_layer
    bt = layout.block_tokens
    return [np.ascontiguousarray(kv_bytes[:, i * bt:(i + 1) * bt])
            for i in range(layout.n_blocks(n_t))]


def unpack_blocks_to_kv(blocks: Sequence[np.ndarray],
                        layout: BlockLayout) -> np.ndarray:
    if not blocks:
        return np.zeros((layout.n_layers, 0, layout.bytes_per_token_layer),
                        np.uint8)
    return np.concatenate(list(blocks), axis=1)
