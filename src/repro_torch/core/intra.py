"""Intra-engine scheduling (port of ``repro.core.intra``, paper §6.2):
compute-quota batch packing for the prefill engine.

Each item of a forward batch is (cached, bsz): ``cached`` tokens have KV
already, ``bsz`` tokens are computed.  Predicted attention time is
affine in the theoretical attention FLOPs

    F(cached, bsz) = 4 · n_heads · head_dim · bsz · (cached + (bsz+1)/2)

summed over layers; the straddling request is chunked by binary search.
``chunk_tokens`` (the SLO layer's chunked prefill) also caps each
request's slice of a batch, and the PE fifo can be ordered by SLO class
(:func:`class_insert_index`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass
class AttnTimeModel:
    """t(flops) = base_overhead + flops / effective_flops_per_s."""

    effective_flops: float
    base_overhead_s: float = 30e-6  # per-layer launch overhead

    @classmethod
    def from_config(cls, cfg: ModelConfig, peak_flops: float = 197e12,
                    attn_efficiency: float = 0.35):
        """The reference's modelled constants, kept as they are so the
        port packs prompts into the same chunks as the reference.  They
        are a packing model, not a property of the card the port runs
        on.  Calibrating to a card is :meth:`fit`, and opt-in."""
        return cls(effective_flops=peak_flops * attn_efficiency)

    @classmethod
    def fit(cls, samples: Sequence[Tuple[float, float]]):
        """Least-squares fit of (flops, seconds) measurement pairs."""
        n = len(samples)
        sx = sum(f for f, _ in samples)
        sy = sum(t for _, t in samples)
        sxx = sum(f * f for f, _ in samples)
        sxy = sum(f * t for f, t in samples)
        denom = n * sxx - sx * sx
        if denom == 0:
            return cls(effective_flops=1e12)
        slope = (n * sxy - sx * sy) / denom
        intercept = (sy - slope * sx) / n
        slope = max(slope, 1e-18)
        return cls(effective_flops=1.0 / slope,
                   base_overhead_s=max(intercept, 0.0))

    def seconds(self, flops: float) -> float:
        return self.base_overhead_s + flops / self.effective_flops


def attn_flops_per_layer(cfg: ModelConfig, cached: int, bsz: int) -> float:
    """Theoretical attention FLOPs for one layer of a (cached, bsz) item
    (MLA scores at its q/k width, nope + rope; an attention-free SSM
    layer's SSD work, linear in bsz)."""
    if cfg.attn_variant == "none":
        d_inner = cfg.ssm.expand * cfg.d_model
        return 6.0 * bsz * d_inner * cfg.ssm.d_state
    qk_dim = cfg.head_dim if cfg.attn_variant != "mla" else (
        cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)
    return 4.0 * cfg.n_heads * qk_dim * bsz * (cached + (bsz + 1) / 2.0)


def attn_flops(cfg: ModelConfig, items: Sequence[Tuple[int, int]]) -> float:
    """Over the layers: the attention layers (with a hybrid's shared
    block once per application), or every layer of an attention-free
    model."""
    n_attn = sum(1 for k in cfg.layer_kinds() if k != "ssm")
    if cfg.hybrid_period:
        n_attn += cfg.n_layers // cfg.hybrid_period
    if cfg.attn_variant == "none":
        n_attn = cfg.n_layers
    per_layer = sum(attn_flops_per_layer(cfg, c, b) for c, b in items)
    return per_layer * max(n_attn, 1)


@dataclass
class PrefillWork:
    """Mutable prefill progress of one request on a PE."""

    rid: int
    cached: int                     # tokens whose KV exists already
    remaining: int                  # append tokens still to compute
    rank: int = 0                   # SLO-class rank (0 = interactive)
    arrival: float = 0.0            # round arrival time (tie-break)

    def advance(self, bsz: int):
        self.cached += bsz
        self.remaining -= bsz

    def key(self) -> Tuple[int, float, int]:
        return (self.rank, self.arrival, self.rid)


def class_insert_index(keys: Sequence[Tuple[int, float, int]],
                       new_key: Tuple[int, float, int]) -> int:
    """Stable insertion point for a class-aware prefill fifo: after the
    last entry whose (rank, arrival, rid) key is <= ``new_key``.  An
    interactive round may land ahead of a part-prefilled batch round,
    which resumes from its own progress on a later pack."""
    i = len(keys)
    while i > 0 and keys[i - 1] > new_key:
        i -= 1
    return i


@dataclass
class BatchItem:
    rid: int
    cached: int
    bsz: int
    chunked: bool = False           # True if this is a partial (chunked) fill


class QuotaPacker:
    """FIFO packing under a compute quota with binary-search chunking.

    ``chunk_tokens`` (SloConfig.prefill_chunk_tokens, raised to at least
    ``min_chunk``) caps one request's slice of a batch whatever the
    quota, and a capped slice closes the batch.  ``None`` packs by the
    quota alone."""

    def __init__(self, cfg: ModelConfig, time_model: AttnTimeModel,
                 quota_s: float = 0.300, min_chunk: int = 16,
                 chunk_tokens: Optional[int] = None):
        self.cfg = cfg
        self.time_model = time_model
        self.quota_s = quota_s
        self.min_chunk = min_chunk
        self.chunk_tokens = None if chunk_tokens is None \
            else max(int(chunk_tokens), min_chunk)

    def predict_batch_seconds(self, items: Sequence[Tuple[int, int]]) -> float:
        return self.time_model.seconds(attn_flops(self.cfg, items))

    def pack(self, fifo: List[PrefillWork]) -> List[BatchItem]:
        """Select the next forward batch; mutates ``fifo`` (consumed work
        is advanced, fully-prefilled requests are removed)."""
        batch: List[BatchItem] = []
        items: List[Tuple[int, int]] = []
        while fifo:
            w = fifo[0]
            take = w.remaining if self.chunk_tokens is None \
                else min(w.remaining, self.chunk_tokens)
            cand = items + [(w.cached, take)]
            if self.predict_batch_seconds(cand) <= self.quota_s:
                if take == w.remaining:
                    items.append((w.cached, w.remaining))
                    batch.append(BatchItem(w.rid, w.cached, w.remaining))
                    w.advance(w.remaining)
                    fifo.pop(0)
                    continue
                # a capped slice closes the batch, so the step (and the
                # decode steps between slices) runs now
                batch.append(BatchItem(w.rid, w.cached, take, chunked=True))
                w.advance(take)
                break
            # straddling request: binary search the largest bsz' that fits
            lo, hi = 0, take
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if self.predict_batch_seconds(
                        items + [(w.cached, mid)]) <= self.quota_s:
                    lo = mid
                else:
                    hi = mid - 1
            if lo >= self.min_chunk:
                batch.append(BatchItem(w.rid, w.cached, lo, chunked=True))
                w.advance(lo)
            break
        return batch
