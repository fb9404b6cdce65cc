"""Runtime configuration groups (port of ``repro.core.config``).

Only :class:`TierConfig` so far: the node-local DRAM tier and the
think-time prefetcher.  The reference's other groups (network, elastic,
resilience, SLO) arrive with the slices that port those features.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TierConfig:
    """Node-local DRAM KV tier over the remote store (kvcache/tiers.py).

    ``dram_tier_bytes == 0`` disables the tier.  ``tier_ttl_s=None``
    defers to the policy's own default (agentic-ttl: 120 s)."""

    dram_tier_bytes: float = 0.0      # per-node tier capacity [bytes]
    tier_policy: str = "lru"          # lru | agentic-ttl
    tier_ttl_s: Optional[float] = None  # None = policy default (120 s)
    prefetch: bool = False            # think-time prefetcher
