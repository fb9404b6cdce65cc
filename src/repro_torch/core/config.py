"""Runtime configuration groups (port of ``repro.core.config``).

* :class:`TierConfig` — the node-local DRAM tier and the think-time
  prefetcher.
* :class:`NetworkConfig` — the finite compute network: model collectives
  on each node's compute-NIC link and the arbiter that shares it.
* :class:`ElasticConfig` — elastic PE↔DE role flips (core/autoscale.py).
* :class:`ResilienceConfig` — fault injection (``sim/faults.py``) and
  hedged split reads.
* :class:`SloConfig` — the online SLO layer: the admission gate,
  chunked prefill and priority classes.

Each group has the reference's fields and defaults.  The runtimes take
group objects only; the reference's flat-kwarg deprecation shim is not
ported.  :data:`FLAT_FIELDS` maps each flat name to its ``(group,
field)``: the simulator's ``SimConfig`` reads and writes its groups
through it (``cfg.dram_tier_bytes`` is ``cfg.tier.dram_tier_bytes``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass
class TierConfig:
    """Node-local DRAM KV tier over the remote store (kvcache/tiers.py).

    ``dram_tier_bytes == 0`` disables the tier.  ``tier_ttl_s=None``
    defers to the policy's own default (agentic-ttl: 120 s)."""

    dram_tier_bytes: float = 0.0      # per-node tier capacity [bytes]
    tier_policy: str = "lru"          # lru | agentic-ttl
    tier_ttl_s: Optional[float] = None  # None = policy default (120 s)
    prefetch: bool = False            # think-time prefetcher
    prefetch_chunk_blocks: int = 32   # blocks per staged prefetch chunk


@dataclass
class NetworkConfig:
    """Finite compute network.  Model collectives contend with KV
    transfers under ``net_arbiter``: 'vl' (the paper's weighted-VL
    arbiter) or 'fifo' (class-blind, the ablation).

    * The simulator's shared PE↔DE link has capacity ``net_bw`` (None:
      infinite, the paper's no-congestion assumption), collectives iff
      ``model_collectives`` (None: iff the link is finite) and background
      KV traffic at ``net_bg_load`` × ``net_bw`` in chunks of
      ``net_bg_chunk_bytes``.
    * In the serving runtime ``collective_group_size > 1`` puts the
      per-layer model collectives of every PE and DE step on the stepping
      node's compute-NIC link (volumes from
      ``network.CollectiveVolumeModel``)."""

    net_bw: Optional[float] = None    # shared PE<->DE link [B/s]; None = inf
    net_arbiter: str = "vl"           # 'vl' (paper) | 'fifo' (ablation)
    model_collectives: Optional[bool] = None   # None: on iff net finite
    collective_dtype_bytes: int = 2
    collective_bytes_per_token: Optional[float] = None
    net_bg_load: float = 0.0          # background traffic, frac of net_bw
    net_bg_chunk_bytes: float = 512e6
    collective_group_size: int = 0    # serving: >1 puts collectives on CN


@dataclass
class ElasticConfig:
    """Elastic PE↔DE role flips (core/autoscale.py).  Truthiness follows
    ``enabled``.  The controller observes once per
    ``reconfig_interval_s`` modelled seconds and proposes a flip after
    ``reconfig_patience`` observations outside the [lo, hi] band of the
    pressure ratio, at least ``reconfig_cooldown_s`` after the last;
    ``drain_policy`` picks the victim (idlest | rotate)."""

    enabled: bool = False
    reconfig_interval_s: float = 5.0
    drain_policy: str = "idlest"      # idlest | rotate
    reconfig_hi: float = 2.0          # pressure-ratio hysteresis band
    reconfig_lo: float = 0.5
    reconfig_patience: int = 2
    reconfig_cooldown_s: float = 0.0
    reconfig_idle_floor_s: float = 1e-3
    elastic_min_pe: int = 1           # simulator-only floors
    elastic_min_de: int = 1

    def __bool__(self) -> bool:
        return self.enabled


@dataclass
class ResilienceConfig:
    """Fault injection and hedged split reads.  ``faults`` is a
    ``sim.faults.FaultSchedule``; None or an empty schedule leaves every
    fault hook a no-op.  A read is hedged when one side's storage leg is
    ``hedge_min_severity`` times as slow as the other's or worse; the
    simulator hedges mid-flight, and only a leg with more than
    ``hedge_threshold_s`` seconds of service left."""

    faults: Optional[object] = None   # FaultSchedule (or None)
    hedge_reads: bool = False
    hedge_threshold_s: float = 0.25   # simulator-only (mid-flight hedge)
    hedge_min_severity: float = 2.0


@dataclass
class SloConfig:
    """Online SLO layer: admission control, chunked prefill, priority
    classes.  Every default keeps its feature off, so an all-default
    SloConfig leaves the runtime event-identical to one without it.

    * **Admission control** — with ``admission`` set, online arrivals
      pass a load-aware gate (core/admission.AdmissionGate): a TTFT
      estimate above ``admission_ttft_slo_s`` defers the round by
      ``admission_defer_s``, up to ``admission_max_defers`` times, then
      rejects it (load shedding).  Offline serving admits every round.
    * **Chunked prefill** — ``prefill_chunk_tokens`` caps each request's
      slice of a packed prefill batch (core/intra.QuotaPacker), so decode
      steps interleave with a long prompt; a request between slices is
      in the PREFILL_CHUNKED lifecycle sub-state.
    * **Priority classes** — ``class_aware`` orders the scheduler's
      queues and the PE prefill fifo by (class rank, arrival):
      ``interactive`` rounds overtake ``batch`` rounds.
    """

    admission: bool = False
    admission_ttft_slo_s: float = 0.5
    admission_defer_s: float = 0.05
    admission_max_defers: int = 40
    prefill_chunk_tokens: Optional[int] = None  # None = quota-only packing
    class_aware: bool = False


#: the group field names, in declaration order
GROUP_FIELDS: Tuple[str, ...] = ("tier", "net", "elastic", "resilience",
                                 "slo")

_GROUP_TYPES = dict(tier=TierConfig, net=NetworkConfig,
                    elastic=ElasticConfig, resilience=ResilienceConfig,
                    slo=SloConfig)

#: flat name -> (group, field): the simulator's read/write aliases
FLAT_FIELDS: Dict[str, Tuple[str, str]] = {
    # --- tier ---------------------------------------------------------
    "dram_tier_bytes": ("tier", "dram_tier_bytes"),
    "tier_policy": ("tier", "tier_policy"),
    "tier_ttl_s": ("tier", "tier_ttl_s"),
    "prefetch": ("tier", "prefetch"),
    "prefetch_chunk_blocks": ("tier", "prefetch_chunk_blocks"),
    # --- network ------------------------------------------------------
    "net_bw": ("net", "net_bw"),
    "net_arbiter": ("net", "net_arbiter"),
    "model_collectives": ("net", "model_collectives"),
    "collective_dtype_bytes": ("net", "collective_dtype_bytes"),
    "collective_bytes_per_token": ("net", "collective_bytes_per_token"),
    "net_bg_load": ("net", "net_bg_load"),
    "net_bg_chunk_bytes": ("net", "net_bg_chunk_bytes"),
    "collective_group_size": ("net", "collective_group_size"),
    # --- elastic ------------------------------------------------------
    "reconfig_interval_s": ("elastic", "reconfig_interval_s"),
    "drain_policy": ("elastic", "drain_policy"),
    "reconfig_hi": ("elastic", "reconfig_hi"),
    "reconfig_lo": ("elastic", "reconfig_lo"),
    "reconfig_patience": ("elastic", "reconfig_patience"),
    "reconfig_cooldown_s": ("elastic", "reconfig_cooldown_s"),
    "reconfig_idle_floor_s": ("elastic", "reconfig_idle_floor_s"),
    "elastic_min_pe": ("elastic", "elastic_min_pe"),
    "elastic_min_de": ("elastic", "elastic_min_de"),
    # --- resilience ---------------------------------------------------
    "faults": ("resilience", "faults"),
    "hedge_reads": ("resilience", "hedge_reads"),
    "hedge_threshold_s": ("resilience", "hedge_threshold_s"),
    "hedge_min_severity": ("resilience", "hedge_min_severity"),
}


def group_defaults(name: str):
    """A fresh all-default instance of group ``name``."""
    return _GROUP_TYPES[name]()
