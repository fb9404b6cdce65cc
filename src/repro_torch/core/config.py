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

Each group has the reference's fields and defaults, less those in
:data:`LEFT_OUT`.  The port's ``ServingSystem`` takes group objects only;
the reference's flat-kwarg deprecation shim is not ported.
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


@dataclass
class NetworkConfig:
    """Finite compute network.  ``collective_group_size > 1`` puts the
    per-layer model collectives of every PE and DE step on the stepping
    node's compute-NIC link (volumes from ``network.CollectiveVolumeModel``),
    where they contend with KV transfers under ``net_arbiter``: 'vl' (the
    paper's weighted-VL arbiter) or 'fifo' (class-blind, the ablation)."""

    net_arbiter: str = "vl"
    collective_group_size: int = 0    # >1 puts collectives on the network


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

    def __bool__(self) -> bool:
        return self.enabled


@dataclass
class ResilienceConfig:
    """Fault injection and hedged split reads.  ``faults`` is a
    ``sim.faults.FaultSchedule``; None or an empty schedule leaves every
    fault hook a no-op.  A read is hedged when one side's storage leg is
    twice as slow as the other's or worse (``serving.system``'s
    ``_HEDGE_MIN_SEVERITY``).  The reference's ``hedge_min_severity``
    and ``hedge_threshold_s`` come with the simulator, the only caller
    that sets them."""

    faults: Optional[object] = None   # FaultSchedule (or None)
    hedge_reads: bool = False


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

#: the reference's group fields the port leaves out, with the reason
LEFT_OUT: Dict[str, str] = {
    "prefetch_chunk_blocks": "chunks matter only to the simulator, which "
                             "stages a prefetch over time; the serving "
                             "runtime stages the whole plan at once",
    "net_bw": "simulator-only: the shared link's capacity",
    "model_collectives": "simulator-only switch",
    "collective_dtype_bytes": "simulator-only",
    "collective_bytes_per_token": "simulator-only override",
    "net_bg_load": "simulator-only background traffic",
    "net_bg_chunk_bytes": "simulator-only",
    "elastic_min_pe": "simulator-only floor (serving never drains the "
                      "last admitting engine of a role)",
    "elastic_min_de": "simulator-only floor",
    "hedge_threshold_s": "simulator-only: gates the mid-flight hedge",
    "hedge_min_severity": "no caller sets it; serving/system.py holds "
                          "the reference's default",
}


def group_defaults(name: str):
    """A fresh all-default instance of group ``name``."""
    return _GROUP_TYPES[name]()
