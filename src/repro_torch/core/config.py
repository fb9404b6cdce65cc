"""Runtime configuration groups (port of ``repro.core.config``).

* :class:`TierConfig` — the node-local DRAM tier and the think-time
  prefetcher.
* :class:`ResilienceConfig` — fault injection (``sim/faults.py``) and
  hedged split reads.
* :class:`SloConfig` — the online SLO layer: the admission gate,
  chunked prefill and priority classes.

The reference's other groups (network, elastic) arrive with the slices
that port those features.
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
