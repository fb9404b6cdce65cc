"""The finite, shared, priority-arbitrated compute-network link (port of
``repro.network.link``).

:class:`SharedLink` is the simulator's model of it: a finite-capacity
link multiplexing flows of different
:class:`~repro_torch.core.traffic.TrafficClass` under one of two arbiters
— ``"vl"`` (the paper's weighted-VL arbiter, rates from
:func:`~repro_torch.core.traffic.allocate_bandwidth`) and ``"fifo"``
(class-blind processor sharing, the ablation) — with per-class byte and
delay accounting and a :meth:`SharedLink.congestion` signal that the
read-path choice consumes.

:func:`drain_times` is the closed-form (fluid) counterpart the serving
runtime's clock charges.  Two traffic classes, KV transfers and model
collectives, start together on one work-conserving link.  While both are
backlogged they get fixed shares; when one empties the other takes the
whole link.  So the later finisher always ends at ``kv_s + coll_s``, and
arbitration decides only who finishes *first*: whether model execution stalls on its collectives
(FIFO sharing) or the KV backlog absorbs the delay (the paper's
weighted-VL arbiter).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Optional

from repro_torch.core.traffic import (DEFAULT_ARBITER, TrafficClass,
                                      VLArbiterConfig, allocate_bandwidth)

ARBITERS = ("vl", "fifo")


class SharedLink:
    """Class-aware processor-sharing link (PSResource-compatible).

    The simulator's flow engine asks every resource ``rate_of(flow)`` at
    each reshare.  Under ``"vl"`` the active classes split the capacity
    by the weighted round-robin tables (model collectives ≈ 99 % while
    backlogged, KV never starved) and flows share equally within a
    class; under ``"fifo"`` every flow gets an equal share whatever its
    class.  An infinite ``cap`` leaves every flow rate-unbounded with no
    accounting: the paper's no-congestion assumption."""

    __slots__ = ("name", "cap", "arbiter", "arb", "flows",
                 "bytes_by_class", "collective_delay_s",
                 "transfer_backlog_s", "contended_joins",
                 "_counts_cache", "_counts_n", "_alloc_cache")

    def __init__(self, name: str, cap: float, arbiter: str = "vl",
                 arb: VLArbiterConfig = DEFAULT_ARBITER):
        if arbiter not in ARBITERS:
            raise ValueError(f"arbiter {arbiter!r} (valid: {ARBITERS})")
        self.name = name
        self.cap = cap
        self.arbiter = arbiter
        self.arb = arb
        self.flows: set = set()
        self.bytes_by_class: Dict[TrafficClass, float] = {
            c: 0.0 for c in TrafficClass}
        # per-flow delay against having the link alone, by class
        self.collective_delay_s = 0.0
        self.transfer_backlog_s = 0.0
        self.contended_joins = 0     # flows that joined a busy link
        # per-class census and WRR allocation, rebuilt only when the flow
        # set changes (a reshare asks rate_of once per affected flow)
        self._counts_cache: Optional[Counter] = None
        self._counts_n = -1
        self._alloc_cache: Optional[Dict[TrafficClass, float]] = None

    # -- rate allocation ---------------------------------------------------
    def _invalidate(self):
        self._counts_n = -1
        self._alloc_cache = None

    def _class_counts(self) -> Counter:
        if self._counts_cache is None or self._counts_n != len(self.flows):
            self._counts_cache = Counter(
                getattr(f, "tclass", TrafficClass.KV_TRANSFER)
                for f in self.flows)
            self._counts_n = len(self.flows)
            self._alloc_cache = None
        return self._counts_cache

    def rate_of(self, flow) -> float:
        n = len(self.flows)
        if n == 0 or not math.isfinite(self.cap):
            return self.cap
        tclass = getattr(flow, "tclass", TrafficClass.KV_TRANSFER)
        if self.arbiter == "fifo":
            return self.cap / n
        counts = self._class_counts()
        if self._alloc_cache is None:
            self._alloc_cache = allocate_bandwidth(dict(counts), self.cap,
                                                   self.arb)
        return self._alloc_cache.get(tclass, 0.0) / \
            max(counts.get(tclass, 1), 1)

    # -- signals / accounting ---------------------------------------------
    def congestion(self) -> float:
        """The fraction of in-flight bytes that belong to model
        collectives, in [0, 1]; 0 on an idle or infinite link."""
        if not math.isfinite(self.cap) or not self.flows:
            return 0.0
        tot = coll = 0.0
        for f in self.flows:
            left = max(getattr(f, "nbytes_left", 0.0), 0.0)
            tot += left
            if getattr(f, "tclass", None) == TrafficClass.MODEL_COLLECTIVE:
                coll += left
        return (coll / tot) if tot > 0 else 0.0

    def note_enter(self, flow) -> None:
        self._invalidate()
        if math.isfinite(self.cap) and self.flows:
            self.contended_joins += 1

    def note_done(self, flow, now: float) -> None:
        """Per-flow delay at completion, against the flow having this
        link alone (a flow bottlenecked elsewhere counts its extra time
        here too, so the stall numbers are never under-reported)."""
        self._invalidate()
        if not math.isfinite(self.cap):
            return
        tclass = getattr(flow, "tclass", TrafficClass.KV_TRANSFER)
        nbytes = getattr(flow, "nbytes_total", 0.0)
        self.bytes_by_class[tclass] = \
            self.bytes_by_class.get(tclass, 0.0) + nbytes
        t_enter = getattr(flow, "t_enter", now)
        delay = max(0.0, (now - t_enter) - nbytes / self.cap)
        if tclass == TrafficClass.MODEL_COLLECTIVE:
            self.collective_delay_s += delay
        else:
            self.transfer_backlog_s += delay


def kv_share_when_contended(arbiter: str,
                            arb: VLArbiterConfig = DEFAULT_ARBITER) -> float:
    """Share of link bandwidth KV traffic gets while collectives are
    backlogged: the low-priority leak under the VL arbiter (1 −
    ``high_fraction()`` = 0.0059 with the §A.1 tables), an equal split
    under FIFO sharing."""
    if arbiter == "fifo":
        return 0.5
    return 1.0 - arb.high_fraction()


def drain_times(kv_s: float, coll_s: float, kv_share: float) -> tuple:
    """Completion times ``(kv_done, coll_done)`` of the two classes.

    ``kv_s`` / ``coll_s`` are each class's service time alone at full
    bandwidth (bytes over the link's rate); ``kv_share`` is KV's share
    while both are backlogged, clamped to [0, 1]."""
    kv_s = max(kv_s, 0.0)
    coll_s = max(coll_s, 0.0)
    if kv_s <= 0.0 or coll_s <= 0.0:
        return kv_s, coll_s
    kv_share = min(max(kv_share, 0.0), 1.0)
    coll_share = 1.0 - kv_share
    if coll_share <= 0.0:
        return kv_s, kv_s + coll_s
    if kv_share <= 0.0:
        return kv_s + coll_s, coll_s
    t_kv = kv_s / kv_share
    t_coll = coll_s / coll_share
    if t_coll <= t_kv:                 # collectives empty first
        return kv_s + coll_s, t_coll
    return t_kv, kv_s + coll_s         # KV empties first
