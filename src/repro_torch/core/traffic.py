"""Engine-side transfer manager (port of ``repro.core.traffic``, paper §5).

Transfers are queued per engine with a traffic class; ``flush`` posts the
queue in arbiter order (model collectives first, FIFO within a class)
and charges the modelled doorbell-batched submission cost, ``poll``
executes the posted thunks and fires per-flush completion callbacks, and
``drain`` is flush + poll until idle.  With a tracer attached, every
flush and every poll that completed something records an event.

Model collectives ride a high-priority virtual lane that owns ~99 % of
the arbitration weight; KV transfers ride a low-priority lane with a
starvation floor (:class:`VLArbiterConfig`, :func:`allocate_bandwidth`).
Under compute-network congestion (``net_congestion >= pace_threshold``,
set by the serving runtime each tick) a flush is *paced*: collectives
post, KV WRs post at most one doorbell batch and the rest wait for a
later flush.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Deque, Dict, List, Optional, Tuple


class TrafficClass(IntEnum):
    MODEL_COLLECTIVE = 0      # EP AllToAll, TP ReduceScatter/AllGather
    KV_TRANSFER = 1           # dual-path loading, H2D/D2H, storage persists
    BULK = 2                  # checkpoints, dataset reads


@dataclass(frozen=True)
class VLArbiterConfig:
    """InfiniBand-style two-arbiter WRR (paper §A.1 values).

    ``high_weights``/``low_weights``: VL -> WRR weight in the high- and
    low-priority arbiter.  ``high_limit=240`` (of 255) reserves ~99 % of
    the bandwidth for the high-priority arbiter before the low one is
    consulted; the low table keeps a small weight for the KV lane so it
    never starves."""

    n_vls: int = 4
    high_limit: int = 240
    high_weights: Tuple[int, ...] = (192, 192, 0, 192)
    low_weights: Tuple[int, ...] = (192, 192, 64, 192)
    class_to_vl: Tuple[int, ...] = (0, 2, 2)   # TrafficClass -> VL

    def high_fraction(self) -> float:
        """Fraction of link bandwidth the high-priority arbiter owns when
        both arbiters have backlogged traffic."""
        return self.high_limit / 255.0 + (1 - self.high_limit / 255.0) * (
            sum(w for v, w in enumerate(self.low_weights)
                if self.high_weights[v] > 0) /
            max(sum(self.low_weights), 1))


DEFAULT_ARBITER = VLArbiterConfig()


def allocate_bandwidth(active: Dict[TrafficClass, int], link_bw: float,
                       arb: VLArbiterConfig = DEFAULT_ARBITER
                       ) -> Dict[TrafficClass, float]:
    """Share ``link_bw`` among active flows per the VL arbiter.

    ``active``: backlogged flows per class.  Classes on a high-arbiter VL
    split the high fraction, low-VL classes share the rest (everything
    when no high traffic is active); within a pool, classes share by
    their low-table weight."""
    hi_classes = [c for c, n in active.items()
                  if n > 0 and arb.high_weights[arb.class_to_vl[c]] > 0]
    lo_classes = [c for c, n in active.items()
                  if n > 0 and arb.high_weights[arb.class_to_vl[c]] == 0]
    out: Dict[TrafficClass, float] = {c: 0.0 for c in active}
    if hi_classes and lo_classes:
        hf = arb.high_fraction()
        hi_bw, lo_bw = link_bw * hf, link_bw * (1 - hf)
    elif hi_classes:
        hi_bw, lo_bw = link_bw, 0.0
    else:
        hi_bw, lo_bw = 0.0, link_bw
    for pool_bw, classes in ((hi_bw, hi_classes), (lo_bw, lo_classes)):
        if not classes:
            continue
        tot_w = sum(arb.low_weights[arb.class_to_vl[c]] or 1 for c in classes)
        for c in classes:
            w = arb.low_weights[arb.class_to_vl[c]] or 1
            out[c] = pool_bw * w / tot_w
    return out


@dataclass(frozen=True)
class SubmitCostModel:
    """Modelled submission cost (§5.2): RDMA work requests with
    doorbell batching."""

    rdma_wr_s: float = 1e-6          # one RDMA work request (mmio writes)
    rdma_doorbell_s: float = 0.3e-6  # one doorbell ring (amortisable)
    cuda_memcpy_s: float = 6e-6      # paper: 5–7 µs per cudaMemcpyAsync

    def rdma_batch_seconds(self, n: int) -> float:
        """Doorbell batching: n WRs posted, one doorbell."""
        return n * self.rdma_wr_s + self.rdma_doorbell_s

    def rdma_unbatched_seconds(self, n: int) -> float:
        return n * (self.rdma_wr_s + self.rdma_doorbell_s)

    def cuda_seconds(self, n: int) -> float:
        return n * self.cuda_memcpy_s


@dataclass(order=True)
class _QueuedTransfer:
    sort_key: Tuple[int, int] = field(compare=True)
    fn: Callable[[], None] = field(compare=False)
    nbytes: int = field(compare=False, default=0)
    tclass: TrafficClass = field(compare=False,
                                 default=TrafficClass.KV_TRANSFER)
    # one completion countdown per flush whose batch held this transfer
    # (a WR deferred by pacing belongs to more than one flush)
    cbs: Optional[List[Callable[[], None]]] = field(compare=False,
                                                    default=None)


# the reference's default pacing threshold; no caller sets another
_PACE_THRESHOLD = 0.5


class TrafficManager:
    """Per-engine transfer orderer with an issue half (``flush``) and a
    completion half (``poll``), like an RDMA send queue."""

    #: optional flight recorder (repro_torch.obs.Tracer) and track label,
    #: attached by the owning runtime; None = untraced
    tracer = None
    track = "traffic"

    def __init__(self, cost: SubmitCostModel = SubmitCostModel(),
                 doorbell_batch: int = 32):
        self.cost = cost
        self.doorbell_batch = doorbell_batch
        self._q: List[_QueuedTransfer] = []
        self._inflight: Deque[_QueuedTransfer] = deque()
        self._seq = itertools.count()
        self.submitted_seconds = 0.0     # modelled submission overhead
        self.doorbells = 0
        self.bytes = {c: 0 for c in TrafficClass}
        # compute-network back-pressure: ``net_congestion`` in [0, 1] is
        # set by the runtime each tick; at or above ``pace_threshold`` a
        # flush posts every collective but at most one doorbell batch of
        # KV WRs, so a later collective still overtakes a KV backlog
        self.net_congestion = 0.0
        self.pace_threshold = _PACE_THRESHOLD
        self.paced_flushes = 0
        self.deferred_wrs = 0

    def submit(self, fn: Callable[[], None], nbytes: int,
               tclass: TrafficClass):
        heapq.heappush(self._q, _QueuedTransfer(
            (int(tclass != TrafficClass.MODEL_COLLECTIVE), next(self._seq)),
            fn, nbytes, tclass))
        self.bytes[tclass] += nbytes

    def flush(self, on_complete: Optional[Callable[[], None]] = None) -> int:
        """Post every queued WR (arbiter order) and ring the doorbells;
        non-blocking.  ``on_complete`` fires once every transfer queued
        at this flush has executed (at once when nothing was queued),
        WRs that pacing defers to a later flush included.  A paced flush
        returns the deferred WRs to the queue in order, their submission
        cost charged when they post.  Returns the number of WRs posted."""
        batch: List[_QueuedTransfer] = []
        while self._q:
            batch.append(heapq.heappop(self._q))
        if not batch:
            if on_complete is not None:
                on_complete()
            return 0
        posted = batch
        deferred: List[_QueuedTransfer] = []
        if self.net_congestion >= self.pace_threshold:
            posted = []
            kv_budget = self.doorbell_batch
            for t in batch:
                if t.tclass == TrafficClass.MODEL_COLLECTIVE:
                    posted.append(t)
                elif kv_budget > 0:
                    posted.append(t)
                    kv_budget -= 1
                else:
                    deferred.append(t)
            if deferred:
                self.paced_flushes += 1
                self.deferred_wrs += len(deferred)
        kv_batch = 0
        for t in posted:
            if t.tclass == TrafficClass.MODEL_COLLECTIVE:
                self.submitted_seconds += self.cost.rdma_batch_seconds(1)
                self.doorbells += 1
            else:
                kv_batch += 1
                if kv_batch == self.doorbell_batch:
                    self.submitted_seconds += \
                        self.cost.rdma_batch_seconds(kv_batch)
                    self.doorbells += 1
                    kv_batch = 0
        if kv_batch:
            self.submitted_seconds += self.cost.rdma_batch_seconds(kv_batch)
            self.doorbells += 1
        if on_complete is not None:
            pending = [len(batch)]

            def countdown():
                pending[0] -= 1
                if pending[0] == 0:
                    on_complete()

            for t in batch:
                if t.cbs is None:
                    t.cbs = []
                t.cbs.append(countdown)
        self._inflight.extend(posted)
        for t in deferred:       # sort keys intact: the order is kept
            heapq.heappush(self._q, t)
        if self.tracer is not None:
            self.tracer.event(self.track, "flush", posted=len(posted),
                              deferred=len(deferred),
                              posted_bytes=sum(t.nbytes for t in posted))
        return len(posted)

    def poll(self, max_n: Optional[int] = None) -> int:
        """Execute up to ``max_n`` in-flight transfers (all if None) in
        posted order, firing completion callbacks; returns the count."""
        n = 0
        while self._inflight and (max_n is None or n < max_n):
            t = self._inflight.popleft()
            n += 1
            try:
                t.fn()
            finally:
                cbs, t.cbs = t.cbs, None
                for cb in cbs or ():
                    cb()
        if n and self.tracer is not None:
            self.tracer.event(self.track, "poll", completed=n)
        return n

    @property
    def queued(self) -> int:
        return len(self._q)

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    @property
    def busy(self) -> bool:
        return bool(self._q or self._inflight)

    def drain(self) -> int:
        """Blocking issue + complete: flush and poll until idle."""
        n = 0
        while self._q or self._inflight:
            self.flush()
            n += self.poll()
        return n
