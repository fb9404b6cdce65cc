"""Engine-side transfer manager (port of ``repro.core.traffic``, paper §5).

Transfers are queued per engine with a traffic class; ``flush`` posts the
queue in arbiter order (model collectives first, FIFO within a class)
and charges the modelled doorbell-batched submission cost, ``poll``
executes the posted thunks and fires per-flush completion callbacks, and
``drain`` is flush + poll until idle.  With a tracer attached, every
flush and every poll that completed something records an event.  The
reference's congestion pacing belongs to the compute-network model, which
is not ported yet: a flush here defers nothing.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Deque, List, Optional, Tuple


class TrafficClass(IntEnum):
    MODEL_COLLECTIVE = 0      # EP AllToAll, TP ReduceScatter/AllGather
    KV_TRANSFER = 1           # dual-path loading, H2D/D2H, storage persists
    BULK = 2                  # checkpoints, dataset reads


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
    cbs: Optional[List[Callable[[], None]]] = field(compare=False,
                                                    default=None)


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

    def submit(self, fn: Callable[[], None], nbytes: int,
               tclass: TrafficClass):
        heapq.heappush(self._q, _QueuedTransfer(
            (int(tclass != TrafficClass.MODEL_COLLECTIVE), next(self._seq)),
            fn, nbytes, tclass))
        self.bytes[tclass] += nbytes

    def flush(self, on_complete: Optional[Callable[[], None]] = None) -> int:
        """Post every queued WR (arbiter order) and ring the doorbells;
        non-blocking.  ``on_complete`` fires once every transfer queued
        at this flush has executed (at once when nothing was queued)."""
        batch: List[_QueuedTransfer] = []
        while self._q:
            batch.append(heapq.heappop(self._q))
        if not batch:
            if on_complete is not None:
                on_complete()
            return 0
        kv_batch = 0
        for t in batch:
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
        self._inflight.extend(batch)
        if self.tracer is not None:
            self.tracer.event(self.track, "flush", posted=len(batch),
                              deferred=0,
                              posted_bytes=sum(t.nbytes for t in batch))
        return len(batch)

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

    def drain(self) -> int:
        """Blocking issue + complete: flush and poll until idle."""
        n = 0
        while self._q or self._inflight:
            self.flush()
            n += self.poll()
        return n
