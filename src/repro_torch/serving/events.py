"""Serving runtime scaffolding (port of ``repro.serving.events``).

* :class:`ReqState` — a round's lifecycle ``SCHEDULED → READING →
  PREFILL → PD_TRANSFER → DECODE → PERSIST → DONE``, with the chunked
  prefill's ``PREFILL_CHUNKED`` sub-state between PREFILL and
  PD_TRANSFER.
* :class:`VirtualClock` — the runtime's clock, advanced per tick by
  *modelled* seconds from :class:`ServingTimeModel`: ``max(transfer,
  compute)`` pipelined, ``transfer + compute`` blocking.  The port runs
  the same model as the reference, so its ``wall_s`` is a modelled
  number on both packages; real seconds on the card are measured
  around the run by its caller.
* :class:`EventLoop` — timed events (online arrivals, inter-round think
  gaps) on a heap over that clock; the clock jumps over idle gaps
  instead of sleeping.  The same clock stamps the DRAM tiers, so a TTL
  means modelled seconds.
* :class:`RoundMetrics` + :func:`latency_summary` /
  :func:`latency_by_class` / :func:`slo_attainment` — per-round TTFT /
  TTST / TPOT on that clock, overall and per SLO class.
* :class:`EngineLifecycle` — an engine's state under elastic role flips
  and fail-stop deaths.
* :class:`ServingTimeModel` — the modelled durations, with the finite
  compute network: per-step model collectives contend with KV transfers
  on each node's compute-NIC link under the configured arbiter.
"""
from __future__ import annotations

import heapq
import itertools
from collections import defaultdict
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.intra import attn_flops
from repro_torch.network import (CollectiveVolumeModel, drain_times,
                                 kv_share_when_contended)
from repro_torch.sim.spec import HOPPER_NODE, ModelSimSpec, NodeSpec


class ReqState(Enum):
    """Lifecycle of one round (request) through the serving runtime."""

    SCHEDULED = "scheduled"      # submitted, awaiting (PE, DE) + read path
    READING = "reading"          # storage read legs in flight
    PREFILL = "prefill"          # hit KV installed, in the PE's fifo
    # chunked prefill (SloConfig.prefill_chunk_tokens): a capped slice
    # ran and the rest waits in the PE fifo for a later step
    PREFILL_CHUNKED = "prefill_chunked"
    PD_TRANSFER = "pd_transfer"  # prompt state PE→DE on the compute net
    DECODE = "decode"            # slot-batched decode on the DE
    PERSIST = "persist"          # new FullBlocks persisting to storage
    DONE = "done"


class EngineLifecycle(Enum):
    """Lifecycle of one engine.  A role flip (core/autoscale.py) moves it
    ACTIVE → DRAINING (no admissions; in-flight rounds finish) →
    RECONFIGURING (drained; the other role's weights reloading over the
    node's storage NIC) → ACTIVE under the other kind.  With elastic off
    every engine stays ACTIVE.  DEAD is the fail-stop end
    (sim/faults.EngineDeath)."""

    ACTIVE = "active"
    DRAINING = "draining"
    RECONFIGURING = "reconfiguring"
    DEAD = "dead"


@dataclass
class RoundMetrics:
    """Timestamps of one round on the runtime's clock (-1 = not yet),
    stamped at the end of the tick they occur in."""

    rid: int
    gen_tokens: int
    submit_t: float
    read_done_t: float = -1.0
    prefill_done_t: float = -1.0     # first token ready (TTFT)
    first_decode_t: float = -1.0
    second_token_t: float = -1.0     # TTST
    done_t: float = -1.0
    slo_class: str = "batch"

    @property
    def finished(self) -> bool:
        return self.done_t >= 0

    @property
    def ttft(self) -> float:
        return self.prefill_done_t - self.submit_t

    @property
    def ttst(self) -> Optional[float]:
        if self.second_token_t < 0:
            return None
        return self.second_token_t - self.submit_t

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token over the decode phase (gen > 1 only)."""
        if self.gen_tokens <= 1 or self.first_decode_t < 0:
            return None
        return (self.done_t - self.first_decode_t) / (self.gen_tokens - 1)


def latency_summary(metrics: Iterable[RoundMetrics]) -> dict:
    """TTFT/TTST/TPOT summary over finished rounds (NaN when none)."""
    done = [m for m in metrics if m.finished]
    ttfts = [m.ttft for m in done if m.prefill_done_t >= 0]
    ttsts = [m.ttst for m in done if m.ttst is not None]
    tpots = [m.tpot for m in done if m.tpot is not None]
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else float("nan")
    mean = lambda xs: float(np.mean(xs)) if xs else float("nan")
    return dict(
        finished_rounds=len(done),
        ttft_mean=mean(ttfts), ttft_p99=pct(ttfts, 99),
        ttst_mean=mean(ttsts),
        tpot_mean=mean(tpots), tpot_p99=pct(tpots, 99),
    )


def latency_by_class(metrics: Iterable[RoundMetrics]) -> dict:
    """One :func:`latency_summary` per SLO class; a class with no
    finished round is left out (its all-NaN summary would never compare
    equal)."""
    ms = list(metrics)
    out = {}
    for c in ("interactive", "batch"):
        sub = [m for m in ms if m.slo_class == c]
        if any(m.finished for m in sub):
            out[c] = latency_summary(sub)
    return out


def slo_attainment(metrics: Iterable[RoundMetrics], ttft_slo_s: float,
                   tpot_slo_s: float) -> float:
    """Fraction of finished rounds meeting both the TTFT and the TPOT
    SLO (a round with one output token has no TPOT and is judged on
    TTFT alone); NaN when no round finished."""
    done = [m for m in metrics if m.finished]
    if not done:
        return float("nan")
    ok = 0
    for m in done:
        if m.ttft > ttft_slo_s:
            continue
        t = m.tpot
        if t is not None and t > tpot_slo_s:
            continue
        ok += 1
    return ok / len(done)


class VirtualClock:
    """The runtime's clock [s]: work advances it by modelled durations,
    idle periods jump it to the next timed event."""

    def __init__(self):
        self.now = 0.0

    def advance(self, dt: float) -> float:
        if dt > 0:
            self.now += dt
        return self.now

    def jump_to(self, t: float) -> float:
        if t > self.now:
            self.now = t
        return self.now


class EventLoop:
    """Timed-event heap over a :class:`VirtualClock` (arrivals and
    think-gap round submissions in online serving)."""

    def __init__(self, clock: VirtualClock):
        self.clock = clock
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()

    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.clock.now + max(dt, 0.0), fn)

    @property
    def pending(self) -> int:
        return len(self._heap)

    def next_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def fire_due(self) -> int:
        """Run every event scheduled at or before ``clock.now``."""
        n = 0
        while self._heap and self._heap[0][0] <= self.clock.now:
            _, _, fn = heapq.heappop(self._heap)
            fn()
            n += 1
        return n


class TickIo:
    """Per-tick transfer-seconds ledger, bucketed by physical resource
    (``("snic", node)``, ``("cn", node)``, ``("dram", node)``): distinct
    buckets drain
    concurrently (pipelined charges their max), the blocking runtime
    serialises them (charges their sum)."""

    def __init__(self):
        self.buckets: Dict[tuple, float] = defaultdict(float)

    def add(self, bucket: tuple, seconds: float) -> None:
        if seconds > 0:
            self.buckets[bucket] += seconds

    def parallel_seconds(self) -> float:
        return max(self.buckets.values(), default=0.0)

    def serial_seconds(self) -> float:
        return sum(self.buckets.values())


@dataclass
class ServingTimeModel:
    """Modelled durations for the serving clock: NIC bandwidths for
    transfers, the analytic FLOP and byte forms for compute.
    ``collectives`` (None: an infinite compute network) gives the model
    collectives' volume per token; ``net_arbiter`` is how KV transfers
    and collectives share a contended link: 'vl' (the paper's weighted-VL
    arbiter) or 'fifo' (class-blind sharing, the ablation)."""

    cfg: ModelConfig
    node: NodeSpec
    spec: ModelSimSpec
    net_arbiter: str = "vl"
    collectives: Optional[CollectiveVolumeModel] = None

    @classmethod
    def for_model(cls, cfg: ModelConfig,
                  node: Optional[NodeSpec] = None,
                  net_arbiter: str = "vl",
                  collective_group_size: int = 0) -> "ServingTimeModel":
        coll = CollectiveVolumeModel.from_config(cfg, collective_group_size) \
            if collective_group_size > 1 else None
        return cls(cfg=cfg, node=node or HOPPER_NODE,
                   spec=ModelSimSpec.from_config(cfg),
                   net_arbiter=net_arbiter, collectives=coll)

    def snic_seconds(self, nbytes: float) -> float:
        return nbytes / self.node.snic_bw

    def cn_seconds(self, nbytes: float, coll_bytes: float = 0.0) -> float:
        """Seconds for ``nbytes`` of KV traffic on the compute network;
        with ``coll_bytes`` of collectives contending, the KV completion
        time under the arbiter (:func:`network.drain_times`)."""
        kv_s = nbytes / self.node.cnic_bw
        if coll_bytes <= 0:
            return kv_s
        kv_done, _ = drain_times(kv_s, coll_bytes / self.node.cnic_bw,
                                 kv_share_when_contended(self.net_arbiter))
        return kv_done

    def collective_seconds(self, nbytes: float) -> float:
        """Uncontended service time of collective traffic on the link."""
        return nbytes / self.node.cnic_bw

    def cn_drain(self, kv_s: float, coll_s: float) -> Tuple[float, float]:
        """(kv_done, coll_done) of KV and collective service seconds
        contending on one link under the arbiter."""
        return drain_times(kv_s, coll_s,
                           kv_share_when_contended(self.net_arbiter))

    def dram_seconds(self, nbytes: float) -> float:
        return nbytes / self.node.dram_bw

    def pe_step_seconds(self, items: Sequence[Tuple[int, int]]) -> float:
        """One PE forward batch over ``(cached, bsz)`` items."""
        if not items:
            return 0.0
        a = attn_flops(self.cfg, items)
        lin = self.spec.linear_flops_per_token() * sum(b for _, b in items)
        return (a + lin) / (self.node.gpu.flops * self.node.gpu.mfu_prefill)

    def de_step_seconds(self, ctxs: Sequence[int]) -> float:
        """One slot-batched decode step over active context lengths."""
        if not ctxs:
            return 0.0
        kv = sum(self.spec.decode_step_bytes(c) for c in ctxs)
        w = self.spec.active_param_bytes_resident(1)
        fl = sum(self.spec.decode_step_flops(c) for c in ctxs)
        return max((kv + w) / (self.node.gpu.hbm_bw * self.node.gpu.mbu_decode),
                   fl / (self.node.gpu.flops * self.node.gpu.mfu_prefill))
