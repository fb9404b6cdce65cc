"""DualPath serving system: scheduler + engines + storage, end to end
(port of ``repro.serving.system``, offline runtime).

Per round (paper Fig. 4), as a lifecycle state machine:

  SCHEDULED    client computes the trie hit for ``context ‖ append``
               (§A.4); the scheduler assigns (PE, DE) and a read path
  READING      the chosen side(s)' TrafficManagers carry the FullBlock
               reads (storage→PE directly, or storage→DE→network→PE;
               DRAM-tier prefixes skip the storage NIC)
  PREFILL      PE installs the hit KV layerwise on the card and runs
               quota-packed chunked prefill over the append
  (PREFILL_CHUNKED)  with ``SloConfig.prefill_chunk_tokens``, a round
               whose capped slice ran waits here for its next slice
  PD_TRANSFER  prompt state PE→DE, one submission per attention layer
  DECODE       DE decodes ``gen`` tokens greedily, slot-batched
  PERSIST      newly filled FullBlocks (the scatter kernel) and trie
               entries persist (§A.5), through the DE node's DRAM tier

Two runtimes share every mechanism: **pipelined** (default; reads, PD
transfers and persists stay in flight across engine compute and land at
the tick's poll, the clock charging ``max(transfer, compute)``) and
**blocking** (``pipelined=False``; every submission drains inline, the
clock charging ``transfer + compute``).  Both generate identical tokens
and identical byte accounting.  The clock is modelled (see
``serving/events.py``).

``run_offline`` drives all sessions from t=0; ``run_online(trajectories,
arrivals)`` adds arrivals and inter-round think gaps on the clock.  With
``tier=TierConfig(dram_tier_bytes=...)`` every node has a DRAM tier over
the store (``kvcache/tiers.py``): the DE persists through its node's tier
(write-through), each finished round warms that tier with its context,
and the think-time prefetcher stages evicted blocks back.

The SSM family (mamba2) has no per-token KV: a round's cache is its
session's state blob (``StateBlobStore``), found by the exact context
instead of a trie match, read whole on the side the path decision
chose (never split), installed on the PE in one copy and persisted by
the DE as one blob; the DRAM tiers do not hold blobs.

The dense, MoE and VLM families take the FullBlock path (the reference's
``PAGED_FAMILIES``); a VLM is served by token ids, as the reference
serves it.  An encoder-only config has no decode state and raises at
construction.

``slo=SloConfig(...)`` adds the online SLO layer: an admission gate in
front of the scheduler (``core/admission.py``: online arrivals are
admitted, deferred or rejected on a TTFT estimate from
:meth:`ServingSystem._elastic_signals`), chunked prefill (capped slices,
the PREFILL_CHUNKED sub-state, the ``prefill_chunks`` counter) and
priority classes (``Trajectory.slo_class``; interactive rounds overtake
batch rounds in the scheduler's queues and the PE fifo).  An all-default
SloConfig changes nothing.

``resilience=ResilienceConfig(faults=FaultSchedule(...))`` injects
faults (``sim/faults.py``): slowdown windows and straggling read legs
scale the clock's storage-NIC and compute-network seconds, and with
``hedge_reads`` a read whose one side is degraded moves part of its share
to the other side (``Scheduler.rebalance_remainder``).  An engine death
fail-stops the engine at its modelled time: its unstarted assignments go
back to the queues, and every round with state on it restarts under a
new rid from the persisted KV (the trie match of the same prompt), so a
block whose persist had not landed is persisted once by the recovery.

``elastic=ElasticConfig(enabled=True, ...)`` flips engine roles at run
time (``core/autoscale.py``): once per ``reconfig_interval_s`` the
controller observes the load per role and may propose a flip; the victim
stops admitting (DRAINING), its in-flight rounds finish, its unstarted
ones go back to the queues, the other role's weights reload over the
node's storage NIC (RECONFIGURING, charged to the clock) and a new
engine object of the other kind takes its id (a new DE allocates its
decode state on the card, a DE that leaves frees it); the node's DRAM
tier is kept across the flip.

``net=NetworkConfig(collective_group_size=g)`` with ``g > 1`` models
the finite compute network: every PE and DE step puts its model
collectives on the stepping node's compute-NIC link, where they contend
with that tick's KV transfers under ``net_arbiter`` ('vl' or 'fifo'):
collectives that finish late stall compute (``collective_stall_s``),
KV that finishes late is backlog (``transfer_backlog_s``), and the
collectives' share of the traffic is the congestion that biases the next
read-path decisions and paces KV work requests.

``tracer=Tracer()`` records the run on the modelled clock
(``repro_torch.obs``): lifecycle spans per request, storage reads, tier
hits, persists, read-path and hedge decisions, controller proposals,
``reconfig`` spans, tier and traffic events.  With ``tracer=None`` every
hook is a no-op.  ``stats()`` passes through the metric schema
(``obs.schema.conforming``) and has every key of the reference's.

It serves the dense and MoE families (GQA or MLA attention: ds27b's
FullBlock rows are c ‖ krope) with ``mode`` dualpath or basic,
``split_reads``, ``layerwise`` on and off, any number of PEs, DEs and
groups, offline or online, with or without DRAM tiers, prefetch, the SLO
layer, faults and hedging, elastic roles and the collective network,
traced or not.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import layout_for
from repro_torch.core.admission import DEFER, REJECT, AdmissionGate
from repro_torch.core.autoscale import (DE_TO_PE, DRAIN_POLICIES,
                                        DrainTracker, LoadSignals,
                                        PDController, pick_victim)
from repro_torch.core.config import (ElasticConfig, NetworkConfig,
                                     ResilienceConfig, SloConfig,
                                     TierConfig)
from repro_torch.core.scheduler import Request, Scheduler
from repro_torch.core.traffic import TrafficClass, TrafficManager
from repro_torch.device import resolve
from repro_torch.engines import kvio
from repro_torch.engines.runtime import (DecodeEngine, EngineRequest,
                                         PrefillEngine, uses_state_blob)
from repro_torch.kvcache.store import MemoryKVStore, StateBlobStore
from repro_torch.kvcache.tiers import DramTier, ThinkTimePrefetcher
from repro_torch.kvcache.trie import BlockTrie
from repro_torch.models.params import require_decode
from repro_torch.obs.schema import conforming
from repro_torch.serving import events
from repro_torch.serving.events import (EngineLifecycle, EventLoop,
                                        ReqState, RoundMetrics,
                                        ServingTimeModel, TickIo,
                                        VirtualClock)
from repro_torch.sim.spec import NodeSpec
from repro_torch.sim.traces import Trajectory


# lifecycle states in which a round's state is on its PE (the reference
# lists the first three; a chunked round between slices is on the PE too)
_ON_PE = (ReqState.SCHEDULED, ReqState.READING, ReqState.PREFILL,
          ReqState.PREFILL_CHUNKED)


@dataclass
class AgentSession:
    traj: Trajectory
    rng: np.random.Generator
    context: List[int] = field(default_factory=list)
    next_round: int = 0
    rounds_done: int = 0
    current: Optional[EngineRequest] = None

    def done(self) -> bool:
        return self.next_round >= self.traj.n_rounds and self.current is None


class ServingSystem:
    def __init__(self, cfg: ModelConfig, params, *, n_pe: int = 1,
                 n_de: int = 1, mode: str = "dualpath",
                 block_tokens: int = 16, max_seq: int = 512,
                 de_slots: int = 8, split_reads: bool = False,
                 layerwise: bool = True,
                 pe_group_size: Optional[int] = None,
                 de_group_size: Optional[int] = None,
                 pipelined: bool = True, node: Optional[NodeSpec] = None,
                 tracer=None, tier: Optional[TierConfig] = None,
                 net: Optional[NetworkConfig] = None,
                 elastic: Optional[ElasticConfig] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 slo: Optional[SloConfig] = None, device="cuda"):
        assert mode in ("dualpath", "basic")
        # an encoder has no decode state to serve: refused here, before
        # any engine is built
        require_decode(cfg)
        if max_seq % block_tokens:
            raise ValueError(f"max_seq {max_seq} must be a multiple of "
                             f"block_tokens {block_tokens}")
        self.device = resolve(device)
        weights_dev = params["embed"]["tok"].device
        if weights_dev.type != self.device.type:
            raise ValueError(f"parameters live on {weights_dev}, the system "
                             f"was asked to run on {self.device}")
        self.cfg = cfg
        self.params = params
        self.mode = mode
        self.max_seq = max_seq
        self.pipelined = pipelined
        # the FullBlock row holds the KV cache's real itemsize (the
        # reference assumes 2 bytes, which only bf16 KV satisfies)
        kv_itemsize = torch.empty(
            (), dtype=getattr(torch, cfg.kv_cache_dtype)).element_size()
        self.layout = layout_for(cfg, block_tokens, kv_itemsize)
        self.store = MemoryKVStore(self.layout)
        self.blob_store = StateBlobStore()
        self.trie = BlockTrie(block_tokens)
        scfg = self.slo_cfg = slo or SloConfig()
        self.sched = Scheduler(alpha=1 << 30, beta=1 << 30,
                               split_reads=split_reads,
                               class_aware=scfg.class_aware)
        # ``collective_group_size > 1`` puts model collectives on the
        # compute network and makes its clock charges contention-aware
        ncfg = net or NetworkConfig()
        self.time_model = ServingTimeModel.for_model(
            cfg, node, net_arbiter=ncfg.net_arbiter,
            collective_group_size=ncfg.collective_group_size)
        self.clock = VirtualClock()
        self.loop = EventLoop(self.clock)
        self.metrics: Dict[int, RoundMetrics] = {}
        self._online = False
        # node-local DRAM tiers over the store: reads they serve never
        # reach the store (= the storage NIC).  Their timestamps are the
        # modelled clock, so an agentic-ttl TTL means modelled seconds.
        tcfg = tier or TierConfig()
        self.tiers: Dict[int, DramTier] = {}
        if tcfg.dram_tier_bytes:
            for node_id in range(n_pe + n_de):
                t = DramTier(tcfg.dram_tier_bytes, policy=tcfg.tier_policy,
                             ttl_s=tcfg.tier_ttl_s, backing=self.store)
                # the DE persists through the plain store interface,
                # which passes no time: the tier asks the clock
                t.clock_fn = lambda: self.clock.now
                self.tiers[node_id] = t
        self.prefetcher = ThinkTimePrefetcher(tcfg.prefetch_chunk_blocks) \
            if (tcfg.prefetch and self.tiers) else None
        # engine groups: ``*_group_size`` engines per scheduler group
        # (default: one group spanning all engines of that kind)
        self.pes: Dict[Tuple[int, int], PrefillEngine] = {}
        self.des: Dict[Tuple[int, int], DecodeEngine] = {}
        self._layerwise = layerwise
        self._de_slots = de_slots
        pe_gsz = max(int(pe_group_size or n_pe), 1)
        de_gsz = max(int(de_group_size or n_de), 1)
        for i in range(n_pe):
            eid = (i, 0)
            self.sched.register_engine(eid, node=i, kind="pe",
                                       group=i // pe_gsz)
            self.pes[eid] = self._new_pe(eid)
        for j in range(n_de):
            eid = (n_pe + j, 0)
            st = self.sched.register_engine(eid, node=n_pe + j, kind="de",
                                            group=1000 + j // de_gsz)
            st.free_hbm_tokens = de_slots * max_seq
            self.des[eid] = self._new_de(eid)
        # elastic role flips: the controller and the drain tracker exist
        # when elastic is off too, so stats() always has their columns
        ecfg = elastic or ElasticConfig()
        if ecfg.drain_policy not in DRAIN_POLICIES:
            raise ValueError(f"unknown drain_policy {ecfg.drain_policy!r}")
        self.elastic = bool(ecfg)
        self.reconfig_interval_s = ecfg.reconfig_interval_s
        self.drain_policy = ecfg.drain_policy
        self.drains = DrainTracker()
        self.controller = PDController(
            hi=ecfg.reconfig_hi, lo=ecfg.reconfig_lo,
            patience=ecfg.reconfig_patience,
            cooldown_s=ecfg.reconfig_cooldown_s,
            idle_floor_s=ecfg.reconfig_idle_floor_s)
        self.engine_lifecycle: Dict[Tuple[int, int], EngineLifecycle] = {
            eid: EngineLifecycle.ACTIVE for eid in (*self.pes, *self.des)}
        self._next_gid = itertools.count(5000)
        self._next_obs_t = ecfg.reconfig_interval_s
        self._drain_rotation = 0
        self._reconfig_ready: List = []   # drained DrainRecords to flip
        self.reconfig_weight_bytes = 0.0
        self._rid = itertools.count()
        self._pending_admit: deque = deque()
        self._inflight: Dict[int, EngineRequest] = {}
        self._install_ready: List[EngineRequest] = []
        self._pd_queue: List[EngineRequest] = []
        # milestones are stamped after the tick's clock advance
        self._pending_stamps: List[Tuple[RoundMetrics, str]] = []
        self._tick_io = TickIo()
        self._tick_compute = 0.0
        # collective seconds per node's compute-NIC link this tick, and
        # the interference totals (zeros without collectives)
        self._tick_coll: Dict[int, float] = {}
        self.collective_stall_s = 0.0
        self.transfer_backlog_s = 0.0
        self.net_congestion = 0.0
        self._submit_seconds_seen = 0.0
        self.read_bytes_by_side = {"pe": 0, "de": 0}
        self.dram_bytes_by_side = {"pe": 0, "de": 0}
        self.n_split_reads = 0
        self.gen_tokens_done = 0
        # the SLO layer: no gate without admission (arrivals then go
        # straight to the scheduler); offline serving never consults it
        self.gate = AdmissionGate(scfg) if scfg.admission else None
        self.prefill_chunks = 0
        # fault injection: an empty schedule is normalised to None, so
        # every fault hook is a no-op on the happy path
        rcfg = resilience or ResilienceConfig()
        faults = rcfg.faults
        self.faults = faults if (faults is not None
                                 and not faults.empty) else None
        self.hedge_reads = rcfg.hedge_reads
        self.hedge_min_severity = rcfg.hedge_min_severity
        self._deaths_pending = list(self.faults.deaths) \
            if self.faults is not None else []
        self.dead_engines: List[Tuple[int, int]] = []
        self.recovered_rounds = 0
        self.hedged_reads = 0
        self.hedge_moved_tokens = 0
        # the flight recorder: lifecycle spans close at the end of the
        # tick (``_flush_stamps``), so span edges match the milestones
        self.tracer = tracer
        self._pending_states: List[Tuple[EngineRequest, ReqState]] = []
        if tracer is not None:
            tracer.bind_clock(lambda: self.clock.now)
            if self.faults is not None:
                tracer.annotate_faults(self.faults)
            self.sched.tracer = tracer
            self.controller.tracer = tracer
            for node_id, t in self.tiers.items():
                t.tracer = tracer
                t.track = f"tier/node{node_id}"
            for eng in (*self.pes.values(), *self.des.values()):
                eng.tm.tracer = tracer
                eng.tm.track = f"traffic/node{eng.eid[0]}"

    def _all_tms(self) -> Iterator[TrafficManager]:
        for pe in self.pes.values():
            yield pe.tm
        for de in self.des.values():
            yield de.tm

    # fault-aware service times: the schedule's multipliers compose onto
    # the healthy time model; with no faults the base value is returned
    def _snic_s(self, node: int, nbytes: float, rid: Optional[int] = None,
                side: Optional[str] = None) -> float:
        """Storage-NIC seconds on ``node``, slowed by any active window
        and, for the read leg ``(rid, side)``, by its straggler draw.
        Tier (DRAM) reads never come through here."""
        s = self.time_model.snic_seconds(nbytes)
        if self.faults is not None:
            s *= self.faults.snic_factor(node, self.clock.now)
            if rid is not None:
                s *= self.faults.leg_factor(rid, side)
        return s

    def _cn_s(self, nbytes: float) -> float:
        s = self.time_model.cn_seconds(nbytes)
        if self.faults is not None:
            s *= self.faults.net_factor(self.clock.now)
        return s

    # ------------------------------------------------------------------
    def _cache_hit(self, sess: AgentSession, prompt: List[int]):
        """(blob, hit tokens, hit FullBlock refs) of a round's prompt: the
        trie match, or for the SSM family the state blob of the
        session's exact context (reusable only there)."""
        if uses_state_blob(self.cfg):
            blob, hit = self.blob_store.get(sess.context)
            return blob, (hit if blob is not None else 0), []
        hit, refs = self.trie.match(prompt)
        return None, hit, refs

    def _submit_round(self, sess: AgentSession):
        rnd = sess.traj.rounds[sess.next_round]
        # host numpy draws, as the reference, so token streams compare
        # across the two packages
        append = list(sess.rng.integers(2, self.cfg.vocab_size,
                                        size=rnd.append))
        prompt = sess.context + append
        blob, hit, refs = self._cache_hit(sess, prompt)
        new_tokens = len(prompt) - hit
        if self.gate is not None and self._online:
            # the gate decides after the draws above, as the reference:
            # a deferred attempt draws a fresh append when it comes back
            read_s = self.time_model.snic_seconds(
                hit * self.layout.n_layers *
                self.layout.bytes_per_token_layer)
            prefill_s = self.time_model.pe_step_seconds(
                [(hit, max(new_tokens, 1))])
            verdict = self.gate.decide(
                (sess.traj.tid, sess.next_round),
                self.gate.ttft_estimate(self._elastic_signals(), read_s,
                                        prefill_s))
            if verdict == DEFER:
                self.loop.after(self.slo_cfg.admission_defer_s,
                                lambda s=sess: self._submit_round(s))
                return
            if verdict == REJECT:
                # load shedding: the session's trajectory ends here
                sess.next_round = sess.traj.n_rounds
                sess.current = None
                return
        req = Request(rid=next(self._rid), cached_tokens=hit,
                      new_tokens=new_tokens, gen_tokens=rnd.gen,
                      arrival=self.clock.now, slo_class=sess.traj.slo_class)
        er = EngineRequest(req=req, context_tokens=prompt[:hit],
                           append_tokens=prompt[hit:], hit_refs=refs,
                           blob=blob, session=sess,
                           lifecycle=ReqState.SCHEDULED)
        self._trace_submit(er)
        sess.current = er
        sess.next_round += 1
        self._inflight[req.rid] = er
        self.metrics[req.rid] = RoundMetrics(rid=req.rid, gen_tokens=rnd.gen,
                                             submit_t=self.clock.now,
                                             slo_class=sess.traj.slo_class)
        for tier in self.tiers.values():
            tier.note_alive(sess.traj.tid, now=self.clock.now)
        self.sched.submit(req)

    # ------------------------------------------------------------------
    # scheduling: group fetches + read-path decisions (tick phase 1)
    # ------------------------------------------------------------------
    def _fetch_groups(self):
        """Leader fetch for every group: DE groups first (HBM
        reservation), then PE groups, as in the simulator."""
        for gid, members in self.sched.groups("de").items():
            reports = {eid: (sum(s is not None for s in self.des[eid].slots),
                             sum(int(n) for n in self.des[eid].lengths),
                             0, self.des[eid].free_slots * self.max_seq)
                       for eid in members}
            self.sched.on_de_fetch(gid, reports)
        for gid, members in self.sched.groups("pe").items():
            reports = {eid: (len(self.pes[eid].fifo),
                             sum(w.remaining for w, _ in self.pes[eid].fifo),
                             0)
                       for eid in members}
            self.sched.on_pe_fetch(gid, reports)

    def _schedule_tick(self) -> int:
        self._fetch_groups()
        # decide every ready request's path first (read queues build up
        # across the batch of decisions), then read
        ready = []
        for er in list(self._inflight.values()):
            req = er.req
            if req.pe is None or req.de is None or req.read_path is not None:
                continue
            if self.mode == "basic":
                req.read_path = "pe"
                self.sched.engines[req.pe].read_q += req.cached_tokens
            else:
                tier_tokens = None
                bt = self.layout.block_tokens
                if self.tiers and er.hit_refs:
                    tier_tokens = {
                        side: self.tiers[eid[0]].resident_prefix(
                            er.hit_refs) * bt
                        for side, eid in (("pe", req.pe), ("de", req.de))}
                self.sched.choose_read_path(
                    req, tier_tokens=tier_tokens,
                    net_congestion=self.net_congestion)
                if self.hedge_reads and self.faults is not None:
                    self._maybe_hedge(req)
                if req.dram_tokens:
                    # pin the tier-resident prefix now: the reads of other
                    # ready requests admit (and may evict) blocks before
                    # this one's turn
                    node = (req.pe if req.dram_side == "pe" else req.de)[0]
                    prefix = er.hit_refs[:req.dram_tokens // bt]
                    self.tiers[node].pin(prefix)
                    er.tier_pinned = (node, prefix)
            ready.append(er)
        for er in ready:
            self._set_state(er, ReqState.READING)
            if self.pipelined:
                self._issue_read(er)
            else:
                self._do_read(er)
        return len(ready)

    def _maybe_hedge(self, req: Request) -> int:
        """Hedged split read: if one side's storage leg is degraded
        (straggler draw and/or an active slowdown window on its node)
        ``hedge_min_severity`` times or more against the other, move part
        of that side's share to the healthy side through
        ``Scheduler.rebalance_remainder`` before the legs are built.
        Tier-hit tokens never move."""
        toks = req.read_tokens_by_side()
        if not (toks["pe"] > 0 and toks["de"] > 0):
            return 0
        now = self.clock.now
        f = {s: self.faults.leg_factor(req.rid, s) *
             self.faults.snic_factor((req.pe if s == "pe" else req.de)[0],
                                     now)
             for s in ("pe", "de")}
        for slow, fast in (("pe", "de"), ("de", "pe")):
            if f[fast] <= 0 or f[slow] / f[fast] < self.hedge_min_severity:
                continue
            healthy = req.pe if fast == "pe" else req.de
            st = self.sched.engines.get(healthy)
            # backlog ahead of this request on the healthy NIC: its
            # reading queue less this request's own charge there
            backlog = max((st.read_q if st is not None else 0)
                          - toks[fast], 0)
            moved = self.sched.rebalance_remainder(
                req, slow, toks[slow], f[slow] / f[fast],
                healthy_backlog_tokens=backlog)
            if moved:
                self.hedged_reads += 1
                self.hedge_moved_tokens += moved
            return moved
        return 0

    # ------------------------------------------------------------------
    # the read, split into issue/complete halves
    # ------------------------------------------------------------------
    def _read_transfers(self, er: EngineRequest
                        ) -> List[Tuple[TrafficManager, callable, int]]:
        """Issue half of a read: store and tier accesses and byte
        accounting now; returns ``(tm, thunk, nbytes)`` descriptors whose
        execution models the bytes landing in the PE's buffers.  The hit
        FullBlocks split by page: the DRAM-tier prefix (if any) comes from
        its node's tier, then the PE side's storage reads, then the DE
        side's; only what the DE side reads crosses the compute network.
        With tiers, storage reads go through the reading node's tier
        (misses are admitted, stray resident blocks serve from DRAM)."""
        if uses_state_blob(self.cfg):
            return self._blob_transfers(er)
        req = er.req
        pe = self.pes[req.pe]
        de_tm = self.des[req.de].tm
        pe_node, de_node = req.pe[0], req.de[0]
        tmod = self.time_model
        out: List[Tuple[TrafficManager, callable, int]] = []
        n = len(er.hit_refs)
        tid = er.session.traj.tid
        part = req.hit_blocks_by_side(n)
        k_tier, k_pe = part["tier"], part["pe"]
        segs = [("tier", req.dram_side, er.hit_refs[:k_tier], 0),
                ("snic", "pe", er.hit_refs[k_tier:k_tier + k_pe], k_tier),
                ("snic", "de", er.hit_refs[k_tier + k_pe:], k_tier + k_pe)]
        # a split read means both storage NICs served this request
        if part["pe"] and part["de"]:
            self.n_split_reads += 1
        er.read_payload = [None] * n
        payload = er.read_payload
        for kind, side, refs, lo in segs:
            if not refs:
                continue
            node = pe_node if side == "pe" else de_node
            if kind == "tier":
                # pinned since the path decision: every ref is resident
                blocks = self.tiers[node].read_blocks(
                    refs, owner=tid, now=self.clock.now)
                hit_b = sum(b.nbytes for b in blocks)
                self.dram_bytes_by_side[side] += hit_b
                if hit_b and self.tracer is not None:
                    self.tracer.event(f"req/{req.rid}", "tier_hit",
                                      side=side, nbytes=hit_b)
                self._tick_io.add(("dram", node), tmod.dram_seconds(hit_b))
            elif node in self.tiers:
                tier = self.tiers[node]
                m0, h0 = tier.miss_bytes, tier.dram_hit_bytes
                blocks = tier.read_blocks(refs, owner=tid,
                                          now=self.clock.now)
                miss_b = tier.miss_bytes - m0
                hit_b = tier.dram_hit_bytes - h0
                self.read_bytes_by_side[side] += miss_b
                self.dram_bytes_by_side[side] += hit_b
                if self.tracer is not None:
                    if miss_b:
                        self.tracer.event(f"req/{req.rid}", "storage_read",
                                          side=side, nbytes=miss_b)
                    if hit_b:
                        self.tracer.event(f"req/{req.rid}", "tier_hit",
                                          side=side, nbytes=hit_b)
                self._tick_io.add(("snic", node),
                                  self._snic_s(node, miss_b, rid=req.rid,
                                               side=side))
                self._tick_io.add(("dram", node), tmod.dram_seconds(hit_b))
            else:
                blocks = self.store.read_blocks(refs)
                nb = sum(b.nbytes for b in blocks)
                self._tick_io.add(("snic", node),
                                  self._snic_s(node, nb, rid=req.rid,
                                               side=side))
                self.read_bytes_by_side[side] += nb
                if nb and self.tracer is not None:
                    self.tracer.event(f"req/{req.rid}", "storage_read",
                                      side=side, nbytes=nb)
            nbytes = sum(b.nbytes for b in blocks)
            out.append((pe.tm if side == "pe" else de_tm,
                        lambda blocks=blocks, lo=lo:
                        payload.__setitem__(slice(lo, lo + len(blocks)),
                                            blocks),
                        nbytes))
            if side == "de":
                # DE buffer -> PE over the compute network (layerwise)
                self._tick_io.add(("cn", pe_node), self._cn_s(nbytes))
                out.append((pe.tm, lambda: None, nbytes))
        if er.tier_pinned is not None:
            # the tier segment is copied out: the pin has done its job
            node, prefix = er.tier_pinned
            self.tiers[node].unpin(prefix)
            er.tier_pinned = None
        return out

    def _blob_transfers(self, er: EngineRequest
                        ) -> List[Tuple[TrafficManager, callable, int]]:
        """The read of an SSM state blob: one opaque snapshot, so it is
        not split and rides the side the path decision chose (over the
        compute network from the DE side)."""
        req = er.req
        side = req.read_path
        pe_node, de_node = req.pe[0], req.de[0]
        nbytes = len(er.blob) if er.blob is not None else 0
        self.read_bytes_by_side[side] += nbytes
        if nbytes and self.tracer is not None:
            self.tracer.event(f"req/{req.rid}", "storage_read", side=side,
                              nbytes=nbytes)
        er.read_payload = [None]
        node = pe_node if side == "pe" else de_node
        self._tick_io.add(("snic", node),
                          self._snic_s(node, nbytes, rid=req.rid, side=side))
        pe_tm = self.pes[req.pe].tm
        out = [(pe_tm if side == "pe" else self.des[req.de].tm,
                lambda: er.read_payload.__setitem__(0, er.blob), nbytes)]
        if side == "de":
            self._tick_io.add(("cn", pe_node), self._cn_s(nbytes))
            out.append((pe_tm, lambda: None, nbytes))
        return out

    def _do_read(self, er: EngineRequest):
        """Blocking read: every transfer drains inline."""
        for tm, fn, nbytes in self._read_transfers(er):
            tm.submit(fn, nbytes, TrafficClass.KV_TRANSFER)
            tm.drain()
        self._read_complete(er)

    def _issue_read(self, er: EngineRequest) -> int:
        """Pipelined read: submit every transfer and flush each involved
        TrafficManager once; the request becomes install-ready when all
        of them have landed at a poll."""
        transfers = self._read_transfers(er)
        by_tm: Dict[int, Tuple[TrafficManager, list]] = {}
        for tm, fn, nbytes in transfers:
            by_tm.setdefault(id(tm), (tm, []))[1].append((fn, nbytes))
        if not by_tm:
            self._install_ready.append(er)
            return 0
        pending = [len(by_tm)]

        def tm_done():
            pending[0] -= 1
            if pending[0] == 0:
                self._install_ready.append(er)

        for tm, items in by_tm.values():
            for fn, nbytes in items:
                tm.submit(fn, nbytes, TrafficClass.KV_TRANSFER)
            tm.flush(on_complete=tm_done)
        return len(transfers)

    def _read_complete(self, er: EngineRequest):
        """Completion half: release the read-queue charge and install the
        hit KV on the PE (layerwise, through the gather kernel)."""
        req = er.req
        self._release_read_q(req)
        self._stamp(req.rid, "read_done_t")
        self._set_state(er, ReqState.PREFILL)
        if uses_state_blob(self.cfg):
            self.pes[req.pe].install_hit_kv(er, er.read_payload[0])
        else:
            self.pes[req.pe].install_hit_kv(
                er, [b for b in er.read_payload if b is not None])

    def _release_read_q(self, req: Request):
        """Release exactly what the path decision charged (with
        ``split_reads`` the charge may span both sides)."""
        tokens = req.read_tokens_by_side()
        for side in ("pe", "de"):
            if tokens[side]:
                self.sched.on_read_done(req.pe if side == "pe" else req.de,
                                        tokens[side])

    # ------------------------------------------------------------------
    # engine phases
    # ------------------------------------------------------------------
    def _charge_collectives(self, node: int, tokens: int) -> None:
        """A step's model collectives over ``tokens`` land on the stepping
        node's compute-NIC link, where they contend with that link's KV
        traffic (``_apply_net_contention``)."""
        coll = self.time_model.collectives
        if coll is None or tokens <= 0:
            return
        self._tick_coll[node] = self._tick_coll.get(node, 0.0) + \
            self.time_model.collective_seconds(coll.step_bytes(tokens))

    def _step_pes(self) -> int:
        act = 0
        pe_max = 0.0
        for pe in self.pes.values():
            before = pe.prefill_tokens
            done = pe.step()
            pe_max = max(pe_max,
                         self.time_model.pe_step_seconds(pe.last_step_items))
            self._charge_collectives(
                pe.eid[0], sum(b for _, b in pe.last_step_items))
            act += (pe.prefill_tokens - before) + len(done)
            if self.slo_cfg.prefill_chunk_tokens is not None:
                # a capped slice ran and the round waits in the fifo for
                # its next; only with a cap, so unchunked runs keep the
                # PREFILL-only lifecycle
                for er in pe.last_step_chunked:
                    self.prefill_chunks += 1
                    if er.lifecycle != ReqState.PREFILL_CHUNKED:
                        self._set_state(er, ReqState.PREFILL_CHUNKED)
            for er in done:
                self.sched.on_request_done(er.req.pe, er.req)
                self._stamp(er.req.rid, "prefill_done_t")
                self._set_state(er, ReqState.PD_TRANSFER)
                self._queue_pd_transfer(er)
        self._tick_compute += pe_max
        return act

    def _queue_pd_transfer(self, er: EngineRequest):
        # PE -> DE prompt-state transfer, one submission per attention
        # layer (the byte count is the reference's: 2-byte KV)
        n_l = max(kvio.n_attn_layers(self.cfg), 1)
        nbytes = er.req.prompt_tokens * self.cfg.kv_bytes_per_token()
        de_tm = self.des[er.req.de].tm
        per_layer, rem = divmod(nbytes, n_l)
        for li in range(n_l):
            de_tm.submit(lambda: None,
                         per_layer + (rem if li == n_l - 1 else 0),
                         TrafficClass.KV_TRANSFER)
        self._tick_io.add(("cn", er.req.de[0]), self._cn_s(nbytes))
        if self.pipelined:
            self._pd_queue.append(er)
            de_tm.flush(on_complete=lambda er=er:
                        setattr(er, "pd_ready", True))
        else:
            de_tm.drain()
            self._pending_admit.append(er)

    def _collect_pd(self) -> int:
        """Move PD-complete requests to the admission queue in the order
        their prefills finished."""
        still: List[EngineRequest] = []
        n = 0
        for er in self._pd_queue:
            if er.cancelled:
                continue               # re-homed after an engine death
            if er.pd_ready:
                er.pd_ready = False
                self._pending_admit.append(er)
                n += 1
            else:
                still.append(er)
        self._pd_queue = still
        return n

    def _admit_pending(self) -> int:
        n = 0
        still = deque()
        while self._pending_admit:
            er = self._pending_admit.popleft()
            if er.cancelled:
                continue               # re-homed after an engine death
            de = self.des[er.req.de]
            if de.free_slots:
                self._set_state(er, ReqState.DECODE)
                de.admit(er)
                n += 1
            else:
                still.append(er)
        self._pending_admit = still
        return n

    def _step_des(self) -> int:
        act = 0
        de_max = 0.0
        for de in self.des.values():
            de_node = de.eid[0]
            active_before = [er for er in de.slots if er is not None]
            steps0 = de.decode_steps
            b0 = de.tm.bytes[TrafficClass.KV_TRANSFER]
            finished = de.step()
            de_max = max(de_max,
                         self.time_model.de_step_seconds(de.last_step_ctxs))
            self._charge_collectives(de_node, len(de.last_step_ctxs))
            act += (de.decode_steps - steps0) + len(finished)
            persist_b = de.tm.bytes[TrafficClass.KV_TRANSFER] - b0
            if persist_b and self.tracer is not None:
                self.tracer.event(f"engine/node{de_node}", "persist",
                                  nbytes=persist_b)
            self._tick_io.add(("snic", de_node),
                              self._snic_s(de_node, persist_b))
            for er in active_before:
                m = self.metrics[er.req.rid]
                if m.first_decode_t < 0:
                    self._stamp(er.req.rid, "first_decode_t")
                if len(er.generated) >= 2 and m.second_token_t < 0:
                    self._stamp(er.req.rid, "second_token_t")
            for er in finished:
                self.sched.on_request_done(er.req.de, er.req)
                self._stamp(er.req.rid, "done_t")
            if self.pipelined:
                pend, de.pending_persist = de.pending_persist, []
                if pend:
                    for er, _ in pend:
                        self._set_state(er, ReqState.PERSIST)

                    def persists_done(pend=pend):
                        for er, fin in pend:
                            if er.cancelled:
                                continue   # engine died; the round re-runs
                            if fin is not None:
                                fin()
                            self._finish_round(er)

                    de.tm.flush(on_complete=persists_done)
            else:
                for er in finished:
                    self._finish_round(er)
        self._tick_compute += de_max
        return act

    def _finish_round(self, er: EngineRequest):
        """Round completion (after the persist landed): the session's
        context rolls forward, tier warm-up and prefetch run, and the next
        round submits: at once offline, after its think gap online."""
        sess = er.session
        sess.context = er.context_tokens + er.append_tokens + er.generated
        sess.rounds_done += 1
        sess.current = None
        self._set_state(er, ReqState.DONE)
        self.gen_tokens_done += len(er.generated)
        del self._inflight[er.req.rid]
        if self.tiers:
            self._round_finished_tier(sess, er.req.de[0])
        if sess.next_round < sess.traj.n_rounds:
            think = sess.traj.rounds[sess.next_round].think
            if self._online and think > 0:
                self.loop.after(think, lambda s=sess: self._submit_round(s))
            else:
                self._submit_round(sess)

    def _round_finished_tier(self, sess: AgentSession, de_node: int):
        """Inter-round tier maintenance, at the start of the think gap.

        1. Warm the decode node's tier with the round's full context:
           those blocks just passed through that node's DRAM (the PD
           transfer in, the persists out), so admission moves no storage
           bytes (``store.peek``).
        2. Think-time prefetch: the next round's hit is the trie match of
           the current context; blocks that capacity pressure evicted are
           read back through the store (real storage-NIC bytes, paid in
           the idle gap)."""
        tid = sess.traj.tid
        tier = self.tiers[de_node]
        now = self.clock.now
        if uses_state_blob(self.cfg):
            return
        if sess.next_round >= sess.traj.n_rounds:
            # a finished trajectory is never hit again (§A.4)
            for t in self.tiers.values():
                t.note_done(tid)
            return
        _, refs = self.trie.match(sess.context)
        # tail first: the leading blocks end most recent, so LRU trims
        # the tail and the servable prefix survives
        for r in reversed(refs):
            tier.admit(r, self.layout.full_block_bytes, owner=tid,
                       payload=self.store.peek(r), now=now)
        if self.prefetcher is not None:
            for chunk in self.prefetcher.plan(tier, refs):
                for r in chunk:
                    tier.prefetch_block(r, owner=tid, now=now)

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------
    def _poll_all(self) -> int:
        """Complete every in-flight transfer (tick phase 4)."""
        n = 0
        progress = True
        while progress:
            progress = False
            for tm in self._all_tms():
                if tm.queued:
                    tm.flush()
                k = tm.poll()
                if k:
                    progress = True
                    n += k
        return n

    def _run_installs(self) -> int:
        """Install the hit KV of read-complete requests in rid order (the
        blocking runtime's install order)."""
        ready, self._install_ready = self._install_ready, []
        ready.sort(key=lambda er: er.req.rid)
        n = 0
        for er in ready:
            if er.cancelled:
                continue       # a re-homed request: charges already freed
            n += 1
            self._read_complete(er)
        return n

    def _set_state(self, er: EngineRequest, state: ReqState):
        """Every lifecycle transition after submission goes through here.
        With a tracer the previous state closes as a span on the
        request's track at the end of the tick (``_flush_stamps``)."""
        er.lifecycle = state
        if self.tracer is not None:
            self._pending_states.append((er, state))

    def _trace_submit(self, er: EngineRequest):
        """Open the lifecycle span chain at submission itself, so the
        first span starts at the metrics' ``submit_t``."""
        if self.tracer is not None:
            er.span_state = "scheduled"
            er.state_t0 = self.clock.now

    def _apply_net_contention(self) -> None:
        """Resolve this tick's KV-against-collective contention on each
        compute-NIC link (``network.drain_times``): the link's KV seconds
        grow to the contended completion (the growth adds to
        ``transfer_backlog_s``), and collectives finishing after their
        uncontended service stall the tick's compute
        (``collective_stall_s``; ~0 under 'vl', growing with KV load
        under 'fifo').  The collectives' share of all the links' traffic
        becomes the congestion the next tick's read-path choices and KV
        pacing read.  Without collectives nothing changes."""
        tot_coll = sum(self._tick_coll.values())
        tot_kv = 0.0
        for node, coll_s in self._tick_coll.items():
            if coll_s <= 0:
                continue
            kv_s = self._tick_io.buckets.get(("cn", node), 0.0)
            tot_kv += kv_s
            kv_done, coll_done = self.time_model.cn_drain(kv_s, coll_s)
            if kv_s > 0:
                self._tick_io.buckets[("cn", node)] = kv_done
            stall = max(0.0, coll_done - coll_s)
            self._tick_compute += stall
            self.collective_stall_s += stall
            self.transfer_backlog_s += max(0.0, kv_done - kv_s)
        tot = tot_coll + tot_kv
        self.net_congestion = (tot_coll / tot) if tot > 0 else 0.0
        for tm in self._all_tms():
            tm.net_congestion = self.net_congestion

    def _elastic_signals(self) -> LoadSignals:
        """The deployment's load in seconds of service per role, for the
        admission gate and the elastic controller."""
        sched = self.sched
        spec = self.time_model.spec
        node = self.time_model.node
        pe_rate = max(node.gpu.flops * node.gpu.mfu_prefill /
                      max(spec.linear_flops_per_token(), 1.0), 1.0)
        pe_queued = sum(r.new_tokens for r in sched.pe_queue)
        pe_busy = sum(w.remaining for pe in self.pes.values()
                      for w, _ in pe.fifo)
        de_busy_tok = 0
        n_active = 0
        ctxs: List[float] = []
        for de in self.des.values():
            for slot, er in enumerate(de.slots):
                if er is None:
                    continue
                n_active += 1
                de_busy_tok += er.req.gen_tokens - len(er.generated)
                ctxs.append(float(de.lengths[slot]))
        de_q_tok = 0
        for q in (sched.de_global_queue, *sched.de_private.values()):
            for r in q:
                de_q_tok += r.gen_tokens
                ctxs.append(float(r.prompt_tokens))
        n_ref = max(n_active / max(len(self.des), 1), 1.0)
        ctx_ref = (sum(ctxs) / len(ctxs)) if ctxs else 1.0
        kv_step = spec.decode_step_bytes(ctx_ref)
        w = spec.active_param_bytes_resident(1)
        de_rate = max(n_ref * node.gpu.hbm_bw * node.gpu.mbu_decode /
                      max(n_ref * kv_step + w, 1.0), 1.0)
        snic_tok_rate = max(node.snic_bw / max(spec.kv_bytes_per_token, 1),
                            1.0)
        pe_rq = sum(st.read_q for st in sched.admitting("pe"))
        de_rq = sum(st.read_q for st in sched.admitting("de"))
        dram_hit = sum(t.dram_hit_bytes for t in self.tiers.values())
        denom = dram_hit + sum(self.read_bytes_by_side.values())
        # interactive backlog, counted twice in the pressures; 0 unless
        # class-aware
        pe_q_int = de_q_int = 0.0
        if sched.class_aware:
            pe_q_int = sum(r.new_tokens for r in sched.pe_queue
                           if r.class_rank == 0) / pe_rate
            de_q_int = sum(r.gen_tokens
                           for q in (sched.de_global_queue,
                                     *sched.de_private.values())
                           for r in q if r.class_rank == 0) / de_rate
        return LoadSignals(
            n_pe=len(sched.admitting("pe")),
            n_de=len(sched.admitting("de")),
            pe_queued_s=pe_queued / pe_rate,
            pe_busy_s=pe_busy / pe_rate,
            de_queued_s=de_q_tok / de_rate,
            de_busy_s=de_busy_tok / de_rate,
            pe_read_q_s=pe_rq / snic_tok_rate,
            de_read_q_s=de_rq / snic_tok_rate,
            net_congestion=self.net_congestion,
            dram_hit_ratio=(dram_hit / denom) if denom else 0.0,
            pe_queued_interactive_s=pe_q_int,
            de_queued_interactive_s=de_q_int,
        )

    def _stamp(self, rid: int, field_name: str):
        """Defer a milestone to the end of the current tick, after the
        clock charges the tick's modelled seconds."""
        self._pending_stamps.append((self.metrics[rid], field_name))

    def _flush_stamps(self):
        now = self.clock.now
        for m, fld in self._pending_stamps:
            if getattr(m, fld) < 0:
                setattr(m, fld, now)
                if fld == "prefill_done_t" and self.tracer is not None:
                    # the TTFT endpoint (events.RoundMetrics.ttft)
                    self.tracer.event(f"req/{m.rid}", "first_token")
        self._pending_stamps = []
        for er, state in self._pending_states:
            prev = er.span_state
            t0 = er.state_t0 if er.state_t0 is not None else now
            if prev is not None and now > t0:
                self.tracer.span(f"req/{er.req.rid}", prev, t0, now)
            er.span_state = state.name.lower()
            er.state_t0 = now
        self._pending_states.clear()

    def _submit_overhead_delta(self) -> float:
        tot = sum(tm.submitted_seconds for tm in self._all_tms())
        d = tot - self._submit_seconds_seen
        self._submit_seconds_seen = tot
        return d

    # ------------------------------------------------------------------
    # elastic role flips (core/autoscale.py), driven by the tick loop
    # ------------------------------------------------------------------
    def _begin_reconfig(self, action: str):
        src = "de" if action == DE_TO_PE else "pe"
        cands = self.sched.admitting(src)
        if len(cands) <= 1:
            return

        def load_of(st):
            if st.kind == "de":
                de = self.des[st.engine]
                return st.tok + (de.n_slots - de.free_slots) * self.max_seq
            return st.tok + st.read_q

        victim = pick_victim(cands, self.drain_policy, load_of,
                             rotation=self._drain_rotation)
        self._drain_rotation += 1
        self.sched.begin_drain(victim.engine)
        self.sched.requeue_unstarted(
            victim.engine, [er.req for er in self._inflight.values()])
        self.engine_lifecycle[victim.engine] = EngineLifecycle.DRAINING
        self.drains.begin(victim.engine, src,
                          "pe" if src == "de" else "de", self.clock.now)

    def _engine_drained(self, eid: Tuple[int, int], kind: str) -> bool:
        """Has the draining engine's in-flight work emptied?  The
        scheduler's seq/tok gate covers its assigned requests; the engine
        checks cover work whose completion half is still parked (deferred
        persists, unflushed or unpolled transfers)."""
        if not self.sched.can_finish_drain(eid):
            return False
        if kind == "pe":
            pe = self.pes[eid]
            return not pe.fifo and not pe.tm.busy
        de = self.des[eid]
        return de.free_slots == de.n_slots and not de.pending_persist \
            and not de.tm.busy and \
            not any(er.req.de == eid for er in self._inflight.values())

    def _new_pe(self, eid) -> PrefillEngine:
        """A prefill engine under ``eid``, as the system starts them and
        as a DE->PE flip makes them."""
        return PrefillEngine(
            eid, self.cfg, self.params, self.max_seq,
            layerwise=self._layerwise,
            chunk_tokens=self.slo_cfg.prefill_chunk_tokens,
            class_aware=self.slo_cfg.class_aware, device=self.device)

    def _new_de(self, eid) -> DecodeEngine:
        """A decode engine under ``eid`` with a fresh decode state; it
        persists through its node's tier when there is one."""
        de = DecodeEngine(eid, self.cfg, self.params,
                          self.tiers.get(eid[0], self.store),
                          self.trie, self.layout, self.max_seq,
                          n_slots=self._de_slots, device=self.device,
                          blob_store=self.blob_store)
        de.defer_persist = self.pipelined
        return de

    def _finish_flip(self, rec):
        """Replace the drained engine by one of the other kind under the
        same id, in a new scheduler group.  A DE that leaves takes its
        decode state with it (nothing else holds the engine); a new DE
        allocates one.  The node's tier is kept: its resident bytes are
        the flip's tier handoff."""
        eid = rec.engine
        node_id = eid[0]
        gid = next(self._next_gid)
        tier = self.tiers.get(node_id)
        handoff = int(tier.used_bytes) if tier is not None else 0
        if rec.to_kind == "pe":
            del self.des[eid]
            self.pes[eid] = self._new_pe(eid)
            self.sched.finish_drain(eid, kind="pe", group=gid)
        else:
            del self.pes[eid]
            self.des[eid] = self._new_de(eid)
            self.sched.finish_drain(eid, kind="de", group=gid,
                                    free_hbm_tokens=self._de_slots *
                                    self.max_seq)
        # the DE-group topology changed: re-route queued requests
        self.sched.rebalance_de_private()
        self.engine_lifecycle[eid] = EngineLifecycle.ACTIVE
        rec = self.drains.finish(eid, self.clock.now,
                                 tier_handoff_bytes=handoff)
        if self.tracer is not None:
            eng = self.pes.get(eid) or self.des[eid]
            eng.tm.tracer = self.tracer
            eng.tm.track = f"traffic/node{eid[0]}"
            self.tracer.span(
                "reconfig", "drain", rec.t_begin, self.clock.now,
                engine=list(eid),
                direction=f"{rec.from_kind}->{rec.to_kind}")

    def _elastic_tick(self):
        """Phase 0 of an elastic tick: flip the engines whose weight
        reload was charged last tick, move drained engines to
        RECONFIGURING (charging the reload of one engine's weights to the
        node's storage NIC), then let the controller observe, once per
        ``reconfig_interval_s`` and only with no drain in progress."""
        for rec in self._reconfig_ready:
            self._finish_flip(rec)
        self._reconfig_ready = []
        for eid, rec in list(self.drains.active.items()):
            if rec.t_drained >= 0:
                continue
            if not self._engine_drained(eid, rec.from_kind):
                continue
            self.drains.mark_drained(eid, self.clock.now)
            self.engine_lifecycle[eid] = EngineLifecycle.RECONFIGURING
            w = self.time_model.spec.active_param_bytes_resident(1)
            self.reconfig_weight_bytes += w
            self._tick_io.add(("snic", eid[0]), self._snic_s(eid[0], w))
            self._reconfig_ready.append(rec)
        if self.clock.now >= self._next_obs_t:
            self._next_obs_t = self.clock.now + self.reconfig_interval_s
            if not self.drains.active and not self._reconfig_ready:
                action = self.controller.observe(self._elastic_signals(),
                                                 self.clock.now)
                if action is not None:
                    self._begin_reconfig(action)

    # ------------------------------------------------------------------
    # engine failure (sim/faults.EngineDeath): fail-stop and re-home
    # ------------------------------------------------------------------
    def _fault_tick(self):
        """Process every death whose time has come (before scheduling)."""
        while self._deaths_pending and \
                self._deaths_pending[0].t <= self.clock.now:
            d = self._deaths_pending.pop(0)
            self._engine_death(tuple(d.engine))

    def _engine_death(self, eid: Tuple[int, int]):
        """Fail-stop of engine ``eid``: a drain it was in is dropped (a
        death is not a role change), unstarted assignments go back to the
        queues whole, every round with state on the engine restarts from
        the persisted KV (the trie holds every block persisted before the
        death; blocks whose writes had not landed are persisted once by
        the recovery), and the engine leaves the scheduler so nothing
        routes to it."""
        if eid not in self.pes and eid not in self.des:
            return                     # already dead, or never existed
        self.dead_engines.append(eid)
        if self.tracer is not None:
            kind = "pe" if eid in self.pes else "de"
            self.tracer.event("faults/deaths", "engine_death",
                              engine=list(eid), kind=kind)
        self.drains.abort(eid)
        self._reconfig_ready = [r for r in self._reconfig_ready
                                if r.engine != eid]
        self.sched.requeue_unstarted(
            eid, [er.req for er in self._inflight.values()])
        # a PE's part ends once the prompt state left for the DE (the PD
        # transfer rides the DE's TrafficManager); a DE's lasts until the
        # round's persist lands
        for er in list(self._inflight.values()):
            req = er.req
            if req.de == eid or (req.pe == eid and er.lifecycle in _ON_PE):
                self._resubmit_round(er)
        self.sched.fail_engine(eid)
        self.pes.pop(eid, None)
        self.des.pop(eid, None)
        self.engine_lifecycle[eid] = EngineLifecycle.DEAD
        # the group topology changed: re-route queued DE requests
        self.sched.rebalance_de_private()

    def _resubmit_round(self, er: EngineRequest):
        """Cancel one re-homed round and restart it.  The old request is
        marked ``cancelled`` so every stale completion discards it; its
        scheduler charges are released by lifecycle state (the dead
        engine's own are forfeited).  A fresh request under a new rid
        restarts from the persisted prefix (the trie match of the same
        prompt, no fresh draw) and inherits the round's metrics (same
        ``submit_t``), so its latencies include the recovery.  Greedy
        decode regenerates the same tokens."""
        if er.cancelled:
            return
        er.cancelled = True
        req = er.req
        sess = er.session
        if er.tier_pinned is not None:
            node, prefix = er.tier_pinned
            self.tiers[node].unpin(prefix)
            er.tier_pinned = None
        lc = er.lifecycle
        if lc == ReqState.READING:
            # the read never completed: its whole charge is still held
            self._release_read_q(req)
        if lc in _ON_PE and req.pe is not None:
            self.sched.on_request_done(req.pe, req)
            pe = self.pes.get(req.pe)
            if pe is not None:
                pe.fifo = [(w, e) for (w, e) in pe.fifo if e is not er]
        if req.de is not None and (lc in _ON_PE or lc in (
                ReqState.PD_TRANSFER, ReqState.DECODE)):
            # the DE charge (seq, tok, HBM) is held from assignment until
            # decode finishes
            self.sched.on_request_done(req.de, req)
        del self._inflight[req.rid]
        prompt = er.context_tokens + er.append_tokens
        blob, hit, refs = self._cache_hit(sess, prompt)
        if hit >= len(prompt):         # keep >= 1 token to prefill
            hit = len(prompt) - 1
            refs = refs[:hit // self.layout.block_tokens]
        req2 = Request(rid=next(self._rid), cached_tokens=hit,
                       new_tokens=len(prompt) - hit,
                       gen_tokens=req.gen_tokens,
                       arrival=req.arrival,   # the original queue priority
                       slo_class=req.slo_class)
        er2 = EngineRequest(req=req2, context_tokens=prompt[:hit],
                            append_tokens=prompt[hit:], hit_refs=refs,
                            blob=blob, session=sess,
                            lifecycle=ReqState.SCHEDULED)
        self._trace_submit(er2)
        sess.current = er2
        self._inflight[req2.rid] = er2
        m = self.metrics.pop(req.rid)
        m.rid = req2.rid
        self.metrics[req2.rid] = m
        self.recovered_rounds += 1
        if self.tracer is not None:
            self.tracer.event(f"req/{req2.rid}", "recovered",
                              old_rid=req.rid, cached_tokens=hit)
        self.sched.submit(req2)

    def _tick(self) -> int:
        """One tick; returns an activity count (0 = idle)."""
        self._tick_io = TickIo()
        self._tick_compute = 0.0
        self._tick_coll = {}
        act = 0
        if self._deaths_pending:
            self._fault_tick()
        if self.elastic:
            self._elastic_tick()
        if self.pipelined:
            act += self._schedule_tick()     # 1. decide + issue reads
            act += self._step_pes()          # 2. prefill compute
            act += self._step_des()          # 3. decode compute
            act += self._poll_all()          # 4. transfer completions
            act += self._run_installs()      # 5. hit-KV installs
            self._collect_pd()
            act += self._admit_pending()     # 6. DE admissions
            self._apply_net_contention()
            dt = max(self._tick_io.parallel_seconds(), self._tick_compute)
        else:
            act += self._schedule_tick()
            act += self._step_pes()
            act += self._admit_pending()
            act += self._step_des()
            self._apply_net_contention()
            dt = self._tick_io.serial_seconds() + self._tick_compute
        self.clock.advance(dt + self._submit_overhead_delta())
        self._flush_stamps()
        if self.tracer is not None:
            self.tracer.counter("system/load", inflight=len(self._inflight))
        return act

    def run_offline(self, trajectories: List[Trajectory],
                    max_iters: int = 100000) -> List[AgentSession]:
        sessions = [AgentSession(t, np.random.default_rng(1000 + t.tid))
                    for t in trajectories]
        self._online = False
        for s in sessions:
            self._submit_round(s)
        for _ in range(max_iters):
            if all(s.done() for s in sessions):
                break
            self._tick()
        else:
            raise RuntimeError("serving system did not converge")
        return sessions

    def run_online(self, trajectories: List[Trajectory],
                   arrivals: List[float],
                   max_iters: int = 1000000) -> List[AgentSession]:
        """Online serving: trajectory i starts at ``arrivals[i]`` seconds
        on the modelled clock and each round waits its think gap
        (``Round.think``).  The clock jumps over idle gaps instead of
        sleeping, so a low arrival rate costs no real time."""
        if len(arrivals) != len(trajectories):
            raise ValueError("run_online needs one arrival per trajectory")
        sessions = [AgentSession(t, np.random.default_rng(1000 + t.tid))
                    for t in trajectories]
        self._online = True
        try:
            for s, t0 in zip(sessions, arrivals):
                self.loop.at(float(t0), lambda s=s: self._submit_round(s))
            # wake-ups at death times, so an idle clock jump never lands
            # past a death
            for d in self._deaths_pending:
                self.loop.at(float(d.t), lambda: None)
            for _ in range(max_iters):
                self.loop.fire_due()
                if all(s.done() for s in sessions) and not self.loop.pending:
                    break
                if self._tick() == 0:
                    nt = self.loop.next_time()
                    if nt is None:
                        raise RuntimeError(
                            "serving runtime stalled with no pending events")
                    self.clock.jump_to(nt)
            else:
                raise RuntimeError("serving system did not converge")
        finally:
            self._online = False
        return sessions

    def stats(self) -> dict:
        """The reference's ``stats()``, key for key (``wall_s`` and every
        other second is modelled), checked against the metric schema."""
        tiers = list(self.tiers.values())
        return conforming(dict(
            store_reads=self.store.bytes_read,
            store_writes=self.store.bytes_written,
            read_bytes_pe_side=self.read_bytes_by_side["pe"],
            read_bytes_de_side=self.read_bytes_by_side["de"],
            split_reads=self.n_split_reads,
            trie_blocks=self.trie.n_blocks,
            prefill_tokens=sum(p.prefill_tokens for p in self.pes.values()),
            decode_steps=sum(d.decode_steps for d in self.des.values()),
            gen_tokens=self.gen_tokens_done,
            wall_s=self.clock.now,
            doorbells=sum(tm.doorbells for tm in self._all_tms()),
            submitted_seconds=sum(tm.submitted_seconds
                                  for tm in self._all_tms()),
            # the compute network (zeros without collectives)
            collective_stall_s=self.collective_stall_s,
            transfer_backlog_s=self.transfer_backlog_s,
            net_congestion=self.net_congestion,
            paced_flushes=sum(tm.paced_flushes for tm in self._all_tms()),
            deferred_wrs=sum(tm.deferred_wrs for tm in self._all_tms()),
            **events.latency_summary(self.metrics.values()),
            # DRAM tiers (zeros without them)
            dram_hit_bytes=sum(t.dram_hit_bytes for t in tiers),
            dram_bytes_pe_side=self.dram_bytes_by_side["pe"],
            dram_bytes_de_side=self.dram_bytes_by_side["de"],
            tier_miss_bytes=sum(t.miss_bytes for t in tiers),
            tier_prefetch_bytes=sum(t.prefetch_bytes for t in tiers),
            tier_evicted_bytes=sum(t.evicted_bytes for t in tiers),
            # elastic role flips (zeros with elastic off)
            role_changes=self.drains.n_flips,
            role_changes_by_direction=self.drains.flips_by_direction(),
            reconfig_drain_s=self.drains.drain_seconds(),
            reconfig_weight_bytes=self.reconfig_weight_bytes,
            tier_handoff_bytes=self.drains.tier_handoff_bytes(),
            n_pe_final=len(self.pes),
            n_de_final=len(self.des),
            # faults and hedging (zeros without them)
            engine_deaths=len(self.dead_engines),
            recovered_rounds=self.recovered_rounds,
            hedged_reads=self.hedged_reads,
            hedge_moved_tokens=self.hedge_moved_tokens,
            # the SLO layer (without a gate every round was admitted)
            **(self.gate.counters() if self.gate is not None else dict(
                admitted_rounds=len(self.metrics), deferred_rounds=0,
                rejected_rounds=0)),
            prefill_chunks=self.prefill_chunks,
            latency_by_class=events.latency_by_class(self.metrics.values()),
        ), "serving")

    def slo_attainment(self, ttft_slo_s: float = 4.0,
                       tpot_slo_s: float = 0.050) -> float:
        """Fraction of finished rounds meeting both SLOs (paper §7.4
        defaults: TTFT ≤ 4 s, TPOT ≤ 50 ms, in modelled seconds)."""
        return events.slo_attainment(self.metrics.values(), ttft_slo_s,
                                     tpot_slo_s)
