"""Discrete-event cluster simulator for DualPath (port of
``repro.sim.simulator``).

It reproduces the paper's system-level claims (Fig. 7–15, Table 3) in
*modelled* time: network and storage bandwidth effects are modelled, with
the same scheduler (core/scheduler.py), the same loading plans
(core/loading.py) and the §4.2 closed form as cross-checks.  The
simulator does no device work, in the reference as here: ``Sim`` and
``VectorSim`` (sim/vectorized.py) run on the host in Python and numpy and
take no ``device=``.  Every JCT, TTFT and TPOT it reports is modelled
time, not a measurement of any card.

Model:
* per-node storage NIC — FIFO server (a disk read queue; its backlog in
  tokens is the scheduler's ``read_q`` signal);
* per-engine CNIC PCIe read/write sides, per-node DRAM, PE–DE network —
  processor-sharing resources (fair share among active legs; the
  network is a finite, VL-arbitered ``SharedLink`` when ``net_bw`` is
  set, infinite otherwise);
* engines — grouped (EP/DP unit); groups step in lockstep.  PE groups
  pack forward batches under the compute quota (core/intra.py); DE
  groups run continuous-batching decode in token blocks.

Request lifecycle (round of a trajectory):
  submit → (PE, DE) assignment + read-path choice → storage read (FIFO on
  the chosen side; with ``split_reads`` the hit is partitioned and BOTH
  sides' NICs serve the request concurrently) → PE prefill (chunks;
  layerwise streaming legs overlap as PS flows) → PD transfer complete →
  DE H2D → decode blocks → done → next round of the trajectory.

All legs come from ``core/loading.plan_for``, and every executed leg is
charged to ``RoundSim.charged`` per symbolic resource, so the sim's byte
accounting matches the plans to the byte.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import defaultdict, deque
from dataclasses import dataclass
from dataclasses import field as dc_field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.admission import AdmissionGate
from repro_torch.core.autoscale import (DE_TO_PE, DrainTracker,
                                        LoadSignals, PDController,
                                        pick_victim)
from repro_torch.core.config import (FLAT_FIELDS, ElasticConfig,
                                     NetworkConfig, ResilienceConfig,
                                     SloConfig, TierConfig)
from repro_torch.core.intra import (AttnTimeModel, PrefillWork,
                                    QuotaPacker, class_insert_index)
from repro_torch.core.loading import Leg, PLANS, plan_for
from repro_torch.core.scheduler import (Request, RoundRobinScheduler,
                                        Scheduler)
from repro_torch.core.traffic import TrafficClass
from repro_torch.kvcache.tiers import DramTier, ThinkTimePrefetcher
from repro_torch.network import CollectiveVolumeModel, SharedLink
from repro_torch.obs.schema import conforming
from repro_torch.sim.spec import ModelSimSpec, NodeSpec
from repro_torch.sim.traces import Trajectory

INF = float("inf")


# ---------------------------------------------------------------------------
# Event engine
# ---------------------------------------------------------------------------


class EventLoop:
    def __init__(self):
        self.now = 0.0
        self._heap: List[Tuple[float, int, Callable]] = []
        self._next_seq = 0
        self.n_events = 0   # processed events — the events/sec numerator

    def _take(self) -> int:
        s = self._next_seq
        self._next_seq = s + 1
        return s

    def reserve(self, n: int) -> int:
        """Consume ``n`` sequence numbers without pushing events.

        Same-timestamp events pop in seq order, so seq consumption IS
        the tie-break.  The vectorized engine (sim/vectorized.py)
        reserves one seq per pooled drain completion — the seqs the
        per-flow check events would have consumed — and pushes its
        single boundary event under the winner's seq, which keeps every
        same-instant ordering bit-identical to the per-object loop."""
        s = self._next_seq
        self._next_seq = s + n
        return s

    def at(self, t: float, fn: Callable):
        heapq.heappush(self._heap, (t, self._take(), fn))

    def after(self, dt: float, fn: Callable):
        self.at(self.now + dt, fn)

    def run(self, until: float = INF):
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            if t > until:
                self.now = until
                return
            self.now = t
            self.n_events += 1
            fn()


class PSResource:
    """Processor-sharing link: active flows share capacity equally."""

    __slots__ = ("name", "cap", "flows")

    def __init__(self, name: str, cap: float):
        self.name = name
        self.cap = cap
        self.flows: set = set()

    def rate_of(self, flow) -> float:
        """This flow's share: class-blind fair queuing.  SharedLink
        (repro_torch.network) overrides this with VL-arbitered shares."""
        return self.cap / max(len(self.flows), 1)


class Flow:
    """A transfer leg across one or more PS resources."""

    __slots__ = ("sim", "nbytes_left", "resources", "on_done", "rate",
                 "t_last", "version", "done", "tclass", "t_enter",
                 "nbytes_total", "fid")

    def __init__(self, sim: "Sim", nbytes: float, resources, on_done,
                 tclass: TrafficClass = TrafficClass.KV_TRANSFER):
        self.sim = sim
        self.fid = next(sim._flow_seq)
        self.nbytes_left = float(max(nbytes, 1.0))
        self.nbytes_total = self.nbytes_left
        self.resources = [r for r in resources if r is not None]
        self.on_done = on_done
        self.tclass = tclass
        self.rate = 0.0
        self.t_last = sim.loop.now
        self.t_enter = sim.loop.now
        self.version = 0
        self.done = False
        if not self.resources:
            sim.loop.after(0.0, self._finish)
            return
        for r in self.resources:
            note = getattr(r, "note_enter", None)
            if note is not None:
                note(self)
            r.flows.add(self)
        sim._reshare(self.resources)

    def _settle(self, now: float):
        if math.isinf(self.rate):
            # unbounded rate: served instantaneously (inf * 0 is nan,
            # so never enter it into the residual arithmetic)
            self.nbytes_left = 0.0
        else:
            self.nbytes_left -= self.rate * (now - self.t_last)
        self.t_last = now

    def _finish(self):
        if self.done:
            return
        self.done = True
        for r in self.resources:
            r.flows.discard(self)
            note = getattr(r, "note_done", None)
            if note is not None:
                note(self, self.sim.loop.now)
        if self.resources:
            self.sim._reshare(self.resources)
        self.on_done()

    def cancel(self):
        """Abandon the flow (fault recovery): detach from every resource
        and never fire ``on_done``.  Bytes already moved stay moved; the
        residual is simply lost with the dead engine."""
        if self.done:
            return
        self.done = True
        for r in self.resources:
            r.flows.discard(self)
            # drop arbiter caches without note_done's byte accounting
            # (the flow did not complete; counting its bytes would
            # overstate delivered traffic)
            inv = getattr(r, "_invalidate", None)
            if inv is not None:
                inv()
        if self.resources:
            self.sim._reshare(self.resources)


@dataclass
class SimConfig:
    """Simulator entry point: core fields and the five shared config
    groups of :mod:`repro_torch.core.config`, held by composition as in
    ``ServingSystem``.  Subsystem knobs live in the groups
    (``SimConfig(..., tier=TierConfig(dram_tier_bytes=1e9))``); the flat
    names of :data:`~repro_torch.core.config.FLAT_FIELDS` read and write
    them (``cfg.dram_tier_bytes``).  The reference's flat constructor
    keywords are not ported."""

    node: NodeSpec
    model: ModelSimSpec
    P: int
    D: int
    mode: str = "dualpath"            # dualpath | basic | oracle
    scheduler: str = "adaptive"       # adaptive | rr
    nodes_per_pe_group: Optional[int] = None   # default: all P nodes
    nodes_per_de_group: Optional[int] = None   # default: all D nodes
    quota_s: float = 0.300
    block_tokens: int = 64
    decode_block: int = 64
    kv_hbm_frac: float = 0.55         # fraction of HBM available for KV
    layerwise: bool = True            # layerwise prefill (ablation: False)
    alpha_read_s: float = 3.0         # §A.4: alpha = tokens readable in 3 s
    beta_compute_s: float = 5.0       # beta = tokens processed in 5 s
    split_reads: bool = False         # beyond-paper read splitting
    kv_dtype_bytes: int = 1           # fp8 KV (paper default)
    online: bool = False
    seed: int = 0
    # --- shared config groups (repro_torch.core.config) -----------------
    tier: TierConfig = dc_field(default_factory=TierConfig)
    net: NetworkConfig = dc_field(default_factory=NetworkConfig)
    elastic: ElasticConfig = dc_field(default_factory=ElasticConfig)
    resilience: ResilienceConfig = dc_field(default_factory=ResilienceConfig)
    slo: SloConfig = dc_field(default_factory=SloConfig)


# Flat-name read/write aliases: ``cfg.dram_tier_bytes`` etc. delegate to
# the owning group.  ``elastic`` is excluded: the attribute IS the
# ElasticConfig group, whose __bool__ reads its ``enabled`` switch.
def _flat_alias(grp: str, fld: str) -> property:
    return property(lambda self: getattr(getattr(self, grp), fld),
                    lambda self, v: setattr(getattr(self, grp), fld, v))


for _flat, (_grp, _fld) in FLAT_FIELDS.items():
    if _flat != "elastic" and not hasattr(SimConfig, _flat):
        setattr(SimConfig, _flat, _flat_alias(_grp, _fld))


class _EngineSim:
    __slots__ = ("eid", "node", "kind", "group", "fifo", "packer",
                 "active_decode", "resident_tokens", "kv_capacity_tokens",
                 "attn_sample")

    def __init__(self, eid, node, kind, group):
        self.eid = eid
        self.node = node
        self.kind = kind
        self.group = group
        self.fifo: List[PrefillWork] = []
        self.packer = None              # PEs only (set at init / role flip)
        self.active_decode: List["RoundSim"] = []
        self.resident_tokens = 0
        self.kv_capacity_tokens = 0
        self.attn_sample = 0.0


class RoundSim:
    """One round (request) of a trajectory moving through the system."""

    __slots__ = ("req", "traj", "round_idx", "agent", "submit_t", "read_done_t",
                 "prefill_done_t", "first_decode_t", "done_t", "transfer_done",
                 "prefill_left", "gen_left", "ctx", "h2d_done", "tokens_out",
                 "second_token_t", "charged", "read_legs", "tier_pinned",
                 "read_recs", "read_pending", "hedged", "flows",
                 "gen_total", "n_recoveries")

    def __init__(self, req: Request, traj: Trajectory, round_idx: int, agent):
        self.req = req
        self.traj = traj
        self.round_idx = round_idx
        self.agent = agent
        self.submit_t = 0.0
        self.read_done_t = -1.0
        self.prefill_done_t = -1.0
        self.first_decode_t = -1.0
        self.second_token_t = -1.0
        self.done_t = -1.0
        self.transfer_done = False
        self.h2d_done = False
        self.prefill_left = req.new_tokens
        self.gen_left = req.gen_tokens
        self.ctx = req.prompt_tokens
        self.tokens_out = 0
        # per-symbolic-resource bytes this round charged (load + layerwise
        # + decode_start legs) — must equal the loading-plan byte sums
        self.charged: Dict[str, int] = {}
        # storage legs: [side, nbytes, t_service_start, t_done] — split
        # reads have one entry per side, letting tests assert both NICs
        # served this request's load phase concurrently
        self.read_legs: List[list] = []
        # (node, refs) of DRAM-tier blocks pinned while this round is in
        # flight — unpinned at round completion
        self.tier_pinned = None
        # live per-storage-leg records ({"side","engine","entry","job",
        # "release","refs","done"}) while the load phase is in flight —
        # the handles hedging and fault recovery act on
        self.read_recs = None
        self.read_pending = None
        self.hedged = False
        # in-flight transfer/h2d Flows, cancellable on engine death
        self.flows: List[Flow] = []
        # gen_tokens of the ORIGINAL request: recovery resubmits with
        # only the remaining generation, so TPOT math needs the total
        self.gen_total = req.gen_tokens
        self.n_recoveries = 0

    def charge(self, leg: Leg):
        for r in leg.resources:
            self.charged[r] = self.charged.get(r, 0) + leg.nbytes


class AgentSim:
    __slots__ = ("traj", "next_round", "start_t", "end_t", "prefetch_pinned")

    def __init__(self, traj: Trajectory):
        self.traj = traj
        self.next_round = 0
        self.start_t = -1.0
        self.end_t = -1.0
        # (node, refs) leased by the think-time prefetcher until the next
        # round is submitted (staged blocks must survive to round start)
        self.prefetch_pinned = None


class Sim:
    def __init__(self, cfg: SimConfig, trajectories: List[Trajectory],
                 tracer=None):
        self.cfg = cfg
        self.loop = EventLoop()
        self.model = cfg.model
        self.node_spec = cfg.node
        g = cfg.node.g
        self.kv_per_token = self.model.kv_bytes_per_token
        # monotone Flow ids: _reshare resettles affected flows in fid
        # order so PS rate updates are independent of set iteration
        # order (chaos failures must reproduce from a seed alone)
        self._flow_seq = itertools.count()
        # empty schedules are normalised away so every fault hook stays
        # a structural no-op on the happy path (zero-fault identity)
        f = cfg.faults
        self.faults = f if (f is not None and not f.empty) else None
        # --- flight recorder (repro_torch.obs) -----------------------------
        # None by default: every hook below is guarded by `if tracer is
        # not None`, so an untraced run executes the untraced arithmetic.
        self.tracer = tracer
        # per-rid lifecycle timestamps (RoundSim has __slots__, so the
        # trace scratch lives here, keyed by rid)
        self._tr: Dict[int, dict] = {}
        if tracer is not None:
            tracer.bind_clock(lambda: self.loop.now)
            tracer.annotate_faults(self.faults)

        # --- resources -----------------------------------------------------
        self.snic: Dict[int, "_FifoNic"] = {}
        self.dram: Dict[int, PSResource] = {}
        self.cnic_rd: Dict[Tuple[int, int], PSResource] = {}
        self.cnic_wr: Dict[Tuple[int, int], PSResource] = {}
        # PE<->DE compute network: a finite, priority-arbitrated shared
        # link when cfg.net_bw is set (network.SharedLink); the
        # paper's no-congestion assumption (infinite capacity) otherwise
        self.net = SharedLink("net", cfg.net_bw if cfg.net_bw else INF,
                              arbiter=cfg.net_arbiter)
        n_nodes = cfg.P + cfg.D
        for n in range(n_nodes):
            self.snic[n] = _FifoNic(self, n, cfg.node.snic_bw)
            self.dram[n] = PSResource(f"dram{n}", cfg.node.dram_bw)
            for r in range(g):
                self.cnic_rd[(n, r)] = PSResource(f"cr{n}.{r}", cfg.node.cnic_bw)
                self.cnic_wr[(n, r)] = PSResource(f"cw{n}.{r}", cfg.node.cnic_bw)

        # --- node-local DRAM KV tier (capacity model; kvcache/tiers.py) ---
        # Refs are (trajectory id, block index); block bytes follow the
        # whole-block hit granularity the trie imposes.
        self.block_bytes = cfg.block_tokens * self.kv_per_token
        self.tiers: Dict[int, DramTier] = {}
        if cfg.dram_tier_bytes > 0 and self.block_bytes > 0:
            for n in range(n_nodes):
                self.tiers[n] = DramTier(cfg.dram_tier_bytes,
                                         policy=cfg.tier_policy,
                                         ttl_s=cfg.tier_ttl_s)
                self.tiers[n].clock_fn = lambda: self.loop.now
                if tracer is not None:
                    self.tiers[n].tracer = tracer
                    self.tiers[n].track = f"tier/node{n}"
        self.prefetcher = ThinkTimePrefetcher(cfg.prefetch_chunk_blocks) \
            if (cfg.prefetch and self.tiers) else None

        # --- engines / groups ----------------------------------------------
        npg = cfg.nodes_per_pe_group or cfg.P
        ndg = cfg.nodes_per_de_group or cfg.D
        self.engines: Dict[Tuple[int, int], _EngineSim] = {}
        self.pe_groups: Dict[int, List[_EngineSim]] = defaultdict(list)
        self.de_groups: Dict[int, List[_EngineSim]] = defaultdict(list)
        sched_cls = Scheduler if cfg.scheduler == "adaptive" else \
            RoundRobinScheduler
        alpha = int(cfg.alpha_read_s * cfg.node.snic_bw / max(self.kv_per_token, 1)) \
            if self.kv_per_token else 1 << 30
        tok_rate = cfg.node.gpu.flops * cfg.node.gpu.mfu_prefill / \
            max(self.model.linear_flops_per_token(), 1.0)
        beta = int(cfg.beta_compute_s * tok_rate)
        self.sched = sched_cls(alpha=alpha, beta=beta,
                               split_reads=cfg.split_reads,
                               class_aware=cfg.slo.class_aware)
        if tracer is not None:
            self.sched.tracer = tracer

        kv_cap_bytes = cfg.node.gpu.hbm_bytes * cfg.kv_hbm_frac
        kv_cap_tokens = int(kv_cap_bytes / max(self.kv_per_token, 1)) \
            if self.kv_per_token else 1 << 30
        self._kv_cap_tokens = kv_cap_tokens
        self._pe_tok_rate = max(tok_rate, 1.0)
        self._mk_packer = lambda: _SimPacker(
            self.model,
            AttnTimeModel(effective_flops=cfg.node.gpu.flops *
                          cfg.node.gpu.mfu_prefill),
            cfg.quota_s, chunk_tokens=cfg.slo.prefill_chunk_tokens)

        for n in range(cfg.P):
            grp = n // npg
            for r in range(g):
                e = _EngineSim((n, r), n, "pe", grp)
                tm = AttnTimeModel(effective_flops=cfg.node.gpu.flops *
                                   cfg.node.gpu.mfu_prefill)
                e.packer = _SimPacker(self.model, tm, cfg.quota_s,
                                      chunk_tokens=cfg.slo.prefill_chunk_tokens)
                self.engines[(n, r)] = e
                self.pe_groups[grp].append(e)
                self.sched.register_engine((n, r), node=n, kind="pe", group=grp)
        for dn in range(cfg.D):
            n = cfg.P + dn
            grp = 1000 + dn // ndg
            for r in range(g):
                e = _EngineSim((n, r), n, "de", grp)
                e.kv_capacity_tokens = kv_cap_tokens
                self.engines[(n, r)] = e
                self.de_groups[grp].append(e)
                st = self.sched.register_engine((n, r), node=n, kind="de",
                                                group=grp)
                st.free_hbm_tokens = kv_cap_tokens

        # engines-per-group for weight sharding in the compute model
        self.pe_group_size = npg * g
        self.de_group_size = ndg * g

        # --- model collectives on the shared link (repro_torch.network) ----
        collectives_on = cfg.model_collectives
        if collectives_on is None:
            collectives_on = cfg.net_bw is not None
        self._collectives_on = bool(collectives_on)
        if cfg.collective_bytes_per_token is not None:
            self.coll_model = CollectiveVolumeModel(
                cfg.collective_bytes_per_token, self.model.n_layers)
        else:
            self.coll_model = CollectiveVolumeModel.from_spec(
                self.model, max(self.pe_group_size, self.de_group_size),
                dtype_bytes=cfg.collective_dtype_bytes)
        self.collective_stall_s = 0.0     # step time lost waiting on colls

        # --- workload --------------------------------------------------------
        self.agents = [AgentSim(t) for t in trajectories]
        self.rounds: List[RoundSim] = []
        # rid -> RoundSim.  Recovery after an engine death resubmits a
        # round under a FRESH rid and unmaps the old one, so callbacks
        # captured against the dead incarnation (a prefill batch item in
        # a step barrier, a late NIC completion) resolve to None and are
        # dropped instead of corrupting the recovered round.
        self._by_rid: Dict[int, RoundSim] = {}
        self._rid = itertools.count()
        self._pe_stepping: Dict[int, bool] = {gid: False
                                              for gid in self.pe_groups}
        self._de_stepping: Dict[int, bool] = {gid: False
                                              for gid in self.de_groups}
        self._sched_pending = False

        # --- elastic role reconfiguration (core/autoscale.py) -------------
        if cfg.drain_policy not in ("idlest", "rotate"):
            raise ValueError(f"unknown drain_policy {cfg.drain_policy!r}")
        self.drains = DrainTracker()
        self.controller = PDController(
            hi=cfg.reconfig_hi, lo=cfg.reconfig_lo,
            patience=cfg.reconfig_patience,
            cooldown_s=cfg.reconfig_cooldown_s,
            idle_floor_s=cfg.reconfig_idle_floor_s,
            min_pe=cfg.elastic_min_pe, min_de=cfg.elastic_min_de)
        if tracer is not None:
            self.controller.tracer = tracer
        # role flips re-home the engine into a fresh singleton scheduler
        # group (groups are stepped in lockstep; a flipped engine shares
        # no step barrier with its old peers)
        self._next_gid = itertools.count(5000)
        self._drain_rotation = 0
        self.reconfig_weight_bytes = 0.0

        # --- metrics ---------------------------------------------------------
        self.snic_samples: List[Tuple[float, int, float]] = []  # (t, node, bytes)
        self.attn_balance: List[Tuple[float, float]] = []       # (t, max/avg)
        self.tps_samples: List[Tuple[float, int, int]] = []     # (t, prompt, gen)
        self.prompt_tokens_done = 0
        self.gen_tokens_done = 0
        self.snic_hit_read_bytes = 0   # demand hit bytes that paid a SNIC
        self.net_bg_bytes = 0          # injected background transfer bytes
        # --- faults / hedged reads / recovery ------------------------------
        self.dead_engines: List[Tuple[float, Tuple[int, int], str]] = []
        self.recovered_rounds = 0
        self.hedged_reads = 0
        self.hedge_moved_tokens = 0
        # --- online SLO layer (core/config.SloConfig) ----------------------
        # gate is None when admission control is off: arrivals then flow
        # straight to sched.submit, structurally identical to no SLO layer
        self.gate = AdmissionGate(cfg.slo) if cfg.slo.admission else None
        self.prefill_chunks = 0

    # ------------------------------------------------------------------
    # PS rate management
    # ------------------------------------------------------------------
    def _flow(self, nbytes, resources, on_done,
              tclass: TrafficClass = TrafficClass.KV_TRANSFER):
        """Flow factory: every PS transfer leg the sim launches goes
        through here, so the vectorized engine (sim/vectorized.py) can
        allocate into its struct-of-arrays drain pool by overriding one
        method instead of forking the request-lifecycle handlers."""
        return Flow(self, nbytes, resources, on_done, tclass)

    def _reshare(self, resources):
        now = self.loop.now
        affected = set()
        for r in resources:
            affected.update(r.flows)
        # A plain PS resource's share is class-blind (cap / n_flows) and
        # membership cannot change mid-sweep (finishes are deferred via
        # after(0.0)), so compute each resource's share once per sweep
        # instead of once per member flow.  SharedLink shares are
        # class-aware and stay on rate_of (it keeps its own caches).
        shares: Dict[int, float] = {}
        # resource flow-sets are unordered; resettle in creation order so
        # the event heap's tie-breaking (and thus every downstream
        # timestamp) is independent of set iteration order
        for f in sorted(affected, key=lambda f: f.fid):
            f._settle(now)
            new_rate = INF
            for r in f.resources:
                if type(r) is PSResource:
                    rate = shares.get(id(r))
                    if rate is None:
                        rate = shares[id(r)] = r.cap / max(len(r.flows), 1)
                else:
                    rate = r.rate_of(f)
                if rate < new_rate:
                    new_rate = rate
            f.rate = new_rate
            f.version += 1
            if f.nbytes_left <= 1.0 or math.isinf(new_rate):
                # sub-byte residual, or every resource unbounded (a flow
                # whose only resource is an infinite link — settling at
                # rate inf would produce inf*0 = nan residuals): done
                self.loop.after(0.0, f._finish)
            elif new_rate > 0:
                v = f.version
                eta = f.nbytes_left / new_rate
                self.loop.after(eta, lambda f=f, v=v: self._flow_check(f, v))

    def _flow_check(self, f: Flow, version: int):
        if f.done or f.version != version:
            return
        if math.isinf(f.rate):
            f._finish()
            return
        f._settle(self.loop.now)
        if f.nbytes_left <= 1.0:
            f._finish()
        else:
            # float drift: reschedule the residual instead of dropping it
            f.version += 1
            v = f.version
            eta = f.nbytes_left / max(f.rate, 1.0)
            self.loop.after(eta, lambda f=f, v=v: self._flow_check(f, v))

    # ------------------------------------------------------------------
    # run
    # ------------------------------------------------------------------
    def run(self, arrivals: Optional[List[float]] = None,
            until: float = INF):
        """arrivals: per-agent start times (None = all at t=0, offline)."""
        for i, a in enumerate(self.agents):
            t0 = 0.0 if arrivals is None else arrivals[i]
            self.loop.at(t0, lambda a=a: self._agent_start(a))
        cfg = self.cfg
        if cfg.net_bg_load > 0 and cfg.net_bw:
            # background transfer traffic on the shared link (other
            # tenants' dual-path reads / PD rebalancing): fixed-size KV
            # chunks offered at net_bg_load x net_bw, self-limiting once
            # the workload completes
            chunk = cfg.net_bg_chunk_bytes
            period = chunk / (cfg.net_bg_load * cfg.net_bw)

            def bg():
                if all(a.end_t >= 0 for a in self.agents):
                    return
                self.net_bg_bytes += chunk
                self._flow(chunk, [self.net], lambda: None)
                self.loop.after(period, bg)

            self.loop.after(period, bg)
        if cfg.elastic:
            self.loop.after(cfg.reconfig_interval_s, self._reconfig_tick)
        if self.faults is not None:
            for d in self.faults.deaths:
                self.loop.at(d.t,
                             lambda d=d: self._engine_death(tuple(d.engine)))
            # link flaps: the shared link's capacity changes at window
            # edges; every in-flight flow is resettled at each edge.
            # SNIC windows need no events (the FIFO server reads the
            # fault factor at each job's service start).
            if cfg.net_bw:
                base_cap = self.net.cap

                def flap(t):
                    self.net.cap = base_cap / self.faults.net_factor(t)
                    self.net._invalidate()
                    self._reshare([self.net])

                for t in self.faults.boundaries_array("net"):
                    t = float(t)
                    self.loop.at(t, lambda t=t: flap(t))
        self.loop.run(until)
        return self

    # ------------------------------------------------------------------
    # elastic control loop (core/autoscale.py)
    # ------------------------------------------------------------------
    def _workload_done(self) -> bool:
        return all(a.end_t >= 0 for a in self.agents)

    def _elastic_signals(self) -> LoadSignals:
        """One observation of the deployment, in seconds of service per
        role — built from the same state the scheduler and step loops
        already maintain (queue depths, FIFO backlogs, active decodes,
        disk reading queues, link congestion, tier hits)."""
        sched = self.sched
        gpu = self.cfg.node.gpu
        pe_queued = sum(r.new_tokens for r in sched.pe_queue)
        pe_busy = 0
        de_busy_tok = 0
        ctxs: List[int] = []
        for e in self.engines.values():
            if e.kind == "pe":
                pe_busy += sum(w.remaining for w in e.fifo)
            else:
                for r in e.active_decode:
                    de_busy_tok += r.gen_left
                    ctxs.append(r.ctx)
        de_q_tok = 0
        n_active = 0
        for e in self.engines.values():
            if e.kind == "de":
                n_active += len(e.active_decode)
        for q in (sched.de_global_queue, *sched.de_private.values()):
            for r in q:
                de_q_tok += r.gen_tokens
                ctxs.append(r.prompt_tokens)
        # continuous-batching decode rate per engine at the observed
        # batch size: n tokens advance per step of
        # (n * kv_step_bytes + weight_bytes) / effective HBM bandwidth —
        # the weight read amortises only across the actual batch, so
        # small batches are weight-bound (rate grows with n) and huge
        # ones kv-bound (rate saturates)
        n_de_now = max(sum(1 for e in self.engines.values()
                           if e.kind == "de"), 1)
        n_ref = max(n_active / n_de_now, 1.0)
        ctx_ref = (sum(ctxs) / len(ctxs)) if ctxs else 1.0
        kv_step = self.model.decode_step_bytes(ctx_ref)
        w = self.model.active_param_bytes_resident(self.de_group_size)
        de_rate = max(n_ref * gpu.hbm_bw * gpu.mbu_decode /
                      max(n_ref * kv_step + w, 1.0), 1.0)
        # disk reading backlogs, live from the per-node SNIC FIFOs (the
        # scheduler-side read_q copies go stale between fetches); one
        # count per (node, role) so multi-engine nodes aren't inflated
        snic_tok_rate = max(
            self.cfg.node.snic_bw / max(self.kv_per_token, 1), 1.0)
        pe_rq = de_rq = 0.0
        counted = set()
        for st in sched.engines.values():
            if st.draining:
                continue
            key = (st.node, st.kind)
            if key in counted:
                continue
            counted.add(key)
            q = self.snic[st.node].queued_bytes / max(self.kv_per_token, 1)
            if st.kind == "pe":
                pe_rq += q
            else:
                de_rq += q
        tiers = list(self.tiers.values())
        dram_hit = sum(t.dram_hit_bytes for t in tiers)
        denom = dram_hit + self.snic_hit_read_bytes
        # class signals: interactive share of the queued seconds, fed to
        # the elastic controller only under class-aware scheduling (both
        # stay 0.0 otherwise — class-blind pressures unchanged)
        pe_q_int = de_q_int = 0.0
        if sched.class_aware:
            pe_q_int = sum(r.new_tokens for r in sched.pe_queue
                           if r.class_rank == 0) / self._pe_tok_rate
            de_q_int = sum(r.gen_tokens
                           for q in (sched.de_global_queue,
                                     *sched.de_private.values())
                           for r in q if r.class_rank == 0) / de_rate
        return LoadSignals(
            n_pe=len(sched.admitting("pe")),
            n_de=len(sched.admitting("de")),
            pe_queued_s=pe_queued / self._pe_tok_rate,
            pe_busy_s=pe_busy / self._pe_tok_rate,
            de_queued_s=de_q_tok / de_rate,
            de_busy_s=de_busy_tok / de_rate,
            pe_read_q_s=pe_rq / snic_tok_rate,
            de_read_q_s=de_rq / snic_tok_rate,
            net_congestion=self.net.congestion(),
            dram_hit_ratio=(dram_hit / denom) if denom else 0.0,
            pe_queued_interactive_s=pe_q_int,
            de_queued_interactive_s=de_q_int,
        )

    def _reconfig_tick(self):
        if self._workload_done():
            return                      # let the event loop terminate
        self._advance_drains()
        if not self.drains.active:
            action = self.controller.observe(self._elastic_signals(),
                                             self.loop.now)
            if action is not None:
                self._begin_reconfig(action)
        self.loop.after(self.cfg.reconfig_interval_s, self._reconfig_tick)

    def _begin_reconfig(self, action: str):
        src = "de" if action == DE_TO_PE else "pe"
        floor = self.cfg.elastic_min_de if src == "de" \
            else self.cfg.elastic_min_pe
        cands = self.sched.admitting(src)
        if len(cands) <= floor:
            return

        def load_of(st):
            used_hbm = 0
            if st.kind == "de":
                used_hbm = self._kv_cap_tokens - st.free_hbm_tokens
            return st.tok + st.read_q + used_hbm

        victim = pick_victim(cands, self.cfg.drain_policy, load_of,
                             rotation=self._drain_rotation)
        self._drain_rotation += 1
        self.sched.begin_drain(victim.engine)
        # requests assigned to the victim whose read never started are
        # handed back for reassignment (the drain must not be hostage to
        # work blocked on the other role's capacity)
        back = self.sched.requeue_unstarted(
            victim.engine, [rs.req for rs in self.rounds if rs.done_t < 0])
        if src == "de":
            e = self.engines[victim.engine]
            for req in back:
                e.resident_tokens -= req.hbm_tokens
        self.drains.begin(victim.engine, src,
                          "pe" if src == "de" else "de", self.loop.now)
        if back:
            self._kick_scheduler()
        self.loop.after(min(self.cfg.reconfig_interval_s / 8.0, 1.0),
                        self._drain_poll)

    def _drain_poll(self):
        self._advance_drains()
        if self.drains.active:
            self.loop.after(min(self.cfg.reconfig_interval_s / 8.0, 1.0),
                            self._drain_poll)

    def _engine_busy(self, eid, kind) -> bool:
        """Ground-truth in-flight check for the drain gate.  The
        scheduler's seq/tok are overwritten by fetch reports derived
        from the engine FIFOs, which are EMPTY while a request's KV
        read is still in flight (PrefillWork enters the fifo only at
        _read_done) — so a PE gate must consult the rounds themselves,
        not just the report-refreshed counters.  DEs are covered by
        their reservation ledger: resident_tokens is held from
        assignment to decode completion."""
        e = self.engines[eid]
        if kind == "de":
            return bool(e.active_decode) or e.resident_tokens != 0
        return bool(e.fifo) or any(
            rs.req.pe == eid and rs.done_t < 0 and rs.prefill_done_t < 0
            for rs in self.rounds)

    def _advance_drains(self):
        """Second half of the drain protocol: once a draining engine's
        in-flight lifecycle states have emptied, reload the target
        role's weight shard over the node's storage NIC (it contends
        with real reads, as on hardware), then flip."""
        for eid, rec in list(self.drains.active.items()):
            if rec.t_drained >= 0:
                continue                # weight reload already in flight
            if not self.sched.can_finish_drain(eid) or \
                    self._engine_busy(eid, rec.from_kind):
                continue
            e = self.engines[eid]
            self.drains.mark_drained(eid, self.loop.now)
            # reload exactly the shard the sim's compute model has the
            # engine hold: _pe_step/_de_step shard weights by the
            # STATIC pe/de_group_size regardless of actual group
            # membership, so a flipped engine (singleton scheduler
            # group) still computes — and therefore reloads — 1/gsz of
            # the weights.  (serving's ServingTimeModel shards by 1, so
            # its flip charges active_param_bytes_resident(1) there.)
            gsz = self.pe_group_size if rec.to_kind == "pe" \
                else self.de_group_size
            w = self.model.active_param_bytes_resident(gsz)
            self.reconfig_weight_bytes += w
            self.snic[e.node].enqueue(
                w, lambda rec=rec: self._finish_flip(rec), read=True,
                tag="weights")

    def _finish_flip(self, rec):
        eid = rec.engine
        if eid not in self.engines or eid not in self.drains.active:
            return      # the engine died while its weight reload was queued
        e = self.engines[eid]
        groups = self.pe_groups if rec.from_kind == "pe" else self.de_groups
        groups[e.group].remove(e)
        if not groups[e.group]:
            del groups[e.group]
        gid = next(self._next_gid)
        tier = self.tiers.get(e.node)
        # tier-resident blocks stay with the node across the flip (the
        # DRAM tier is node-local and role-agnostic): the handoff is
        # accounting, not movement
        handoff = int(tier.used_bytes) if tier is not None else 0
        e.kind, e.group = rec.to_kind, gid
        if rec.to_kind == "pe":
            if e.packer is None:
                e.packer = self._mk_packer()
            e.resident_tokens = 0
            self.pe_groups[gid].append(e)
            self._pe_stepping.setdefault(gid, False)
            self.sched.finish_drain(eid, kind="pe", group=gid)
        else:
            e.kv_capacity_tokens = self._kv_cap_tokens
            self.de_groups[gid].append(e)
            self._de_stepping.setdefault(gid, False)
            self.sched.finish_drain(eid, kind="de", group=gid,
                                    free_hbm_tokens=self._kv_cap_tokens)
        # the DE group topology changed: re-route queued requests
        # against it (requests parked in an old group's private queue
        # would otherwise never see the new group)
        self.sched.rebalance_de_private()
        self.drains.finish(eid, self.loop.now, tier_handoff_bytes=handoff)
        if self.tracer is not None:
            self.tracer.span(
                "reconfig", "drain", rec.t_begin, self.loop.now,
                engine=list(eid),
                direction=f"{rec.from_kind}->{rec.to_kind}")
        self._kick_scheduler()
        if rec.to_kind == "pe":
            self._wake_pe_group(gid)
        else:
            self._wake_de_group(gid)

    # ------------------------------------------------------------------
    # engine death & request recovery (sim/faults.py)
    # ------------------------------------------------------------------
    def _engine_death(self, eid):
        """Fail-stop of one engine (role backfill).  The
        engine's unstarted assignments are handed back via the drain
        machinery, its in-flight rounds are recovered (prefill restarts
        from persisted whole-block KV, decode resumes from the trie),
        and the engine leaves the scheduler and topology.  Backfill is
        controller-driven: the dead engine drops out of the admitting
        sets the elastic LoadSignals count, so the resulting pressure
        shift makes the PDController propose a compensating flip."""
        e = self.engines.get(eid)
        if e is None or eid not in self.sched.engines:
            return                       # unknown or already dead
        kind = e.kind
        self.dead_engines.append((self.loop.now, eid, kind))
        if self.tracer is not None:
            self.tracer.event("faults/deaths", "engine_death",
                              engine=list(eid), kind=kind)
        # a victim dying mid-drain: the flip it was draining for is off
        if eid in self.drains.active:
            self.drains.abort(eid)
        # 1. assignments whose read never started are cheap: hand them
        # back for reassignment exactly like a drain does
        back = self.sched.requeue_unstarted(
            eid, [rs.req for rs in self.rounds if rs.done_t < 0])
        if kind == "de":
            for req in back:
                e.resident_tokens -= req.hbm_tokens
        # 2. started rounds that still depend on the engine are
        # recovered.  A PE's involvement ends once prefill AND the PD
        # transfer are done; a DE's only at round completion.
        for rs in self.rounds:
            if rs.done_t >= 0 or rs.req.read_path is None:
                continue
            req = rs.req
            lost = (req.de == eid) or (
                req.pe == eid and (rs.prefill_done_t < 0
                                   or not rs.transfer_done))
            if lost:
                self._recover_round(rs)
        # 3. drop the engine from the scheduler and the step topology
        self.sched.fail_engine(eid)
        groups = self.pe_groups if kind == "pe" else self.de_groups
        members = groups.get(e.group)
        if members and e in members:
            members.remove(e)
            if not members:
                del groups[e.group]
        del self.engines[eid]
        self.sched.rebalance_de_private()
        self._kick_scheduler()

    def _recover_round(self, rs: RoundSim):
        """Re-home one in-flight round after an engine death.

        Cancels everything physical (NIC read jobs, transfer flows),
        releases every hold the incarnation took (read_q, engine
        seq/tok/HBM reservations, tier pins), then resubmits the round
        under a fresh rid: whole blocks of context persisted so far —
        prompt AND generated — are cached (exactly what the trie would
        match), the tail re-prefills, and the remaining generation
        re-decodes.  Timing milestones already reached stay: TTFT/TPOT
        honestly include the recovery gap, which is what the SLO
        regression fixtures pin."""
        req = rs.req
        # (a) outstanding storage reads: abort, release read_q charge
        if rs.read_recs:
            for rec in rs.read_recs:
                if rec["done"]:
                    continue
                rec["done"] = True
                if rec["job"] is not None:
                    self.snic[rec["engine"][0]].abort(rec["job"])
                self.sched.on_read_done(rec["engine"], rec["release"])
        rs.read_recs = None
        rs.read_pending = None
        # (b) in-flight transfer / h2d flows die with the data
        for f in rs.flows:
            f.cancel()
        rs.flows = []
        # (c) engine-side holds (the dead engine's state is still
        # registered at this point; its releases are simply forfeited
        # when fail_engine removes it moments later)
        if req.pe is not None:
            if rs.prefill_done_t < 0:
                self.sched.on_request_done(req.pe, req)
            pe = self.engines.get(req.pe)
            if pe is not None:
                pe.fifo = [w for w in pe.fifo if w.rid != req.rid]
        if req.de is not None:
            de = self.engines.get(req.de)
            if de is not None:
                if rs in de.active_decode:
                    de.active_decode.remove(rs)
                de.resident_tokens -= req.hbm_tokens
            self.sched.on_request_done(req.de, req)
        # (d) tier pins from the dead incarnation
        if rs.tier_pinned is not None:
            node, refs = rs.tier_pinned
            tier = self.tiers.get(node)
            if tier is not None:
                tier.unpin(refs)
            rs.tier_pinned = None
        # (e) resubmit: persisted whole blocks (prompt + generated) are
        # the new hit; keep the ORIGINAL arrival so the round does not
        # lose its place in arrival-ordered queues
        bt = self.cfg.block_tokens
        ctx = req.prompt_tokens + rs.tokens_out
        cached = (ctx // bt) * bt
        new_req = Request(rid=next(self._rid), cached_tokens=cached,
                          new_tokens=max(ctx - cached, 1),
                          gen_tokens=max(rs.gen_left, 1),
                          arrival=req.arrival, slo_class=req.slo_class)
        del self._by_rid[req.rid]
        self._by_rid[new_req.rid] = rs
        new_req._sim_round = rs
        rs.req = new_req
        # accounting restarts for the new incarnation (NIC counters keep
        # the bytes the dead one physically moved)
        rs.charged = {}
        rs.read_legs = []
        rs.read_done_t = -1.0
        rs.transfer_done = False
        rs.h2d_done = False
        rs.hedged = False
        rs.prefill_left = new_req.new_tokens
        rs.gen_left = new_req.gen_tokens
        rs.ctx = new_req.prompt_tokens
        rs.n_recoveries += 1
        self.recovered_rounds += 1
        if self.tracer is not None:
            self.tracer.event(f"req/{new_req.rid}", "recovered",
                              old_rid=req.rid,
                              cached_tokens=new_req.cached_tokens)
        self.sched.submit(new_req)

    # ------------------------------------------------------------------
    # agent / request lifecycle
    # ------------------------------------------------------------------
    def _agent_start(self, agent: AgentSim):
        agent.start_t = self.loop.now
        self._submit_round(agent)

    def _submit_round(self, agent: AgentSim):
        if agent.prefetch_pinned is not None:
            # the prefetcher's lease ends at submission: the round's own
            # in-flight pin (taken at read start) protects what it uses
            node, refs = agent.prefetch_pinned
            self.tiers[node].unpin(refs)
            agent.prefetch_pinned = None
        i = agent.next_round
        traj = agent.traj
        if i >= traj.n_rounds:
            agent.end_t = self.loop.now
            return
        rnd = traj.rounds[i]
        cached = traj.context_before(i)
        # whole-block hits only (trie granularity)
        bt = self.cfg.block_tokens
        cached_blocks = (cached // bt) * bt
        new_tokens = rnd.append + (cached - cached_blocks)
        if self.gate is not None:
            # load-aware admission (core/admission.py): queueing-delay-
            # aware TTFT estimate from the elastic controller's signals
            # plus this arrival's own read + prefill service time
            sig = self._elastic_signals()
            read_s = cached_blocks * self.kv_per_token / \
                max(self.cfg.node.snic_bw, 1.0)
            prefill_s = max(new_tokens, 1) / self._pe_tok_rate
            verdict = self.gate.decide(
                (traj.tid, i), self.gate.ttft_estimate(sig, read_s,
                                                       prefill_s))
            if verdict == "defer":
                self.loop.after(self.cfg.slo.admission_defer_s,
                                lambda a=agent: self._submit_round(a))
                return
            if verdict == "reject":
                # shed the load: the client's trajectory ends here
                # rather than holding queue slots it cannot meet SLO in
                agent.end_t = self.loop.now
                return
        req = Request(rid=next(self._rid), cached_tokens=cached_blocks,
                      new_tokens=max(new_tokens, 1), gen_tokens=rnd.gen,
                      arrival=self.loop.now, slo_class=traj.slo_class)
        rs = RoundSim(req, traj, i, agent)
        rs.submit_t = self.loop.now
        self.rounds.append(rs)
        self._by_rid[req.rid] = rs
        rs.req._sim_round = rs          # backref
        for tier in self.tiers.values():
            tier.note_alive(traj.tid, now=self.loop.now)
        self.sched.submit(req)
        self._kick_scheduler()

    def _kick_scheduler(self):
        if self._sched_pending:
            return
        self._sched_pending = True
        self.loop.after(1e-4, self._sched_tick)

    def _sched_tick(self):
        self._sched_pending = False
        kvpt = self.kv_per_token
        # DE admission first (HBM reservation), then PE assignment.
        # Reports are built with explicit integer loops: the generator
        # version spent more time in frame switches than in the adds
        # once fleets grew past a few hundred standing decodes.
        for gid, members in self.de_groups.items():
            if not self.sched.de_private.get(gid) and \
                    not self.sched.de_global_queue:
                continue
            reports = {}
            for e in members:
                tok = 0
                for r in e.active_decode:
                    tok += r.ctx + r.gen_left
                reports[e.eid] = (len(e.active_decode), tok,
                                  self.snic[e.node].queue_tokens(kvpt),
                                  e.kv_capacity_tokens - e.resident_tokens)
            for asg in self.sched.on_de_fetch(gid, reports):
                rs = asg.request._sim_round
                e = self.engines[asg.engine]
                e.resident_tokens += asg.request.hbm_tokens
                self._maybe_start_read(rs)
        for gid, members in self.pe_groups.items():
            if not self.sched.pe_queue:
                break
            reports = {}
            for e in members:
                rem = 0
                for w in e.fifo:
                    rem += w.remaining
                reports[e.eid] = (len(e.fifo), rem,
                                  self.snic[e.node].queue_tokens(kvpt))
            for asg in self.sched.on_pe_fetch(gid, reports):
                self._maybe_start_read(asg.request._sim_round)

    def _maybe_start_read(self, rs: RoundSim):
        req = rs.req
        if req.pe is None or req.de is None or req.read_path is not None:
            return
        if self.cfg.mode == "oracle":
            req.read_path = "pe"
            self._read_done(rs)
            return
        bt = self.cfg.block_tokens
        hit_refs = [(rs.traj.tid, b) for b in range(req.cached_tokens // bt)]
        if self.cfg.mode == "basic":
            req.read_path = "pe"
            self.sched.engines[req.pe].read_q += req.cached_tokens
        else:
            tier_tokens = None
            if self.tiers and hit_refs:
                tier_tokens = {
                    "pe": self.tiers[req.pe[0]].resident_prefix(hit_refs) * bt,
                    "de": self.tiers[req.de[0]].resident_prefix(hit_refs) * bt,
                }
            self.sched.choose_read_path(
                req, tier_tokens=tier_tokens,
                net_congestion=self.net.congestion())
            if req.dram_tokens:
                # serve the resident prefix from the tier side's DRAM and
                # pin it for the round (in-flight blocks never evicted)
                node = (req.pe if req.dram_side == "pe" else req.de)[0]
                prefix = hit_refs[:req.dram_tokens // bt]
                self.tiers[node].serve(prefix, now=self.loop.now)
                self.tiers[node].pin(prefix)
                rs.tier_pinned = (node, prefix)
        load_legs = [leg for leg in self._request_legs(req)
                     if leg.phase == "load" and leg.nbytes > 0]
        # tier-hit legs move no new bytes (the data already sits in that
        # node's DRAM buffer): charge the accounting resource and drop
        # them from the SNIC work list
        snic_legs = []
        for leg in load_legs:
            if leg.name.endswith("_tier_hit"):
                rs.charge(leg)
            else:
                snic_legs.append(leg)
        # block-granular admission sets per side: the SNIC-read blocks
        # warm the reading node's tier when one is configured
        admit_refs = {"pe": [], "de": []}
        tokens = req.read_tokens_by_side()
        if self.tiers and hit_refs:
            part = req.hit_blocks_by_side(len(hit_refs))
            lo = part["tier"]
            admit_refs["pe"] = hit_refs[lo:lo + part["pe"]]
            admit_refs["de"] = hit_refs[lo + part["pe"]:]
        # an SSM/hybrid state blob is one opaque snapshot — it cannot be
        # partitioned, so it rides the majority side's storage NIC
        extra = self.model.ssm_state_bytes
        major = "pe" if req.pe_read_frac >= 0.5 else "de"
        rid = req.rid
        rs.read_recs = []
        if not snic_legs:
            # no SNIC bytes to read (pure-SSM models, or the whole hit
            # was served from the DRAM tier): release the read_q charge
            # on both sides, then complete (after the blob read, if any)
            for side, engine in (("pe", req.pe), ("de", req.de)):
                if tokens[side]:
                    rs.read_recs.append(
                        {"side": side, "engine": engine, "entry": None,
                         "refs": [], "release": tokens[side],
                         "done": False, "job": None})

            def finish(rs=rs):
                if rs.req.rid != rid:
                    return              # round re-homed after a death
                for rec in rs.read_recs:
                    if not rec["done"]:
                        rec["done"] = True
                        self.sched.on_read_done(rec["engine"],
                                                rec["release"])
                self._read_done(rs)

            if extra > 0:
                node = (req.pe if major == "pe" else req.de)[0]
                brec = {"side": major,
                        "engine": req.pe if major == "pe" else req.de,
                        "entry": None, "refs": [], "release": 0,
                        "done": False, "job": None}
                rs.read_recs.append(brec)
                brec["job"] = self.snic[node].enqueue(
                    extra, finish, tag="blob", rank=self._read_rank(req))
                return
            finish()
            return
        leg_sides = {("pe" if "pe_snic" in leg.resources else "de")
                     for leg in snic_legs}
        # the blob rides the majority side's SNIC; when the tier served
        # that side's whole hit there is no leg to piggyback on, so it
        # gets its own FIFO entry (its bytes must never vanish)
        blob_alone = extra > 0 and major not in leg_sides
        rs.read_pending = [len(snic_legs) + (1 if blob_alone else 0)]

        if blob_alone:
            node = (req.pe if major == "pe" else req.de)[0]
            brec = {"side": major,
                    "engine": req.pe if major == "pe" else req.de,
                    "entry": None, "refs": [], "release": 0,
                    "done": False, "job": None}
            rs.read_recs.append(brec)
            brec["job"] = self.snic[node].enqueue(
                extra, lambda: self._read_leg_done(rs, brec), tag="blob",
                rank=self._read_rank(req))
        for leg in snic_legs:
            side = "pe" if "pe_snic" in leg.resources else "de"
            engine = req.pe if side == "pe" else req.de
            nbytes = leg.nbytes + \
                (extra if side == major and not blob_alone else 0)
            rs.charge(leg)
            self.snic_hit_read_bytes += leg.nbytes
            entry = [side, nbytes, -1.0, -1.0]
            rs.read_legs.append(entry)
            rec = {"side": side, "engine": engine, "entry": entry,
                   "refs": admit_refs[side], "release": tokens[side],
                   "done": False, "job": None}
            rs.read_recs.append(rec)
            rec["job"] = self.snic[engine[0]].enqueue(
                nbytes, lambda rec=rec: self._read_leg_done(rs, rec),
                read=True,
                on_start=lambda t, entry=entry: entry.__setitem__(2, t),
                factor=(self.faults.leg_factor(rid, side)
                        if self.faults is not None else 1.0),
                rank=self._read_rank(req))
        if extra > 0:
            rs.hedged = True    # opaque blob rides a leg: byte-exact
            #                     remainder accounting impossible
        elif (self.cfg.hedge_reads and self.faults is not None
                and self.cfg.mode == "dualpath"):
            # timer covers the single-leg case, where no sibling
            # completion event re-evaluates the straggler
            self.loop.after(self.cfg.hedge_threshold_s,
                            lambda: self._maybe_hedge(rs, rid))

    def _read_leg_done(self, rs: RoundSim, rec: dict):
        """One storage leg landed: release its read_q charge, warm the
        reading node's tier with its blocks, and complete the load phase
        once every leg (original or hedged remainder) is in."""
        rec["done"] = True
        if rec["entry"] is not None:
            rec["entry"][3] = self.loop.now
            if self.tracer is not None and rec["entry"][2] >= 0:
                e = rec["entry"]
                self.tracer.span(f"req/{rs.req.rid}", "read_leg",
                                 e[2], e[3], side=e[0], nbytes=e[1])
        self.sched.on_read_done(rec["engine"], rec["release"])
        tier = self.tiers.get(rec["engine"][0])
        if tier is not None:
            now = self.loop.now
            for ref in rec["refs"]:
                tier.admit(ref, self.block_bytes, owner=rs.traj.tid,
                           now=now)
        rs.read_pending[0] -= 1
        if rs.read_pending[0] == 0:
            self._read_done(rs)
        elif self.cfg.hedge_reads:
            # a sibling leg is still out: the classic hedge moment
            self._maybe_hedge(rs, rs.req.rid)

    def _maybe_hedge(self, rs: RoundSim, rid: int):
        """Hedged split reads: when exactly one storage leg
        is still in flight and it is *fault-slowed* relative to the
        healthy side (observed service-time factors, not queue depth —
        issue-time water-filling already balanced load), re-water-fill
        the unserved remainder onto the healthy side's NIC.

        Byte-exact by construction: the straggling FIFO job is shrunk
        by exactly the moved bytes, a new job for exactly those bytes is
        enqueued on the healthy NIC, and Scheduler.rebalance_remainder
        moves the same tokens between the authoritative per-side
        partition and the read_q charges.  Tier-hit bytes never appear
        here (they are not SNIC work and not movable)."""
        if (not self.cfg.hedge_reads or self.faults is None or rs.hedged
                or rs.req.rid != rid or rs.read_done_t >= 0
                or not rs.read_recs or not self.kv_per_token):
            return
        live = [rec for rec in rs.read_recs if not rec["done"]]
        if len(live) != 1:
            return
        rec = live[0]
        job = rec["job"]
        if job is None or job.state not in ("queued", "serving"):
            return
        req = rs.req
        s = rec["side"]
        h = "de" if s == "pe" else "pe"
        h_engine = req.pe if h == "pe" else req.de
        s_nic = self.snic[rec["engine"][0]]
        h_nic = self.snic[h_engine[0]]
        now = self.loop.now
        # observed straggle: the leg's own draw x the SNIC window it is
        # (or would be) served under, relative to the healthy side
        t_ref = job.t_start if job.state == "serving" else now
        f_s = job.factor * self.faults.snic_factor(s_nic.node, t_ref)
        f_h = self.faults.leg_factor(rid, h) * \
            self.faults.snic_factor(h_nic.node, now)
        severity = f_s / max(f_h, 1e-12)
        if severity < self.cfg.hedge_min_severity:
            return
        rem_bytes = s_nic.remaining_bytes(job, now)
        # whole unserved tokens only, never beyond the side's charged
        # SNIC share (the partition the remainder is carved from)
        rem_tok = min(int(rem_bytes // self.kv_per_token),
                      req.read_tokens_by_side()[s])
        if rem_tok <= 0:
            return
        # not worth a second queue entry if the straggler is nearly done
        if rem_bytes * f_s / s_nic.bw < self.cfg.hedge_threshold_s:
            return
        moved = self.sched.rebalance_remainder(
            req, s, rem_tok, severity,
            healthy_backlog_tokens=h_nic.queue_tokens(self.kv_per_token))
        if moved <= 0:
            return
        rs.hedged = True
        self.hedged_reads += 1
        self.hedge_moved_tokens += moved
        moved_bytes = moved * self.kv_per_token
        got = s_nic.shrink(job, moved_bytes)
        assert got == moved_bytes, (got, moved_bytes)
        rec["release"] -= moved
        if rec["entry"] is not None:
            rec["entry"][1] -= moved_bytes
        # the straggler serves front-to-back, so its unserved tail —
        # including its trailing admit blocks — is what moves
        bt = self.cfg.block_tokens
        m_blk = min(len(rec["refs"]), moved // bt) if bt else 0
        moved_refs = rec["refs"][-m_blk:] if m_blk else []
        if m_blk:
            del rec["refs"][-m_blk:]
        # byte-exact re-charge: the moved bytes now traverse the healthy
        # side's SNIC + DRAM instead of the straggler's
        for res_s, res_h in ((f"{s}_snic", f"{h}_snic"),
                             (f"{s}_dram", f"{h}_dram")):
            rs.charged[res_s] = rs.charged.get(res_s, 0) - moved_bytes
            rs.charged[res_h] = rs.charged.get(res_h, 0) + moved_bytes
        entry = [h, moved_bytes, -1.0, -1.0]
        rs.read_legs.append(entry)
        hrec = {"side": h, "engine": h_engine, "entry": entry,
                "refs": moved_refs, "release": moved, "done": False,
                "job": None}
        rs.read_recs.append(hrec)
        rs.read_pending[0] += 1
        hrec["job"] = h_nic.enqueue(
            moved_bytes, lambda: self._read_leg_done(rs, hrec), read=True,
            on_start=lambda t, entry=entry: entry.__setitem__(2, t),
            factor=self.faults.leg_factor(rid, h),
            rank=self._read_rank(rs.req))

    def _read_rank(self, req: Request) -> int:
        """SNIC-queue rank of a demand read: the request's class rank
        when class-aware, the neutral 1 (pure FIFO) otherwise.  The
        class-aware SLO layer must reach the storage NIC queue — under
        prefill overload an interactive round's TTFT is dominated by
        its KV read waiting behind multi-GB batch reads, not by the
        scheduler's global queue."""
        return req.class_rank if self.cfg.slo.class_aware else 1

    def _read_done(self, rs: RoundSim):
        rs.read_done_t = self.loop.now
        if self.tracer is not None:
            # the pre-read span: submission up to the first leg's
            # service start (pure wait — attribution's queue residual)
            starts = [rec["entry"][2] for rec in (rs.read_recs or [])
                      if rec["entry"] is not None
                      and rec["entry"][2] >= 0]
            self.tracer.span(f"req/{rs.req.rid}", "scheduled",
                             rs.submit_t,
                             min(starts) if starts else self.loop.now)
        req = rs.req
        pe = self.engines[req.pe]
        work = PrefillWork(req.rid, req.cached_tokens, req.new_tokens,
                           rank=req.class_rank, arrival=req.arrival)
        if self.cfg.slo.class_aware:
            pe.fifo.insert(class_insert_index([w.key() for w in pe.fifo],
                                              work.key()), work)
        else:
            pe.fifo.append(work)
        rs.prefill_left = req.new_tokens
        if self.cfg.layerwise:
            # layerwise streaming + PD transfer legs overlap the prefill
            self._launch_transfer_flows(rs)
        self._wake_pe_group(pe.group)
        self._kick_scheduler()

    # ------------------------------------------------------------------
    # transfer flows (loading plans, minus the storage leg handled above)
    # ------------------------------------------------------------------
    def _request_legs(self, req: Request) -> List[Leg]:
        """The loading-plan legs this request executes.  One dispatch
        point (core/loading.plan_for) shared with the engines and the
        property tests, so the sim's byte accounting is the plan's byte
        accounting by construction — including split plans, whose two
        load legs charge both snic resources concurrently."""
        if self.cfg.mode == "oracle":
            return []
        hit = req.cached_tokens * self.kv_per_token
        miss = req.new_tokens * self.kv_per_token
        if self.cfg.mode == "basic":
            return PLANS["basic"](hit, miss, 0)
        return plan_for(req.read_path, req.read_split, hit, miss, 0,
                        tier=req.hit_bytes_partition(self.kv_per_token))

    def _resmap(self, req: Request):
        (pn, pr), (dn, dr) = req.pe, req.de
        return {
            "pe_snic": None, "de_snic": None,  # handled by FIFO server
            "pe_dram": self.dram[pn], "de_dram": self.dram[dn],
            "pe_cnic_rd": self.cnic_rd[(pn, pr)],
            "pe_cnic_wr": self.cnic_wr[(pn, pr)],
            "de_cnic_rd": self.cnic_rd[(dn, dr)],
            "de_cnic_wr": self.cnic_wr[(dn, dr)],
            "net": self.net,
        }

    def _traced_leg_cb(self, rid: int, leg_name: str, nbytes: float,
                       cb: Callable) -> Callable:
        """Wrap a flow-completion callback with a ``pd_transfer`` span
        on the request's track (no-op passthrough when untraced)."""
        if self.tracer is None:
            return cb
        t0 = self.loop.now

        def done():
            self.tracer.span(f"req/{rid}", "pd_transfer", t0,
                             self.loop.now, leg=leg_name, nbytes=nbytes)
            cb()

        return done

    def _launch_transfer_flows(self, rs: RoundSim):
        if self.cfg.mode == "oracle":
            rs.transfer_done = True
            return
        req = rs.req
        legs = [leg for leg in self._request_legs(req) if leg.layerwise]
        rmap = self._resmap(req)
        pending = [len(legs)]
        if not legs:
            rs.transfer_done = True
            return

        def leg_done():
            pending[0] -= 1
            if pending[0] == 0:
                rs.transfer_done = True
                self._maybe_to_decode(rs)

        for leg in legs:
            rs.charge(leg)
            rs.flows.append(
                self._flow(leg.nbytes, [rmap[r] for r in leg.resources],
                           self._traced_leg_cb(req.rid, leg.name,
                                               leg.nbytes, leg_done),
                           tclass=leg.tclass))

    # ------------------------------------------------------------------
    # PE group stepping
    # ------------------------------------------------------------------
    def _wake_pe_group(self, gid: int):
        if self._pe_stepping[gid]:
            return
        self._pe_stepping[gid] = True
        self.loop.after(0.0, lambda: self._pe_step(gid))

    def _pe_step(self, gid: int):
        # a role flip can dissolve the group between wake and step
        members = self.pe_groups.get(gid, [])
        if not any(e.fifo for e in members):
            self._pe_stepping[gid] = False
            return
        t_max, attns = 0.0, []
        work: List[Tuple[_EngineSim, list]] = []
        kv_cap = None
        if not self.cfg.layerwise and self.kv_per_token:
            kv_cap = int(self.cfg.node.gpu.hbm_bytes * self.cfg.kv_hbm_frac /
                         self.kv_per_token)
        for e in members:
            batch = e.packer.pack(e.fifo)
            if batch and kv_cap is not None:
                # without layerwise prefill the whole batch's prompt KV
                # must reside in HBM: truncate to capacity (>=1 item)
                kept, resid = [], 0
                for bi in batch:
                    resid += bi.cached + bi.bsz
                    if kept and resid > kv_cap:
                        # push back unprocessed work
                        rq = self._by_rid[bi.rid].req
                        e.fifo.insert(0, PrefillWork(bi.rid, bi.cached,
                                                     bi.bsz,
                                                     rank=rq.class_rank,
                                                     arrival=rq.arrival))
                        continue
                    kept.append(bi)
                batch = kept
            if not batch:
                attns.append(0.0)
                continue
            items = [(bi.cached, bi.bsz) for bi in batch]
            a_fl = attn_flops_sim(self.model, items)
            lin = self.model.linear_flops_per_token() * \
                sum(b for _, b in items)
            eff = self.cfg.node.gpu.flops * self.cfg.node.gpu.mfu_prefill
            t_e = (a_fl + lin) / eff
            attns.append(a_fl / eff)
            t_max = max(t_max, t_e)
            work.append((e, batch))
        pos = [a for a in attns if a > 0]
        if pos and len(pos) > 1:
            self.attn_balance.append((self.loop.now,
                                      max(pos) / (sum(pos) / len(pos))))
        if t_max <= 0:
            self._pe_stepping[gid] = False
            return
        step_tokens = sum(bi.bsz for _, batch in work for bi in batch)
        t0 = self.loop.now
        self._step_barrier(t_max, self.coll_model.step_bytes(step_tokens),
                           lambda: self._pe_step_done(gid, work, t0))

    def _step_barrier(self, t_compute: float, coll_bytes: float,
                      done: Callable):
        """Complete a group step after BOTH its compute time and its
        model collectives (a Flow on the shared compute network,
        MODEL_COLLECTIVE class).  Any time the collectives finish after
        the compute is interference — the step stalls on communication —
        and is recorded as ``collective_stall_s``: ≈ 0 under the VL
        arbiter (collectives own ~99 % of a contended link), nonzero
        under FIFO sharing once KV transfer load builds up."""
        if not self._collectives_on or coll_bytes <= 0:
            self.loop.after(t_compute, done)
            return
        t0 = self.loop.now
        pending = [2]

        def arm():
            pending[0] -= 1
            if pending[0] == 0:
                self.collective_stall_s += max(
                    0.0, self.loop.now - (t0 + t_compute))
                done()

        self.loop.after(t_compute, arm)
        self._flow(coll_bytes, [self.net], arm,
                   tclass=TrafficClass.MODEL_COLLECTIVE)

    def _pe_step_done(self, gid, work, t0):
        for e, batch in work:
            for bi in batch:
                rs = self._round_by_rid(bi.rid)
                if rs is None:
                    # the round was re-homed (engine death) after this
                    # step launched: its new incarnation re-prefills
                    # from scratch, so the stale batch item is dropped
                    continue
                if self.tracer is not None:
                    self.tracer.span(f"req/{bi.rid}", "prefill", t0,
                                     self.loop.now, engine=list(e.eid),
                                     tokens=bi.bsz)
                if bi.chunked:
                    # partial slice (quota straddler or SloConfig chunk
                    # cap) — the sim's PREFILL_CHUNKED sub-state: more
                    # slices of this round follow in later batches
                    self.prefill_chunks += 1
                rs.prefill_left -= bi.bsz
                self.prompt_tokens_done += bi.bsz
                if rs.prefill_left <= 0 and rs.prefill_done_t < 0:
                    rs.prefill_done_t = self.loop.now
                    if self.tracer is not None:
                        # TTFT's endpoint in both runtimes: the first
                        # output token is ready when prefill completes
                        self.tracer.event(f"req/{bi.rid}", "first_token")
                    self.sched.on_request_done(rs.req.pe, rs.req)
                    if not self.cfg.layerwise and not rs.transfer_done:
                        # no layerwise streaming: transfers run after the
                        # forward pass instead of overlapping it
                        self._launch_transfer_flows(rs)
                    self._maybe_to_decode(rs)
        self.tps_samples.append((self.loop.now, self.prompt_tokens_done,
                                 self.gen_tokens_done))
        # keep stepping
        self._pe_stepping[gid] = False
        self._wake_pe_group(gid)
        self._kick_scheduler()

    def _round_by_rid(self, rid):
        return self._by_rid.get(rid)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _maybe_to_decode(self, rs: RoundSim):
        if rs.prefill_done_t < 0 or not rs.transfer_done or rs.h2d_done:
            return
        if self.cfg.mode == "oracle":
            self._h2d_done(rs)
            return
        req = rs.req
        rmap = self._resmap(req)
        legs = [leg for leg in self._request_legs(req)
                if leg.phase == "decode_start"]
        if not legs:
            # the basic plan writes PE HBM -> DE HBM directly (no
            # decode_start leg); the sim still stages decode start
            # through DE DRAM like real PD-disaggregated systems do
            full = req.prompt_tokens * self.kv_per_token
            (dn, dr) = req.de
            rs.charge(Leg("de_h2d", full,
                          ("de_cnic_rd", "de_cnic_wr", "de_dram")))
            rs.flows.append(
                self._flow(full,
                           [self.cnic_rd[(dn, dr)], self.cnic_wr[(dn, dr)],
                            self.dram[dn]],
                           self._traced_leg_cb(req.rid, "de_h2d", full,
                                               lambda: self._h2d_done(rs))))
            return
        pending = [len(legs)]

        def leg_done():
            pending[0] -= 1
            if pending[0] == 0:
                self._h2d_done(rs)

        for leg in legs:
            rs.charge(leg)
            rs.flows.append(
                self._flow(leg.nbytes, [rmap[r] for r in leg.resources],
                           self._traced_leg_cb(req.rid, leg.name,
                                               leg.nbytes, leg_done),
                           tclass=leg.tclass))

    def _h2d_done(self, rs: RoundSim):
        rs.h2d_done = True
        e = self.engines[rs.req.de]
        e.active_decode.append(rs)
        self._wake_de_group(e.group)

    def _wake_de_group(self, gid: int):
        if self._de_stepping[gid]:
            return
        self._de_stepping[gid] = True
        self.loop.after(0.0, lambda: self._de_step(gid))

    def _de_step(self, gid: int):
        # a role flip can dissolve the group between wake and step
        members = self.de_groups.get(gid, [])
        active = [e for e in members if e.active_decode]
        if not active:
            self._de_stepping[gid] = False
            return
        # block length: 1 until every new seq has emitted its 2nd token
        block = self.cfg.decode_block
        if any(r.tokens_out < 2 for e in active for r in e.active_decode):
            block = 1
        block = min(block, min(r.gen_left for e in active
                               for r in e.active_decode))
        gpu = self.cfg.node.gpu
        t_max = 0.0
        for e in active:
            kv_bytes = sum(self.model.decode_step_bytes(r.ctx)
                           for r in e.active_decode)
            w_bytes = self.model.active_param_bytes_resident(
                self.de_group_size)
            step_bytes = kv_bytes + w_bytes
            step_flops = sum(self.model.decode_step_flops(r.ctx)
                             for r in e.active_decode)
            t_step = max(step_bytes / (gpu.hbm_bw * gpu.mbu_decode),
                         step_flops / (gpu.flops * gpu.mfu_prefill))
            t_max = max(t_max, t_step * block)
        step_tokens = block * sum(len(e.active_decode) for e in active)
        self._step_barrier(t_max, self.coll_model.step_bytes(step_tokens),
                           lambda: self._de_step_done(gid, block))

    def _de_step_done(self, gid: int, block: int):
        members = self.de_groups.get(gid, [])
        persist_bytes: Dict[int, int] = defaultdict(int)
        for e in members:
            done = []
            for r in e.active_decode:
                if r.first_decode_t < 0:
                    r.first_decode_t = self.loop.now
                r.tokens_out += block
                if r.tokens_out >= 2 and r.second_token_t < 0:
                    r.second_token_t = self.loop.now
                r.gen_left -= block
                r.ctx += block
                self.gen_tokens_done += block
                persist_bytes[e.node] += block * self.kv_per_token
                if r.gen_left <= 0:
                    done.append(r)
            for r in done:
                e.active_decode.remove(r)
                e.resident_tokens -= r.req.hbm_tokens
                self.sched.on_request_done(r.req.de, r.req)
                r.done_t = self.loop.now
                self._round_finished(r, e.node)
        if self.cfg.mode != "oracle":
            for node, nb in persist_bytes.items():
                # miss-token KV persists ride along with generated blocks
                self.snic[node].enqueue(nb, lambda: None, read=False)
        self._de_stepping[gid] = False
        self._wake_de_group(gid)
        self._kick_scheduler()

    def _round_finished(self, rs: RoundSim, de_node: int):
        """Round completion: release tier pins, warm the DE node's tier
        with the round's full context (every one of those blocks staged
        through DE DRAM on its way to HBM / storage), then enter the
        agent's think-time window — the idle gap the prefetcher uses to
        stage the *next* round's predicted hit — before submitting the
        next round."""
        agent, traj = rs.agent, rs.traj
        tid = traj.tid
        now = self.loop.now
        if self.tracer is not None and rs.first_decode_t >= 0:
            self.tracer.span(f"req/{rs.req.rid}", "decode",
                             rs.first_decode_t, rs.done_t,
                             tokens=rs.tokens_out)
        if rs.tier_pinned is not None:
            node, refs = rs.tier_pinned
            self.tiers[node].unpin(refs)
            rs.tier_pinned = None
        agent.next_round += 1
        i = agent.next_round
        if i >= traj.n_rounds:
            # finished trajectory: its blocks will never be hit again
            # (§A.4) — no warm-up (it would only evict live agents'
            # prefixes), just release the owner for eager reclamation
            for t in self.tiers.values():
                t.note_done(tid)
            self._submit_round(agent)     # records end_t
            return
        tier = self.tiers.get(de_node)
        if tier is not None:
            bt = self.cfg.block_tokens
            ctx = rs.req.prompt_tokens + rs.req.gen_tokens
            # tail-first admission: the LEADING blocks end up most
            # recent, so LRU pressure evicts the context tail first and
            # the resident-prefix (the only thing a round can serve)
            # survives — head-first order would evict block 0 first and
            # collapse the prefix to zero under any pressure
            for b in reversed(range(ctx // bt)):
                tier.admit((tid, b), self.block_bytes, owner=tid, now=now)
        think = traj.rounds[i].think
        if think > 0:
            if self.prefetcher is not None:
                self._schedule_prefetch(agent, de_node, think)
            self.loop.after(think, lambda a=agent: self._submit_round(a))
        else:
            self._submit_round(agent)

    def _schedule_prefetch(self, agent: AgentSim, node: int, think: float):
        """Think-time prefetch: stage the next round's predicted hit
        blocks (the trajectory's current context — exactly what the trie
        will match) into the previous decode node's DRAM tier.

        Fired *late* in the think window — just early enough to restage
        the whole hit at SNIC bandwidth (with slack) — so it repairs the
        evictions other trajectories inflicted during the gap instead of
        re-admitting what the round-end warm-up already left resident.
        Staged and already-resident predicted blocks are pinned (a
        lease) until the round submits, so a prefetch cannot itself be
        evicted before it pays off."""
        tier = self.tiers.get(node)
        if tier is None:
            return
        traj = agent.traj
        tid = traj.tid
        i = agent.next_round
        cached = traj.context_before(i)
        n_refs = cached // self.cfg.block_tokens
        if n_refs == 0:
            return
        stage_s = n_refs * self.block_bytes / self.cfg.node.snic_bw
        delay = max(0.0, min(think - 1.25 * stage_s, 0.9 * think))

        def issue(agent=agent, tier=tier, node=node, tid=tid, i=i):
            if agent.next_round != i or agent.prefetch_pinned is not None:
                return                       # stale wake-up
            refs = [(tid, b) for b in range(n_refs)]
            pinned: List = []
            resident = refs[:tier.resident_prefix(refs)]
            # extend the lease over blocks already resident...
            tier.pin(resident)
            pinned.extend(resident)
            agent.prefetch_pinned = (node, pinned)
            # ...and stage the missing ones in order, chunk by chunk,
            # bounded by what the tier could actually hold (free +
            # evictable bytes) — staging reads the tier must drop would
            # burn exactly the SNIC bandwidth prefetch exists to save
            budget = int((tier.capacity_bytes - tier.pinned_bytes()) //
                         max(self.block_bytes, 1))
            for chunk in self.prefetcher.plan(tier, refs):
                chunk = chunk[:budget]
                if not chunk:
                    break
                budget -= len(chunk)
                nbytes = len(chunk) * self.block_bytes

                def staged(chunk=chunk):
                    now = self.loop.now
                    # lease still open? (a chunk can drain from the FIFO
                    # after the round already submitted — still admit,
                    # but don't pin past the lease)
                    lease = agent.prefetch_pinned is not None and \
                        agent.prefetch_pinned[1] is pinned
                    for ref in chunk:
                        if tier.admit(ref, self.block_bytes, owner=tid,
                                      now=now, prefetch=True) and lease:
                            tier.pin([ref])
                            pinned.append(ref)

                self.snic[node].enqueue(nbytes, staged, read=True,
                                        prefetch=True)

        self.loop.after(delay, issue)

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def round_metrics(self) -> list:
        """The rounds' timing as serving RoundMetrics, so the serving
        layer's estimators (latency_summary / slo_attainment) apply to
        simulator output unchanged — one percentile/SLO definition for
        both runtimes."""
        # imported here, not at the top: serving/events imports sim/spec,
        # and a package import of serving would come back to this module
        from repro_torch.serving.events import RoundMetrics
        return [RoundMetrics(rid=rs.req.rid, gen_tokens=rs.gen_total,
                             submit_t=rs.submit_t,
                             read_done_t=rs.read_done_t,
                             prefill_done_t=rs.prefill_done_t,
                             first_decode_t=rs.first_decode_t,
                             second_token_t=rs.second_token_t,
                             done_t=rs.done_t,
                             slo_class=rs.req.slo_class)
                for rs in self.rounds]

    def slo_attainment(self, ttft_slo_s: float = 4.0,
                       tpot_slo_s: float = 0.050) -> float:
        """Fraction of finished rounds meeting both SLOs (paper §7.4
        defaults), via the serving layer's shared estimator."""
        from repro_torch.serving.events import slo_attainment
        return slo_attainment(self.round_metrics(), ttft_slo_s, tpot_slo_s)

    def results(self) -> dict:
        from repro_torch.serving.events import latency_by_class
        done_rounds = [r for r in self.rounds if r.done_t >= 0]
        jcts = [a.end_t - a.start_t for a in self.agents if a.end_t >= 0]
        ttfts = [r.prefill_done_t - r.submit_t for r in done_rounds]
        ttsts = [r.second_token_t - r.submit_t for r in done_rounds
                 if r.second_token_t >= 0]
        tpots = [(r.done_t - r.first_decode_t) / max(r.gen_total - 1, 1)
                 for r in done_rounds if r.gen_total > 1]
        pct = lambda xs, q: float(np.percentile(xs, q)) if xs else float("nan")
        mean = lambda xs: float(np.mean(xs)) if xs else float("nan")
        tiers = list(self.tiers.values())
        dram_hit = sum(t.dram_hit_bytes for t in tiers)
        denom = dram_hit + self.snic_hit_read_bytes
        return conforming(dict(
            finished_agents=len(jcts),
            finished_rounds=len(done_rounds),
            jct_mean=mean(jcts), jct_max=max(jcts) if jcts else float("nan"),
            ttft_mean=mean(ttfts), ttft_p99=pct(ttfts, 99),
            ttst_mean=mean(ttsts), tpot_mean=mean(tpots),
            tpot_p99=pct(tpots, 99),
            sim_time=self.loop.now,
            prompt_tokens=self.prompt_tokens_done,
            gen_tokens=self.gen_tokens_done,
            # --- DRAM tier (kvcache/tiers.py; zeros when disabled) -----
            dram_hit_bytes=dram_hit,
            snic_hit_read_bytes=self.snic_hit_read_bytes,
            dram_hit_ratio=(dram_hit / denom) if denom else 0.0,
            tier_prefetch_bytes=sum(t.prefetch_bytes for t in tiers),
            tier_evicted_bytes=sum(t.evicted_bytes for t in tiers),
            tier_evictions=sum(t.evictions for t in tiers),
            # --- finite compute network (repro_torch.network; zeros when
            # the link is infinite — the no-congestion configuration)
            collective_stall_s=self.collective_stall_s,
            transfer_backlog_s=self.net.transfer_backlog_s,
            net_collective_delay_s=self.net.collective_delay_s,
            net_collective_bytes=self.net.bytes_by_class.get(
                TrafficClass.MODEL_COLLECTIVE, 0.0),
            net_kv_bytes=self.net.bytes_by_class.get(
                TrafficClass.KV_TRANSFER, 0.0),
            net_contended_joins=self.net.contended_joins,
            # --- elastic reconfiguration (core/autoscale.py; zeros when
            # elastic is off — the static-topology configuration) -------
            role_changes=self.drains.n_flips,
            role_changes_by_direction=self.drains.flips_by_direction(),
            reconfig_drain_s=self.drains.drain_seconds(),
            reconfig_weight_bytes=self.reconfig_weight_bytes,
            tier_handoff_bytes=self.drains.tier_handoff_bytes(),
            n_pe_final=sum(1 for e in self.engines.values()
                           if e.kind == "pe"),
            n_de_final=sum(1 for e in self.engines.values()
                           if e.kind == "de"),
            # --- faults / hedged reads / recovery (sim/faults.py; zeros
            # when no schedule is injected) -----------------------------
            engine_deaths=len(self.dead_engines),
            recovered_rounds=self.recovered_rounds,
            hedged_reads=self.hedged_reads,
            hedge_moved_tokens=self.hedge_moved_tokens,
            # --- online SLO layer (core/config.SloConfig; admitted ==
            # submitted rounds and deferred/rejected are 0 when the
            # admission gate is off) ------------------------------------
            admitted_rounds=(self.gate.admitted_rounds
                             if self.gate is not None else len(self.rounds)),
            deferred_rounds=(self.gate.deferred_rounds
                             if self.gate is not None else 0),
            rejected_rounds=(self.gate.rejected_rounds
                             if self.gate is not None else 0),
            prefill_chunks=self.prefill_chunks,
            latency_by_class=latency_by_class(self.round_metrics()),
        ), "sim")


class _NicJob:
    """One FIFO entry on a storage NIC — a first-class handle so hedged
    reads can shrink it mid-flight and fault recovery can abort it."""

    __slots__ = ("nbytes", "cb", "read", "on_start", "prefetch", "factor",
                 "t_start", "rate", "version", "state", "tag", "rank")

    def __init__(self, nbytes, cb, read, on_start, prefetch, factor,
                 tag="", rank=1):
        # SLO-class rank (scheduler.Request.class_rank): only demand
        # reads of interactive rounds carry 0; all other traffic stays
        # at the neutral 1, so a non-class-aware run is pure FIFO
        self.rank = rank
        self.nbytes = nbytes
        self.cb = cb
        self.read = read
        self.on_start = on_start
        self.prefetch = prefetch
        # trace label for the NIC-span audit: demand "read" vs "blob" /
        # "weights" / "persist" / "prefetch" (derived in enqueue)
        self.tag = tag
        # per-job service-time multiplier (straggler draw); SNIC window
        # factors compose with it at service start
        self.factor = factor
        self.t_start = -1.0
        self.rate = 0.0
        self.version = 0        # bumped on shrink/abort to void the
        #                         completion event already in the heap
        self.state = "queued"   # queued | serving | done | cancelled


class _FifoNic:
    """Per-node storage NIC: serial FIFO server with byte accounting.

    Tracks reads (KV loads) and writes (block persists) separately so
    tests can pin the read totals against the loading-plan snic sums,
    and reports service start via ``on_start`` so split-read tests can
    assert two NICs were busy concurrently on one request.

    Fault semantics: a job's effective rate is fixed at service start —
    ``bw / (job.factor * FaultSchedule.snic_factor(node, t_start))`` —
    so degradation windows apply to jobs *starting* inside them (the
    granularity the chaos suite pins).  With no faults the arithmetic
    is that of a fault-free server (``rate == bw`` exactly)."""

    def __init__(self, sim: Sim, node: int, bw: float):
        self.sim = sim
        self.node = node
        self.bw = bw
        self.queue: deque = deque()
        self.busy = False
        self.current: Optional[_NicJob] = None
        self.queued_bytes = 0
        self.total_bytes = 0
        self.read_bytes = 0
        self.write_bytes = 0
        self.prefetch_bytes = 0
        self.samples: List[Tuple[float, float]] = []   # (t_done, bytes)

    def queue_tokens(self, kv_per_token: float) -> int:
        if kv_per_token <= 0:
            return 0
        return int(self.queued_bytes / kv_per_token)

    def enqueue(self, nbytes: float, on_done, read=True, on_start=None,
                prefetch=False, factor: float = 1.0,
                tag: str = "", rank: int = 1) -> _NicJob:
        if not tag:
            tag = "prefetch" if prefetch else ("read" if read
                                               else "persist")
        job = _NicJob(nbytes, on_done, read, on_start, prefetch, factor,
                      tag, rank)
        if rank < 1 and any(j.rank > rank for j in self.queue):
            # class-aware: an interactive demand read overtakes queued
            # lower-priority traffic (stable among equals; the job in
            # service is never preempted)
            idx = next(i for i, j in enumerate(self.queue)
                       if j.rank > rank)
            self.queue.insert(idx, job)
        else:
            self.queue.append(job)
        self.queued_bytes += nbytes
        if not self.busy:
            self._serve()
        return job

    def _serve(self):
        if not self.queue:
            self.busy = False
            self.current = None
            return
        self.busy = True
        job = self.queue.popleft()
        self.current = job
        job.state = "serving"
        now = self.sim.loop.now
        job.t_start = now
        if job.on_start is not None:
            job.on_start(now)
        f = job.factor
        faults = self.sim.faults
        if faults is not None:
            f *= faults.snic_factor(self.node, now)
        job.rate = self.bw if f == 1.0 else self.bw / f
        v = job.version
        self.sim.loop.after(job.nbytes / job.rate,
                            lambda: self._complete(job, v))

    def _complete(self, job: _NicJob, version: int):
        if job.version != version or job.state != "serving":
            return              # voided by a shrink/abort
        job.state = "done"
        nbytes = job.nbytes
        self.queued_bytes -= nbytes
        self.total_bytes += nbytes
        if job.prefetch:
            # think-time staging reads — separated from demand reads
            # so round-start SNIC traffic stays directly observable
            self.prefetch_bytes += nbytes
        elif job.read:
            self.read_bytes += nbytes
        else:
            self.write_bytes += nbytes
        self.samples.append((self.sim.loop.now, nbytes))
        tr = self.sim.tracer
        if tr is not None:
            # one span per completed FIFO job, with the same float the
            # byte counters just accumulated — obs.audit pins the sums
            # equal, so a dropped or double-emitted span is an error
            tr.span(f"snic/node{self.node}", "nic_xfer", job.t_start,
                    self.sim.loop.now, tag=job.tag, nbytes=nbytes)
            tr.counter(f"snic/node{self.node}/queue",
                       queued_bytes=self.queued_bytes)
        if job.cb is not None:
            job.cb()
        self._serve()

    # -- hedged reads / fault recovery ---------------------------------
    def remaining_bytes(self, job: _NicJob, now: float) -> float:
        """Unserved bytes of ``job`` at ``now`` (0 once finished)."""
        if job.state == "serving":
            return max(0.0, job.nbytes - (now - job.t_start) * job.rate)
        if job.state == "queued":
            return job.nbytes
        return 0.0

    def shrink(self, job: _NicJob, delta: float) -> float:
        """Hedge: carve ``delta`` unserved bytes off the tail of the job
        (they will be served elsewhere).  The job keeps its callback and
        completes earlier at its reduced size; a queued job shrunk to
        nothing is unqueued and completes immediately having served
        zero bytes here.  Returns the bytes actually removed."""
        assert delta >= 0
        now = self.sim.loop.now
        if job.state == "serving":
            served = (now - job.t_start) * job.rate
            delta = min(delta, max(0.0, job.nbytes - served))
            job.nbytes -= delta
            self.queued_bytes -= delta
            job.version += 1
            v = job.version
            t_done = job.t_start + job.nbytes / job.rate
            self.sim.loop.after(max(t_done - now, 0.0),
                                lambda: self._complete(job, v))
            return delta
        if job.state == "queued":
            delta = min(delta, job.nbytes)
            job.nbytes -= delta
            self.queued_bytes -= delta
            if job.nbytes <= 0:
                self.queue.remove(job)
                job.state = "done"
                if job.cb is not None:
                    self.sim.loop.after(0.0, job.cb)
            return delta
        return 0.0

    def abort(self, job: _NicJob):
        """Fault recovery: drop the job.  Queued jobs vanish without a
        trace; an in-service job is truncated to the bytes already
        served (they were physically read and stay in the counters) and
        its callback is suppressed."""
        if job.state == "queued":
            self.queue.remove(job)
            self.queued_bytes -= job.nbytes
            job.state = "cancelled"
            job.cb = None
            return
        if job.state == "serving":
            served = (self.sim.loop.now - job.t_start) * job.rate
            delta = max(0.0, job.nbytes - served)
            job.nbytes -= delta
            self.queued_bytes -= delta
            job.cb = None
            job.version += 1
            v = job.version
            # complete immediately at the truncated size: the byte
            # accounting and FIFO hand-off reuse the normal path
            self.sim.loop.after(0.0, lambda: self._complete(job, v))


class _SimPacker(QuotaPacker):
    def __init__(self, model: ModelSimSpec, time_model: AttnTimeModel,
                 quota_s: float, chunk_tokens: Optional[int] = None):
        self.model = model
        self.time_model = time_model
        self.quota_s = quota_s
        self.min_chunk = 16
        self.chunk_tokens = None if chunk_tokens is None \
            else max(int(chunk_tokens), self.min_chunk)

    def predict_batch_seconds(self, items) -> float:
        return self.time_model.seconds(attn_flops_sim(self.model, items))


def attn_flops_sim(model: ModelSimSpec, items) -> float:
    tot = 0.0
    for cached, bsz in items:
        a = 4.0 * model.n_layers * model.n_heads * model.qk_head_dim * \
            bsz * (cached + (bsz + 1) / 2.0)
        if model.sparse_topk:
            a = min(a, 4.0 * model.n_layers * model.n_heads *
                    model.qk_head_dim * bsz * model.sparse_topk)
        tot += a
    return tot
