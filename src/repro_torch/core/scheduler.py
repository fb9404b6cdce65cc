"""Adaptive request scheduler (port of ``repro.core.scheduler``, paper §6.1).

* **PE scheduling (Algorithm 1)** — FIFO queue; engines classified per
  fetch into C1 (tok_e > β), C2 (read_q ≤ α ∧ tok_e ≤ β) and C3
  (read_q > α ∧ tok_e ≤ β); requests go to argmin-tok in C2, else C3,
  else the fetch ends.
* **DE scheduling phase 1** — the global queue drains into per-group
  private queues, each request to the group with minimum Σ tok_e.
* **DE scheduling phase 2** — within a group, bounded by aggregate free
  HBM; threshold Z = 1.05·(Σ_{r∈R} len_r + Σ_e tok_e)/|E|; the low-token
  class (tok_e + len ≤ Z) by min seq_e, else min tok_e.
* **Read-path selection** — the side with the shorter disk reading
  queue; with ``split_reads`` the hit is water-filled across both sides.
  With DRAM tiers the side whose tier holds the longer resident prefix
  serves that prefix from DRAM and the cold remainder is routed as above.

With ``class_aware`` (the SLO layer's priority classes) the global
queues are ordered by (class rank, arrival, rid), so ``interactive``
rounds overtake ``batch`` rounds at submission.

Elastic role flips (core/autoscale.py drives them): ``begin_drain``
stops admissions to an engine (a draining engine is left out of the PE
classes, the DE fits and the phase-1 groups, and its side's reading
queue looks a whole hit deeper to ``choose_read_path``),
``requeue_unstarted`` hands back its unstarted assignments,
``can_finish_drain`` says when its in-flight work is done and
``finish_drain`` re-registers it under the other kind;
``rebalance_de_private`` re-routes queued DE requests after the group
topology changed.  ``choose_read_path`` also takes the compute network's
congestion, which makes the DE side (whose reads cross the network) look
deeper.

Fault tolerance: ``rebalance_remainder`` hedges a straggling side's
read share onto the healthy side (``loading.hedge_water_fill``);
``fail_engine`` removes a dead engine through ``begin_drain``'s queue
hand-back.  The completion hooks forfeit the charges of a dead engine.
With a tracer attached, every read-path decision and every hedge
records an event.

The arithmetic is the reference's, so both packages make the same
decisions on the same lengths.  :class:`RoundRobinScheduler` is the
simulator's Fig. 13 baseline, and :func:`water_fill_frac_batch` the
read-path water-fill over request arrays.
"""
from __future__ import annotations

import bisect
import itertools
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.loading import hedge_water_fill

EngineId = Tuple[int, int]          # (node_id, local_rank)


@dataclass
class Request:
    rid: int
    cached_tokens: int              # KV-hit tokens (loaded, not computed)
    new_tokens: int                 # appended tokens (prefill compute)
    gen_tokens: int                 # expected generation length
    arrival: float = 0.0
    # SLO class (core/config.SloConfig): 'interactive' rounds overtake
    # 'batch' rounds in every class-aware queue order
    slo_class: str = "batch"
    # filled by the scheduler:
    pe: Optional[EngineId] = None
    de: Optional[EngineId] = None
    read_path: Optional[str] = None   # 'pe' | 'de'
    read_split: float = 1.0           # fraction read on `read_path` side
    # DRAM-tier serving (kvcache/tiers.py): ``dram_tokens`` hit tokens
    # sit in the ``dram_side`` node's DRAM tier and never touch a storage
    # NIC; ``snic_tokens`` is the explicit per-side partition of the rest
    dram_side: Optional[str] = None   # 'pe' | 'de'
    dram_tokens: int = 0
    snic_tokens: Optional[Dict[str, int]] = None

    @property
    def class_rank(self) -> int:
        """Priority rank: interactive (0) ahead of batch (1)."""
        return 0 if self.slo_class == "interactive" else 1

    @property
    def prompt_tokens(self) -> int:
        return self.cached_tokens + self.new_tokens

    @property
    def hbm_tokens(self) -> int:
        """KV residency a DE must reserve (prompt + generated)."""
        return self.prompt_tokens + self.gen_tokens

    @property
    def pe_read_frac(self) -> float:
        """Fraction of hit bytes entering via the PE side (tier + SNIC);
        with a DRAM-tier hit the explicit token partition decides."""
        if self.snic_tokens is not None:
            if not self.cached_tokens:
                return 0.0
            pe_total = self.snic_tokens["pe"] + \
                (self.dram_tokens if self.dram_side == "pe" else 0)
            return pe_total / self.cached_tokens
        if self.read_path is None:
            return 0.0
        if self.read_path == "pe":
            return self.read_split
        return 1.0 - self.read_split

    def read_tokens_by_side(self) -> Dict[str, int]:
        """Hit tokens charged to each side's disk reading queue: the SNIC
        share per side under an explicit partition (tier tokens enter no
        queue); otherwise PE gets floor(cached * pe_frac), DE the rest."""
        if self.snic_tokens is not None:
            return dict(self.snic_tokens)
        pe_t = int(self.cached_tokens * self.pe_read_frac)
        return {"pe": pe_t, "de": self.cached_tokens - pe_t}

    def hit_blocks_by_side(self, n_blocks: int) -> Dict[str, int]:
        """Block-granular hit partition: the leading ``tier`` blocks come
        from the ``dram_side`` node's DRAM tier, the next ``pe`` blocks
        via the PE-side storage NIC, the rest via the DE side."""
        if n_blocks <= 0 or not self.cached_tokens:
            return {"tier": 0, "pe": 0, "de": max(n_blocks, 0)}
        # exact: the trie hit is whole blocks and dram_tokens a whole-block
        # prefix of it
        k_tier = (self.dram_tokens * n_blocks) // self.cached_tokens
        tok = self.read_tokens_by_side()
        rem_blocks = n_blocks - k_tier
        rem_tok = tok["pe"] + tok["de"]
        k_pe = int(round(rem_blocks * tok["pe"] / rem_tok)) if rem_tok else 0
        return {"tier": k_tier, "pe": k_pe, "de": rem_blocks - k_pe}

    def hit_bytes_partition(self, kv_per_token: int) -> Optional[tuple]:
        """(pe_snic, de_snic, pe_tier, de_tier) hit bytes, the ``tier``
        argument of ``loading.plan_for``; None when the request carries
        no explicit partition (its read_split applies)."""
        if self.snic_tokens is None:
            return None
        return (self.snic_tokens["pe"] * kv_per_token,
                self.snic_tokens["de"] * kv_per_token,
                (self.dram_tokens if self.dram_side == "pe" else 0)
                * kv_per_token,
                (self.dram_tokens if self.dram_side == "de" else 0)
                * kv_per_token)


@dataclass
class EngineState:
    """Scheduler-side view of one engine (refreshed by fetch reports)."""

    engine: EngineId
    node: int
    kind: str                       # 'pe' | 'de'
    group: int
    seq: int = 0                    # unfinished requests
    tok: int = 0                    # unfinished tokens
    read_q: int = 0                 # node disk reading queue (tokens)
    free_hbm_tokens: int = 0        # decode engines only
    draining: bool = False          # admits no new work


@dataclass
class Assignment:
    request: Request
    engine: EngineId


class Scheduler:
    """Central request scheduler.  ``alpha``: short-reading-queue
    threshold [tokens]; ``beta``: unfinished-token limit [tokens]."""

    #: optional flight recorder (repro_torch.obs.Tracer), attached by the
    #: owning runtime; None = untraced
    tracer = None

    def __init__(self, alpha: int, beta: int, *, z_factor: float = 1.05,
                 split_reads: bool = False, class_aware: bool = False):
        self.alpha = alpha
        self.beta = beta
        self.z_factor = z_factor
        self.split_reads = split_reads
        # SLO classes: the queue order becomes (class rank, arrival, rid);
        # off, the rank term is 0 and the order is submission order
        self.class_aware = class_aware
        # read-path tie-breaker: the first tie goes to the PE side
        self._tie_toggle = False
        self.engines: Dict[EngineId, EngineState] = {}
        self.pe_queue: Deque[Request] = deque()
        self.de_global_queue: Deque[Request] = deque()
        self.de_private: Dict[int, Deque[Request]] = {}
        self._groups: Dict[int, List[EngineId]] = {}

    def register_engine(self, engine: EngineId, *, node: int, kind: str,
                        group: int) -> EngineState:
        st = EngineState(engine=engine, node=node, kind=kind, group=group)
        self.engines[engine] = st
        self._groups.setdefault(group, []).append(engine)
        if kind == "de":
            self.de_private.setdefault(group, deque())
        return st

    def groups(self, kind: str) -> Dict[int, List[EngineId]]:
        return {g: es for g, es in self._groups.items()
                if es and self.engines[es[0]].kind == kind}

    def admitting(self, kind: str) -> List[EngineState]:
        """Engines of ``kind`` still accepting work (not draining)."""
        return [st for st in self.engines.values()
                if st.kind == kind and not st.draining]

    def _order_key(self, r: Request):
        """(class rank, arrival, rid) when class-aware, else (0, arrival,
        rid), which is submission order."""
        return (r.class_rank if self.class_aware else 0, r.arrival, r.rid)

    def _priority_insert(self, q: Deque[Request], req: Request):
        """Stable insert before the first lower-priority queued request
        (FIFO within a class), scanning from the right."""
        k = self._order_key(req)
        idx = len(q)
        while idx > 0 and self._order_key(q[idx - 1]) > k:
            idx -= 1
        q.insert(idx, req)

    def submit(self, req: Request):
        if not self.class_aware:
            self.pe_queue.append(req)
            self.de_global_queue.append(req)
            return
        self._priority_insert(self.pe_queue, req)
        self._priority_insert(self.de_global_queue, req)

    # -- elastic role flips ---------------------------------------------------
    def begin_drain(self, engine: EngineId) -> EngineState:
        """Stop admitting to ``engine``; its in-flight work drains through
        the completion hooks.  If this empties a DE group's admitting set,
        the group's private queue goes back to the front of the global
        queue (in order) for phase 1 to re-route."""
        st = self.engines[engine]
        if st.draining:
            return st
        st.draining = True
        if st.kind == "de":
            members = [self.engines[e] for e in self._groups[st.group]]
            if all(m.draining for m in members):
                q = self.de_private.get(st.group)
                while q:
                    self.de_global_queue.appendleft(q.pop())
        return st

    def can_finish_drain(self, engine: EngineId) -> bool:
        """True once the draining engine holds no unfinished request and
        no unfinished token.  ``read_q`` is not part of it: it tracks the
        node's disk queue, which others keep busy, and a request's read
        completes before its prefill."""
        st = self.engines[engine]
        return st.draining and st.seq == 0 and st.tok == 0

    def finish_drain(self, engine: EngineId, *, kind: str, group: int,
                     free_hbm_tokens: int = 0) -> EngineState:
        """Flip the drained engine's role: it leaves its old group (an
        emptied group is dropped) and is registered under
        ``kind``/``group``.  A PE→DE→PE round trip restores the
        scheduler's state exactly."""
        st = self.engines[engine]
        assert st.draining, f"{engine} was not draining"
        assert st.seq == 0 and st.tok == 0, \
            f"{engine} still has in-flight work"
        old = self._groups[st.group]
        old.remove(engine)
        if not old:
            del self._groups[st.group]
            q = self.de_private.pop(st.group, None)
            assert not q, f"drained group {st.group} still had queued work"
        st.kind = kind
        st.group = group
        st.draining = False
        # every charge of the engine's own requests is released; what is
        # left is a stale node-backlog report of the old role
        st.read_q = 0
        st.free_hbm_tokens = free_hbm_tokens if kind == "de" else 0
        # group members in engine-id order, as register_engine builds
        # them, so min() tie-breaks do not depend on flip history
        bisect.insort(self._groups.setdefault(group, []), engine)
        if kind == "de":
            self.de_private.setdefault(group, deque())
        return st

    # -- PE scheduling: Algorithm 1 ----------------------------------------
    def _classify_pe(self, engines: Sequence[EngineState]):
        c2 = [e for e in engines if not e.draining
              and e.read_q <= self.alpha and e.tok <= self.beta]
        c3 = [e for e in engines if not e.draining
              and e.read_q > self.alpha and e.tok <= self.beta]
        return c2, c3

    def on_pe_fetch(self, group: int,
                    reports: Optional[Dict[EngineId, Tuple[int, int, int]]] = None
                    ) -> List[Assignment]:
        """Leader-engine fetch for a PE group; ``reports`` refreshes
        (seq, tok, read_q) per engine."""
        members = [self.engines[e] for e in self._groups[group]]
        self._apply_reports(members, reports)
        out: List[Assignment] = []
        while self.pe_queue:
            c2, c3 = self._classify_pe(members)
            pool = c2 if c2 else c3
            if not pool:
                break
            req = self.pe_queue.popleft()
            pe = min(pool, key=lambda e: e.tok)
            req.pe = pe.engine
            pe.tok += req.prompt_tokens
            pe.seq += 1
            out.append(Assignment(req, pe.engine))
        return out

    # -- DE scheduling -----------------------------------------------------
    def de_phase1(self):
        """Drain the global DE queue into per-group private queues."""
        if not self.de_global_queue:
            return
        # a group whose every member drains cannot admit: requests routed
        # there would wait for the flip
        gtok = {g: sum(self.engines[e].tok for e in es)
                for g, es in self.groups("de").items()
                if any(not self.engines[e].draining for e in es)}
        if not gtok:
            return
        while self.de_global_queue:
            req = self.de_global_queue.popleft()
            g = min(gtok, key=gtok.get)
            self.de_private[g].append(req)
            gtok[g] += req.prompt_tokens

    def on_de_fetch(self, group: int,
                    reports: Optional[Dict[EngineId, Tuple[int, int, int, int]]] = None
                    ) -> List[Assignment]:
        """Two-phase DE scheduling; phase 1 runs on every fetch."""
        self.de_phase1()
        members = [self.engines[e] for e in self._groups[group]]
        self._apply_reports(members, reports)
        queue = self.de_private[group]
        free = {e.engine: e.free_hbm_tokens for e in members}
        # R: FIFO prefix fitting aggregate free HBM
        total_free = sum(free.values())
        acc, r_len = 0, []
        for r in queue:
            if acc + r.hbm_tokens > total_free:
                break
            acc += r.hbm_tokens
            r_len.append(r.prompt_tokens)
        n_engines = max(len(members), 1)
        z = self.z_factor * ((sum(r_len) +
                              sum(e.tok for e in members)) / n_engines)
        out: List[Assignment] = []
        while queue:
            req = queue[0]
            fits = [e for e in members
                    if not e.draining and free[e.engine] >= req.hbm_tokens]
            if not fits:
                break
            low = [e for e in fits if e.tok + req.prompt_tokens <= z]
            de = min(low, key=lambda e: e.seq) if low \
                else min(fits, key=lambda e: e.tok)
            queue.popleft()
            req.de = de.engine
            de.tok += req.prompt_tokens
            de.seq += 1
            free[de.engine] -= req.hbm_tokens
            de.free_hbm_tokens = free[de.engine]
            out.append(Assignment(req, de.engine))
        return out

    # -- read-path selection (§6.1) ----------------------------------------
    def _water_fill_frac(self, pe_q: int, de_q: int, h: int) -> float:
        """PE share x of ``h`` tokens equalising both sides' queue drain
        times: pe_q + x·h = de_q + (1−x)·h, clamped to [0, 1]."""
        return min(1.0, max(0.0, (de_q - pe_q + h) / (2.0 * h)))

    def _shorter_queue_side(self, pe_q: int, de_q: int) -> str:
        if pe_q == de_q:
            # ties alternate: a fixed preference overloads one side
            self._tie_toggle = not self._tie_toggle
            return "pe" if self._tie_toggle else "de"
        return "pe" if pe_q < de_q else "de"

    def _finalise_partition(self, req: Request, side: str, t: int,
                            snic: Dict[str, int]) -> str:
        """Install a tier/SNIC hit partition on the request, derive its
        (read_path, read_split) majority view and charge both sides'
        disk reading queues their SNIC share."""
        req.dram_side, req.dram_tokens = side, t
        req.snic_tokens = snic
        pe_total = snic["pe"] + (t if side == "pe" else 0)
        de_total = snic["de"] + (t if side == "de" else 0)
        if pe_total == de_total:
            req.read_path = side
        else:
            req.read_path = "pe" if pe_total > de_total else "de"
        major = pe_total if req.read_path == "pe" else de_total
        req.read_split = major / req.cached_tokens
        self.engines[req.pe].read_q += snic["pe"]
        self.engines[req.de].read_q += snic["de"]
        if self.tracer is not None:
            self.tracer.event("sched", "read_path", rid=req.rid,
                              path=req.read_path, split=req.read_split,
                              tier_side=side, tier_tokens=t,
                              pe_tokens=snic["pe"],
                              de_tokens=snic["de"])
        return req.read_path

    def choose_read_path(self, req: Request,
                         tier_tokens: Optional[Dict[str, int]] = None,
                         net_congestion: float = 0.0) -> str:
        """``tier_tokens``: the hit tokens resident as a prefix in each
        side's DRAM tier (None without tiers).  ``net_congestion`` in
        [0, 1] is the compute network's back-pressure: only DE-side reads
        cross the PE↔DE link, so the DE side's queue looks
        ``congestion · hit`` tokens deeper."""
        assert req.pe is not None and req.de is not None, req.rid
        pe_q = self.engines[req.pe].read_q
        de_q = self.engines[req.de].read_q
        # a draining side must empty, not refill: it looks a whole hit
        # deeper, so the read goes to the surviving side
        if self.engines[req.pe].draining:
            pe_q += req.cached_tokens
        if self.engines[req.de].draining:
            de_q += req.cached_tokens
        if tier_tokens and req.cached_tokens:
            t_pe = min(tier_tokens.get("pe", 0), req.cached_tokens)
            t_de = min(tier_tokens.get("de", 0), req.cached_tokens)
        else:
            t_pe = t_de = 0
        if t_pe or t_de:
            # prefer the side whose tier holds the longer prefix; the cold
            # remainder is routed by queue depth like a tier-less read (a
            # small warm prefix must not drag it onto a backlogged NIC)
            if t_pe > t_de:
                side, t = "pe", t_pe
            elif t_de > t_pe:
                side, t = "de", t_de
            else:
                side, t = self._shorter_queue_side(pe_q, de_q), t_pe
            rem = req.cached_tokens - t
            snic = {"pe": 0, "de": 0}
            if rem:
                bias = int(net_congestion * rem)
                if self.split_reads:
                    frac_pe = self._water_fill_frac(pe_q, de_q + bias, rem)
                    snic["pe"] = int(rem * frac_pe)
                    snic["de"] = rem - snic["pe"]
                else:
                    snic[self._shorter_queue_side(pe_q, de_q + bias)] = rem
            return self._finalise_partition(req, side, t, snic)
        bias = int(net_congestion * req.cached_tokens)
        if self.split_reads and req.cached_tokens:
            frac_pe = self._water_fill_frac(pe_q, de_q + bias,
                                            req.cached_tokens)
            req.read_path = "pe" if frac_pe >= 0.5 else "de"
            req.read_split = max(frac_pe, 1.0 - frac_pe)
        else:
            req.read_path = self._shorter_queue_side(pe_q, de_q + bias)
            req.read_split = 1.0
        tokens = req.read_tokens_by_side()
        self.engines[req.pe].read_q += tokens["pe"]
        self.engines[req.de].read_q += tokens["de"]
        if self.tracer is not None:
            self.tracer.event("sched", "read_path", rid=req.rid,
                              path=req.read_path, split=req.read_split,
                              tier_side="", tier_tokens=0,
                              pe_tokens=tokens["pe"],
                              de_tokens=tokens["de"])
        return req.read_path

    # -- hedged split reads --------------------------------------------------
    def rebalance_remainder(self, req: Request, from_side: str,
                            remaining_tokens: int, severity: float,
                            healthy_backlog_tokens: int = 0) -> int:
        """Hedge: ``from_side``'s read leg straggles (service-time ratio
        ``severity`` >= 1 against the healthy side) with
        ``remaining_tokens`` of its SNIC share unserved; move the
        water-filled part of that remainder (``loading.hedge_water_fill``)
        to the healthy side.  The request's SNIC partition becomes
        explicit (tier tokens never move), the reading queues transfer
        exactly the moved charge, and the (read_path, read_split) majority
        view is re-derived.  Returns the moved token count (0 = no
        hedge)."""
        assert from_side in ("pe", "de"), from_side
        to_side = "de" if from_side == "pe" else "pe"
        tokens = req.read_tokens_by_side()
        rem = max(0, min(int(remaining_tokens), tokens[from_side]))
        moved = hedge_water_fill(rem, max(severity, 1.0),
                                 max(int(healthy_backlog_tokens), 0))
        if moved <= 0:
            return 0
        snic = {from_side: tokens[from_side] - moved,
                to_side: tokens[to_side] + moved}
        req.snic_tokens = snic
        from_eng = req.pe if from_side == "pe" else req.de
        to_eng = req.pe if to_side == "pe" else req.de
        st_from = self.engines.get(from_eng)
        if st_from is not None:
            st_from.read_q = max(0, st_from.read_q - moved)
        st_to = self.engines.get(to_eng)
        if st_to is not None:
            st_to.read_q += moved
        # the majority view, as _finalise_partition derives it, without
        # charging the queues again
        t = req.dram_tokens
        pe_total = snic["pe"] + (t if req.dram_side == "pe" else 0)
        de_total = snic["de"] + (t if req.dram_side == "de" else 0)
        if pe_total != de_total:
            req.read_path = "pe" if pe_total > de_total else "de"
        elif req.read_path not in ("pe", "de"):
            req.read_path = to_side
        major = pe_total if req.read_path == "pe" else de_total
        if req.cached_tokens:
            req.read_split = major / req.cached_tokens
        if self.tracer is not None:
            self.tracer.event("sched", "hedge", rid=req.rid,
                              from_side=from_side, moved_tokens=moved)
        return moved

    # -- engine failure (fail-stop) -------------------------------------------
    def requeue_unstarted(self, engine: EngineId, requests):
        """Hand back ``engine``'s assigned requests whose read has not
        begun (``read_path is None``): nothing physical happened for them
        on this engine, so reassigning them is free.  ``requests`` is the
        runtime's in-flight request set; returns the requests given back,
        re-sorted into their queue in (class rank, arrival, rid) order."""
        st = self.engines[engine]
        back: List[Request] = []
        for req in requests:
            if req.read_path is not None:
                continue
            if st.kind == "pe" and req.pe == engine:
                req.pe = None
            elif st.kind == "de" and req.de == engine:
                req.de = None
                st.free_hbm_tokens += req.hbm_tokens
            else:
                continue
            st.seq = max(0, st.seq - 1)
            st.tok = max(0, st.tok - req.prompt_tokens)
            back.append(req)
        if back:
            # an assigned request left its queue at assignment, so
            # concatenate-and-sort restores the order without duplicates
            if st.kind == "pe":
                self.pe_queue = deque(sorted(
                    list(self.pe_queue) + back, key=self._order_key))
            else:
                self.de_global_queue = deque(sorted(
                    list(self.de_global_queue) + back,
                    key=self._order_key))
        return back

    def rebalance_de_private(self):
        """Pull every unassigned request out of the per-group private
        queues back into the global queue (queue order), so the next
        ``de_phase1`` routes them over the current group topology."""
        pend = list(self.de_global_queue)
        for q in self.de_private.values():
            while q:
                pend.append(q.popleft())
        pend.sort(key=self._order_key)
        self.de_global_queue = deque(pend)

    def fail_engine(self, engine: EngineId) -> EngineState:
        """Fail-stop removal, the involuntary form of a drain: the engine
        admits nothing from now on (``begin_drain``, with its queue
        hand-back), its outstanding charges are forfeited (the runtime
        re-homes its requests; the completion hooks swallow their late
        releases) and it leaves the registry."""
        st = self.engines[engine]
        if not st.draining:
            self.begin_drain(engine)
        grp = self._groups[st.group]
        grp.remove(engine)
        if not grp:
            del self._groups[st.group]
            q = self.de_private.pop(st.group, None)
            if q:
                pend = sorted(list(self.de_global_queue) + list(q),
                              key=self._order_key)
                self.de_global_queue = deque(pend)
        del self.engines[engine]
        return st

    # -- completion hooks --------------------------------------------------
    def on_read_done(self, engine: EngineId, tokens: int):
        st = self.engines.get(engine)
        if st is None:                 # engine failed: charge forfeited
            return
        st.read_q = max(0, st.read_q - tokens)

    def on_request_done(self, engine: EngineId, req: Request):
        st = self.engines.get(engine)
        if st is None:                 # engine failed: charge forfeited
            return
        st.seq = max(0, st.seq - 1)
        st.tok = max(0, st.tok - req.prompt_tokens)
        if st.kind == "de":
            st.free_hbm_tokens += req.hbm_tokens

    def _apply_reports(self, members, reports):
        if not reports:
            return
        for st in members:
            if st.engine in reports:
                vals = reports[st.engine]
                st.seq, st.tok, st.read_q = vals[0], vals[1], vals[2]
                if len(vals) > 3:
                    st.free_hbm_tokens = vals[3]


class RoundRobinScheduler(Scheduler):
    """Baseline for the Fig. 13 load-balance comparison: round-robin
    engine assignment, alternating read path (ignores queues and load)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._rr_pe = itertools.count()
        self._rr_de = itertools.count()
        self._rr_path = itertools.count()

    def on_pe_fetch(self, group, reports=None):
        members = [self.engines[e] for e in self._groups[group]]
        self._apply_reports(members, reports)
        # draining engines leave the rotation, as under every policy
        members = [e for e in members if not e.draining]
        out = []
        while self.pe_queue and members:
            req = self.pe_queue.popleft()
            pe = members[next(self._rr_pe) % len(members)]
            req.pe = pe.engine
            pe.tok += req.prompt_tokens
            pe.seq += 1
            out.append(Assignment(req, pe.engine))
        return out

    def on_de_fetch(self, group, reports=None):
        self.de_phase1()
        members = [self.engines[e] for e in self._groups[group]]
        self._apply_reports(members, reports)
        queue = self.de_private[group]
        out = []
        while queue:
            req = queue[0]
            fits = [e for e in members
                    if not e.draining and e.free_hbm_tokens >= req.hbm_tokens]
            if not fits:
                break
            de = fits[next(self._rr_de) % len(fits)]
            queue.popleft()
            req.de = de.engine
            de.tok += req.prompt_tokens
            de.seq += 1
            de.free_hbm_tokens -= req.hbm_tokens
            out.append(Assignment(req, de.engine))
        return out

    def choose_read_path(self, req: Request, tier_tokens=None,
                         net_congestion: float = 0.0) -> str:
        """Tier-aware like the base class (a DRAM-resident prefix skips
        the storage NIC whatever the policy), but the cold remainder
        keeps the round-robin alternation: no queue depths, no
        congestion signal."""
        if tier_tokens and req.cached_tokens:
            t_pe = min(tier_tokens.get("pe", 0), req.cached_tokens)
            t_de = min(tier_tokens.get("de", 0), req.cached_tokens)
        else:
            t_pe = t_de = 0
        if t_pe or t_de:
            # one draw per request, so the parity alternates
            flip = next(self._rr_path) % 2 == 0
            if t_pe > t_de:
                side, t = "pe", t_pe
            elif t_de > t_pe:
                side, t = "de", t_de
            else:   # equal prefixes: alternate, like every other RR choice
                side, t = ("pe" if flip else "de"), t_pe
            rem = req.cached_tokens - t
            snic = {"pe": 0, "de": 0}
            if rem:
                snic["pe" if flip else "de"] = rem
            return self._finalise_partition(req, side, t, snic)
        req.read_path = "pe" if next(self._rr_path) % 2 == 0 else "de"
        req.read_split = 1.0
        side = self.engines[req.pe if req.read_path == "pe" else req.de]
        side.read_q += req.cached_tokens
        return req.read_path


def water_fill_frac_batch(pe_q, de_q, h):
    """:meth:`Scheduler._water_fill_frac` over request arrays: the same
    expression in the same IEEE doubles, so it equals the scalar form
    element for element.  ``h`` must be positive, as there."""
    pe_q = np.asarray(pe_q, dtype=np.float64)
    de_q = np.asarray(de_q, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    return np.clip((de_q - pe_q + h) / (2.0 * h), 0.0, 1.0)
