"""Tiered KV-Cache: a capacity-bounded node-local DRAM tier (port of
``repro.kvcache.tiers``).

The remote store is reachable only through the storage NIC, so every hit
byte a round-start read pulls pays the SNIC.  ``DramTier`` layers a
node-local DRAM cache over the store: blocks staged there are served at
round start without touching the SNIC.

* **capacity-bounded** — admissions never push ``used_bytes`` past
  ``capacity_bytes``; if eviction cannot free enough space the admission
  is rejected (the block stays remote), never over-committed;
* **ref-count pinning** — blocks held by an in-flight request carry a
  pin count and are never eviction victims;
* **eviction policies** — ``LRUPolicy`` (recency) and
  ``AgenticTTLPolicy`` (trajectory liveness: blocks of finished
  trajectories first, then of trajectories idle past a TTL, then LRU);
* **a store in front of the store** — with a ``backing`` store the tier
  serves real FullBlocks: hits never reach the backing store, misses
  read through and are admitted, writes write through and warm the tier.

Tier payloads are host numpy FullBlocks, never device tensors.
``ThinkTimePrefetcher`` plans which predicted next-round hit blocks to
stage during the inter-round think gap; the serving system moves them.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Iterable, Iterator, List, \
    Optional, Sequence, Set


@dataclass
class TierEntry:
    ref: Hashable
    nbytes: int
    owner: Optional[Hashable] = None      # trajectory id
    payload: object = None                # host FullBlock
    last_used: float = 0.0
    pins: int = 0


class EvictionPolicy:
    """Victim selection strategy.  ``victims`` yields candidate entries
    in eviction order; the tier skips pinned ones and stops once enough
    bytes are freed."""

    name = "base"

    def victims(self, tier: "DramTier", now: float) -> Iterator[TierEntry]:
        raise NotImplementedError  # pragma: no cover - abstract


class LRUPolicy(EvictionPolicy):
    """Least-recently-used: the tier keeps entries in recency order."""

    name = "lru"

    def victims(self, tier: "DramTier", now: float) -> Iterator[TierEntry]:
        # lazy: the tier drops its victims only after the iteration stops
        yield from tier._entries.values()


class AgenticTTLPolicy(EvictionPolicy):
    """Trajectory-liveness eviction for agentic workloads: a finished
    trajectory's prefix is never hit again (hits occur only within a
    trajectory, paper §A.4).  Victim order: blocks of trajectories marked
    done, then of trajectories idle longer than ``ttl_s``, then LRU."""

    name = "agentic-ttl"

    def __init__(self, ttl_s: float = 120.0):
        self.ttl_s = ttl_s

    def victims(self, tier: "DramTier", now: float) -> Iterator[TierEntry]:
        done = tier._done_owners
        for owner in list(done):                # 1. dead trajectories
            for ref in list(tier._by_owner.get(owner, ())):
                e = tier._entries.get(ref)
                if e is not None:
                    yield e
        expired = {o for o, last in tier._owner_alive.items()
                   if o not in done and now - last > self.ttl_s}
        if expired:
            for e in tier._entries.values():    # 2. TTL-expired
                if e.owner in expired:
                    yield e
        for e in tier._entries.values():        # 3. LRU fallback
            if e.owner not in done and e.owner not in expired:
                yield e


def make_policy(name: str, **kw) -> EvictionPolicy:
    if name == "lru":
        return LRUPolicy()
    if name == "agentic-ttl":
        ttl = kw.get("ttl_s")
        return AgenticTTLPolicy(ttl) if ttl is not None else \
            AgenticTTLPolicy()
    raise ValueError(f"unknown tier eviction policy {name!r} "
                     f"(valid: lru, agentic-ttl)")


class DramTier:
    """Node-local DRAM tier over a remote KVStore.

    With ``backing`` set the tier has the store's hot-path interface
    (``alloc_ref`` / ``read_block`` / ``read_blocks`` / ``write_block``),
    so a decode engine persists through it unchanged."""

    #: optional flight recorder (repro_torch.obs.Tracer) and track label,
    #: attached by the owning runtime; None = untraced
    tracer = None
    track = "tier"

    def __init__(self, capacity_bytes: float, policy="lru",
                 backing=None, ttl_s: Optional[float] = None):
        self.capacity_bytes = float(capacity_bytes)
        kw = {"ttl_s": ttl_s} if ttl_s is not None else {}
        self.policy = make_policy(policy, **kw)
        self.backing = backing
        self._entries: "OrderedDict[Hashable, TierEntry]" = OrderedDict()
        self._by_owner: Dict[Hashable, Set[Hashable]] = {}
        self._owner_alive: Dict[Hashable, float] = {}
        self._done_owners: Set[Hashable] = set()
        self._tick = itertools.count()
        # owner-provided clock (the serving system's modelled seconds),
        # consulted when a call site passes no ``now`` (engine persists
        # through the plain store interface); without one, timestamps
        # are operation counts
        self.clock_fn: Optional[Callable[[], float]] = None
        self.used_bytes = 0
        self._pinned_bytes = 0
        # --- accounting -------------------------------------------------
        self.dram_hit_bytes = 0       # hit bytes served from DRAM (no SNIC)
        self.miss_bytes = 0           # demand reads through the backing store
        self.prefetch_bytes = 0       # bytes staged ahead of demand
        self.evicted_bytes = 0
        self.rejected_bytes = 0       # admissions refused (pinned/capacity)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    # occupancy queries
    # ------------------------------------------------------------------
    @property
    def free_bytes(self) -> float:
        return self.capacity_bytes - self.used_bytes

    def __len__(self) -> int:
        return len(self._entries)

    def contains(self, ref) -> bool:
        return ref in self._entries

    def resident_prefix(self, refs: Sequence) -> int:
        """Number of leading refs resident: hits are prefixes, so only a
        resident prefix can be served without a hole."""
        n = 0
        for r in refs:
            if r not in self._entries:
                break
            n += 1
        return n

    # ------------------------------------------------------------------
    # pinning (in-flight requests)
    # ------------------------------------------------------------------
    def pin(self, refs: Iterable) -> None:
        n_pinned = 0
        for r in refs:
            e = self._entries.get(r)
            if e is not None:
                if e.pins == 0:
                    self._pinned_bytes += e.nbytes
                e.pins += 1
                n_pinned += 1
        if n_pinned and self.tracer is not None:
            self.tracer.event(self.track, "pin", n=n_pinned,
                              pinned_bytes=self._pinned_bytes)

    def unpin(self, refs: Iterable) -> None:
        for r in refs:
            e = self._entries.get(r)
            if e is not None and e.pins > 0:
                e.pins -= 1
                if e.pins == 0:
                    self._pinned_bytes -= e.nbytes

    def pinned_bytes(self) -> int:
        return self._pinned_bytes

    def can_admit(self, nbytes: int) -> bool:
        """Whether an admission of ``nbytes`` could succeed: free space
        plus every unpinned byte covers it (so the prefetcher pays no
        backing read for a block the tier would reject)."""
        return 0 < nbytes <= self.capacity_bytes - self._pinned_bytes

    # ------------------------------------------------------------------
    # trajectory liveness (AgenticTTLPolicy signals)
    # ------------------------------------------------------------------
    def note_alive(self, owner, now: Optional[float] = None) -> None:
        if owner is None:
            return
        self._owner_alive[owner] = self._now(now)
        self._done_owners.discard(owner)

    def note_done(self, owner) -> None:
        if owner is None:
            return
        if not self._by_owner.get(owner):
            self._forget_owner(owner)
        else:
            self._done_owners.add(owner)

    def _forget_owner(self, owner) -> None:
        self._by_owner.pop(owner, None)
        self._owner_alive.pop(owner, None)
        self._done_owners.discard(owner)

    # ------------------------------------------------------------------
    # admission / eviction
    # ------------------------------------------------------------------
    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return float(now)
        if self.clock_fn is not None:
            return float(self.clock_fn())
        return float(next(self._tick))

    def touch(self, refs: Iterable, now: Optional[float] = None) -> None:
        t = self._now(now)
        for r in refs:
            e = self._entries.get(r)
            if e is not None:
                e.last_used = t
                self._entries.move_to_end(r)

    def admit(self, ref, nbytes: int, owner=None, payload=None,
              now: Optional[float] = None, prefetch: bool = False) -> bool:
        """Stage one block; False when it cannot fit (eviction could not
        free enough unpinned bytes).  Re-admitting a resident ref
        refreshes its recency (and payload and owner, if given)."""
        t = self._now(now)
        e = self._entries.get(ref)
        if e is not None:
            e.last_used = t
            if payload is not None:
                e.payload = payload
            if owner is not None:
                self._reown(e, owner)
            self._entries.move_to_end(ref)
            return True
        nbytes = int(nbytes)
        if nbytes > self.capacity_bytes or nbytes <= 0:
            self.rejected_bytes += max(nbytes, 0)
            return False
        if self.used_bytes + nbytes > self.capacity_bytes and \
                not self._evict(self.used_bytes + nbytes -
                                self.capacity_bytes, t):
            self.rejected_bytes += nbytes
            return False
        e = TierEntry(ref=ref, nbytes=nbytes, owner=owner, payload=payload,
                      last_used=t)
        self._entries[ref] = e
        self.used_bytes += nbytes
        if owner is not None:
            self._by_owner.setdefault(owner, set()).add(ref)
        if prefetch:
            self.prefetch_bytes += nbytes
            if self.tracer is not None:
                self.tracer.event(self.track, "prefetch_admit",
                                  nbytes=nbytes)
        return True

    def _reown(self, e: TierEntry, owner) -> None:
        if e.owner == owner:
            return
        if e.owner is not None:
            self._by_owner.get(e.owner, set()).discard(e.ref)
        e.owner = owner
        self._by_owner.setdefault(owner, set()).add(e.ref)

    def _evict(self, need_bytes: float, now: float) -> bool:
        """Free at least ``need_bytes`` of unpinned entries, in policy
        order; False if the tier cannot free enough."""
        freed = 0.0
        victims: List[TierEntry] = []
        for e in self.policy.victims(self, now):
            if freed >= need_bytes:
                break
            if e.pins > 0 or e.ref not in self._entries:
                continue
            victims.append(e)
            freed += e.nbytes
        if freed < need_bytes:
            return False
        for e in victims:
            self._drop(e)
        return True

    def _drop(self, e: TierEntry) -> None:
        self._entries.pop(e.ref, None)
        self.used_bytes -= e.nbytes
        self.evicted_bytes += e.nbytes
        self.evictions += 1
        if self.tracer is not None:
            self.tracer.event(self.track, "evict", nbytes=e.nbytes)
            self.tracer.counter(f"{self.track}/occupancy",
                                used_bytes=self.used_bytes)
        if e.owner is not None:
            held = self._by_owner.get(e.owner)
            if held is not None:
                held.discard(e.ref)
                if not held and e.owner in self._done_owners:
                    self._forget_owner(e.owner)   # last dead block gone

    def evict_bytes(self, nbytes: float, now: Optional[float] = None) -> bool:
        """External pressure: free ``nbytes`` of unpinned entries."""
        return self._evict(nbytes, self._now(now))

    # ------------------------------------------------------------------
    # accounting-only serving (the simulator's path)
    # ------------------------------------------------------------------
    def serve(self, refs: Sequence, now: Optional[float] = None) -> int:
        """Mark ``refs`` (all resident) as served from DRAM; the byte
        count.  The simulator serves the resident prefix it charged to a
        ``*_tier`` plan leg this way: no payload moves."""
        t = self._now(now)
        served = 0
        for r in refs:
            e = self._entries[r]
            e.last_used = t
            self._entries.move_to_end(r)
            served += e.nbytes
            self.hits += 1
        self.dram_hit_bytes += served
        return served

    # ------------------------------------------------------------------
    # the store interface, over the backing store
    # ------------------------------------------------------------------
    @property
    def layout(self):
        return self.backing.layout

    def alloc_ref(self) -> int:
        return self.backing.alloc_ref()

    def read_block(self, ref, owner=None, now: Optional[float] = None):
        e = self._entries.get(ref)
        if e is not None and e.payload is not None:
            e.last_used = self._now(now)
            self._entries.move_to_end(ref)
            self.hits += 1
            self.dram_hit_bytes += e.nbytes
            return e.payload
        block = self.backing.read_block(ref)       # SNIC read-through
        nbytes = self.backing.layout.full_block_bytes
        self.misses += 1
        self.miss_bytes += nbytes
        self.admit(ref, nbytes, owner=owner, payload=block, now=now)
        return block

    def read_blocks(self, refs: Sequence, owner=None,
                    now: Optional[float] = None) -> List:
        return [self.read_block(r, owner=owner, now=now) for r in refs]

    def write_block(self, ref, block, owner=None,
                    now: Optional[float] = None) -> None:
        """Write-through and warm-up: the block just passed through this
        node's DRAM on its way to storage, so admit it."""
        self.backing.write_block(ref, block)
        self.admit(ref, self.backing.layout.full_block_bytes, owner=owner,
                   payload=block, now=now)

    def prefetch_block(self, ref, owner=None,
                       now: Optional[float] = None) -> int:
        """Stage one block from the backing store ahead of demand; the
        bytes moved (0 if resident or inadmissible).  The admissibility
        check runs before the backing read, so a full or pinned tier
        burns no SNIC bandwidth on a block it would drop."""
        if ref in self._entries:
            self.touch([ref], now)
            return 0
        nbytes = self.backing.layout.full_block_bytes
        if not self.can_admit(nbytes):
            return 0
        block = self.backing.read_block(ref)
        if self.admit(ref, nbytes, owner=owner, payload=block, now=now,
                      prefetch=True):
            return nbytes
        return 0

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return dict(
            used_bytes=self.used_bytes,
            capacity_bytes=self.capacity_bytes,
            entries=len(self._entries),
            dram_hit_bytes=self.dram_hit_bytes,
            miss_bytes=self.miss_bytes,
            prefetch_bytes=self.prefetch_bytes,
            evicted_bytes=self.evicted_bytes,
            rejected_bytes=self.rejected_bytes,
            hits=self.hits, misses=self.misses, evictions=self.evictions,
        )


class ThinkTimePrefetcher:
    """Plans which predicted next-round hit blocks to stage during the
    inter-round think gap, when the storage NICs sit idle.  The predicted
    hit is the trajectory's current context (exactly the trie match), so
    the plan is its non-resident blocks, in order, grouped into chunks of
    ``chunk_blocks``: staged front first, a round that starts early still
    finds a resident prefix.  The simulator stages a chunk per storage-NIC
    job; the serving runtime stages the whole plan at once."""

    def __init__(self, chunk_blocks: int = 32):
        self.chunk_blocks = max(int(chunk_blocks), 1)
        self.rounds_planned = 0
        self.blocks_planned = 0

    def plan(self, tier: DramTier, refs: Sequence) -> List[List]:
        """Missing refs, in order, grouped into stage-order chunks."""
        missing = [r for r in refs if not tier.contains(r)]
        self.rounds_planned += 1
        self.blocks_planned += len(missing)
        return [missing[i:i + self.chunk_blocks]
                for i in range(0, len(missing), self.chunk_blocks)]
