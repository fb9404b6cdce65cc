"""Fleet-scale vectorized event engine: the struct-of-arrays drain pool
(port of ``repro.sim.vectorized``).

``Sim`` (sim/simulator.py) is a per-object discrete-event simulator: every
transfer leg is a Python ``Flow``, and every processor-sharing reshare
resettles each affected flow — and pushes one completion-check event per
flow — in a Python loop.  At fleet scale that loop is the simulator's own
bottleneck: a shared link carrying N flows costs O(N) Python per join or
leave plus O(N) heap events.

:class:`VectorSim` keeps the event loop and every request-lifecycle
handler of ``Sim`` (it *is* a ``Sim``; scheduling decisions, loading
plans, NIC FIFOs, tiers, step timing, metrics all run the shared code),
and replaces only the processor-sharing drain plane with a
struct-of-arrays pool (:class:`FlowPool`):

* per-flow state (``nbytes_left``, ``rate``, ``t_last``, absolute drain
  ``eta``) lives in parallel numpy arrays, not object attributes;
* a reshare settles all affected flows and recomputes every rate and
  every completion time with a handful of array ops (per-resource fair
  shares from incrementally maintained ``cap``/``n_flows`` arrays; the
  VL-arbitered :class:`~repro_torch.network.SharedLink` contributes one
  per-class rate vector through the same
  :func:`~repro_torch.core.traffic.allocate_bandwidth` call ``Sim``
  uses);
* instead of one check event per flow per reshare, the pool schedules a
  *single* next-boundary event at the argmin of the drain completions.
  Arrivals, fault-window edges and NIC completions remain ordinary loop
  events, so event *order* matches ``Sim`` by construction.

Contract: on any supported config, ``VectorSim.results()`` equals
``Sim.results()`` (settles are the same IEEE arithmetic at the same
instants, so observed runs are bit-identical).

Like ``Sim``, the engine runs on the host and takes no ``device=``.  The
one opt-in device step is the settle's ``now + nl / rate``:
``VectorSim(cfg, trajs, settle_device="cuda")`` computes it in float64
tensors on that device (``None``, the default, keeps numpy).  Naming a
device that is not there raises; nothing falls back.

Not supported (raise :class:`VectorSimUnsupported`): engine deaths,
hedged reads, elastic reconfiguration — the paths that cancel or shrink
in-flight work mid-drain.  Everything else — split reads, DRAM tiers,
FIFO/VL arbitration, background load, slowdown windows, stragglers,
prefetch, online arrivals — runs vectorized.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.traffic import TrafficClass, allocate_bandwidth
from repro_torch.network.link import SharedLink
from repro_torch.sim.simulator import INF, Sim, SimConfig

__all__ = ["VectorSim", "VectorSimUnsupported", "FlowPool"]


def _noop():
    return None


_TCLASSES = tuple(TrafficClass)
_TCODE = {c: i for i, c in enumerate(_TCLASSES)}
_COLL_CODE = _TCODE[TrafficClass.MODEL_COLLECTIVE]
_MAX_RES = 4                      # widest loading-plan leg (de_h2d: 3)


class VectorSimUnsupported(ValueError):
    """Config uses a feature the vectorized engine does not model."""


class _PoolFlow:
    """Handle for one slot of the struct-of-arrays pool.

    Resources keep these in their ``flows`` sets (SharedLink reads
    ``tclass`` / ``nbytes_left`` / ``nbytes_total`` / ``t_enter`` for
    arbitration, congestion and delay accounting), but all mutable drain
    state lives in the pool arrays — the handle is an index."""

    __slots__ = ("pool", "slot", "fid", "tclass", "nbytes_total",
                 "t_enter", "resources", "on_done", "done")

    @property
    def nbytes_left(self) -> float:
        # read live (and deliberately stale-between-settles, exactly like
        # Flow.nbytes_left) by SharedLink.congestion()
        return self.pool.nl[self.slot]

    @property
    def rate(self) -> float:
        return self.pool.rate[self.slot]

    def _finish(self):
        if self.done:
            return
        self.done = True
        pool = self.pool
        now = pool.sim.loop.now
        for r in self.resources:
            r.flows.discard(self)
            pool._leave(self, r)
            note = getattr(r, "note_done", None)
            if note is not None:
                note(self, now)
        pool._release(self)
        if self.resources:
            pool.sim._reshare(self.resources)
        self.on_done()

    def cancel(self):
        raise VectorSimUnsupported(
            "flow cancellation (engine-death recovery) is not modelled "
            "by the vectorized engine")


class _PoolLink(SharedLink):
    """SharedLink whose O(flows) congestion walk reads the pool arrays.

    ``congestion()`` sums every on-link flow's ``nbytes_left``; under a
    deep fleet backlog that walk is O(k) Python per scheduling decision
    — quadratic over a run.  The pool holds the identical settled
    values in one column, so the ratio reduces to two masked numpy
    sums.  Summation order differs from the set walk (slot order,
    pairwise), which the engine-equivalence suite pins as harmless: the
    signal's consumers (water-fill, pacing) are threshold comparisons
    fed from both engines' runs bit-identically in practice."""

    __slots__ = ("pool",)

    def congestion(self) -> float:
        if not math.isfinite(self.cap) or not self.flows:
            return 0.0
        return self.pool.link_congestion()


class FlowPool:
    """Struct-of-arrays drain state for every in-flight PS transfer."""

    def __init__(self, sim: "VectorSim", resources, link):
        self.sim = sim
        # --- fixed resource census (rid 0 is the padding pseudo-resource:
        # infinite cap, zero flows, so gathers through it yield +inf and
        # never win a min) --------------------------------------------------
        self._rid = {id(r): i + 1 for i, r in enumerate(resources)}
        self.res_cap = np.asarray([INF] + [r.cap for r in resources],
                                  dtype=np.float64)
        self.res_n = np.zeros(len(resources) + 1, dtype=np.int64)
        self.link = link
        self.link_rid = self._rid[id(link)]
        # scratch lookup table for vectorized affected-set discovery:
        # touched[rid] flips True for the reshare's resources, and one
        # gather through the res matrix replaces the Python set union
        self._touched = np.zeros(len(resources) + 2, dtype=bool)
        # per-class member count on the shared link, maintained on
        # enter/leave — the same census SharedLink._class_counts rebuilds
        # from its flow set
        self.link_counts = np.zeros(len(_TCLASSES), dtype=np.int64)
        self._link_vl = link.arbiter == "vl" and math.isfinite(link.cap)
        # --- per-flow arrays -------------------------------------------------
        n = 256
        self.nl = np.zeros(n)                 # bytes left (settled)
        self.rate = np.zeros(n)               # current PS share [B/s]
        self.t_last = np.zeros(n)             # last settle instant
        self.eta = np.full(n, INF)            # absolute drain completion
        # the heap sequence number this flow's completion check would
        # have consumed in the per-object loop — the same-timestamp
        # tie-break (see EventLoop.reserve)
        self.eseq = np.full(n, 2 ** 62, dtype=np.int64)
        self.fid = np.full(n, -1, dtype=np.int64)
        self.tcode = np.zeros(n, dtype=np.int16)
        # resource ids as _MAX_RES separate contiguous columns: short
        # inner-axis reductions on an (n, 4) matrix are numpy's worst
        # case, while chained 1-D gathers/minimums vectorize cleanly
        self.res = [np.zeros(n, dtype=np.int32) for _ in range(_MAX_RES)]
        self.on_link = np.zeros(n, dtype=bool)
        # resource-SET signature: flows sharing a set share a PS min —
        # the per-flow min-gather collapses to a per-signature min (a
        # few hundred rows at fleet scale) plus one gather through sig
        self.sig = np.zeros(n, dtype=np.int32)
        self._sig_of: Dict[Tuple[int, ...], int] = {}
        self._sig_res = np.zeros((1, _MAX_RES), dtype=np.int32)  # row 0: empty
        self.flows: List[Optional[_PoolFlow]] = [None] * n
        # bump allocation + periodic compaction: slots are handed out in
        # spawn order, and spawn order IS fid order, so the live region
        # [0, _next_slot) is always fid-sorted — reshares need no
        # argsort, and every scan stops at _next_slot
        self._next_slot = 0
        # widest leg seen so far: mask/min scans read only the first
        # _res_width res columns (legs rarely span all _MAX_RES)
        self._res_width = 1
        self._pending: Set[Tuple[float, int]] = set()  # armed boundary keys
        self._lcr_cache = None                # per-class link rates
        self._lcr_dirty = True                # census changed since cached
        self._lcr_cap = link.cap              # cap the cache was built at
        # Sim leaves every superseded per-flow check in the heap; those
        # stale pops are no-ops but still advance loop.now, so the final
        # clock (results' sim_time, hence throughput) is max over every
        # check ever scheduled.  Track that max and keep one no-op event
        # at it so the pooled engine's clock drains to the same instant.
        self._watermark = -INF
        self.n_reshares = 0
        self.n_live = 0
        self.peak_flows = 0

    # -- slot management ---------------------------------------------------
    def _compact(self):
        """Out of bump space: squeeze released slots out of the live
        region (preserving order, so it stays fid-sorted) and double the
        arrays when more than half the slots are genuinely live.
        Handles are re-pointed; a stale slot cached by a pending
        boundary event fails its (eta, eseq) validation and re-arms."""
        ns = self._next_slot
        live = np.nonzero(self.fid[:ns] >= 0)[0]
        n_live = len(live)
        cap = len(self.flows)
        new_cap = cap * 2 if n_live > cap // 2 else cap
        arrays = {"nl": np.zeros(new_cap), "rate": np.zeros(new_cap),
                  "t_last": np.zeros(new_cap),
                  "eta": np.full(new_cap, INF),
                  "eseq": np.full(new_cap, 2 ** 62, dtype=np.int64),
                  "fid": np.full(new_cap, -1, dtype=np.int64),
                  "tcode": np.zeros(new_cap, dtype=np.int16),
                  "on_link": np.zeros(new_cap, dtype=bool),
                  "sig": np.zeros(new_cap, dtype=np.int32)}
        for name, arr in arrays.items():
            arr[:n_live] = getattr(self, name)[live]
            setattr(self, name, arr)
        for j in range(_MAX_RES):
            col = np.zeros(new_cap, dtype=np.int32)
            col[:n_live] = self.res[j][live]
            self.res[j] = col
        flows: List[Optional[_PoolFlow]] = [None] * new_cap
        old = self.flows
        for i, s in enumerate(live.tolist()):
            f = old[s]
            f.slot = i
            flows[i] = f
        self.flows = flows
        self._next_slot = n_live

    def spawn(self, nbytes, resources, on_done, tclass) -> _PoolFlow:
        sim = self.sim
        f = _PoolFlow()
        f.pool = self
        f.fid = next(sim._flow_seq)
        f.resources = [r for r in resources if r is not None]
        f.tclass = tclass
        f.nbytes_total = float(max(nbytes, 1.0))
        f.t_enter = sim.loop.now
        f.on_done = on_done
        f.done = False
        ns = self._next_slot
        if ns == len(self.flows) or (ns > 2048 and self.n_live * 2 < ns):
            # out of bump space, or mostly dead: every reshare/arm scan
            # runs over [0, ns), so squeezing released slots out early
            # keeps the array kernels sized to the live population
            self._compact()
        s = f.slot = self._next_slot
        self._next_slot = s + 1
        self.nl[s] = f.nbytes_total
        self.rate[s] = 0.0
        self.t_last[s] = sim.loop.now
        self.eta[s] = INF
        self.eseq[s] = 2 ** 62
        self.fid[s] = f.fid
        self.tcode[s] = _TCODE[tclass]
        self.flows[s] = f
        res = self.res
        for j in range(_MAX_RES):
            res[j][s] = 0
        if not f.resources:
            sim.loop.after(0.0, f._finish)
            return f
        if len(f.resources) > _MAX_RES:
            raise VectorSimUnsupported(
                f"leg spans {len(f.resources)} resources (> {_MAX_RES})")
        if len(f.resources) > self._res_width:
            self._res_width = len(f.resources)
        onl = False
        key = []
        for j, r in enumerate(f.resources):
            rid = self._rid.get(id(r))
            if rid is None:
                raise VectorSimUnsupported(
                    f"flow on unregistered resource {r!r}")
            res[j][s] = rid
            key.append(rid)
            note = getattr(r, "note_enter", None)
            if note is not None:
                note(f)
            r.flows.add(f)
            self.res_n[rid] += 1
            if rid == self.link_rid:
                onl = True
                self.link_counts[self.tcode[s]] += 1
                self._lcr_dirty = True
        self.on_link[s] = onl
        key = tuple(key)
        sig = self._sig_of.get(key)
        if sig is None:
            sig = self._sig_of[key] = len(self._sig_res)
            row = np.zeros((1, _MAX_RES), dtype=np.int32)
            row[0, :len(key)] = key
            self._sig_res = np.concatenate([self._sig_res, row])
        self.sig[s] = sig
        self.n_live += 1
        if self.n_live > self.peak_flows:
            self.peak_flows = self.n_live
        sim._reshare(f.resources)
        return f

    def _leave(self, f: _PoolFlow, r) -> None:
        rid = self._rid[id(r)]
        self.res_n[rid] -= 1
        if rid == self.link_rid:
            self.link_counts[self.tcode[f.slot]] -= 1
            self._lcr_dirty = True

    def _release(self, f: _PoolFlow) -> None:
        s = f.slot
        self.eta[s] = INF
        self.eseq[s] = 2 ** 62
        self.fid[s] = -1
        self.on_link[s] = False
        self.sig[s] = 0
        for j in range(_MAX_RES):
            self.res[j][s] = 0
        self.flows[s] = None
        if f.resources:
            self.n_live -= 1

    def link_congestion(self) -> float:
        """Vectorized :meth:`SharedLink.congestion`: the collective
        share of in-flight bytes on the link, from the pool's settled
        ``nl`` column — the same deliberately-stale-between-settles
        values the per-object walk reads off each flow."""
        ns = self._next_slot
        onl = self.on_link[:ns]
        nl = np.maximum(self.nl[:ns], 0.0)
        tot = float(np.sum(nl, where=onl, initial=0.0))
        if tot <= 0.0:
            return 0.0
        coll = float(np.sum(nl, initial=0.0,
                            where=onl & (self.tcode[:ns] == _COLL_CODE)))
        return coll / tot

    # -- vectorized drain algebra -----------------------------------------
    def link_class_rates(self) -> np.ndarray:
        """Per-class flow rate on the VL-arbitered link — the same
        ``allocate_bandwidth`` arithmetic SharedLink.rate_of performs,
        evaluated once per census change instead of once per flow (the
        allocation is pure in ``(counts, cap)``, so enter/leave mark it
        dirty, a cap change — a fault-window flap — is caught by the
        cap compare, and everything else reuses the cached rates)."""
        if not self._lcr_dirty and self.link.cap == self._lcr_cap:
            return self._lcr_cache
        counts = self.link_counts
        active = {_TCLASSES[i]: int(c)
                  for i, c in enumerate(counts) if c}
        alloc = allocate_bandwidth(active, self.link.cap, self.link.arb)
        out = np.full(len(_TCLASSES), INF)
        for i, c in enumerate(_TCLASSES):
            n = int(counts[i])
            if n:
                out[i] = alloc.get(c, 0.0) / n
        self._lcr_cache = out
        self._lcr_dirty = False
        self._lcr_cap = self.link.cap
        return out

    def reshare(self, rids: List[int]) -> None:
        """Settle, re-rate and re-arm every flow on the resources in
        ``rids`` — the vectorized counterpart of Sim._reshare's per-flow
        loop.  Affected-set discovery is a table lookup through the res
        matrix, not a Python set union."""
        sim = self.sim
        loop = sim.loop
        now = loop.now
        self.n_reshares += 1
        ns = self._next_slot
        touched = self._touched
        touched[rids] = True
        # a signature is affected iff any of its resources is; the
        # per-flow membership test is one gather through sig (the
        # signature table is a few hundred rows, the pool thousands)
        sr = self._sig_res
        tsig = touched[sr[:, 0]]
        for j in range(1, self._res_width):
            tsig |= touched[sr[:, j]]
        mask = tsig[self.sig[:ns]]
        touched[rids] = False
        # released slots have zeroed res rows, so the mask is live-only;
        # the live region is fid-sorted by construction (bump allocation
        # in spawn = fid order), which is exactly the order Sim._reshare
        # sweeps — no argsort needed for the seq-number consumption
        idx = np.nonzero(mask)[0]
        k = len(idx)
        if k == 0:
            # a finish may have consumed the armed boundary even when it
            # leaves its resources empty — keep the pool armed
            self.arm()
            return
        if k <= 8:
            # numpy dispatch overhead (~30 kernel launches) dwarfs the
            # math below ~10 flows; run the same arithmetic scalar.
            # Python floats are IEEE doubles, so every branch produces
            # bit-identical values to the array path.
            self._reshare_scalar(idx, now)
            return
        with np.errstate(invalid="ignore", divide="ignore"):
            # settle at `now` with the *old* rates (inf-rate flows are
            # served instantaneously; inf * 0 would be nan)
            r_old = self.rate[idx]
            dt = now - self.t_last[idx]
            nlv = np.where(np.isinf(r_old), 0.0,
                           self.nl[idx] - r_old * dt)
            self.nl[idx] = nlv
            self.t_last[idx] = now
            # new rates: each resource's fair share is computed once on
            # the small per-resource arrays (cap / n_flows — identical
            # to PSResource.rate_of and Sim._reshare's share cache),
            # then one gather through the padded rid matrix gives every
            # flow's min; the VL link's class-aware share overrides its
            # generic column
            self.res_cap[self.link_rid] = self.link.cap   # track flaps
            shares = self.res_cap / np.maximum(self.res_n, 1)
            if self._link_vl:
                shares[self.link_rid] = INF
            # min fair share per *signature* (rid 0 pads gather INF —
            # res_cap[0] is the INF sentinel — so short legs are
            # unaffected), then one gather fans it out per flow
            smin = shares[sr[:, 0]]
            for j in range(1, self._res_width):
                np.minimum(smin, shares[sr[:, j]], out=smin)
            rmin = smin[self.sig[idx]]
            if self._link_vl:
                onl = self.on_link[idx]
                if onl.any():
                    lr = self.link_class_rates()[self.tcode[idx]]
                    rmin = np.where(onl, np.minimum(rmin, lr), rmin)
            self.rate[idx] = rmin
            # sub-byte residual or unbounded rate finishes now; the rest
            # get an absolute drain eta.  Sim pushes one heap event per
            # flow here (a zero-delay finish or a completion check); we
            # push only the finishes, but *reserve* every seq the checks
            # would have consumed and stamp each live flow with its
            # would-be seq — the armed boundary event then reuses the
            # winner's seq, so every same-timestamp ordering matches the
            # per-object loop.
            fin = (nlv <= 1.0) | np.isinf(rmin)
            live = ~fin & (rmin > 0)
            cs = np.cumsum(fin | live)         # the seqs Sim would burn
            seqs = cs + (loop.reserve(int(cs[-1])) - 1)
            self.eseq[idx[live]] = seqs[live]
            settled = sim._settle_kernel
            if settled is not None:            # opt-in device settle
                eta = np.where(live, settled(nlv, rmin, now), INF)
            else:
                eta = np.where(live, now + nlv / rmin, INF)
            self.eta[idx] = eta
        if live.any():
            self._bump_watermark(float(np.max(eta, initial=-INF,
                                              where=live)))
        if fin.any():
            heap = loop._heap
            flows = self.flows
            for j in np.nonzero(fin)[0]:
                heapq.heappush(heap, (now, int(seqs[j]),
                                      flows[int(idx[j])]._finish))
        self.arm()

    def _reshare_scalar(self, idx, now: float) -> None:
        """Small-affected-set reshare: identical arithmetic to the array
        path (and to Sim._reshare), executed with scalar ops.  Slot
        order is fid order, so seq consumption and finish scheduling
        interleave exactly as the sorted per-object sweep does."""
        loop = self.sim.loop
        nl = self.nl
        rate = self.rate
        t_last = self.t_last
        eta = self.eta
        eseq = self.eseq
        res = self.res
        res_cap = self.res_cap
        res_n = self.res_n
        link_rid = self.link_rid
        res_cap[link_rid] = self.link.cap     # track flaps
        link_vl = self._link_vl
        lr = None
        heap = loop._heap
        wm = -INF
        for s in idx.tolist():
            r_old = rate[s]
            if math.isinf(r_old):
                nlv = 0.0
            else:
                nlv = nl[s] - r_old * (now - t_last[s])
            nl[s] = nlv
            t_last[s] = now
            rmin = INF
            for col in res:
                rid = int(col[s])
                if rid and not (link_vl and rid == link_rid):
                    share = res_cap[rid] / max(res_n[rid], 1)
                    if share < rmin:
                        rmin = share
            if link_vl and self.on_link[s]:
                if lr is None:
                    lr = self.link_class_rates()
                cr = lr[self.tcode[s]]
                if cr < rmin:
                    rmin = cr
            rate[s] = rmin
            if nlv <= 1.0 or math.isinf(rmin):
                heapq.heappush(heap, (now, loop._take(),
                                      self.flows[s]._finish))
                eta[s] = INF
            elif rmin > 0:
                e = now + nlv / rmin
                eseq[s] = loop._take()
                eta[s] = e
                if e > wm:
                    wm = e
            else:
                eta[s] = INF
        if wm > -INF:
            self._bump_watermark(wm)
        self.arm()

    def _bump_watermark(self, t: float) -> None:
        if t > self._watermark and math.isfinite(t):
            self._watermark = t
            # seq 2**62 keeps the tuple unique (watermark times strictly
            # increase) and sorts after any real event at the same t
            heapq.heappush(self.sim.loop._heap, (t, 2 ** 62, _noop))

    def arm(self) -> None:
        """Arm the next-boundary event: the lexicographic ``(eta, eseq)``
        argmin over every in-flight drain — exactly the next pooled
        completion the per-object heap would pop."""
        ns = self._next_slot
        if ns == 0:
            return
        eta = self.eta[:ns]
        w = int(eta.argmin())
        m = eta[w]
        if not math.isfinite(m):
            return
        cand = np.nonzero(eta == m)[0]
        if len(cand) > 1:      # eta tie: earliest would-be check seq wins
            w = int(cand[np.argmin(self.eseq[cand])])
        key = (float(m), int(self.eseq[w]))
        if key in self._pending:
            return
        self._pending.add(key)
        heapq.heappush(self.sim.loop._heap,
                       (key[0], key[1], lambda: self._boundary(key, w)))

    def _boundary(self, key: Tuple[float, int], s: int) -> None:
        """The macro-step boundary.  Runs Sim._flow_check's arithmetic on
        the armed flow; a finish triggers a reshare, which re-arms the
        next boundary.  A slot whose ``(eta, eseq)`` no longer matches
        the armed key is a stale arming (the winner was resheared at
        this instant by an earlier event) — it degenerates to a re-arm,
        like a version-stale check."""
        self._pending.discard(key)
        t, seq = key
        if self.eseq[s] != seq or self.eta[s] != t:
            self.arm()
            return
        f = self.flows[s]
        loop = self.sim.loop
        now = loop.now
        rate = self.rate[s]
        if math.isinf(rate):
            f._finish()
            return
        nl = self.nl[s] - rate * (now - self.t_last[s])
        self.nl[s] = nl
        self.t_last[s] = now
        if nl <= 1.0:
            f._finish()
        else:
            # float drift: reschedule the residual instead of dropping
            # it, consuming one check seq as _flow_check would
            self.eseq[s] = loop.reserve(1)
            self.eta[s] = now + nl / max(rate, 1.0)
            self._bump_watermark(float(self.eta[s]))
            self.arm()


class _DeviceSettle:
    """The drain completion times ``now + nl / rate`` in float64 tensors
    on ``device``, returned as a host array: the numpy settle's IEEE
    arithmetic, element for element.  ``calls`` counts the settles it
    computed."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"VectorSim settle_device={device!r}: cuda is not "
                f"available")
        self.calls = 0

    def __call__(self, nl: np.ndarray, rate: np.ndarray,
                 now: float) -> np.ndarray:
        self.calls += 1
        t_nl = self.torch.from_numpy(nl).to(self.device)
        t_rate = self.torch.from_numpy(rate).to(self.device)
        return (now + t_nl / t_rate).cpu().numpy()


class VectorSim(Sim):
    """Drop-in ``Sim`` with the struct-of-arrays drain pool.

    Construction, ``run()`` and ``results()`` are the base class's; the
    only overridden machinery is flow creation (``_flow``) and the PS
    reshare (``_reshare``).  See the module docstring for the contract
    and :func:`check_supported` for the gated features."""

    def __init__(self, cfg: SimConfig, trajectories, tracer=None,
                 settle_device=None):
        check_supported(cfg)
        super().__init__(cfg, trajectories, tracer=tracer)
        # swap the shared link for the pool-backed one BEFORE any flow
        # exists: every Sim reference is a late-bound `self.net` lookup,
        # so the plain SharedLink built by Sim.__init__ is simply
        # dropped here
        link = _PoolLink(self.net.name, self.net.cap,
                         arbiter=self.net.arbiter, arb=self.net.arb)
        self.net = link
        resources = (list(self.dram.values()) +
                     list(self.cnic_rd.values()) +
                     list(self.cnic_wr.values()) + [self.net])
        self.pool = FlowPool(self, resources, self.net)
        link.pool = self.pool
        # None keeps the numpy settle
        self._settle_kernel = None if settle_device is None \
            else _DeviceSettle(settle_device)

    # -- drain plane overrides --------------------------------------------
    def _flow(self, nbytes, resources, on_done,
              tclass: TrafficClass = TrafficClass.KV_TRANSFER):
        return self.pool.spawn(nbytes, resources, on_done, tclass)

    def _reshare(self, resources):
        pool = self.pool
        rid = pool._rid
        pool.reshare([rid[id(r)] for r in resources])

    # -- struct-of-arrays request table -----------------------------------
    def request_table(self) -> Dict[str, np.ndarray]:
        """Every round's lifecycle as parallel arrays (rid-aligned):
        arrival/stamp columns, token counts and the per-side read
        partition — the fleet benchmark computes its SLO/throughput
        curves from these instead of iterating round objects."""
        rounds = self.rounds
        n = len(rounds)

        def col(fn, dtype=np.float64):
            return np.fromiter((fn(r) for r in rounds), dtype=dtype,
                               count=n)

        return {
            "rid": col(lambda r: r.req.rid, np.int64),
            "arrival": col(lambda r: r.req.arrival),
            "submit_t": col(lambda r: r.submit_t),
            "read_done_t": col(lambda r: r.read_done_t),
            "prefill_done_t": col(lambda r: r.prefill_done_t),
            "first_decode_t": col(lambda r: r.first_decode_t),
            "second_token_t": col(lambda r: r.second_token_t),
            "done_t": col(lambda r: r.done_t),
            "cached_tokens": col(lambda r: r.req.cached_tokens, np.int64),
            "new_tokens": col(lambda r: r.req.new_tokens, np.int64),
            "gen_tokens": col(lambda r: r.gen_total, np.int64),
            "dram_tokens": col(lambda r: r.req.dram_tokens, np.int64),
            "read_pe_tokens": col(
                lambda r: r.req.read_tokens_by_side()["pe"]
                if r.req.read_path else 0, np.int64),
            "read_de_tokens": col(
                lambda r: r.req.read_tokens_by_side()["de"]
                if r.req.read_path else 0, np.int64),
        }


def check_supported(cfg: SimConfig) -> None:
    """Raise :class:`VectorSimUnsupported` for configs whose semantics
    the pool cannot reproduce (paths that cancel or re-partition
    in-flight drains)."""
    bad = []
    if cfg.elastic:
        bad.append("elastic role reconfiguration")
    if cfg.hedge_reads:
        bad.append("hedged split reads")
    if cfg.faults is not None and not cfg.faults.empty and cfg.faults.deaths:
        bad.append("engine deaths")
    if bad:
        raise VectorSimUnsupported(
            f"VectorSim does not support: {', '.join(bad)} — "
            f"use sim.simulator.Sim for these configs")
