"""Elastic PE↔DE role reconfiguration (port of ``repro.core.autoscale``).

* :class:`LoadSignals` — one observation of queued and in-flight work per
  engine role, in *seconds of service* (tokens over that role's
  per-engine token rate), so prefill and decode pressure compare.  The
  admission gate and the controller read it.
* :class:`PDController` — a hysteresis controller over the pressure
  ratio: at most one flip per observation, only after ``patience``
  consecutive observations outside the [lo, hi] band, never inside the
  cooldown after the previous one, never below one engine per role.
* :class:`DrainTracker` — the drain protocol's bookkeeping: one drain per
  engine at a time, drained before flipped, and the totals ``stats()``
  reports.  The runtime runs the protocol (scheduler ``begin_drain`` →
  in-flight rounds finish → weight reload → ``finish_drain``).
* :func:`pick_victim` — which engine drains.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

EngineId = Tuple[int, int]

#: role-flip actions the controller can propose
DE_TO_PE = "de->pe"
PE_TO_DE = "pe->de"

#: victim-selection policies for the drain
DRAIN_POLICIES = ("idlest", "rotate")


@dataclass
class LoadSignals:
    """One observation of the deployment's load, per engine role."""

    n_pe: int                       # admitting (non-draining) PEs
    n_de: int                       # admitting (non-draining) DEs
    pe_queued_s: float              # un-assigned + assigned-unstarted work
    pe_busy_s: float                # in-flight prefill work
    de_queued_s: float              # waiting in the DE global/private queues
    de_busy_s: float                # remaining decode work of active slots
    pe_read_q_s: float = 0.0        # PE-side disk reading queue backlog
    de_read_q_s: float = 0.0        # DE-side disk reading queue backlog
    net_congestion: float = 0.0     # compute-network congestion in [0, 1]
    dram_hit_ratio: float = 0.0     # tier hits / (tier hits + SNIC reads)
    # class-aware signals: the share of each role's queued seconds owed
    # to interactive rounds, counted twice in the pressures; 0.0 when
    # class-aware scheduling is off
    pe_queued_interactive_s: float = 0.0
    de_queued_interactive_s: float = 0.0

    @property
    def pe_pressure(self) -> float:
        """Seconds of outstanding prefill-side work per admitting PE
        (storage reads feed the prefill, so their backlog counts;
        interactive backlog counts twice)."""
        tot = self.pe_queued_s + self.pe_busy_s + self.pe_read_q_s \
            + self.pe_queued_interactive_s
        return tot / max(self.n_pe, 1)

    @property
    def de_pressure(self) -> float:
        tot = self.de_queued_s + self.de_busy_s + self.de_read_q_s \
            + self.de_queued_interactive_s
        return tot / max(self.n_de, 1)


@dataclass
class PDController:
    """Hysteresis controller choosing the PD ratio from observed load.

    ``observe`` returns DE_TO_PE, PE_TO_DE or None.  ``idle_floor_s``
    guards the ratio against noise: when both sides' pressure is below it
    the system is idle and no evidence accumulates either way."""

    hi: float = 2.0                 # pe_pressure/de_pressure above => +PE
    lo: float = 0.5                 # below => +DE
    patience: int = 2               # consecutive out-of-band observations
    cooldown_s: float = 0.0         # min seconds between proposals
    min_pe: int = 1
    min_de: int = 1
    idle_floor_s: float = 1e-3
    # --- state ----------------------------------------------------------
    _streak: int = 0                # signed: +k toward PE, -k toward DE
    _last_action_t: float = field(default=float("-inf"))
    n_proposed: int = 0

    #: optional flight recorder (repro_torch.obs.Tracer); a class
    #: attribute, not a field, so a tracer changes neither the repr, the
    #: equality nor the constructor
    tracer = None

    def target_ratio(self, sig: LoadSignals) -> float:
        """pe/de pressure ratio of this observation (inf when DEs idle)."""
        de = sig.de_pressure
        if de <= self.idle_floor_s:
            return float("inf") if sig.pe_pressure > self.idle_floor_s \
                else 1.0
        return sig.pe_pressure / de

    def observe(self, sig: LoadSignals, now: float) -> Optional[str]:
        if sig.pe_pressure <= self.idle_floor_s and \
                sig.de_pressure <= self.idle_floor_s:
            self._streak = 0            # idle: no evidence either way
            return None
        r = self.target_ratio(sig)
        if r > self.hi:
            self._streak = self._streak + 1 if self._streak > 0 else 1
        elif r < self.lo:
            self._streak = self._streak - 1 if self._streak < 0 else -1
        else:
            self._streak = 0            # inside the dead band
            return None
        if abs(self._streak) < self.patience:
            return None
        if now - self._last_action_t < self.cooldown_s:
            return None
        if self._streak > 0:
            if sig.n_de <= self.min_de:
                return None
            action = DE_TO_PE
        else:
            if sig.n_pe <= self.min_pe:
                return None
            action = PE_TO_DE
        self._streak = 0
        self._last_action_t = now
        self.n_proposed += 1
        if self.tracer is not None:
            self.tracer.event("autoscale", "proposal", t=now,
                              action=action,
                              ratio=(-1.0 if r == float("inf") else r),
                              n_pe=sig.n_pe, n_de=sig.n_de)
        return action


@dataclass
class DrainRecord:
    """One role reconfiguration in progress (or done)."""

    engine: EngineId
    from_kind: str
    to_kind: str
    t_begin: float
    t_drained: float = -1.0         # in-flight states emptied
    t_flip: float = -1.0            # kind flipped (after weight reload)
    tier_handoff_bytes: int = 0     # tier-resident bytes kept at flip


class DrainTracker:
    """Drains in progress and the log of finished ones."""

    def __init__(self):
        self.active: Dict[EngineId, DrainRecord] = {}
        self.log: List[DrainRecord] = []

    def begin(self, engine: EngineId, from_kind: str, to_kind: str,
              now: float) -> DrainRecord:
        assert engine not in self.active, f"{engine} is already draining"
        rec = DrainRecord(engine, from_kind, to_kind, t_begin=now)
        self.active[engine] = rec
        return rec

    def mark_drained(self, engine: EngineId, now: float) -> DrainRecord:
        rec = self.active[engine]
        assert rec.t_drained < 0, f"{engine} drained twice"
        rec.t_drained = now
        return rec

    def finish(self, engine: EngineId, now: float,
               tier_handoff_bytes: int = 0) -> DrainRecord:
        rec = self.active[engine]
        assert rec.t_drained >= 0, f"{engine} flipped before draining"
        del self.active[engine]
        rec.t_flip = now
        rec.tier_handoff_bytes = tier_handoff_bytes
        self.log.append(rec)
        return rec

    def abort(self, engine: EngineId) -> Optional[DrainRecord]:
        """Drop a drain whose victim died before it flipped: not a role
        change, so it is not logged."""
        return self.active.pop(engine, None)

    @property
    def n_flips(self) -> int:
        return len(self.log)

    def drain_seconds(self) -> float:
        """Admission-stop-to-flip seconds summed over finished flips."""
        return sum(r.t_flip - r.t_begin for r in self.log)

    def flips_by_direction(self) -> Dict[str, int]:
        out = {DE_TO_PE: 0, PE_TO_DE: 0}
        for r in self.log:
            out[f"{r.from_kind}->{r.to_kind}"] += 1
        return out

    def tier_handoff_bytes(self) -> int:
        return sum(r.tier_handoff_bytes for r in self.log)


def pick_victim(candidates, policy: str, load_of, rotation: int = 0):
    """The engine to drain, from a non-empty ``candidates`` list.
    ``idlest`` takes the least ``load_of``; ``rotate`` takes them in
    engine-id order by ``rotation``, spreading flips over the fleet."""
    if policy == "rotate":
        ordered = sorted(candidates, key=lambda e: tuple(_eid_of(e)))
        return ordered[rotation % len(ordered)]
    if policy != "idlest":
        raise ValueError(f"unknown drain_policy {policy!r}; "
                         f"expected one of {DRAIN_POLICIES}")
    return min(candidates, key=load_of)


def _eid_of(candidate):
    eid = getattr(candidate, "eid", None)
    if eid is None:
        eid = getattr(candidate, "engine", candidate)
    return eid
