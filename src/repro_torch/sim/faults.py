"""Fault model of the serving runtime (port of ``repro.sim.faults``).

A :class:`FaultSchedule` describes partial failures on the modelled
clock: a storage NIC slowed down, a compute-network link flapping, an
engine dying, a read leg straggling.  The reference's simulator and
serving runtime, and this port's serving runtime, read the same schedule.

* **Deterministic.**  A schedule is pure data: windows, death times and
  a hash-based straggler draw.  No RNG state is consumed at query time,
  so callers asking in different orders see identical faults.
* **Empty = invisible.**  An empty schedule makes every hook a no-op:
  the runtime normalises it to ``None``.
* **Slowdowns are service-time multipliers** (>= 1), never rates.

``SlowdownWindow``: resource ``"snic"`` (one node's or every node's
storage NIC) or ``"net"`` (the compute network), active on
``t0 <= t < t1``; overlapping windows multiply.  ``EngineDeath``: an
engine fails permanently at ``t`` and the runtime re-homes its rounds.
``StragglerModel``: with probability ``prob`` a request's read leg on
one side is slowed by ``severity``; hedged split reads exist to cut it.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

__all__ = ["SlowdownWindow", "EngineDeath", "StragglerModel",
           "FaultSchedule"]

_RESOURCES = ("snic", "net")


@lru_cache(maxsize=65536)
def _straggle_draw(seed: int, rid: int, side: str) -> float:
    """The uniform draw behind :meth:`StragglerModel.factor`, memoized.

    A runtime asks for the same ``(rid, side)`` factor several times per
    request (a leg's start, hedging probes); the md5 is pure in ``(seed, rid,
    side)`` so the hash only ever needs to run once per key.

    md5, not crc32: crc is linear, so draws for keys differing only in
    the side suffix would be XOR-correlated — both sides of one request
    would (not) straggle together.
    """
    d = hashlib.md5(f"{seed}:{rid}:{side}".encode()).digest()
    return int.from_bytes(d[:8], "big") / float(1 << 64)


@dataclass(frozen=True)
class SlowdownWindow:
    """Service-time multiplier ``factor`` on one resource over
    ``[t0, t1)``.  ``node=None`` hits every node (a fabric-wide flap);
    an integer restricts the window to that node's SNIC."""
    resource: str                  # "snic" | "net"
    t0: float
    t1: float
    factor: float                  # >= 1: service-time multiplier
    node: Optional[int] = None

    def __post_init__(self):
        if self.resource not in _RESOURCES:
            raise ValueError(f"resource {self.resource!r} "
                             f"(valid: {_RESOURCES})")
        if not self.t1 > self.t0:
            raise ValueError(f"empty window [{self.t0}, {self.t1})")
        if self.factor < 1.0:
            raise ValueError(f"factor {self.factor} < 1 (slowdowns only; "
                             f"speedups would break conservation checks)")

    def active(self, t: float) -> bool:
        return self.t0 <= t < self.t1


@dataclass(frozen=True)
class EngineDeath:
    """Permanent fail-stop of engine ``engine`` (an ``(node, idx)`` id)
    at time ``t``.  Fail-stop, not fail-slow: in-flight work on the
    engine is lost and must be re-homed by the runtime."""
    t: float
    engine: Tuple[int, int]


@dataclass(frozen=True)
class StragglerModel:
    """Hash-seeded per-read-leg straggle draw.

    ``factor(rid, side)`` is a pure function of ``(seed, rid, side)`` —
    no RNG state — so the order in which legs start can never change
    which legs straggle, and a straggler observed in a chaos failure
    reproduces exactly from the schedule's seed.
    """
    prob: float                    # P[leg straggles] in [0, 1]
    severity: float                # service-time multiplier when it does
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob {self.prob} outside [0, 1]")
        if self.severity < 1.0:
            raise ValueError(f"severity {self.severity} < 1")

    def factor(self, rid: int, side: str) -> float:
        if self.prob <= 0.0:
            return 1.0
        return (self.severity
                if _straggle_draw(self.seed, rid, side) < self.prob
                else 1.0)


@dataclass
class FaultSchedule:
    """The full fault timeline for one run.  Queried, never mutated."""
    windows: List[SlowdownWindow] = field(default_factory=list)
    deaths: List[EngineDeath] = field(default_factory=list)
    straggler: Optional[StragglerModel] = None

    def __post_init__(self):
        # deterministic processing order regardless of construction order
        self.windows = sorted(self.windows,
                              key=lambda w: (w.t0, w.t1, w.resource,
                                             -1 if w.node is None else w.node))
        self.deaths = sorted(self.deaths, key=lambda d: (d.t, d.engine))

    # -- queries -----------------------------------------------------------
    @property
    def empty(self) -> bool:
        """True iff every hook is guaranteed a no-op (used by both
        runtimes to skip fault plumbing entirely on the happy path)."""
        return (not self.windows and not self.deaths and
                (self.straggler is None or self.straggler.prob <= 0.0))

    def snic_factor(self, node: int, t: float) -> float:
        """Composed service-time multiplier on node ``node``'s storage
        NIC at time ``t`` (overlapping windows multiply)."""
        f = 1.0
        for w in self.windows:
            if (w.resource == "snic" and w.active(t)
                    and (w.node is None or w.node == node)):
                f *= w.factor
        return f

    def net_factor(self, t: float) -> float:
        """Composed multiplier on the compute-network link at ``t``."""
        f = 1.0
        for w in self.windows:
            if w.resource == "net" and w.active(t):
                f *= w.factor
        return f

    def leg_factor(self, rid: int, side: str) -> float:
        """Straggle multiplier for request ``rid``'s ``side`` read leg."""
        if self.straggler is None:
            return 1.0
        return self.straggler.factor(rid, side)

    def boundaries(self, resource: str) -> List[float]:
        """Sorted unique window edges for ``resource`` — the instants a
        runtime must re-evaluate rates at (the sim re-shares the shared
        link at each ``net`` boundary)."""
        return self.boundaries_array(resource).tolist()

    def boundaries_array(self, resource: str) -> "np.ndarray":
        """:meth:`boundaries` as a float64 ndarray (sorted, deduplicated).

        Both runtimes consume this form: the event loop schedules one
        re-share per edge, and the vectorized macro-stepper feeds it
        straight into its next-boundary argmin without a list->array
        conversion per step.  Kept as the single source of truth so the
        two engines can never disagree on where a window edge falls.
        """
        import numpy as np
        ts = [t for w in self.windows if w.resource == resource
              for t in (w.t0, w.t1)]
        return np.unique(np.asarray(ts, dtype=np.float64))

    # -- construction ------------------------------------------------------
    @classmethod
    def generate(cls, seed: int, duration_s: float, nodes: Sequence[int],
                 engines: Sequence[Tuple[int, int]] = (),
                 snic_fault_rate: float = 0.0,
                 snic_factor: float = 4.0,
                 snic_window_s: float = 10.0,
                 link_flap_rate: float = 0.0,
                 link_factor: float = 3.0,
                 link_window_s: float = 2.0,
                 straggler_prob: float = 0.0,
                 straggler_severity: float = 6.0,
                 n_deaths: int = 0,
                 death_frac: float = 0.5) -> "FaultSchedule":
        """Seeded random schedule: Poisson-ish window starts (expected
        ``rate * duration`` windows per process, uniform starts), plus
        ``n_deaths`` engine deaths clustered at ``death_frac`` of the
        run.  Same ``(seed, params)`` -> same schedule, always."""
        import numpy as np
        rng = np.random.default_rng(seed)
        windows: List[SlowdownWindow] = []
        n_snic = int(round(snic_fault_rate * duration_s))
        for _ in range(n_snic):
            t0 = float(rng.uniform(0.0, max(duration_s - snic_window_s,
                                            1e-9)))
            node = int(rng.choice(list(nodes))) if len(nodes) else None
            windows.append(SlowdownWindow("snic", t0, t0 + snic_window_s,
                                          snic_factor, node=node))
        n_flap = int(round(link_flap_rate * duration_s))
        for _ in range(n_flap):
            t0 = float(rng.uniform(0.0, max(duration_s - link_window_s,
                                            1e-9)))
            windows.append(SlowdownWindow("net", t0, t0 + link_window_s,
                                          link_factor))
        deaths: List[EngineDeath] = []
        if n_deaths and len(engines):
            idxs = rng.choice(len(engines), size=min(n_deaths,
                                                     len(engines)),
                              replace=False)
            for i in sorted(int(j) for j in idxs):
                t = float(duration_s * death_frac *
                          (1.0 + 0.1 * rng.uniform(-1.0, 1.0)))
                deaths.append(EngineDeath(t, tuple(engines[i])))
        strag = (StragglerModel(straggler_prob, straggler_severity,
                                seed=seed)
                 if straggler_prob > 0.0 else None)
        return cls(windows=windows, deaths=deaths, straggler=strag)
