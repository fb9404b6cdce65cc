"""Load signals of the deployment (port of ``LoadSignals`` from
``repro.core.autoscale``).

:class:`LoadSignals` is one observation of queued and in-flight work per
engine role, in *seconds of service* (tokens over that role's per-engine
token rate), so prefill and decode pressure compare.  The SLO layer's
admission gate reads it; the reference's elastic PD controller, victim
choice and drains read it too and arrive with the elastic slice.
"""
from __future__ import annotations

from dataclasses import dataclass


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
