"""Load-aware admission control, the online SLO layer's front gate (port
of ``repro.core.admission``).

Every online round arrival is first shown to :class:`AdmissionGate`,
which holds a queueing-delay-aware TTFT estimate built from the
per-role seconds-of-service signals (:class:`core.autoscale.LoadSignals`):

    est = (queued + busy + read-backlog seconds) / admitting PEs
          + own storage-read seconds + own prefill seconds

An arrival whose estimate exceeds ``admission_ttft_slo_s`` is *deferred*
(resubmitted ``admission_defer_s`` later, when the backlog has partly
drained); after ``admission_max_defers`` consecutive deferrals it is
*rejected* (load shedding: the trajectory ends).  With
``SloConfig.admission`` unset the gate is never built and arrivals go
straight to ``Scheduler.submit``.
"""
from __future__ import annotations

from typing import Dict, Hashable

from repro_torch.core.autoscale import LoadSignals
from repro_torch.core.config import SloConfig

#: decisions returned by :meth:`AdmissionGate.decide`
ADMIT = "admit"
DEFER = "defer"
REJECT = "reject"


class AdmissionGate:
    """SLO-budget gate over round arrivals.

    ``key`` identifies one logical arrival across its re-submissions (the
    runtime uses ``(trajectory id, round index)``), so the defer counter
    survives the deferrals and the gate can escalate to a rejection.
    """

    def __init__(self, slo: SloConfig):
        self.slo = slo
        self.admitted_rounds = 0
        self.deferred_rounds = 0
        self.rejected_rounds = 0
        self._defers: Dict[Hashable, int] = {}

    def ttft_estimate(self, sig: LoadSignals, read_s: float,
                      prefill_s: float) -> float:
        """TTFT estimate of a new arrival whose own storage read and
        prefill take ``read_s`` and ``prefill_s``: the prefill-side
        backlog over the admitting PEs, plus its own service."""
        backlog = sig.pe_queued_s + sig.pe_busy_s + sig.pe_read_q_s
        return backlog / max(sig.n_pe, 1) + read_s + prefill_s

    def decide(self, key: Hashable, ttft_est: float) -> str:
        """ADMIT / DEFER / REJECT one arrival given its TTFT estimate."""
        if ttft_est <= self.slo.admission_ttft_slo_s:
            self._defers.pop(key, None)
            self.admitted_rounds += 1
            return ADMIT
        n = self._defers.get(key, 0)
        if n >= self.slo.admission_max_defers:
            self._defers.pop(key, None)
            self.rejected_rounds += 1
            return REJECT
        self._defers[key] = n + 1
        self.deferred_rounds += 1
        return DEFER

    def counters(self) -> Dict[str, int]:
        """The three admission counters, as ``stats()`` names them."""
        return dict(admitted_rounds=self.admitted_rounds,
                    deferred_rounds=self.deferred_rounds,
                    rejected_rounds=self.rejected_rounds)


__all__ = ["AdmissionGate", "ADMIT", "DEFER", "REJECT"]
