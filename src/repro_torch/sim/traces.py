"""Agent trajectories (port of ``Round`` and ``Trajectory`` from
``repro.sim.traces``).  Each round appends ``append`` tokens to the full
previous context and generates ``gen``; everything but the append hits
the KV-Cache (hits only within a trajectory, §A.4).  ``think`` is the
inter-round gap before a round's submission in online serving, and
``slo_class`` the priority class of every round of a trajectory.  The
synthetic Table-2 dataset generator arrives with the slice that drives
it (a benchmark or the simulator).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class Round:
    append: int
    gen: int
    # seconds between the previous round's completion and this round's
    # submission (tool execution); 0 for the first round
    think: float = 0.0


@dataclass
class Trajectory:
    tid: int
    rounds: List[Round]
    # SLO class carried onto every Request this trajectory submits
    # (core/config.SloConfig class_aware): 'interactive' | 'batch'
    slo_class: str = "batch"

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)
