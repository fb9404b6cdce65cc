"""Agent trajectories (port of ``Round`` and ``Trajectory`` from
``repro.sim.traces``).  Each round appends ``append`` tokens to the full
previous context and generates ``gen``; everything but the append hits
the KV-Cache.  Think times and the synthetic Table-2 dataset generator
arrive with the online-serving and simulator slices."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class Round:
    append: int
    gen: int


@dataclass
class Trajectory:
    tid: int
    rounds: List[Round]

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)
