"""Agent trajectories and the synthetic dataset calibrated to the paper's
Table 2 (port of ``repro.sim.traces``).

| MaxLen | Turns | Append | Gen | Total | Context |
|  32K   |  60   |  608   | 148 | 28639 | 17183   |
|  48K   | 106   |  474   | 172 | 42607 | 25120   |
|  64K   | 157   |  429   | 176 | 55958 | 32721   |

Each trajectory is a sequence of rounds (append_i, gen_i); round i's
prompt is the full previous context plus append_i, of which everything
but append_i hits the KV-Cache (hits only within a trajectory, §A.4).
``think`` is the inter-round gap before a round's submission, and
``slo_class`` the priority class of every round of a trajectory.  Per
§A.3, trajectories past the first ``base`` resample an existing one and
prepend a synthetic first round.

Append and gen lengths are drawn lognormal (heavy-tailed, like tool
output) and trajectories truncate at MaxLen, which reproduces the Table 2
means to within a few percent.  The draws consume one
``np.random.Generator`` stream in the reference's order, so
``generate_dataset(n, max_len, seed)`` gives the reference's
trajectories exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

TABLE2 = {
    32768: dict(turns=60, append=608, gen=148, total=28639, context=17183),
    49152: dict(turns=106, append=474, gen=172, total=42607, context=25120),
    65536: dict(turns=157, append=429, gen=176, total=55958, context=32721),
}


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
    # (core/config.SloConfig class_aware): 'interactive' | 'batch'.
    # Assigned by workloads, never drawn from the RNG.
    slo_class: str = "batch"

    @property
    def total_tokens(self) -> int:
        return sum(r.append + r.gen for r in self.rounds)

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def context_before(self, i: int) -> int:
        return sum(r.append + r.gen for r in self.rounds[:i])

    def mean_context(self) -> float:
        """Mean context at each round's prompt time (Table 2's
        'Context')."""
        return float(np.mean([self.context_before(i)
                              for i in range(len(self.rounds))]))

    def scaled(self, append_scale: float = 1.0, gen_scale: float = 1.0,
               max_len: Optional[int] = None) -> "Trajectory":
        """Paper §7.3: scale every round's append and gen by a constant
        and truncate the whole trajectory at ``max_len``."""
        rounds, tot = [], 0
        for r in self.rounds:
            a = max(1, int(round(r.append * append_scale)))
            g = max(1, int(round(r.gen * gen_scale)))
            if max_len is not None and tot + a + g > max_len:
                break
            rounds.append(Round(a, g, r.think))
            tot += a + g
        if not rounds:
            rounds = [Round(1, 1)]
        return Trajectory(self.tid, rounds, self.slo_class)


def _lognormal(rng, mean, sigma=0.9, size=None):
    mu = math.log(mean) - sigma * sigma / 2.0
    return rng.lognormal(mu, sigma, size)


def generate_trajectory(tid: int, max_len: int, rng: np.random.Generator,
                        think_mean_s: float = 0.0) -> Trajectory:
    stats = TABLE2.get(max_len)
    if stats is None:  # interpolate for non-table lengths
        stats = dict(append=500, gen=160, total=int(max_len * 0.87))
    # Table 2's Turns/Append/Total are jointly consistent only with a
    # strong per-trajectory anti-correlation between turn count and
    # append size (many-turn agents emit short tool calls): a
    # per-trajectory "chattiness" u scales appends by 1/u².
    u = float(rng.lognormal(0.0, 0.55))
    app_mean = max(24.0, stats["append"] / (u * u))
    stop_total = int(min(max_len, stats["total"] * rng.uniform(0.75, 1.25)))
    rounds: List[Round] = []
    # first round: the task prompt (larger, like a repo/issue description)
    first = int(np.clip(_lognormal(rng, stats["append"] * 4), 64, max_len // 4))
    g0 = max(1, int(_lognormal(rng, stats["gen"], 0.6)))
    rounds.append(Round(first, g0))
    total = first + g0
    while total < stop_total:
        a = max(1, int(_lognormal(rng, app_mean, 0.6)))
        g = max(1, int(_lognormal(rng, stats["gen"], 0.6)))
        if total + a + g > max_len:
            break
        # think time is drawn only when asked for, so datasets without it
        # consume the same RNG stream
        th = float(_lognormal(rng, think_mean_s, 0.6)) \
            if think_mean_s > 0 else 0.0
        rounds.append(Round(a, g, th))
        total += a + g
    return Trajectory(tid, rounds)


def generate_dataset(n: int, max_len: int, seed: int = 0,
                     base: int = 500,
                     think_mean_s: float = 0.0) -> List[Trajectory]:
    """``n`` trajectories: the first ``min(n, base)`` independent, the
    rest resampling an existing one with a synthetic first round (§A.3).
    ``think_mean_s`` > 0 draws a lognormal inter-round think time per
    round."""
    rng = np.random.default_rng(seed)
    out: List[Trajectory] = []
    for tid in range(min(n, base)):
        out.append(generate_trajectory(tid, max_len, rng, think_mean_s))
    for tid in range(len(out), n):
        src = out[rng.integers(0, min(n, base))]
        synth = Round(int(rng.integers(8, 64)), 1)
        rounds = [synth] + [Round(r.append, r.gen, r.think)
                            for r in src.rounds]
        # re-truncate to max_len
        out.append(Trajectory(tid, rounds).scaled(1.0, 1.0, max_len))
    return out


def dataset_stats(trajs: List[Trajectory]) -> dict:
    """Table 2's columns over ``trajs``, plus the KV hit rate (cached
    over prompt tokens) and the mean think time."""
    turns = [t.n_rounds for t in trajs]
    appends = [r.append for t in trajs for r in t.rounds]
    gens = [r.gen for t in trajs for r in t.rounds]
    totals = [t.total_tokens for t in trajs]
    ctxs = [t.mean_context() for t in trajs]
    hit_tokens = sum(t.context_before(i) for t in trajs
                     for i in range(t.n_rounds))
    prompt_tokens = sum(t.context_before(i) + t.rounds[i].append
                        for t in trajs for i in range(t.n_rounds))
    thinks = [r.think for t in trajs for r in t.rounds]
    return dict(
        turns=float(np.mean(turns)),
        append=float(np.mean(appends)),
        gen=float(np.mean(gens)),
        total=float(np.mean(totals)),
        context=float(np.mean(ctxs)),
        hit_rate=hit_tokens / max(prompt_tokens, 1),
        think=float(np.mean(thinks)) if thinks else 0.0,
    )
