"""Token data pipeline: deterministic, seeded, checkpointable (port of
``repro.training.data``, numpy only, so every batch is byte-equal to the
reference's).

Two sources:
* ``SyntheticLM``   — seeded random token stream (bigram structure, so
  the loss actually decreases);
* ``TrajectoryLM``  — packs agent trajectories (``repro_torch.sim.traces``)
  into training sequences, the data the paper's RL rollout phase would
  emit.

State is (seed, step): save/restore is exact — a restarted job resumes
on the same batch sequence, which the fault-tolerance test asserts.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.sim.traces import generate_dataset


@dataclass
class PipelineState:
    seed: int
    step: int


class SyntheticLM:
    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.state = PipelineState(seed=seed, step=0)

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(
            (self.state.seed, self.state.step))

    def next_batch(self) -> np.ndarray:
        rng = self._rng()
        # bigram structure: next token ~ (prev*7 + noise) mod vocab
        base = rng.integers(0, self.vocab, size=(self.batch, 1))
        noise = rng.integers(0, max(self.vocab // 16, 2),
                             size=(self.batch, self.seq))
        toks = np.zeros((self.batch, self.seq), np.int64)
        toks[:, 0] = base[:, 0]
        for i in range(1, self.seq):
            toks[:, i] = (toks[:, i - 1] * 7 + noise[:, i]) % self.vocab
        self.state.step += 1
        return toks.astype(np.int32)

    # checkpointing
    def state_dict(self) -> dict:
        return dict(seed=self.state.seed, step=self.state.step)

    def load_state_dict(self, d: dict):
        self.state = PipelineState(seed=d["seed"], step=d["step"])


class TrajectoryLM(SyntheticLM):
    """Packs agent-trajectory token streams into fixed-length rows."""

    def __init__(self, vocab_size: int, batch: int, seq: int,
                 max_len: int = 32768, seed: int = 0):
        super().__init__(vocab_size, batch, seq, seed)
        self.trajs = generate_dataset(64, max_len, seed=seed)

    def next_batch(self) -> np.ndarray:
        rng = self._rng()
        rows = []
        for _ in range(self.batch):
            t = self.trajs[rng.integers(0, len(self.trajs))]
            total = t.total_tokens
            toks = rng.integers(0, self.vocab, size=min(total, self.seq))
            if len(toks) < self.seq:
                toks = np.pad(toks, (0, self.seq - len(toks)))
            rows.append(toks)
        self.state.step += 1
        return np.stack(rows).astype(np.int32)
