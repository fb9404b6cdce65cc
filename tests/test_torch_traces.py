"""The port's agent-trajectory generator against the JAX package's.

* ``generate_dataset`` gives the reference's trajectories round for
  round (append, gen, think, ``slo_class``) at each ``TABLE2`` length,
  with and without think times and past the augmentation base, and
  ``dataset_stats`` equal the reference's exactly.
* ``Trajectory`` helpers (``context_before``, ``mean_context``,
  ``scaled``, ``total_tokens``) equal the reference's.
* The claims of the reference's tests/test_traces.py on the port: Table 2
  statistics within their bounds, the 98.7 % hit rate, determinism,
  scaling with truncation, and the synthetic first round of augmented
  trajectories.
"""
import numpy as np
import pytest

from repro.sim import traces as jax_traces
from repro_torch.sim import traces
from repro_torch.sim.traces import TABLE2, dataset_stats, generate_dataset


def _rounds(trajs):
    return [(t.tid, t.slo_class,
             [(r.append, r.gen, r.think) for r in t.rounds]) for t in trajs]


# ---------------------------------------------------------------------------
# the generator against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n=40, max_len=32768, seed=0),
    dict(n=40, max_len=49152, seed=1),
    dict(n=40, max_len=65536, seed=2),
    dict(n=12, max_len=8192, seed=3),                 # not a Table 2 row
    dict(n=16, max_len=32768, seed=4, think_mean_s=2.0),
    dict(n=30, max_len=32768, seed=5, base=20),       # augmented past base
], ids=["32k", "48k", "64k", "8k", "think", "augmented"])
def test_generate_dataset_equals_reference(kw):
    got = generate_dataset(**kw)
    want = jax_traces.generate_dataset(**kw)
    assert _rounds(got) == _rounds(want)
    assert dataset_stats(got) == jax_traces.dataset_stats(want)


def test_table2_equals_reference():
    assert TABLE2 == jax_traces.TABLE2


def test_trajectory_helpers_equal_reference():
    t = generate_dataset(3, 65536, seed=11)[2]
    j = jax_traces.generate_dataset(3, 65536, seed=11)[2]
    assert t.total_tokens == j.total_tokens
    assert t.mean_context() == j.mean_context()
    assert [t.context_before(i) for i in range(t.n_rounds + 1)] == \
        [j.context_before(i) for i in range(j.n_rounds + 1)]
    for kw in (dict(append_scale=4.0, max_len=65536),
               dict(append_scale=0.5, gen_scale=2.0),
               dict(max_len=100)):
        assert _rounds([t.scaled(**kw)]) == _rounds([j.scaled(**kw)])
    t.slo_class = "interactive"
    assert t.scaled(2.0).slo_class == "interactive"
    # truncated to nothing, a trajectory keeps one token of each
    assert _rounds([t.scaled(max_len=1)]) == [(t.tid, "interactive",
                                               [(1, 1, 0.0)])]


# ---------------------------------------------------------------------------
# the reference's claims, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", [32768, 49152, 65536])
def test_table2_stats(max_len):
    st = dataset_stats(generate_dataset(200, max_len, seed=0))
    tgt = TABLE2[max_len]
    # Total and Gen are matched tightly; Turns/Append are jointly
    # inconsistent in the paper's pooling (see traces.py)
    assert abs(st["total"] - tgt["total"]) / tgt["total"] < 0.15
    assert abs(st["gen"] - tgt["gen"]) / tgt["gen"] < 0.10
    assert abs(st["turns"] - tgt["turns"]) / tgt["turns"] < 0.40
    assert abs(st["append"] - tgt["append"]) / tgt["append"] < 0.35
    assert abs(st["context"] - tgt["context"]) / tgt["context"] < 0.25


def test_hit_rate_matches_paper():
    """Paper §3: 98.7 % KV hit rate on the 64K trace."""
    st = dataset_stats(generate_dataset(300, 65536, seed=0))
    assert st["hit_rate"] > 0.98


def test_deterministic():
    a = generate_dataset(20, 32768, seed=7)
    b = generate_dataset(20, 32768, seed=7)
    assert _rounds(a) == _rounds(b)
    assert _rounds(a) != _rounds(generate_dataset(20, 32768, seed=8))


def test_scaling_truncates():
    t = generate_dataset(5, 65536, seed=0)[0]
    s = t.scaled(append_scale=4.0, max_len=65536)
    assert s.total_tokens <= 65536
    mean_a = np.mean([r.append for r in s.rounds])
    assert mean_a > np.mean([r.append for r in t.rounds]) * 1.5


def test_augmentation_prepends_synthetic_round():
    ds = generate_dataset(510, 32768, seed=0, base=500)
    aug = ds[505]
    assert aug.rounds[0].gen == 1      # synthetic first round (§A.3)
    assert 8 <= aug.rounds[0].append < 64
    assert aug.total_tokens <= 32768
    assert [a.tid for a in ds] == list(range(510))


def test_think_times_are_drawn_only_when_asked():
    plain = generate_dataset(8, 32768, seed=3)
    think = generate_dataset(8, 32768, seed=3, think_mean_s=3.0)
    assert all(r.think == 0.0 for t in plain for r in t.rounds)
    assert all(t.rounds[0].think == 0.0 for t in think)
    assert all(r.think > 0.0 for t in think for r in t.rounds[1:])
    assert dataset_stats(think)["think"] > 0.0
    assert isinstance(traces.Round(1, 1).think, float)
