"""The port's fault model, hedged reads and fail-stop recovery against the
JAX package's.

* ``FaultSchedule`` unit behaviour (the port of tests/test_faults.py's
  schedule tests) on the port's objects, and ``generate`` giving the
  reference's windows, deaths and straggler for the same seed and rates;
  the straggler draw equal to the reference's for every (rid, side).
* The reference's serving chaos arms (tests/test_faults.py: reduced
  qwen, 2 PEs + 2 DEs, split reads, ``REDUCED_TEST_NODE``, 4 agents x 3
  rounds online) on both packages' ServingSystems with bridged bf16
  weights: the fault-free baseline, a slow node-0 storage NIC with
  stragglers and hedged reads, a DE's death at 0.65 s, and a generated
  schedule (``CHAOS_SEED``); and the fault-free and hedged arms again with
  a DRAM tier, agentic-TTL eviction and the prefetcher.  Each arm's
  contexts and ``stats()`` equal the same arm of the reference (modelled
  seconds within 1e-9 relative, the rest exact); the traced arms record
  the same events in both packages; and every untiered arm keeps the
  reference's chaos invariants.  The zero-fault arm (an empty schedule,
  hedging armed) runs on the port only: an empty schedule is normalised
  to ``None`` in both packages, and the reference's own suite pins its
  zero-fault arm to its baseline, so the port's must equal both
  baselines.
* The loading plans against the read ledgers on both packages' tiered
  arms: each round's ``plan_for`` bytes equal what the round read in
  total and lie within page rounding on each side; with a tier, a hedge
  changes the storage total while storage + DRAM stays conserved.
* A case the reference does not reach: a DE dies while a round on it is
  between chunked-prefill slices; the port re-homes it and every round
  finishes with the fault-free tokens.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import loading as jax_loading
from repro.core.config import ResilienceConfig as JaxResilienceConfig
from repro.core.config import TierConfig as JaxTierConfig
from repro.models import init_params as jax_init_params
from repro.obs import Tracer as JaxTracer
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim import faults as jax_faults
from repro.sim.spec import REDUCED_TEST_NODE as JAX_REDUCED_TEST_NODE
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import loading
from repro_torch.core.config import ResilienceConfig, SloConfig, TierConfig
from repro_torch.obs import Tracer, audit_serving
from repro_torch.serving import ServingSystem
from repro_torch.sim import faults
from repro_torch.sim.faults import (EngineDeath, FaultSchedule,
                                    SlowdownWindow, StragglerModel)
from repro_torch.sim.spec import REDUCED_TEST_NODE
from repro_torch.sim.traces import Round, Trajectory

torch.set_num_threads(1)

CHAOS_SEED = int(os.environ.get("CHAOS_SEED", "0"))


# ---------------------------------------------------------------------------
# FaultSchedule: pure data, deterministic queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    lambda: SlowdownWindow("disk", 0.0, 1.0, 2.0),
    lambda: SlowdownWindow("snic", 1.0, 1.0, 2.0),
    lambda: SlowdownWindow("snic", 0.0, 1.0, 0.5),
    lambda: StragglerModel(prob=1.5, severity=2.0),
    lambda: StragglerModel(prob=0.5, severity=0.9),
], ids=["resource", "empty", "speedup", "prob", "severity"])
def test_validation(bad):
    with pytest.raises(ValueError):
        bad()


def test_windows_compose_multiplicatively():
    fs = FaultSchedule(windows=[
        SlowdownWindow("snic", 0.0, 10.0, 4.0),
        SlowdownWindow("snic", 5.0, 15.0, 2.0, node=0),
        SlowdownWindow("net", 2.0, 3.0, 3.0),
    ])
    assert fs.snic_factor(0, 1.0) == 4.0
    assert fs.snic_factor(0, 7.0) == 8.0
    assert fs.snic_factor(1, 7.0) == 4.0
    assert fs.snic_factor(0, 12.0) == 2.0
    assert fs.snic_factor(0, 15.0) == 1.0
    assert fs.snic_factor(0, 0.0) == 4.0
    assert fs.net_factor(2.5) == 3.0 and fs.net_factor(3.0) == 1.0
    assert fs.boundaries("snic") == [0.0, 5.0, 10.0, 15.0]
    assert fs.boundaries("net") == [2.0, 3.0]
    assert fs.boundaries_array("dram").size == 0
    assert fs.leg_factor(3, "pe") == 1.0


def test_schedule_sorts_regardless_of_construction_order():
    a = SlowdownWindow("snic", 5.0, 6.0, 2.0)
    b = SlowdownWindow("net", 1.0, 2.0, 2.0)
    d1, d2 = EngineDeath(9.0, (1, 0)), EngineDeath(3.0, (0, 0))
    fs = FaultSchedule(windows=[a, b], deaths=[d1, d2])
    assert fs.windows == [b, a]
    assert fs.deaths == [d2, d1]


def test_empty_property():
    assert FaultSchedule().empty
    assert FaultSchedule(straggler=StragglerModel(0.0, 4.0)).empty
    assert not FaultSchedule(
        windows=[SlowdownWindow("snic", 0.0, 1.0, 2.0)]).empty
    assert not FaultSchedule(deaths=[EngineDeath(1.0, (0, 0))]).empty
    assert not FaultSchedule(straggler=StragglerModel(0.1, 4.0)).empty


@pytest.mark.parametrize("seed", [CHAOS_SEED, 11])
def test_straggler_draw_matches_the_reference(seed):
    m = StragglerModel(prob=0.5, severity=6.0, seed=seed)
    jm = jax_faults.StragglerModel(prob=0.5, severity=6.0, seed=seed)
    draws = {(rid, side): m.factor(rid, side)
             for rid in range(200) for side in ("pe", "de")}
    for (rid, side), f in sorted(draws.items(), reverse=True):
        assert f == jm.factor(rid, side) == m.factor(rid, side)
        assert f in (1.0, 6.0)
    assert any(draws[(r, "pe")] != draws[(r, "de")] for r in range(200))
    frac = sum(f > 1.0 for f in draws.values()) / len(draws)
    assert 0.3 < frac < 0.7


def windows_of(fs):
    return [(w.resource, w.t0, w.t1, w.factor, w.node) for w in fs.windows]


@pytest.mark.parametrize("seed", [0, 7, 8])
def test_generate_matches_the_reference(seed):
    kw = dict(duration_s=100.0, nodes=range(4), engines=((2, 0), (3, 0)),
              snic_fault_rate=0.05, link_flap_rate=0.03,
              straggler_prob=0.2, n_deaths=2, death_frac=0.4)
    a = FaultSchedule.generate(seed=seed, **kw)
    j = jax_faults.FaultSchedule.generate(seed=seed, **kw)
    assert windows_of(a) == windows_of(j)
    assert [(d.t, d.engine) for d in a.deaths] == \
        [(d.t, d.engine) for d in j.deaths]
    assert (a.straggler.prob, a.straggler.severity, a.straggler.seed) == \
        (j.straggler.prob, j.straggler.severity, j.straggler.seed)
    assert windows_of(a) == windows_of(FaultSchedule.generate(seed=seed,
                                                              **kw))
    assert len(a.windows) == round(0.05 * 100) + round(0.03 * 100)
    for d in a.deaths:
        assert d.engine in ((2, 0), (3, 0))
        assert 0.9 * 40.0 <= d.t <= 1.1 * 40.0
    assert FaultSchedule.generate(seed=seed, duration_s=10.0,
                                  nodes=()).empty


# ---------------------------------------------------------------------------
# serving chaos on both packages
# ---------------------------------------------------------------------------

KW = dict(n_pe=2, n_de=2, block_tokens=16, max_seq=160, de_slots=2,
          pipelined=True, split_reads=True)
ROUNDS = [(24, 4), (16, 4), (8, 4)]
ARRIVALS = [0.0, 0.1, 0.2, 0.3]
GENERATED = dict(duration_s=2.0, nodes=range(2), snic_fault_rate=1.0,
                 snic_factor=4.0, snic_window_s=0.5, link_flap_rate=0.5,
                 link_factor=2.0, link_window_s=0.5, straggler_prob=0.3,
                 straggler_severity=6.0)
# the tiered arms: a DRAM tier of TIER_BLOCKS FullBlocks per node with
# agentic-TTL eviction and the think-time prefetcher, and think times
TIER_BLOCKS = 6
TIER_ROUNDS = [(24, 4, 0.0), (16, 4, 0.3), (8, 4, 0.3)]


def schedule(mod, arm):
    """The arm's schedule and hedging, built from ``mod`` (either
    package's ``sim.faults``); a ``_tier`` arm has its untiered twin's."""
    arm = arm.removesuffix("_tier")
    if arm == "base":
        return None, False
    if arm == "zero":
        return mod.FaultSchedule(), True
    if arm == "hedged":
        return mod.FaultSchedule(
            windows=[mod.SlowdownWindow("snic", 0.0, 1e9, 8.0, node=0)],
            straggler=mod.StragglerModel(0.4, 8.0, seed=7)), True
    if arm == "death":
        return mod.FaultSchedule(
            deaths=[mod.EngineDeath(0.65, (2, 0))]), False
    return mod.FaultSchedule.generate(seed=CHAOS_SEED, **GENERATED), True


TRACED = ("hedged", "death", "base_tier", "hedged_tier")
TIERED = ("base_tier", "hedged_tier")


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """The reference model runs its scans eagerly, so every reference
    ServingSystem run compiles the same XLA programs again.  A persistent
    compilation cache in the session's temp directory serves the repeats
    (the same executables: no result changes); the setting is restored
    when the module ends."""
    from jax.experimental.compilation_cache import compilation_cache as cc
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    cc.reset_cache()
    jax.config.update(keys[0], str(tmp_path_factory.getbasetemp()
                                   / "jax_compilation_cache"))
    jax.config.update(keys[1], 0.0)
    yield
    for k, v in old.items():
        jax.config.update(k, v)
    cc.reset_cache()


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen1.5-0.5b").reduced()
    return jcfg, jp, cfg, bridge.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def serve(pkg, arm, tracer=None, **kw):
    """One online run of ``pkg``'s ServingSystem (``pkg`` holds that
    package's ServingSystem, configs, traces, faults and system kwargs)
    under the arm's schedule; every Request the scheduler gets is
    recorded.  Returns (system, sessions, requests)."""
    fs, hedge = schedule(pkg["faults"], arm)
    rounds = ROUNDS
    if arm in TIERED:
        kw["tier"] = pkg["TierConfig"](
            dram_tier_bytes=TIER_BLOCKS * pkg["fullblock"],
            tier_policy="agentic-ttl", prefetch=True)
        rounds = TIER_ROUNDS
    s = pkg["ServingSystem"](
        pkg["cfg"], pkg["params"], node=pkg["node"], tracer=tracer,
        resilience=pkg["ResilienceConfig"](faults=fs, hedge_reads=hedge),
        **pkg["kw"], **{**KW, **kw})
    requests = []
    submit = s.sched.submit
    s.sched.submit = lambda r: (requests.append(r), submit(r))
    ses = s.run_online([pkg["Trajectory"](i, [pkg["Round"](*r)
                                              for r in rounds])
                        for i in range(4)], ARRIVALS)
    return s, ses, requests


@pytest.fixture(scope="module")
def packages(weights):
    jcfg, jp, cfg, tp = weights
    jax_pkg = dict(ServingSystem=JaxServingSystem, cfg=jcfg, params=jp,
                   node=JAX_REDUCED_TEST_NODE, faults=jax_faults,
                   ResilienceConfig=JaxResilienceConfig,
                   TierConfig=JaxTierConfig, Trajectory=JaxTrajectory,
                   Round=JaxRound, Tracer=JaxTracer, loading=jax_loading,
                   kw=dict(seed=0))
    port_pkg = dict(ServingSystem=ServingSystem, cfg=cfg, params=tp,
                    node=REDUCED_TEST_NODE, faults=faults,
                    ResilienceConfig=ResilienceConfig, TierConfig=TierConfig,
                    Trajectory=Trajectory, Round=Round, Tracer=Tracer,
                    loading=loading, kw=dict(device="cpu"))
    for pkg in (jax_pkg, port_pkg):
        pkg["fullblock"] = pkg["ServingSystem"](
            pkg["cfg"], pkg["params"], node=pkg["node"], **pkg["kw"],
            **KW).layout.full_block_bytes
    return dict(jax=jax_pkg, port=port_pkg)


@pytest.fixture(scope="module")
def arms(packages, jax_compile_cache):
    """{arm: {"jax": run, "port": run}}, a run being a dict of system,
    tracer, contexts (lists of ints), sessions and requests; the zero arm
    has no reference run."""
    out = {}
    for arm in ("base", "hedged", "death", "generated", "zero") + TIERED:
        out[arm] = {}
        for name, pkg in packages.items():
            if arm == "zero" and name == "jax":
                continue
            tr = pkg["Tracer"]() if arm in TRACED else None
            s, ses, requests = serve(pkg, arm, tracer=tr)
            out[arm][name] = dict(
                system=s, tracer=tr, sessions=ses, requests=requests,
                contexts=[[int(t) for t in x.context] for x in ses])
    return out


def assert_chaos_invariants(st, sessions, base_st, base_ctx):
    """The reference's chaos invariants (tests/test_faults.py)."""
    assert all(s.done() for s in sessions)
    assert [s.context for s in sessions] == base_ctx
    assert st["store_writes"] == base_st["store_writes"]
    assert st["trie_blocks"] == base_st["trie_blocks"]
    total = st["read_bytes_pe_side"] + st["read_bytes_de_side"]
    base_total = base_st["read_bytes_pe_side"] + \
        base_st["read_bytes_de_side"]
    if st["recovered_rounds"] == 0:
        assert total == base_total
    else:
        assert total >= base_total


def assert_stats_match(tst, jst):
    for k, v in tst.items():
        if k == "latency_by_class":
            assert v.keys() == jst[k].keys()
            for cls, summary in jst[k].items():
                for kk, vv in summary.items():
                    assert v[cls][kk] == pytest.approx(
                        vv, rel=1e-9, abs=0, nan_ok=True), (cls, kk)
        elif isinstance(v, float):
            assert v == pytest.approx(jst[k], rel=1e-9, abs=0,
                                      nan_ok=True), k
        else:
            assert v == jst[k], k


@pytest.mark.parametrize("arm", ["base", "hedged", "death", "generated",
                                 "base_tier", "hedged_tier"])
def test_arm_matches_the_reference(arms, arm):
    j, t = arms[arm]["jax"], arms[arm]["port"]
    assert t["contexts"] == j["contexts"]
    assert_stats_match(t["system"].stats(), j["system"].stats())


@pytest.mark.parametrize("arm", ["zero", "hedged", "death", "generated"])
def test_arm_keeps_the_chaos_invariants(arms, arm):
    base, run = arms["base"]["port"], arms[arm]["port"]
    base_st = base["system"].stats()
    assert_chaos_invariants(run["system"].stats(), run["sessions"], base_st,
                            base["contexts"])
    st = run["system"].stats()
    if arm == "zero":
        # an empty schedule is invisible: the whole stats() dict, wall
        # clock included, equals both packages' fault-free runs
        assert st == base_st
        assert_stats_match(st, arms["base"]["jax"]["system"].stats())
    elif arm == "hedged":
        assert st["hedged_reads"] > 0 and st["hedge_moved_tokens"] > 0
    elif arm == "death":
        assert st["engine_deaths"] == 1 and st["recovered_rounds"] > 0
        assert st["n_de_final"] == 1 and st["n_pe_final"] == 2
        assert st["store_reads"] >= base_st["store_reads"]
    else:
        assert not schedule(faults, arm)[0].empty


@pytest.mark.parametrize("arm", TRACED)
def test_traced_arm_records_the_reference_events(arms, arm):
    jtr = arms[arm]["jax"]["tracer"]
    tsys, ttr = arms[arm]["port"]["system"], arms[arm]["port"]["tracer"]
    want = [(track, name, args) for _, track, name, _, _, args in jtr.spans]
    got = [(track, name, args) for _, track, name, _, _, args in ttr.spans]
    assert got == want
    for r, q in zip(ttr.spans, jtr.spans):
        assert r[3:5] == pytest.approx(q[3:5], rel=1e-9, abs=0)
    assert [c[1:] for c in ttr.counters] == [c[1:] for c in jtr.counters]
    out = audit_serving(tsys, ttr, check_persists=True)
    st = tsys.stats()
    assert out["persist_bytes"] == st["store_writes"]
    assert out["hedge_events"] == st["hedged_reads"]
    assert len(list(ttr.iter_events("recovered"))) == \
        st["recovered_rounds"]
    if arm == "death":
        assert [a["engine"] for _, _, _, a in
                ttr.iter_events("engine_death")] == [[2, 0]]
        assert [a["engine"] for _, _, _, a in
                ttr.iter_events("engine_death_scheduled")] == [[2, 0]]


# ---------------------------------------------------------------------------
# loading plans against the read ledgers, with split reads and a tier
# ---------------------------------------------------------------------------


def plan_against_reads(run, loading):
    """Per round: (plan, read, slack), each a {side: hit bytes} over the
    side's storage NIC and DRAM tier.  ``plan`` is the round's loading
    plan (``loading.plan_for`` on the request's own hit partition,
    ``tier=Request.hit_bytes_partition``), ``read`` what the run's trace
    shows the round read (``storage_read`` + ``tier_hit`` events), and
    ``slack`` half a FullBlock and a token when both storage NICs served
    the round (the plan splits by token, the runtime by whole FullBlock),
    else 0."""
    layout = run["system"].layout
    kv = layout.n_layers * layout.bytes_per_token_layer
    read = {}
    for track, name, _, args in run["tracer"].iter_events():
        if name in ("storage_read", "tier_hit"):
            side = read.setdefault(int(track.split("/", 1)[1]),
                                   dict(pe=0, de=0))
            side[args["side"]] += args["nbytes"]
    out = []
    for r in run["requests"]:
        plan = dict(pe=0, de=0)
        for leg in loading.plan_for(
                r.read_path, r.read_split, r.cached_tokens * kv,
                r.new_tokens * kv, r.gen_tokens * kv,
                tier=r.hit_bytes_partition(kv)):
            if leg.phase == "load":
                for res in leg.resources:
                    if res in ("pe_snic", "pe_tier", "de_snic", "de_tier"):
                        plan[res[:2]] += leg.nbytes
        tok = r.read_tokens_by_side()
        slack = layout.full_block_bytes // 2 + kv \
            if tok["pe"] and tok["de"] else 0
        out.append((plan, read.get(r.rid, dict(pe=0, de=0)), slack))
    return out


@pytest.mark.parametrize("name", ["jax", "port"])
@pytest.mark.parametrize("arm", TIERED)
def test_plans_bound_the_read_ledgers(arms, packages, arm, name):
    """On the reference as on the port, each round's plan carries exactly
    the hit bytes the round read, and each side's plan sits within the
    page rounding of what that side read: the runtime splits a read at
    whole FullBlocks, the plan at tokens, so per side the two are not
    equal.  In the fault-free tiered arm two split rounds each round half
    a FullBlock onto the DE side, and the sums over rounds (what the
    ledgers hold) are a FullBlock apart per side."""
    run = arms[arm][name]
    rounds = plan_against_reads(run, packages[name]["loading"])
    assert sum(s > 0 for _, _, s in rounds) >= 2
    for plan, read, slack in rounds:
        assert sum(plan.values()) == sum(read.values())
        for side in ("pe", "de"):
            assert abs(plan[side] - read[side]) <= slack, (plan, read)
    st = run["system"].stats()
    plan = {s: sum(p[s] for p, _, _ in rounds) for s in ("pe", "de")}
    got = {s: st[f"read_bytes_{s}_side"] + st[f"dram_bytes_{s}_side"]
           for s in ("pe", "de")}
    assert sum(plan.values()) == sum(got.values()) > 0
    if arm == "base_tier":
        fb = run["system"].layout.full_block_bytes
        assert (plan["pe"] - got["pe"], plan["de"] - got["de"]) == (fb, -fb)
    # the port's plans are the reference's, round for round
    assert rounds == plan_against_reads(arms[arm]["jax"],
                                        packages["jax"]["loading"])


@pytest.mark.parametrize("name", ["jax", "port"])
def test_hedge_with_a_tier_moves_the_storage_total(arms, name):
    """With a DRAM tier, a hedge moves blocks from one node's read path to
    the other's, and so between the two nodes' tiers: storage serves a
    different share of the hits than in the fault-free run.  What is
    conserved is every hit byte served once, from storage or a tier."""
    base = arms["base_tier"][name]["system"].stats()
    run = arms["hedged_tier"][name]
    st = run["system"].stats()
    assert st["hedged_reads"] > 0 and st["hedge_moved_tokens"] > 0
    assert run["contexts"] == arms["base_tier"][name]["contexts"]
    for k in ("store_writes", "trie_blocks"):
        assert st[k] == base[k], k

    def total(st, kinds):
        return sum(st[f"{k}_bytes_{s}_side"] for k in kinds
                   for s in ("pe", "de"))
    assert total(st, ("read",)) != total(base, ("read",))
    assert total(st, ("read", "dram")) == total(base, ("read", "dram"))


def test_death_between_prefill_slices_recovers(packages):
    """A round on the dying DE waits between chunked-prefill slices on
    its PE: it is re-homed like the rounds in PREFILL (its state is on the
    PE), and every round finishes with the fault-free tokens, persisting
    once.  The death lands at the start of the tick after a slice, where
    the fault-free trace opens a ``prefill_chunked`` span."""
    port = packages["port"]
    cfg, tp = port["cfg"], port["params"]
    slo = SloConfig(prefill_chunk_tokens=8)
    tr = Tracer()
    base, base_ses, _ = serve(port, "base", tracer=tr, slo=slo)
    assert base.stats()["prefill_chunks"] > 0
    t_death = min(t0 for _, _, t0, _, _ in
                  tr.iter_spans("req/", "prefill_chunked"))
    de = (2, 0)
    states = []
    s = ServingSystem(cfg, tp, node=REDUCED_TEST_NODE, device="cpu",
                      slo=slo, resilience=ResilienceConfig(
                          faults=FaultSchedule(
                              deaths=[EngineDeath(t_death, de)])), **KW)
    death = s._engine_death

    def watch(eid):
        states.extend((er.req.de, er.lifecycle.name)
                      for er in s._inflight.values())
        death(eid)
    s._engine_death = watch
    ses = s.run_online([Trajectory(i, [Round(*r) for r in ROUNDS])
                        for i in range(4)], ARRIVALS)
    st = s.stats()
    assert (de, "PREFILL_CHUNKED") in states, states
    assert st["recovered_rounds"] == sum(d == de for d, _ in states)
    assert_chaos_invariants(st, ses, base.stats(),
                            [x.context for x in base_ses])
    assert all(m.finished for m in s.metrics.values())
