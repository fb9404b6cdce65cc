"""The port's event simulator against the JAX package's.

* ``results()`` equal the reference's, value for value (NaN equal to
  NaN), on shared trajectories of 24-48 agents in every arm of ``ARMS``:
  basic, dualpath and oracle; the round-robin scheduler; split reads; a
  DRAM tier with the prefetcher; online Poisson arrivals behind the SLO
  gate with priority classes and chunked prefill; a fault schedule with
  hedged reads and an engine death; elastic role flips; the finite
  compute network under 'vl' and 'fifo'; and a hand-set
  ``ssm_state_bytes`` (the state-blob branch), traced, whose Chrome
  trace equals the reference's byte for byte.  Each arm also checks
  that its feature engaged (deferrals, hedges, flips, blob reads).
* The flat read aliases: all 26 ``FLAT_FIELDS`` names read the same
  values on both packages' ``SimConfig`` and write through to the group.
* The claims of the reference's tests/test_sim.py on the port, at the
  reference's sizes: every agent finishes, oracle TTFT bounds basic,
  dualpath leaves TPOT alone, the online SLO, split reads concurrent on
  both NICs, charges equal to the loading plans to the byte, think time
  honoured.  The I/O-bound claims are in tests/test_torch_sim_claims.py,
  the DRAM-tier claims in tests/test_torch_sim_tiered.py, and the
  192-agent I/O-bound point in ``chip_smoke.py``'s event-simulator
  phase.
* ``audit_sim`` passes on a traced run and fails on a tampered ledger.
"""
import dataclasses
import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.configs as jax_configs
import repro.core.config as jax_config
import repro.sim as jax_sim
import repro_torch.configs as port_configs
import repro.sim.faults as jax_faults
import repro.sim.traces as jax_traces
import repro_torch.sim as port_sim
from repro.obs import Tracer as JaxTracer
from repro_torch.core import config
from repro_torch.core.config import ElasticConfig, TierConfig
from repro_torch.core.loading import resource_bytes
from repro_torch.obs import TraceAuditError, Tracer, audit_sim
from repro_torch.sim import (DS_660B, HOPPER_NODE, Sim, SimConfig,
                             generate_dataset)
from repro_torch.sim import faults, traces
from repro_torch.sim.traces import Round, Trajectory

JAX = SimpleNamespace(sim=jax_sim, config=jax_config, faults=jax_faults,
                      traces=jax_traces, Tracer=JaxTracer,
                      configs=jax_configs)
PORT = SimpleNamespace(sim=port_sim, config=config, faults=faults,
                       traces=traces, Tracer=Tracer, configs=port_configs)

SLOW = dataclasses.replace(HOPPER_NODE, snic_bw=10e9)   # I/O-bound point


def assert_results_equal(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in sorted(want):
        a, b = got[k], want[k]
        if isinstance(b, float) and math.isnan(b):
            assert isinstance(a, float) and math.isnan(a), (k, a, b)
        else:
            assert a == b, (k, a, b)


# ---------------------------------------------------------------------------
# the arms: one workload and config per feature, built for either package
# ---------------------------------------------------------------------------


def _base(p, node=None, model=None, **kw):
    return dict(node=node or p.sim.HOPPER_NODE,
                model=model or p.sim.DS_660B, P=kw.pop("P", 1),
                D=kw.pop("D", 2), **kw)


def _mixed(p, n, seed):
    """Every other trajectory interactive, the rest batch."""
    trajs = p.traces.generate_dataset(n, 32768, seed=seed)
    for i, t in enumerate(trajs):
        t.slo_class = "interactive" if i % 2 else "batch"
    return trajs


def _two_phase(p, n_pre=16, n_dec=32):
    """The reference's elastic workload, cut to 48 agents: a prefill-heavy
    wave at 0, then a decode-heavy one at 20 s."""
    R, T = p.traces.Round, p.traces.Trajectory
    trajs = [T(i, [R(4096, 8)]) for i in range(n_pre)] + \
        [T(100 + i, [R(64, 512)]) for i in range(n_dec)]
    return trajs, [0.0] * n_pre + [20.0] * n_dec


def _arm(name, p):
    """(cfg, trajectories, arrivals, tracer) of arm ``name`` built from
    package namespace ``p``."""
    c = p.config
    trajs = p.traces.generate_dataset(48, 32768, seed=0)
    arrivals = tracer = None
    if name in ("basic", "dualpath", "oracle"):
        kw = _base(p, mode=name)
    elif name == "rr":
        kw = _base(p, dataclasses.replace(p.sim.HOPPER_NODE, snic_bw=10e9),
                   scheduler="rr")
    elif name == "split":
        trajs = trajs[:32]
        kw = _base(p, dataclasses.replace(p.sim.HOPPER_NODE, snic_bw=10e9),
                   split_reads=True)
    elif name == "tier_prefetch":
        trajs = p.traces.generate_dataset(24, 32768, seed=0,
                                          think_mean_s=2.0)
        kw = _base(p, split_reads=True,
                   tier=c.TierConfig(dram_tier_bytes=8e9, prefetch=True,
                                     tier_policy="agentic-ttl",
                                     tier_ttl_s=30.0,
                                     prefetch_chunk_blocks=8))
    elif name == "online_slo":
        trajs = _mixed(p, 32, seed=1)
        rng = np.random.default_rng(0)
        arrivals = list(np.cumsum(rng.exponential(1 / 4.0, len(trajs))))
        kw = _base(p, online=True, beta_compute_s=1.0,
                   slo=c.SloConfig(admission=True,
                                   admission_ttft_slo_s=0.5,
                                   admission_max_defers=8,
                                   prefill_chunk_tokens=1024,
                                   class_aware=True))
    elif name == "faults_hedge":
        trajs = trajs[:24]
        f = p.faults
        sched = f.FaultSchedule(
            windows=[f.SlowdownWindow("snic", 0.0, 40.0, 4.0, node=0)],
            straggler=f.StragglerModel(0.3, 4.0, seed=7),
            deaths=[f.EngineDeath(30.0, (3, 0))])
        kw = _base(p, dataclasses.replace(p.sim.HOPPER_NODE, g=1,
                                          snic_bw=4e9),
                   P=2, D=2, nodes_per_pe_group=1, nodes_per_de_group=1,
                   split_reads=True, kv_hbm_frac=0.04,
                   resilience=c.ResilienceConfig(faults=sched,
                                                 hedge_reads=True))
    elif name == "elastic":
        trajs, arrivals = _two_phase(p)
        kw = _base(p, dataclasses.replace(p.sim.HOPPER_NODE, g=1),
                   P=2, D=2, nodes_per_pe_group=1, nodes_per_de_group=1,
                   kv_hbm_frac=0.04,
                   elastic=c.ElasticConfig(enabled=True,
                                           reconfig_interval_s=4.0,
                                           reconfig_patience=2))
    elif name in ("net_vl", "net_fifo"):
        trajs = trajs[:24]
        kw = _base(p, net=c.NetworkConfig(
            net_bw=25e9, net_arbiter=name[4:],
            collective_bytes_per_token=0.4e6, net_bg_load=0.4))
    elif name == "ssm_blob":
        trajs = p.traces.generate_dataset(24, 8192, seed=2,
                                          think_mean_s=1.0)
        kw = _base(p, model=dataclasses.replace(p.sim.DS_660B,
                                                ssm_state_bytes=48 << 20),
                   split_reads=True,
                   tier=c.TierConfig(dram_tier_bytes=0.5e9, prefetch=True))
        tracer = p.Tracer()
    elif name == "ssm_config":
        # the blob arm with mamba2-1.3b's spec built from its config
        # (its ~103 MB state blob), as the serving clock builds it
        trajs = p.traces.generate_dataset(24, 8192, seed=2,
                                          think_mean_s=1.0)
        kw = _base(p, model=p.sim.ModelSimSpec.from_config(
            p.configs.get_config("mamba2-1.3b")), split_reads=True,
            tier=c.TierConfig(dram_tier_bytes=0.5e9, prefetch=True))
    else:
        raise KeyError(name)
    return p.sim.SimConfig(**kw), trajs, arrivals, tracer


ARMS = ("basic", "dualpath", "oracle", "rr", "split", "tier_prefetch",
        "online_slo", "faults_hedge", "elastic", "net_vl", "net_fifo",
        "ssm_blob", "ssm_config")


@functools.lru_cache(maxsize=None)
def pair(name):
    """(reference sim, port sim, their tracers) after one run each."""
    out = []
    for p in (JAX, PORT):
        cfg, trajs, arrivals, tracer = _arm(name, p)
        sim = p.sim.Sim(cfg, trajs, tracer=tracer).run(arrivals=arrivals)
        out += [sim, tracer]
    return out[0], out[2], out[1], out[3]


@pytest.mark.parametrize("name", ARMS)
def test_results_equal_reference(name):
    jsim, sim, _, _ = pair(name)
    r = sim.results()
    assert_results_equal(r, jsim.results())
    assert r["finished_rounds"] > 0
    # the storage NICs and the rounds' ledgers agree too
    for n, nic in sim.snic.items():
        ref = jsim.snic[n]
        assert (nic.read_bytes, nic.write_bytes, nic.prefetch_bytes) == \
            (ref.read_bytes, ref.write_bytes, ref.prefetch_bytes), n
    assert [rs.charged for rs in sim.rounds] == \
        [rs.charged for rs in jsim.rounds]
    assert [rs.read_legs for rs in sim.rounds] == \
        [rs.read_legs for rs in jsim.rounds]
    assert sim.loop.n_events == jsim.loop.n_events


def test_arms_engage_their_features():
    r = {name: pair(name)[1].results() for name in ARMS}
    assert r["rr"]["finished_agents"] == 48
    assert r["tier_prefetch"]["dram_hit_ratio"] > 0
    assert r["tier_prefetch"]["tier_prefetch_bytes"] > 0
    slo = r["online_slo"]
    assert slo["deferred_rounds"] > 0 and slo["rejected_rounds"] > 0
    assert slo["prefill_chunks"] > 0
    assert set(slo["latency_by_class"]) == {"interactive", "batch"}
    fh = r["faults_hedge"]
    assert fh["hedged_reads"] > 0 and fh["hedge_moved_tokens"] > 0
    assert fh["engine_deaths"] == 1 and fh["recovered_rounds"] > 0
    assert fh["finished_agents"] == 24
    el = r["elastic"]
    assert el["role_changes"] >= 1 and el["finished_agents"] == 48
    assert el["n_pe_final"] + el["n_de_final"] == 4
    # 'vl' keeps the model collectives' stall below 'fifo''s
    assert r["net_fifo"]["collective_stall_s"] > \
        r["net_vl"]["collective_stall_s"]
    assert r["net_vl"]["net_collective_bytes"] > 0
    # the state blob rides the storage NICs: tagged blob reads, and the
    # reads count the blob's bytes beyond the plans' KV bytes
    _, sim, _, tracer = pair("ssm_blob")
    tags = {args["tag"] for _, _, _, _, args in
            tracer.iter_spans("snic/", "nic_xfer")}
    assert "blob" in tags
    assert sum(n.read_bytes for n in sim.snic.values()) > \
        sim.results()["snic_hit_read_bytes"]
    # from mamba2-1.3b's config: an attention-free model whose reads are
    # its blobs alone
    sim = pair("ssm_config")[1]
    assert sim.model.ssm_state_bytes == \
        port_configs.get_config("mamba2-1.3b").ssm_state_bytes() > 0
    assert sim.model.kv_bytes_per_token == 0
    assert sum(n.read_bytes for n in sim.snic.values()) >= \
        sim.model.ssm_state_bytes


@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
def test_model_spec_from_config_matches_reference(arch):
    """Every field, ``ssm_state_bytes`` included (0 before the SSM
    family was ported, whatever the config)."""
    got = port_sim.ModelSimSpec.from_config(port_configs.get_config(arch))
    want = jax_sim.ModelSimSpec.from_config(jax_configs.get_config(arch))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_traced_run_equals_reference_trace_and_passes_audit():
    jsim, sim, jtr, tr = pair("ssm_blob")
    assert tr.export_bytes() == jtr.export_bytes()
    got = audit_sim(sim, tr)
    assert got["snic_bytes_by_node"]
    # a ledger one byte off fails the audit
    sim.snic[0].read_bytes += 1
    try:
        with pytest.raises(TraceAuditError):
            audit_sim(sim, tr)
    finally:
        sim.snic[0].read_bytes -= 1


# ---------------------------------------------------------------------------
# SimConfig: grouped construction, flat aliases
# ---------------------------------------------------------------------------


def _groups(c):
    return dict(
        tier=c.TierConfig(dram_tier_bytes=3e9, tier_policy="agentic-ttl",
                          tier_ttl_s=7.0, prefetch=True,
                          prefetch_chunk_blocks=5),
        net=c.NetworkConfig(net_bw=1e11, net_arbiter="fifo",
                            model_collectives=True,
                            collective_dtype_bytes=1,
                            collective_bytes_per_token=3.0,
                            net_bg_load=0.2, net_bg_chunk_bytes=1e6,
                            collective_group_size=4),
        elastic=c.ElasticConfig(enabled=True, reconfig_interval_s=2.0,
                                drain_policy="rotate", reconfig_hi=3.0,
                                reconfig_lo=0.25, reconfig_patience=3,
                                reconfig_cooldown_s=1.0,
                                reconfig_idle_floor_s=0.5,
                                elastic_min_pe=2, elastic_min_de=3),
        resilience=c.ResilienceConfig(hedge_reads=True,
                                      hedge_threshold_s=0.5,
                                      hedge_min_severity=3.0))


def test_flat_aliases_equal_reference():
    assert config.FLAT_FIELDS == jax_config.FLAT_FIELDS
    assert len(config.FLAT_FIELDS) == 26
    got = SimConfig(HOPPER_NODE, DS_660B, 1, 2, **_groups(config))
    want = jax_sim.SimConfig(jax_sim.HOPPER_NODE, jax_sim.DS_660B, 1, 2,
                             **_groups(jax_config))
    for name in config.FLAT_FIELDS:
        # every name is a property on both packages' SimConfig
        assert hasattr(jax_sim.SimConfig, name), name
        assert hasattr(SimConfig, name), name
        assert getattr(got, name) == getattr(want, name), name
    assert bool(got.elastic) and got.elastic.drain_policy == "rotate"


def test_flat_aliases_write_through_to_the_group():
    cfg = SimConfig(HOPPER_NODE, DS_660B, 1, 1)
    for name, (grp, fld) in config.FLAT_FIELDS.items():
        if name == "elastic":
            continue
        old = getattr(cfg, name)
        new = 7 if not isinstance(old, str) else "x"
        setattr(cfg, name, new)
        assert getattr(getattr(cfg, grp), fld) == new, name
    # defaults are fresh groups, never shared between configs
    assert SimConfig(HOPPER_NODE, DS_660B, 1, 1).dram_tier_bytes == 0.0
    assert cfg.dram_tier_bytes == 7


# ---------------------------------------------------------------------------
# the reference's claims (tests/test_sim.py), on the port
# ---------------------------------------------------------------------------


def run(mode, n_agents=96, max_len=32768, scheduler="adaptive", P=1, D=2,
        **kw):
    trajs = generate_dataset(n_agents, max_len, seed=0)
    cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=P, D=D, mode=mode,
                    scheduler=scheduler, **kw)
    return Sim(cfg, trajs).run().results()


def test_all_agents_finish():
    for mode in ("basic", "dualpath", "oracle"):
        r = run(mode, n_agents=24)
        assert r["finished_agents"] == 24, (mode, r)


def test_oracle_is_lower_bound_on_ttft():
    rb = pair("basic")[1].results()
    ro = pair("oracle")[1].results()
    assert ro["ttft_mean"] <= rb["ttft_mean"] * 1.05


def test_tpot_unaffected_by_dualpath():
    """Paper §7.4: DualPath adds no decoding overhead."""
    rb = pair("basic")[1].results()
    rd = pair("dualpath")[1].results()
    assert abs(rd["tpot_mean"] - rb["tpot_mean"]) / rb["tpot_mean"] < 0.15


def test_online_poisson_slo():
    trajs = generate_dataset(32, 32768, seed=1)
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1 / 0.5, size=len(trajs)))
    cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=1, D=2,
                    mode="dualpath", online=True)
    sim = Sim(cfg, trajs).run(arrivals=list(arrivals))
    r = sim.results()
    assert r["finished_agents"] == 32
    assert r["tpot_mean"] < 0.050          # SLO from the paper
    assert 0.0 < sim.slo_attainment() <= 1.0


def test_split_reads_engage_both_nics_concurrently():
    trajs = generate_dataset(8, 32768, seed=0)
    cfg = SimConfig(node=SLOW, model=DS_660B, P=1, D=1,
                    mode="dualpath", split_reads=True)
    sim = Sim(cfg, trajs).run()
    assert sim.results()["finished_agents"] == 8
    split_rounds = [rs for rs in sim.rounds
                    if 0.0 < rs.req.pe_read_frac < 1.0]
    assert split_rounds, "no round produced a split read"
    overlapped = 0
    for rs in split_rounds:
        legs = {e[0]: e for e in rs.read_legs}
        assert set(legs) == {"pe", "de"}, rs.read_legs
        start = max(legs["pe"][2], legs["de"][2])
        first_done = min(legs["pe"][3], legs["de"][3])
        if first_done > start >= 0:
            overlapped += 1
    assert overlapped > 0, "no split round had concurrent NIC service"
    assert all(n.read_bytes > 0 for n in sim.snic.values())


def test_sim_charges_match_loading_plans_to_the_byte():
    trajs = generate_dataset(6, 32768, seed=2)
    for split, tier in ((False, 0.0), (True, 0.0), (False, 2e9),
                        (True, 2e9)):
        cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=1, D=1,
                        mode="dualpath", split_reads=split,
                        tier=TierConfig(dram_tier_bytes=tier))
        sim = Sim(cfg, trajs).run()
        checked = tiered = 0
        for rs in sim.rounds:
            if rs.done_t < 0 or rs.req.read_path is None:
                continue
            legs = [leg for leg in sim._request_legs(rs.req)
                    if leg.phase != "decode"]     # persists aggregate
            exp = {k: v for k, v in resource_bytes(legs).items() if v}
            got = {k: v for k, v in rs.charged.items() if v}
            assert got == exp, (split, tier, rs.req.rid, got, exp)
            checked += 1
            tiered += bool(rs.req.dram_tokens)
        assert checked > 0
        if tier:
            assert tiered > 0, "tier arm never served a DRAM hit"


def test_think_time_delays_next_round_submission():
    traj = Trajectory(0, [Round(256, 8), Round(64, 8, think=5.0)])
    cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=1, D=1,
                    mode="dualpath")
    sim = Sim(cfg, [traj]).run()
    assert sim.results()["finished_agents"] == 1
    r0, r1 = sim.rounds[0], sim.rounds[1]
    assert r1.submit_t - r0.done_t >= 5.0 - 1e-9


def test_unknown_drain_policy_raises():
    cfg = SimConfig(HOPPER_NODE, DS_660B, 1, 1,
                    elastic=ElasticConfig(drain_policy="nope"))
    with pytest.raises(ValueError):
        Sim(cfg, [])
