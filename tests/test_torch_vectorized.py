"""The port's vectorized event engine against the port's ``Sim`` and the
JAX package's ``VectorSim``.

The reference's tests/test_vectorized.py on the port:

* on every supported config, ``VectorSim.results()`` equals
  ``Sim.results()`` — exactly for counters, bytes and tokens, within
  ``TIME_RTOL`` for time-valued keys (the reference's documented
  contract; observed exact) — and here also equals the reference
  ``VectorSim``'s results value for value on the same inputs: the
  equivalence matrix, a randomized arm, the zero-fault arm and a
  horizon-cut run with staggered arrivals;
* two runs are bit-identical, pooled charges equal the loading plans to
  the byte, the request table matches the round objects;
* the batch forms (``resource_bytes_batch``, ``hedge_water_fill_batch``,
  ``water_fill_frac_batch``) equal their scalar forms element for
  element;
* unsupported features refuse with ``VectorSimUnsupported``.

And the settle: ``settle_device="cpu"`` computes ``now + nl / rate`` in
float64 tensors and gives the numpy settle's results bit for bit.
"""
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.config as jax_config
import repro.sim as jax_sim
import repro.sim.faults as jax_faults
import repro_torch.sim as port_sim
import repro_torch.sim.faults as port_faults
from repro_torch.core import config
from repro_torch.core.config import (ElasticConfig, NetworkConfig,
                                     ResilienceConfig, TierConfig)
from repro_torch.core.loading import (hedge_water_fill,
                                      hedge_water_fill_batch, plan_for,
                                      resource_bytes, resource_bytes_batch)
from repro_torch.core.scheduler import Scheduler, water_fill_frac_batch
from repro_torch.sim import (DS_660B, HOPPER_NODE, Sim, SimConfig,
                             VectorSim, VectorSimUnsupported,
                             generate_dataset)
from repro_torch.sim.faults import (EngineDeath, FaultSchedule,
                                    SlowdownWindow, StragglerModel)
from repro_torch.sim.vectorized import _PoolFlow

#: results() keys that are modelled times (or derived from them): the
#: reference's Sim/VectorSim contract allows TIME_RTOL relative error
#: there and exactness everywhere else
TIME_KEYS = frozenset({
    "jct_mean", "jct_max", "ttft_mean", "ttft_p99", "ttst_mean",
    "tpot_mean", "tpot_p99", "sim_time", "collective_stall_s",
    "transfer_backlog_s", "net_collective_delay_s",
})
TIME_RTOL = 1e-9


def _compare(r0, r1, time_rtol=None):
    assert set(r0) == set(r1), set(r0) ^ set(r1)
    for k in sorted(r0):
        a, b = r0[k], r1[k]
        if isinstance(a, float) and math.isnan(a):
            assert isinstance(b, float) and math.isnan(b), (k, a, b)
        elif k in TIME_KEYS and time_rtol is not None:
            assert b == pytest.approx(a, rel=time_rtol), (k, a, b)
        else:
            assert a == b, (k, a, b)


def _cfg(**kw):
    kw.setdefault("P", 1)
    kw.setdefault("D", 2)
    return SimConfig(node=HOPPER_NODE, model=DS_660B, **kw)


#: each package's (config, sim, faults) modules
PORT = (config, port_sim, port_faults)
JAX = (jax_config, jax_sim, jax_faults)
_GROUP = dict(tier="TierConfig", net="NetworkConfig",
              resilience="ResilienceConfig")


def _pkg_cfg(pkg, core, groups):
    """The SimConfig of package ``pkg`` for core fields ``core`` and
    ``groups`` (group name -> kwargs; a ``faults`` value is a function of
    the package's faults module)."""
    c, sim, f = pkg
    built = {}
    for grp, kw in groups.items():
        kw = dict(kw)
        if "faults" in kw:
            kw["faults"] = kw["faults"](f)
        built[grp] = getattr(c, _GROUP[grp])(**kw)
    core = dict(core)
    core.setdefault("P", 1)
    core.setdefault("D", 2)
    return sim.SimConfig(node=sim.HOPPER_NODE, model=sim.DS_660B, **core,
                         **built)


def _faults(f):
    return f.FaultSchedule(
        windows=[f.SlowdownWindow("snic", 2.0, 20.0, 3.0, node=0),
                 f.SlowdownWindow("net", 5.0, 9.0, 2.0),
                 f.SlowdownWindow("net", 7.0, 15.0, 1.5)],
        straggler=f.StragglerModel(0.3, 4.0, seed=7))


def assert_equivalent(core, groups, n, max_len, seed, arrivals=None,
                      until=None, exact_times=False):
    """Port Sim vs port VectorSim under the reference's contract, then
    the port VectorSim against the reference VectorSim value for
    value."""
    until = math.inf if until is None else until
    out = []
    for pkg, engines in ((PORT, (Sim, VectorSim)), (JAX, (jax_sim.VectorSim,))):
        trajs = pkg[1].generate_dataset(n, max_len, seed=seed)
        cfg = _pkg_cfg(pkg, core, groups)
        for engine in engines:
            arr = None if arrivals is None else list(arrivals)
            out.append(engine(cfg, trajs).run(arrivals=arr, until=until)
                       .results())
    r0, r1, rj = out
    _compare(r0, r1, time_rtol=None if exact_times else TIME_RTOL)
    _compare(r1, rj)
    return r0, r1


# --------------------------------------------------------------------------
# engine equivalence
# --------------------------------------------------------------------------

MATRIX = [
    ({}, {}),                                           # dualpath
    (dict(mode="basic"), {}),
    (dict(mode="oracle"), {}),
    (dict(split_reads=True), {}),
    ({}, dict(tier=dict(dram_tier_bytes=64e9, prefetch=True))),
    ({}, dict(tier=dict(dram_tier_bytes=64e9, tier_policy="agentic-ttl",
                        tier_ttl_s=30.0))),
    ({}, dict(net=dict(net_bw=400e9, net_bg_load=0.4))),    # VL + coll
    ({}, dict(net=dict(net_bw=400e9, net_arbiter="fifo", net_bg_load=0.4))),
    ({}, dict(resilience=dict(faults=_faults))),
    ({}, dict(resilience=dict(faults=_faults),
              net=dict(net_bw=300e9, net_bg_load=0.3))),
    (dict(online=True), {}),
    (dict(layerwise=False), {}),
    (dict(scheduler="rr"), {}),
    (dict(P=2, D=4, split_reads=True, nodes_per_pe_group=1,
          nodes_per_de_group=1),
     dict(tier=dict(dram_tier_bytes=32e9),
          net=dict(net_bw=300e9, net_bg_load=0.3))),
]


@pytest.mark.parametrize("core,groups", MATRIX, ids=lambda kw: ",".join(
    sorted(kw)) or "-")
def test_engine_equivalence_matrix(core, groups):
    """Every supported feature axis: results() key for key."""
    assert_equivalent(core, groups, 5, 8192, seed=3)


@given(data=st.data())
@settings(max_examples=5, deadline=None)
def test_engine_equivalence_randomized(data):
    n_agents = data.draw(st.integers(2, 6), label="n_agents")
    max_len = data.draw(st.sampled_from([2048, 8192, 16384]),
                        label="max_len")
    seed = data.draw(st.integers(0, 2 ** 10), label="seed")
    core, groups = {}, {}
    core["mode"] = data.draw(st.sampled_from(["dualpath", "basic"]),
                             label="mode")
    if data.draw(st.booleans(), label="split"):
        core["split_reads"] = True
    if data.draw(st.booleans(), label="tier"):
        groups["tier"] = dict(dram_tier_bytes=32e9)
    if data.draw(st.booleans(), label="net"):
        groups["net"] = dict(
            net_bw=data.draw(st.sampled_from([200e9, 400e9]),
                             label="net_bw"),
            net_bg_load=data.draw(st.sampled_from([0.0, 0.5]), label="bg"))
    if data.draw(st.booleans(), label="online"):
        core["online"] = True
    assert_equivalent(core, groups, n_agents, max_len, seed)


def test_zero_fault_schedule_is_bit_identical():
    """An empty schedule == faults=None == the event engine, all exact."""
    net = dict(net=dict(net_bw=300e9))
    _, r_vec = assert_equivalent({}, net, 4, 8192, seed=5, exact_times=True)
    _, r_vec_empty = assert_equivalent(
        {}, dict(net, resilience=dict(faults=lambda f: f.FaultSchedule())),
        4, 8192, seed=5, exact_times=True)
    assert r_vec == r_vec_empty


def test_vectorized_engine_is_deterministic():
    trajs = generate_dataset(4, 8192, seed=9)
    cfg = _cfg(split_reads=True,
               net=NetworkConfig(net_bw=300e9, net_bg_load=0.4))
    r1 = VectorSim(cfg, trajs).run().results()
    r2 = VectorSim(cfg, trajs).run().results()
    assert r1 == r2


def test_equivalence_with_staggered_arrivals_and_horizon():
    """An ``until`` cutoff with arrivals: the fleet benchmark's shape."""
    trajs = generate_dataset(6, 8192, seed=11)
    arrivals = [0.3 * i for i in range(6)]
    cfg = _cfg(net=NetworkConfig(net_bw=200e9, net_bg_load=0.6))
    s0 = Sim(cfg, trajs).run(arrivals=list(arrivals), until=20.0)
    s1 = VectorSim(cfg, trajs).run(arrivals=list(arrivals), until=20.0)
    assert s0.results() == s1.results()
    assert_equivalent({}, dict(net=dict(net_bw=200e9, net_bg_load=0.6)),
                      6, 8192, seed=11, arrivals=arrivals, until=20.0)


# --------------------------------------------------------------------------
# the settle on a device
# --------------------------------------------------------------------------


def test_cpu_settle_equals_numpy_settle_bit_for_bit():
    """The device settle on the CPU, on a cut of the microbench's
    saturated-link workload (4 nodes, split reads, background load at
    0.8 of the link): the same float64 IEEE arithmetic, so every result
    and every round's stamps are bit-identical, and the pool really took
    the array path (more than 8 flows affected) through it."""
    trajs = generate_dataset(16, 8192, seed=0)
    arrivals = [i * 2.0 / 15 for i in range(16)]
    cfg = _cfg(P=1, D=3, nodes_per_pe_group=1, nodes_per_de_group=1,
               split_reads=True,
               net=NetworkConfig(net_bw=4e9, net_bg_load=0.8,
                                 net_bg_chunk_bytes=64e6))
    host = VectorSim(cfg, trajs).run(arrivals=list(arrivals), until=10.0)
    dev = VectorSim(cfg, trajs, settle_device="cpu").run(
        arrivals=list(arrivals), until=10.0)
    assert host._settle_kernel is None
    assert dev._settle_kernel.calls > 0
    _compare(dev.results(), host.results())
    assert (dev.loop.n_events, dev.pool.n_reshares) == \
        (host.loop.n_events, host.pool.n_reshares)
    t_dev, t_host = dev.request_table(), host.request_table()
    for k in t_host:
        assert np.array_equal(t_dev[k], t_host[k]), k
    assert t_host["read_done_t"].max() > 0      # reads completed


# --------------------------------------------------------------------------
# byte conservation
# --------------------------------------------------------------------------


def test_pooled_charges_match_loading_plans_to_the_byte():
    trajs = generate_dataset(5, 16384, seed=2)
    for split, tier in ((False, 0.0), (True, 0.0), (True, 2e9)):
        cfg = _cfg(split_reads=split, tier=TierConfig(dram_tier_bytes=tier))
        sim = VectorSim(cfg, trajs).run()
        checked = 0
        for rs in sim.rounds:
            if rs.done_t < 0 or rs.req.read_path is None:
                continue
            legs = [leg for leg in sim._request_legs(rs.req)
                    if leg.phase != "decode"]
            exp = {k: v for k, v in resource_bytes(legs).items() if v}
            got = {k: v for k, v in rs.charged.items() if v}
            assert got == exp, (split, tier, rs.req.rid, got, exp)
            checked += 1
        assert checked > 0


def test_request_table_matches_round_objects():
    trajs = generate_dataset(5, 8192, seed=4)
    sim = VectorSim(_cfg(split_reads=True), trajs).run()
    t = sim.request_table()
    n = len(sim.rounds)
    assert all(len(v) == n for v in t.values())
    for i, rs in enumerate(sim.rounds):
        assert t["rid"][i] == rs.req.rid
        assert t["done_t"][i] == rs.done_t
        assert t["gen_tokens"][i] == rs.gen_total
    assert int(t["cached_tokens"].sum()) == \
        sum(rs.req.cached_tokens for rs in sim.rounds)
    # the reference's table on the same inputs, column for column
    jtrajs = jax_sim.generate_dataset(5, 8192, seed=4)
    jt = jax_sim.VectorSim(_pkg_cfg(JAX, dict(split_reads=True), {}),
                           jtrajs).run().request_table()
    assert set(t) == set(jt)
    for k in t:
        assert t[k].dtype == jt[k].dtype and np.array_equal(t[k], jt[k]), k


# --------------------------------------------------------------------------
# batch plan kernels == scalar kernels
# --------------------------------------------------------------------------


@given(data=st.data())
@settings(max_examples=20, deadline=None)
def test_resource_bytes_batch_matches_plan_sums(data):
    n = data.draw(st.integers(1, 40), label="n")
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 20),
                                          label="seed"))
    hit = rng.integers(0, 1 << 32, n)
    miss = rng.integers(0, 1 << 30, n)
    gen = rng.integers(0, 1 << 28, n)
    cuts = np.sort((rng.random((n, 3)) * hit[:, None]).astype(np.int64),
                   axis=1)
    part = (cuts[:, 0], cuts[:, 1] - cuts[:, 0], cuts[:, 2] - cuts[:, 1],
            hit - cuts[:, 2])
    batch = resource_bytes_batch("dualpath", hit, miss, gen, *part)
    for i in range(n):
        tier = tuple(int(p[i]) for p in part)
        rb = resource_bytes(plan_for("pe", 1.0, int(hit[i]), int(miss[i]),
                                     int(gen[i]), tier=tier))
        for k, arr in batch.items():
            assert rb.get(k, 0) == arr[i], (i, k)
    for mode in ("basic", "oracle"):
        b = resource_bytes_batch(mode, hit, miss, gen)
        for i in range(0, n, 7):
            rb = resource_bytes(plan_for(mode, 1.0, int(hit[i]),
                                         int(miss[i]), int(gen[i])))
            for k, arr in b.items():
                assert rb.get(k, 0) == arr[i], (mode, i, k)


def test_resource_bytes_batch_rejects_bad_partition():
    one = np.asarray([10])
    with pytest.raises(ValueError):
        resource_bytes_batch("dualpath", one, one, one,
                             pe_snic=np.asarray([3]))
    with pytest.raises(ValueError):
        resource_bytes_batch("nope", one, one, one)


@given(data=st.data())
@settings(max_examples=20, deadline=None)
def test_hedge_water_fill_batch_matches_scalar(data):
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 20),
                                          label="seed"))
    n = 64
    rem = rng.integers(0, 1 << 30, n)
    sev = 1.0 + rng.random(n) * 9.0
    back = rng.integers(0, 1 << 30, n)
    out = hedge_water_fill_batch(rem, sev, back)
    for i in range(n):
        assert out[i] == hedge_water_fill(int(rem[i]), float(sev[i]),
                                          int(back[i])), i


@given(data=st.data())
@settings(max_examples=20, deadline=None)
def test_water_fill_frac_batch_matches_scalar(data):
    from repro.core.scheduler import \
        water_fill_frac_batch as jax_water_fill_frac_batch
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 20),
                                          label="seed"))
    n = 64
    pe_q = rng.integers(0, 1 << 20, n)
    de_q = rng.integers(0, 1 << 20, n)
    h = rng.integers(1, 1 << 16, n)
    out = water_fill_frac_batch(pe_q, de_q, h)
    scalar = Scheduler.__dict__["_water_fill_frac"]
    stub = object.__new__(Scheduler)
    for i in range(n):
        assert out[i] == scalar(stub, int(pe_q[i]), int(de_q[i]),
                                int(h[i])), i
    assert np.all((out >= 0.0) & (out <= 1.0))
    assert np.array_equal(out, jax_water_fill_frac_batch(pe_q, de_q, h))


# --------------------------------------------------------------------------
# gating
# --------------------------------------------------------------------------


def test_unsupported_configs_refuse_loudly():
    trajs = generate_dataset(2, 2048, seed=0)
    deaths = FaultSchedule(deaths=[EngineDeath(5.0, (0, 0))])
    for kw in (dict(elastic=ElasticConfig(enabled=True)),
               dict(resilience=ResilienceConfig(hedge_reads=True)),
               dict(resilience=ResilienceConfig(faults=deaths))):
        with pytest.raises(VectorSimUnsupported):
            VectorSim(_cfg(**kw), trajs)
    # an *empty* death list is supported (structurally invisible)
    VectorSim(_cfg(resilience=ResilienceConfig(faults=FaultSchedule())),
              trajs)
    # slowdown windows and stragglers are supported
    VectorSim(_cfg(resilience=ResilienceConfig(faults=FaultSchedule(
        windows=[SlowdownWindow("snic", 0.0, 1.0, 2.0)],
        straggler=StragglerModel(0.5, 2.0)))), trajs)


def test_pool_flow_cancel_refuses():
    f = _PoolFlow()
    with pytest.raises(VectorSimUnsupported):
        f.cancel()
