"""The port's finite compute network against the JAX package's.

* The primitives on a grid and on hypothesis draws, with the edges of
  tests/test_network.py: ``drain_times``, ``kv_share_when_contended``,
  ``allocate_bandwidth``, ``VLArbiterConfig.high_fraction``,
  ``CollectiveVolumeModel`` (``analytic``, ``from_config``,
  ``step_bytes``) and ``ServingTimeModel`` (``cn_seconds``,
  ``collective_seconds``, ``cn_drain``).  The port does the reference's
  float arithmetic in the reference's order, so the results are equal
  (exact ``==``).
* The paced flush: both packages' ``TrafficManager`` fed the same
  submissions under the same congestion sequence post, defer and complete
  the same WRs in the same order, with equal doorbells, submission
  seconds, paced flushes and deferred WRs.
* Network serving: both ``ServingSystem``s (reduced qwen, 2 PEs + 2 DEs,
  split reads, ``REDUCED_TEST_NODE``, bridged bf16 weights) with
  ``NetworkConfig(collective_group_size=8)`` under 'vl' and under 'fifo',
  on 4 agents whose first round appends 560 tokens, so a DE persists 35
  FullBlocks in one flush while the link is congested and the flush is
  paced (the chaos workload of tests/test_torch_faults.py never queues
  more than one doorbell batch of KV WRs at reduced width).  Contexts
  equal, ``stats()`` equal (modelled seconds within 1e-9 relative, the
  rest exact), pacing on the reference, and 'fifo' stalls the
  collectives longer than 'vl'.
* The config groups: the port's five groups have the reference's field
  names and defaults, every one of them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.core import config as jax_config
from repro.core import traffic as jax_traffic
from repro.models import init_params as jax_init_params
from repro.network import CollectiveVolumeModel as JaxCollectiveVolumeModel
from repro.network import drain_times as jax_drain_times
from repro.network import kv_share_when_contended as jax_kv_share
from repro.serving import ServingSystem as JaxServingSystem
from repro.serving.events import ServingTimeModel as JaxServingTimeModel
from repro.sim.spec import REDUCED_TEST_NODE as JAX_REDUCED_TEST_NODE
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import config, traffic
from repro_torch.network import (CollectiveVolumeModel, drain_times,
                                 kv_share_when_contended)
from repro_torch.serving import ServingSystem
from repro_torch.serving.events import ServingTimeModel
from repro_torch.sim.spec import REDUCED_TEST_NODE
from repro_torch.sim.traces import Round, Trajectory

torch.set_num_threads(1)

# the edges of tests/test_network.py plus a grid around the crossover
EDGES = [(0.0, 5.0, 0.5), (5.0, 0.0, 0.5), (3.0, 4.0, 0.0), (3.0, 4.0, 1.0),
         (10.0, 1.0, 0.5), (1.0, 10.0, 0.5), (0.0, 0.0, 0.3),
         (-1.0, 2.0, 0.5), (2.0, -1.0, 0.5), (3.0, 4.0, -0.5),
         (3.0, 4.0, 1.5), (1.0, 1.0, 0.5), (1e-12, 1e4, 0.0059)]
GRID = [(kv, coll, share) for kv in (0.0, 1e-6, 0.3, 1.0, 7.5)
        for coll in (0.0, 2e-6, 0.3, 1.0, 9.0)
        for share in (0.0, 0.0059, 0.25, 0.5, 0.99, 1.0)]


@pytest.mark.parametrize("kv,coll,share", EDGES + GRID)
def test_drain_times_match(kv, coll, share):
    assert drain_times(kv, coll, share) == jax_drain_times(kv, coll, share)


@given(kv=st.floats(-10.0, 1e4), coll=st.floats(-10.0, 1e4),
       share=st.floats(-0.5, 1.5))
@settings(max_examples=200, deadline=None)
def test_drain_times_match_drawn(kv, coll, share):
    assert drain_times(kv, coll, share) == jax_drain_times(kv, coll, share)


ARBITER_TABLES = [
    {},
    dict(high_limit=200),
    dict(high_limit=0),
    dict(high_limit=255),
    dict(high_weights=(192, 0, 0, 192), low_weights=(10, 20, 30, 40)),
    dict(high_weights=(0, 0, 0, 0), low_weights=(1, 2, 3, 4)),
    dict(low_weights=(0, 0, 0, 0)),
    dict(class_to_vl=(0, 1, 2)),
]


@pytest.mark.parametrize("table", ARBITER_TABLES,
                         ids=[str(i) for i in range(len(ARBITER_TABLES))])
def test_arbiter_matches(table):
    arb = traffic.VLArbiterConfig(**table)
    jarb = jax_traffic.VLArbiterConfig(**table)
    assert arb.high_fraction() == jarb.high_fraction()
    for name in ("vl", "fifo"):
        assert kv_share_when_contended(name, arb) == \
            jax_kv_share(name, jarb)
    classes = list(traffic.TrafficClass)
    for counts in ((1, 0, 0), (0, 3, 0), (1, 10, 0), (2, 5, 1), (0, 0, 4),
                   (0, 0, 0), (3, 0, 2)):
        got = traffic.allocate_bandwidth(dict(zip(classes, counts)),
                                         100e9, arb)
        want = jax_traffic.allocate_bandwidth(
            dict(zip(jax_traffic.TrafficClass, counts)), 100e9, jarb)
        assert [got[c] for c in classes] == \
            [want[jax_traffic.TrafficClass(int(c))] for c in classes]
    assert traffic.DEFAULT_ARBITER == traffic.VLArbiterConfig()
    assert dataclasses.astuple(traffic.DEFAULT_ARBITER) == \
        dataclasses.astuple(jax_traffic.DEFAULT_ARBITER)


@pytest.mark.parametrize("n_layers,width,group,dtype_bytes", [
    (24, 1024, 8, 2), (24, 1024, 1, 2), (24, 1024, 0, 2), (2, 64, 2, 4),
    (0, 64, 4, 2), (61, 7168, 16, 1), (1, 1, 3, 2)])
def test_collective_volumes_match(n_layers, width, group, dtype_bytes):
    got = CollectiveVolumeModel.analytic(n_layers, width, group, dtype_bytes)
    want = JaxCollectiveVolumeModel.analytic(n_layers, width, group,
                                             dtype_bytes)
    assert (got.bytes_per_token, got.n_layers) == \
        (want.bytes_per_token, want.n_layers)
    assert got.bytes_per_token_layer == want.bytes_per_token_layer
    for tokens in (-3, 0, 1, 7, 4096):
        assert got.step_bytes(tokens) == want.step_bytes(tokens)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_time_model_network_matches(name, reduced):
    cfg, jcfg = get_config(name), jax_get_config(name)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for group in (0, 1, 2, 8):
        got = CollectiveVolumeModel.from_config(cfg, group)
        want = JaxCollectiveVolumeModel.from_config(jcfg, group)
        assert (got.bytes_per_token, got.n_layers) == \
            (want.bytes_per_token, want.n_layers)
        for arb in ("vl", "fifo"):
            tm = ServingTimeModel.for_model(cfg, REDUCED_TEST_NODE,
                                            net_arbiter=arb,
                                            collective_group_size=group)
            jtm = JaxServingTimeModel.for_model(
                jcfg, JAX_REDUCED_TEST_NODE, net_arbiter=arb,
                collective_group_size=group)
            assert (tm.collectives is None) == (jtm.collectives is None) \
                == (group <= 1)
            for nbytes in (0.0, 1.0, 3e6, 7.5e8):
                assert tm.collective_seconds(nbytes) == \
                    jtm.collective_seconds(nbytes)
                for coll in (0.0, -1.0, 1e6, 9e8):
                    assert tm.cn_seconds(nbytes, coll) == \
                        jtm.cn_seconds(nbytes, coll)
            for kv_s, coll_s in ((0.0, 1.0), (1e-3, 2e-4), (0.5, 0.5),
                                 (2e-4, 1e-3), (1.0, 0.0)):
                assert tm.cn_drain(kv_s, coll_s) == \
                    jtm.cn_drain(kv_s, coll_s)


# ---------------------------------------------------------------------------
# the paced flush
# ---------------------------------------------------------------------------


def _drive_traffic(mod, script):
    """Feed ``mod``'s TrafficManager a script of ('submit', n, class,
    nbytes) / ('flush', congestion, with_callback) / ('poll', max_n)
    steps; returns the order WRs ran in, each flush's return, the
    completions' order and the counters."""
    tm = mod.TrafficManager(doorbell_batch=4)
    ran, flushes, done = [], [], []
    n_sub = 0
    for step in script:
        if step[0] == "submit":
            _, n, tclass, nbytes = step
            for _ in range(n):
                tm.submit(lambda i=n_sub: ran.append(i), nbytes,
                          mod.TrafficClass(tclass))
                n_sub += 1
        elif step[0] == "flush":
            _, congestion, cb = step
            tm.net_congestion = congestion
            k = len(flushes)
            flushes.append(tm.flush(
                on_complete=(lambda k=k: done.append(k)) if cb else None))
        else:
            ran.append(("poll", tm.poll(step[1])))
        flushes.append((tm.queued, tm.in_flight, tm.busy))
    tm.drain()
    return dict(ran=ran, flushes=flushes, done=done,
                counters=(tm.doorbells, tm.submitted_seconds,
                          tm.paced_flushes, tm.deferred_wrs,
                          [tm.bytes[c] for c in mod.TrafficClass]))


PACING_SCRIPTS = {
    "unpaced": [("submit", 9, 1, 10), ("submit", 2, 0, 5),
                ("flush", 0.0, True), ("poll", None)],
    "paced": [("submit", 11, 1, 10), ("submit", 3, 0, 5),
              ("flush", 0.9, True), ("poll", 3), ("submit", 2, 0, 7),
              ("flush", 0.5, True), ("poll", None), ("flush", 0.2, False),
              ("poll", None)],
    "deferred-twice": [("submit", 13, 1, 10), ("flush", 1.0, True),
                       ("poll", 2), ("submit", 5, 2, 3),
                       ("flush", 0.7, True), ("poll", None),
                       ("submit", 1, 0, 1), ("flush", 0.7, True),
                       ("poll", None), ("flush", 0.49, True),
                       ("poll", None)],
    "threshold": [("submit", 6, 1, 10), ("flush", 0.5, False),
                  ("submit", 6, 1, 10), ("flush", 0.4999, True),
                  ("poll", None)],
}


@pytest.mark.parametrize("script", list(PACING_SCRIPTS))
def test_paced_flush_matches(script):
    got = _drive_traffic(traffic, PACING_SCRIPTS[script])
    want = _drive_traffic(jax_traffic, PACING_SCRIPTS[script])
    assert got == want
    if script != "unpaced":
        assert got["counters"][2] > 0 and got["counters"][3] > 0
    else:
        assert got["counters"][2:4] == (0, 0)


# ---------------------------------------------------------------------------
# network serving on both packages
# ---------------------------------------------------------------------------

KW = dict(n_pe=2, n_de=2, block_tokens=16, max_seq=608, de_slots=2,
          pipelined=True, split_reads=True)
ROUNDS = [(560, 4), (16, 4)]
ARRIVALS = [0.0, 0.1, 0.2, 0.3]
ARBITERS = ("vl", "fifo")


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """A persistent XLA compilation cache in the session's temp directory
    for the reference's eager scans (the same executables: no result
    changes); the setting is restored when the module ends."""
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


@pytest.fixture(scope="module")
def runs(weights, jax_compile_cache):
    """{arbiter: {"jax": (system, contexts), "port": (system, contexts)}}."""
    jcfg, jp, cfg, tp = weights
    out = {}
    for arb in ARBITERS:
        js = JaxServingSystem(jcfg, jp, node=JAX_REDUCED_TEST_NODE, seed=0,
                              net=jax_config.NetworkConfig(
                                  net_arbiter=arb, collective_group_size=8),
                              **KW)
        jses = js.run_online([JaxTrajectory(i, [JaxRound(*r)
                                                for r in ROUNDS])
                              for i in range(4)], ARRIVALS)
        ts = ServingSystem(cfg, tp, node=REDUCED_TEST_NODE, device="cpu",
                           net=config.NetworkConfig(
                               net_arbiter=arb, collective_group_size=8),
                           **KW)
        tses = ts.run_online([Trajectory(i, [Round(*r) for r in ROUNDS])
                              for i in range(4)], ARRIVALS)
        out[arb] = {name: (s, [[int(t) for t in x.context] for x in ses])
                    for name, s, ses in (("jax", js, jses),
                                         ("port", ts, tses))}
    return out


def assert_stats_match(tst, jst):
    """Modelled seconds within 1e-9 relative, everything else exact."""
    assert tst.keys() == jst.keys()
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


@pytest.mark.parametrize("arb", ARBITERS)
def test_network_serving_matches_the_reference(runs, arb):
    (js, jctx), (ts, tctx) = runs[arb]["jax"], runs[arb]["port"]
    assert tctx == jctx
    jst, tst = js.stats(), ts.stats()
    assert_stats_match(tst, jst)
    assert jst["finished_rounds"] == 8
    # the workload paces KV WRs and charges collectives on both packages
    assert jst["deferred_wrs"] > 0 and jst["paced_flushes"] > 0
    assert tst["transfer_backlog_s"] > 0 and tst["net_congestion"] > 0


def test_fifo_stalls_collectives_longer_than_vl(runs):
    vl, fifo = (runs[a]["port"][0].stats() for a in ARBITERS)
    assert runs["vl"]["port"][1] == runs["fifo"]["port"][1]
    assert fifo["collective_stall_s"] > vl["collective_stall_s"] > 0
    # work conservation: the KV side pays the same backlog either way
    assert fifo["transfer_backlog_s"] == pytest.approx(
        vl["transfer_backlog_s"], rel=1e-9)


def test_no_collectives_leave_the_clock_alone(weights):
    """``collective_group_size`` 0 and 1 carry no collectives: every
    network counter stays 0 and ``stats()`` is the default system's."""
    cfg, tp = weights[2], weights[3]

    def run(net):
        s = ServingSystem(cfg, tp, node=REDUCED_TEST_NODE, device="cpu",
                          net=net, **KW)
        ses = s.run_online([Trajectory(i, [Round(*r) for r in ROUNDS])
                            for i in range(2)], ARRIVALS[:2])
        return [list(x.context) for x in ses], s.stats()

    want = run(None)
    for g in (0, 1):
        got = run(config.NetworkConfig(net_arbiter="fifo",
                                       collective_group_size=g))
        assert got[0] == want[0]
        assert_stats_match(got[1], want[1])
    for k in ("collective_stall_s", "transfer_backlog_s", "net_congestion",
              "paced_flushes", "deferred_wrs"):
        assert want[1][k] == 0, k


# ---------------------------------------------------------------------------
# the config groups
# ---------------------------------------------------------------------------


def _fields(group):
    return {f.name: f.default for f in dataclasses.fields(group)}


@pytest.mark.parametrize("name", jax_config.GROUP_FIELDS)
def test_group_fields_and_defaults_match(name):
    assert config.GROUP_FIELDS == jax_config.GROUP_FIELDS
    got = _fields(config.group_defaults(name))
    want = _fields(jax_config.group_defaults(name))
    assert got == want
    assert dataclasses.astuple(config.group_defaults(name)) == tuple(
        getattr(jax_config.group_defaults(name), k) for k in got)


def test_left_out_fields_are_real_and_documented():
    known = {f.name for g in jax_config.GROUP_FIELDS
             for f in dataclasses.fields(jax_config.group_defaults(g))}
    ported = {f.name for g in config.GROUP_FIELDS
              for f in dataclasses.fields(config.group_defaults(g))}
    # the simulator needs every group field, so the port leaves none out
    assert known == ported
    assert bool(config.ElasticConfig(enabled=True))
    assert not bool(config.ElasticConfig())
