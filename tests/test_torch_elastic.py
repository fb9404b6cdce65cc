"""The port's elastic PE↔DE role flips against the JAX package's.

* ``PDController``, ``DrainTracker`` and ``pick_victim`` on the scenarios
  of tests/test_autoscale.py (and on a seeded random observation
  sequence, traced), each run on both packages: the same decisions, the
  same state and the same ``proposal`` events.
* The scheduler's drain protocol on the cases of tests/test_autoscale.py:
  no admission while draining, the private-queue hand-back,
  ``requeue_unstarted``, the PE→DE→PE round trip, refusing an in-flight
  ``finish_drain``, ``choose_read_path`` steering away from a draining
  side, and its ``net_congestion`` bias; the same operations leave both
  packages' schedulers in the same state.
* Elastic serving on the workload of
  tests/test_autoscale.py::test_serving_elastic_identity_and_tier_pin_release
  (reduced qwen, 2 PEs + 2 DEs, one slot each, a 64 kB DRAM tier per
  node, ``REDUCED_TEST_NODE``, bridged bf16 weights), elastic on (traced)
  and off, on both packages: equal contexts, equal ``stats()`` with the
  same key set (modelled seconds within 1e-9 relative, the rest exact),
  equal final ``engine_lifecycle``, equal ``reconfig`` spans; no tier pin
  left; elastic on and off generate the same tokens.
* A ``FaultSchedule`` kills the drain's victim while it drains and while
  it reconfigures (times from the elastic run's ``reconfig`` span and its
  drain record): both packages drop the drain, end the engine DEAD and
  agree on contexts and ``stats()``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import autoscale as jax_autoscale
from repro.core import config as jax_config
from repro.core import scheduler as jax_scheduler
from repro.models import init_params as jax_init_params
from repro.obs import Tracer as JaxTracer
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim import faults as jax_faults
from repro.sim.spec import REDUCED_TEST_NODE as JAX_REDUCED_TEST_NODE
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import autoscale, config, scheduler
from repro_torch.obs import Tracer
from repro_torch.serving import ServingSystem
from repro_torch.serving.events import EngineLifecycle
from repro_torch.sim import faults
from repro_torch.sim.spec import REDUCED_TEST_NODE
from repro_torch.sim.traces import Round, Trajectory

torch.set_num_threads(1)

PKGS = {"jax": dict(autoscale=jax_autoscale, scheduler=jax_scheduler,
                    Tracer=JaxTracer),
        "port": dict(autoscale=autoscale, scheduler=scheduler,
                     Tracer=Tracer)}


def both(fn):
    """``fn(pkg)`` on both packages; asserts equal results, returns one."""
    got, want = fn(PKGS["port"]), fn(PKGS["jax"])
    assert got == want
    return got


# ---------------------------------------------------------------------------
# PDController, DrainTracker, pick_victim
# ---------------------------------------------------------------------------


def _sig(m, pe_s, de_s, n_pe=2, n_de=2):
    return m.LoadSignals(n_pe=n_pe, n_de=n_de, pe_queued_s=pe_s,
                         pe_busy_s=0.0, de_queued_s=de_s, de_busy_s=0.0)


# (controller kwargs, [(pe_s, de_s, n_pe, n_de, now)], the decisions
# tests/test_autoscale.py expects)
CONTROLLER = {
    "dead-band": (dict(patience=1), [(1.0, 1.0, 2, 2, 0.0)] * 10,
                  [None] * 10),
    "patience-and-directions": (
        dict(patience=2),
        [(10.0, 1.0, 2, 2, 0.0), (10.0, 1.0, 2, 2, 1.0),
         (1.0, 10.0, 2, 2, 2.0), (1.0, 10.0, 2, 2, 3.0)],
        [None, "de->pe", None, "pe->de"]),
    "streak-resets-in-band": (
        dict(patience=2),
        [(10.0, 1.0, 2, 2, 0.0), (1.0, 1.0, 2, 2, 1.0),
         (10.0, 1.0, 2, 2, 2.0), (10.0, 1.0, 2, 2, 3.0)],
        [None, None, None, "de->pe"]),
    "cooldown": (
        dict(patience=1, cooldown_s=10.0),
        [(10.0, 1.0, 2, 2, 0.0), (10.0, 1.0, 2, 2, 5.0),
         (10.0, 1.0, 2, 2, 11.0)],
        ["de->pe", None, "de->pe"]),
    "role-floors": (
        dict(patience=1, min_pe=1, min_de=1),
        [(10.0, 1.0, 2, 1, 0.0), (0.1, 10.0, 1, 2, 1.0)], [None, None]),
    "idle-floor": (
        dict(patience=1, idle_floor_s=1e-3),
        [(1e-5, 0.0, 2, 2, 0.0), (1.0, 0.0, 2, 2, 1.0)],
        [None, "de->pe"]),
}


@pytest.mark.parametrize("case", list(CONTROLLER))
def test_controller_matches(case):
    kw, obs, want = CONTROLLER[case]

    def run(pkg):
        m = pkg["autoscale"]
        c = m.PDController(hi=2.0, lo=0.5, **kw)
        out = [c.observe(_sig(m, *o[:4]), now=o[4]) for o in obs]
        return out, c.n_proposed, c._streak, c._last_action_t

    out = both(run)
    assert out[0] == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_matches_on_a_random_sequence(seed):
    """Seeded random pressures, role counts, times and settings, traced:
    equal decisions and equal ``proposal`` events."""
    rng = np.random.default_rng(seed)
    kw = dict(hi=float(rng.uniform(1.2, 3.0)), lo=float(rng.uniform(0.2, 0.8)),
              patience=int(rng.integers(1, 4)),
              cooldown_s=float(rng.choice([0.0, 0.5])),
              idle_floor_s=float(rng.choice([1e-4, 1e-2])))
    obs = [(float(rng.choice([0.0, 1e-3, rng.exponential(1.0)])),
            float(rng.choice([0.0, 1e-3, rng.exponential(1.0)])),
            int(rng.integers(1, 4)), int(rng.integers(1, 4)), 0.1 * i)
           for i in range(200)]

    def run(pkg):
        m = pkg["autoscale"]
        c = m.PDController(**kw)
        tr = pkg["Tracer"](now_fn=lambda: 0.0)
        c.tracer = tr
        out = [c.observe(_sig(m, *o[:4]), now=o[4]) for o in obs]
        return out, c.n_proposed, [(tk, n, t, a) for tk, n, t, a
                                   in tr.iter_events()]

    out = both(run)
    assert out[1] > 0 and len(out[2]) == out[1]


def test_drain_tracker_matches():
    def run(pkg):
        m = pkg["autoscale"]
        t = m.DrainTracker()
        rec = t.begin((0, 0), "de", "pe", now=1.0)
        raised = []
        for bad in (lambda: t.begin((0, 0), "de", "pe", now=1.5),
                    lambda: t.finish((0, 0), now=2.0)):
            try:
                bad()
            except AssertionError:
                raised.append(True)
        t.mark_drained((0, 0), now=3.0)
        t.finish((0, 0), now=5.0, tier_handoff_bytes=128)
        t.begin((1, 0), "pe", "de", now=6.0)
        aborted = t.abort((1, 0))
        t.begin((2, 0), "pe", "de", now=7.0)
        t.mark_drained((2, 0), now=7.5)
        t.finish((2, 0), now=9.25, tier_handoff_bytes=64)
        return (raised, (rec.t_drained, rec.t_flip), t.n_flips,
                t.drain_seconds(), t.flips_by_direction(),
                t.tier_handoff_bytes(), list(t.active),
                (aborted.engine, aborted.t_drained), t.abort((9, 9)))

    out = both(run)
    assert out[0] == [True, True] and out[2] == 2
    assert out[3] == pytest.approx(4.0 + 2.25)
    assert out[4] == {"de->pe": 1, "pe->de": 1}
    assert autoscale.DRAIN_POLICIES == jax_autoscale.DRAIN_POLICIES
    assert (autoscale.DE_TO_PE, autoscale.PE_TO_DE) == \
        (jax_autoscale.DE_TO_PE, jax_autoscale.PE_TO_DE)


class _E:
    def __init__(self, eid, load):
        self.engine = eid
        self.load = load


@pytest.mark.parametrize("policy,rotation", [
    ("idlest", 0), ("rotate", 0), ("rotate", 2), ("rotate", 3),
    ("rotate", 7), ("bogus", 0)])
def test_pick_victim_matches(policy, rotation):
    es = [_E((0, 0), 5), _E((2, 0), 1), _E((1, 0), 9), _E((3, 0), 1)]

    def run(pkg):
        try:
            v = pkg["autoscale"].pick_victim(es, policy, lambda e: e.load,
                                             rotation=rotation)
        except ValueError:
            return "ValueError"
        return v.engine

    out = both(run)
    if policy == "idlest":
        assert out == (2, 0)
    if policy == "bogus":
        assert out == "ValueError"


# ---------------------------------------------------------------------------
# the scheduler's drain protocol
# ---------------------------------------------------------------------------


def _sched(m, n_pe=2, n_de=2):
    s = m.Scheduler(alpha=1 << 30, beta=1 << 30)
    for i in range(n_pe):
        s.register_engine((i, 0), node=i, kind="pe", group=0)
    for j in range(n_de):
        st = s.register_engine((n_pe + j, 0), node=n_pe + j, kind="de",
                               group=1000 + j)
        st.free_hbm_tokens = 10000
    return s


def _req(m, rid, cached=0, new=64, gen=16, arrival=0.0):
    return m.Request(rid=rid, cached_tokens=cached, new_tokens=new,
                     gen_tokens=gen, arrival=arrival)


def snapshot(s):
    """Everything the scheduler holds, by value."""
    return dict(
        engines={eid: (st.kind, st.group, st.seq, st.tok, st.read_q,
                       st.free_hbm_tokens, st.draining)
                 for eid, st in s.engines.items()},
        groups={g: list(es) for g, es in s._groups.items()},
        pe_queue=[r.rid for r in s.pe_queue],
        de_global=[r.rid for r in s.de_global_queue],
        de_private={g: [r.rid for r in q] for g, q in s.de_private.items()})


def _req_view(r):
    return (r.rid, r.pe, r.de, r.read_path, r.read_split, r.dram_side,
            r.dram_tokens, r.snic_tokens)


def case_no_admission_while_draining(m):
    s = _sched(m)
    s.begin_drain((0, 0))
    s.begin_drain((2, 0))
    for i in range(6):
        s.submit(_req(m, i))
    pe = [(a.request.rid, a.engine) for a in s.on_pe_fetch(0)]
    de = [(a.request.rid, a.engine) for gid in list(s.groups("de"))
          for a in s.on_de_fetch(gid)]
    assert all(e != (0, 0) for _, e in pe)
    assert all(e != (2, 0) for _, e in de)
    assert not s.de_private[1000]
    return pe, de, snapshot(s)


def case_private_queue_hand_back(m):
    s = _sched(m, n_de=1)
    for i in range(3):
        s.submit(_req(m, i))
    s.de_phase1()
    before = snapshot(s)
    s.begin_drain((2, 0))
    assert [r.rid for r in s.de_global_queue] == [0, 1, 2]
    assert not s.de_private[1000]
    return before, snapshot(s)


def case_requeue_unstarted(m):
    s = _sched(m)
    rs = [_req(m, i, cached=64, arrival=float(i)) for i in range(3)]
    for r in rs:
        s.submit(r)
    assert len(s.on_pe_fetch(0)) == 3
    victim = rs[0].pe
    for r in rs:
        if r.de is None:
            r.de = (2, 0)
    started = [r for r in rs if r.pe == victim][0]
    s.choose_read_path(started)
    s.begin_drain(victim)
    back = s.requeue_unstarted(victim, rs)
    assert started not in back and all(r.pe is None for r in back)
    assert [r.rid for r in s.pe_queue] == sorted(r.rid for r in back)
    return [r.rid for r in back], [_req_view(r) for r in rs], snapshot(s)


def case_requeue_unstarted_de(m):
    s = _sched(m)
    rs = [_req(m, i, gen=8 * i, arrival=float(i)) for i in range(4)]
    for r in rs:
        s.submit(r)
    s.on_de_fetch(1000)
    s.on_de_fetch(1001)
    victim = (2, 0)
    s.begin_drain(victim)
    back = s.requeue_unstarted(victim, rs)
    return [r.rid for r in back], [_req_view(r) for r in rs], snapshot(s)


def case_round_trip(m):
    s = _sched(m)
    snap = snapshot(s)
    eid = (0, 0)
    s.begin_drain(eid)
    assert s.can_finish_drain(eid)
    s.finish_drain(eid, kind="de", group=2000, free_hbm_tokens=5000)
    mid = snapshot(s)
    assert eid in s.groups("de")[2000]
    s.begin_drain(eid)
    s.finish_drain(eid, kind="pe", group=0)
    end = snapshot(s)
    assert end["engines"] == snap["engines"]
    assert {g: es for g, es in end["groups"].items() if es} == snap["groups"]
    assert 2000 not in s._groups
    return mid, end


def case_refuse_inflight_finish(m):
    s = _sched(m)
    s.submit(_req(m, 0))
    s.on_pe_fetch(0)
    busy = next(st.engine for st in s.engines.values()
                if st.kind == "pe" and st.tok > 0)
    s.begin_drain(busy)
    assert not s.can_finish_drain(busy)
    try:
        s.finish_drain(busy, kind="de", group=2000)
    except AssertionError:
        return busy, snapshot(s)
    raise AssertionError("finish_drain flipped an engine with work")


def case_read_path_steers_away(m):
    out = []
    for drained, want in (((2, 0), "pe"), ((0, 0), "de")):
        for split in (False, True):
            s = m.Scheduler(alpha=1 << 30, beta=1 << 30, split_reads=split)
            for i in range(2):
                s.register_engine((i, 0), node=i, kind="pe", group=0)
            for j in range(2):
                s.register_engine((2 + j, 0), node=2 + j, kind="de",
                                  group=1000 + j)
            r = _req(m, 0, cached=100)
            r.pe, r.de = (0, 0), (2, 0)
            s.begin_drain(drained)
            got = s.choose_read_path(r)
            if not split:
                assert got == want
            out.append((_req_view(r), snapshot(s)))
    return out


@pytest.mark.parametrize("congestion", [0.0, 0.3, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("split", [False, True], ids=["pure", "split"])
@pytest.mark.parametrize("tier", [None, (64, 0), (32, 32)],
                         ids=["no-tier", "pe-tier", "tie-tier"])
def test_read_path_congestion_bias_matches(congestion, split, tier):
    def run(pkg):
        m = pkg["scheduler"]
        s = m.Scheduler(alpha=1 << 30, beta=1 << 30, split_reads=split)
        s.register_engine((0, 0), node=0, kind="pe", group=0)
        s.register_engine((1, 0), node=1, kind="de", group=1000)
        s.engines[(0, 0)].read_q = 300
        s.engines[(1, 0)].read_q = 100
        out = []
        for rid, cached in enumerate((512, 128, 1000, 0, 96)):
            r = _req(m, rid, cached=cached)
            r.pe, r.de = (0, 0), (1, 0)
            tt = None if tier is None else {"pe": tier[0], "de": tier[1]}
            s.choose_read_path(r, tier_tokens=tt, net_congestion=congestion)
            out.append(_req_view(r))
        return out, snapshot(s)

    out = both(run)
    if tier is None and not split and congestion == 0.0:
        assert out[0][0][3] == "de"        # the shorter queue


SCHED_CASES = {f.__name__[5:]: f for f in (
    case_no_admission_while_draining, case_private_queue_hand_back,
    case_requeue_unstarted, case_requeue_unstarted_de, case_round_trip,
    case_refuse_inflight_finish, case_read_path_steers_away)}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_drain_protocol_matches(case):
    both(lambda pkg: SCHED_CASES[case](pkg["scheduler"]))


def test_fail_engine_reuses_the_drain_hand_back():
    """A dead engine that was the last admitting member of its DE group
    hands the private queue back as ``begin_drain`` does; one already
    draining hands back nothing more."""
    def run(pkg):
        m = pkg["scheduler"]
        s = _sched(m, n_de=2)
        for i in range(4):
            s.submit(_req(m, i, arrival=float(i)))
        s.de_phase1()
        s.fail_engine((2, 0))
        a = snapshot(s)
        s.begin_drain((3, 0))
        s.fail_engine((3, 0))
        return a, snapshot(s)

    both(run)


# ---------------------------------------------------------------------------
# elastic serving on both packages
# ---------------------------------------------------------------------------

TRAJS = [[(48, 1), (8, 1)]] * 3 + [[(4, 16)]] * 3
TIDS = [0, 1, 2, 10, 11, 12]
ARRIVALS = [0.0] * 3 + [1.5] * 3
KW = dict(n_pe=2, n_de=2, block_tokens=16, max_seq=96, de_slots=1,
          pipelined=True)


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
def packages():
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen1.5-0.5b").reduced()
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    return dict(
        jax=dict(ServingSystem=JaxServingSystem, cfg=jcfg, params=jp,
                 node=JAX_REDUCED_TEST_NODE, config=jax_config,
                 faults=jax_faults, Round=JaxRound,
                 Trajectory=JaxTrajectory, Tracer=JaxTracer,
                 kw=dict(seed=0)),
        port=dict(ServingSystem=ServingSystem, cfg=cfg, params=tp,
                  node=REDUCED_TEST_NODE, config=config, faults=faults,
                  Round=Round, Trajectory=Trajectory, Tracer=Tracer,
                  kw=dict(device="cpu")))


def serve(pkg, elastic, tracer=None, death=None):
    """One online run of ``pkg``'s ServingSystem; ``death`` is (modelled
    time, engine) of an EngineDeath.  Returns (system, contexts)."""
    c, f = pkg["config"], pkg["faults"]
    res = None if death is None else c.ResilienceConfig(
        faults=f.FaultSchedule(deaths=[f.EngineDeath(*death)]))
    s = pkg["ServingSystem"](
        pkg["cfg"], pkg["params"], node=pkg["node"], tracer=tracer,
        tier=c.TierConfig(dram_tier_bytes=64e3),
        elastic=c.ElasticConfig(enabled=elastic, reconfig_interval_s=0.05,
                                reconfig_patience=2,
                                reconfig_idle_floor_s=1e-4),
        resilience=res, **pkg["kw"], **KW)
    ses = s.run_online([pkg["Trajectory"](t, [pkg["Round"](*r) for r in rs])
                        for t, rs in zip(TIDS, TRAJS)], ARRIVALS)
    assert all(x.done() for x in ses)
    return s, [[int(t) for t in x.context] for x in ses]


@pytest.fixture(scope="module")
def runs(packages, jax_compile_cache):
    """{"on" | "off": {"jax": (system, contexts, tracer), "port": ...}};
    the elastic runs are traced."""
    out = {}
    for arm, elastic in (("on", True), ("off", False)):
        out[arm] = {}
        for name, pkg in packages.items():
            tr = pkg["Tracer"]() if elastic else None
            s, ctx = serve(pkg, elastic, tracer=tr)
            out[arm][name] = (s, ctx, tr)
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


def lifecycles(s):
    return {eid: lc.name for eid, lc in s.engine_lifecycle.items()}


@pytest.mark.parametrize("arm", ["on", "off"])
def test_elastic_serving_matches_the_reference(runs, arm):
    (js, jctx, _), (ts, tctx, _) = runs[arm]["jax"], runs[arm]["port"]
    assert tctx == jctx
    assert_stats_match(ts.stats(), js.stats())
    assert lifecycles(ts) == lifecycles(js)
    assert set(ts.pes) == set(js.pes) and set(ts.des) == set(js.des)


def test_elastic_flips_and_settles(runs):
    """The reference's own checks on the port: a flip happened, tokens
    equal elastic off, no tier pin left, every engine ACTIVE, engine maps
    equal the scheduler's view."""
    ts, tctx, _ = runs["on"]["port"]
    st = ts.stats()
    assert tctx == runs["off"]["port"][1]
    assert st["role_changes"] >= 1 and st["reconfig_drain_s"] > 0
    assert st["reconfig_weight_bytes"] > 0
    assert runs["off"]["port"][0].stats()["role_changes"] == 0
    assert all(t.pinned_bytes() == 0 for t in ts.tiers.values())
    assert all(lc == EngineLifecycle.ACTIVE
               for lc in ts.engine_lifecycle.values())
    assert st["n_pe_final"] == len(ts.pes) == sum(
        st_.kind == "pe" for st_ in ts.sched.engines.values())
    assert st["n_de_final"] == len(ts.des)
    assert set(ts.pes) == {st_.engine for st_ in ts.sched.engines.values()
                           if st_.kind == "pe"}
    assert not ts.drains.active and not any(
        st_.draining for st_ in ts.sched.engines.values())


def test_reconfig_spans_match(runs):
    (_, _, jtr), (_, _, ttr) = runs["on"]["jax"], runs["on"]["port"]
    got = list(ttr.iter_spans("reconfig"))
    want = list(jtr.iter_spans("reconfig"))
    assert len(got) == len(want) == runs["on"]["port"][0].stats()[
        "role_changes"]
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[4] == w[4]
        assert g[2:4] == pytest.approx(w[2:4], rel=1e-9, abs=0)
    props = [(t, n, a) for t, n, _, a in ttr.iter_events("proposal")]
    assert props == [(t, n, a) for t, n, _, a in jtr.iter_events("proposal")]
    assert len(props) >= len(got)


@pytest.mark.parametrize("phase", ["draining", "reconfiguring"])
def test_death_of_the_drain_victim_matches(runs, packages, phase):
    """The victim of the elastic run's first drain dies in the middle of
    its DRAINING or its RECONFIGURING state: both packages drop the
    drain (no role change), end the engine DEAD and agree on contexts,
    ``stats()`` and the final lifecycles; every round still finishes with
    the fault-free tokens."""
    ts, tctx, ttr = runs["on"]["port"]
    _, _, t0, t1, args = next(ttr.iter_spans("reconfig"))
    rec = ts.drains.log[0]
    assert (rec.t_begin, rec.t_flip) == (t0, t1)
    victim = tuple(args["engine"])
    t = 0.5 * (t0 + rec.t_drained) if phase == "draining" \
        else 0.5 * (rec.t_drained + t1)
    out = {name: serve(pkg, True, death=(t, victim))
           for name, pkg in packages.items()}
    (js, jctx), (ds, dctx) = out["jax"], out["port"]
    assert dctx == jctx == tctx
    assert_stats_match(ds.stats(), js.stats())
    assert lifecycles(ds) == lifecycles(js)
    st = ds.stats()
    assert st["engine_deaths"] == 1
    assert st["role_changes"] == ts.stats()["role_changes"] - 1
    assert ds.engine_lifecycle[victim] == EngineLifecycle.DEAD
    assert victim not in ds.drains.active and not ds._reconfig_ready
    assert all(lc in (EngineLifecycle.ACTIVE, EngineLifecycle.DEAD)
               for lc in ds.engine_lifecycle.values())
