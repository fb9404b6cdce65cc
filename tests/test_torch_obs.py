"""The port's flight recorder (``repro_torch.obs``) against the JAX
package's.

* Unit behaviour of the tracer, the metric instruments, the schema, the
  fault annotation and the TTFT attribution (the port of
  tests/test_obs.py's unit tests), on the port's objects; the schema's
  registry equals the reference's entry for entry, and the same records
  export the same bytes from both tracers.
* One traced online run of each package's ServingSystem on the
  reference's observability fixture (reduced qwen, 1 PE + 2 DEs, split
  reads, ``REDUCED_TEST_NODE``, bridged bf16 weights): the two traces
  hold the same records, (track, name, args) in order and times within
  1e-9 relative; two traced port runs export byte-identical traces; an
  untraced port run gives identical tokens and ``stats()``; the trace
  audit and the attribution pass on the port's run, and a dropped
  ``storage_read`` event fails the audit.
* The port's ``stats()`` passes its ``conforming(..., "serving")``, has
  the reference's keys, and emits every registered serving key.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.obs import Tracer as JaxTracer
from repro.obs import schema as jax_schema
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.spec import REDUCED_TEST_NODE as JAX_REDUCED_TEST_NODE
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                             TraceAuditError, Tracer, attribute_ttft,
                             audit_serving, bottleneck_report, conforming,
                             orphans, registered_keys, schema)
from repro_torch.serving import ServingSystem
from repro_torch.sim.faults import EngineDeath, FaultSchedule, SlowdownWindow
from repro_torch.sim.spec import REDUCED_TEST_NODE
from repro_torch.sim.traces import Round, Trajectory

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# tracer, metrics, schema, annotation, attribution: unit behaviour
# ---------------------------------------------------------------------------


def test_tracer_requires_bound_clock_for_default_timestamps():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        tr.event("x", "no-clock")
    tr.event("x", "explicit", t=1.5)
    tr.bind_clock(lambda: 2.0)
    tr.event("x", "bound")
    assert [(t, n) for _, n, t, _ in tr.iter_events()] == \
        [(1.5, "explicit"), (2.0, "bound")]


def test_span_event_counter_separation():
    tr = Tracer(now_fn=lambda: 0.0)
    tr.span("a/t", "s", 1.0, 2.0, k=1)
    tr.event("a/t", "e", t=1.5)
    tr.counter("a/q", t=1.0, depth=3)
    assert [n for _, n, *_ in tr.iter_spans()] == ["s"]
    assert [n for _, n, *_ in tr.iter_events()] == ["e"]
    trace = tr.to_chrome_trace()["traceEvents"]
    assert [r["ph"] for r in trace if r["ph"] != "M"] == ["X", "C", "i"]
    meta = {r["name"]: r for r in trace if r["ph"] == "M"}
    assert meta["process_name"]["args"]["name"] == "a"


def test_export_bytes_deterministic_and_equal_to_the_reference():
    def build(cls):
        tr = cls(now_fn=lambda: 0.0)
        tr.span("snic/node0", "nic_xfer", 0.0, 1.0, tag="read", nbytes=10)
        tr.event("req/1", "first_token", t=1.0)
        tr.counter("snic/node0/queue", t=1.0, queued_bytes=5)
        tr.span("req/1", "prefill", 0.25, 0.75)
        return tr.export_bytes()
    assert build(Tracer) == build(Tracer) == build(JaxTracer)
    assert build(Tracer).endswith(b"\n")


def test_metrics_primitives():
    c = Counter("gen_tokens")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        Counter("Bad-Name")
    g = Gauge("net_congestion")
    assert math.isnan(g.value)
    g.set(0.25)
    assert g.value == 0.25
    h = Histogram("ttft_s")
    assert math.isnan(h.percentile(50))
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    assert h.percentile(50) == 2.0
    assert h.percentile(100) == 4.0
    with pytest.raises(ValueError):
        h.percentile(101)
    s = h.summary()
    assert s["count"] == 4 and s["mean"] == 2.5


def test_registry_get_or_create_and_kind_conflicts():
    r = MetricsRegistry()
    c = r.counter("doorbells")
    assert r.counter("doorbells") is c
    with pytest.raises(TypeError):
        r.gauge("doorbells")
    r.gauge("wall_s").set(1.0)
    r.histogram("ttft_s").observe(0.5)
    c.inc(3)
    snap = r.snapshot()
    assert snap["doorbells"] == 3 and snap["wall_s"] == 1.0
    assert snap["ttft_s"]["p50"] == 0.5
    assert list(snap) == sorted(snap)
    assert r.get("nope") is None


def test_schema_registry_equals_the_reference():
    def table(mod):
        return {n: (s.kind, s.unit, s.runtimes)
                for n, s in mod.REGISTRY.items()}
    assert table(schema) == table(jax_schema)
    for rt in ("sim", "serving"):
        assert registered_keys(rt) == jax_schema.registered_keys(rt)
    with pytest.raises(KeyError, match="not_a_registered_metric"):
        conforming({"not_a_registered_metric": 1}, "serving")
    with pytest.raises(ValueError):
        schema.register("BadName", "counter", "count", ("serving",))
    with pytest.raises(ValueError):
        schema.register("gen_tokens", "gauge", "tokens", ("serving",))


def test_fault_schedule_annotation_boundaries():
    fs = FaultSchedule(
        windows=[SlowdownWindow("snic", 2.0, 5.0, 8.0, node=1),
                 SlowdownWindow("net", 1.0, 3.0, 2.0)],
        deaths=[EngineDeath(4.5, (1, 0))])
    tr = Tracer()
    tr.annotate_faults(fs)
    tr.annotate_faults(None)
    spans = {(trk, t0, t1): args for trk, _, t0, t1, args
             in tr.iter_spans(None, "fault_window")}
    assert spans[("faults/snic", 2.0, 5.0)] == {"factor": 8.0, "node": 1}
    assert spans[("faults/net", 1.0, 3.0)] == {"factor": 2.0,
                                               "node": "all"}
    deaths = [(t, args) for _, _, t, args
              in tr.iter_events("engine_death_scheduled")]
    assert deaths == [(4.5, {"engine": [1, 0]})]


def _synthetic_tracer():
    """Window [0, 10]: read_leg [1, 4], prefill [3, 7], pd_transfer [7, 8],
    a drain [8.5, 9], first token at 10 -> storage 3, compute 3, net 1,
    drain 0.5, queue 2.5."""
    tr = Tracer(now_fn=lambda: 0.0)
    tr.span("req/5", "scheduled", 0.0, 1.0)
    tr.span("req/5", "read_leg", 1.0, 4.0, side="pe", nbytes=10)
    tr.span("req/5", "prefill", 3.0, 7.0)
    tr.span("req/5", "pd_transfer", 7.0, 8.0)
    tr.span("reconfig", "drain", 8.5, 9.0, engine=[0, 0])
    tr.event("req/5", "first_token", t=10.0)
    return tr


def test_attribution_hand_computed_partition():
    per = attribute_ttft(_synthetic_tracer())
    rec = per[5]
    want = dict(ttft_s=10.0, storage_s=3.0, compute_s=3.0, net_s=1.0,
                drain_s=0.5, queue_s=2.5)
    for k, v in want.items():
        assert rec[k] == pytest.approx(v), k
    assert attribute_ttft(_synthetic_tracer(), rid=6) == {}
    rep = bottleneck_report(per)
    assert rep["n"] == 1 and rep["bottleneck"] in ("storage", "compute")
    assert rep["max_decomp_err_s"] < 1e-12
    empty = bottleneck_report({})
    assert empty["n"] == 0 and empty["bottleneck"] == "none"
    assert math.isnan(empty["ttft_mean_s"])


# ---------------------------------------------------------------------------
# a traced online run of each ServingSystem
# ---------------------------------------------------------------------------

KW = dict(n_pe=1, n_de=2, block_tokens=16, max_seq=160, de_slots=2,
          split_reads=True)
ROUNDS = [(24, 6, 0.5), (16, 4, 0.0)]
ARRIVALS = [0.0, 0.1, 0.2, 0.3]


def port_run(cfg, params, tracer):
    s = ServingSystem(cfg, params, node=REDUCED_TEST_NODE, tracer=tracer,
                      device="cpu", **KW)
    sessions = s.run_online(
        [Trajectory(i, [Round(*r) for r in ROUNDS]) for i in range(4)],
        ARRIVALS)
    assert all(x.done() for x in sessions)
    return s, [x.context for x in sessions]


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
def runs(jax_compile_cache):
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen1.5-0.5b").reduced()
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    jtr = JaxTracer()
    jsys = JaxServingSystem(jcfg, jp, seed=0, node=JAX_REDUCED_TEST_NODE,
                            tracer=jtr, **KW)
    jses = jsys.run_online(
        [JaxTrajectory(i, [JaxRound(*r) for r in ROUNDS]) for i in range(4)],
        ARRIVALS)
    out = {"jax": (jsys, jtr, [[int(t) for t in x.context] for x in jses])}
    for name in ("port", "port2"):
        tr = Tracer()
        s, ctx = port_run(cfg, tp, tr)
        out[name] = (s, tr, ctx)
    s, ctx = port_run(cfg, tp, None)
    out["untraced"] = (s, None, ctx)
    return out


def records(tracer):
    """Every span, event and counter as (kind, track, name, args, times),
    in recording order."""
    out = [("span" if t1 >= 0 else "event", track, name, args,
            (t0,) if t1 < 0 else (t0, t1))
           for _, track, name, t0, t1, args in tracer.spans]
    out += [("counter", track, "", values, (t,))
            for _, track, t, values in tracer.counters]
    seqs = [r[0] for r in tracer.spans] + [r[0] for r in tracer.counters]
    return [rec for _, rec in sorted(zip(seqs, out), key=lambda p: p[0])]


def test_port_trace_holds_the_reference_records(runs):
    jsys, jtr, jctx = runs["jax"]
    tsys, ttr, tctx = runs["port"]
    assert tctx == jctx
    got, want = records(ttr), records(jtr)
    assert len(got) == len(want) > 100
    assert [r[:4] for r in got] == [r[:4] for r in want]
    for g, w in zip(got, want):
        assert g[4] == pytest.approx(w[4], rel=1e-9, abs=0), (g, w)
    kinds = {r[2] for r in got}
    assert {"storage_read", "persist", "read_path", "first_token", "flush",
            "poll", "scheduled", "decode"} <= kinds


def test_port_traces_export_byte_identical(runs):
    b = runs["port"][1].export_bytes()
    assert b == runs["port2"][1].export_bytes()
    assert b.endswith(b"\n") and len(b) > 1000


def test_untraced_port_run_is_identical(runs):
    tsys, _, tctx = runs["port"]
    usys, _, uctx = runs["untraced"]
    assert uctx == tctx
    st, ust = tsys.stats(), usys.stats()
    assert st.keys() == ust.keys()
    for k in st:
        if isinstance(st[k], float) and math.isnan(st[k]):
            assert math.isnan(ust[k]), k
        else:
            assert st[k] == ust[k], k


def test_port_stats_match_the_reference(runs):
    jst, tst = runs["jax"][0].stats(), runs["port"][0].stats()
    assert tst.keys() == jst.keys()
    for k in tst:
        if isinstance(jst[k], float):
            assert tst[k] == pytest.approx(jst[k], rel=1e-9, abs=0,
                                           nan_ok=True), k
        elif k != "latency_by_class":
            assert tst[k] == jst[k], k


def test_port_audit_and_attribution(runs):
    tsys, tr, _ = runs["port"]
    st = tsys.stats()
    out = audit_serving(tsys, tr, check_persists=True)
    assert out["persist_bytes"] == st["store_writes"] > 0
    assert sum(out["read_bytes_by_side"].values()) == \
        st["read_bytes_pe_side"] + st["read_bytes_de_side"] > 0
    rep = bottleneck_report(attribute_ttft(tr))
    assert rep["n"] == st["finished_rounds"] == 8
    assert rep["max_decomp_err_s"] < 1e-9
    assert rep["ttft_mean_s"] == pytest.approx(st["ttft_mean"], rel=1e-9)
    firsts = list(tr.iter_events("first_token"))
    assert len(firsts) == st["finished_rounds"]
    assert {"scheduled", "prefill", "decode"} <= \
        {n for _, n, *_ in tr.iter_spans("req/")}


def test_port_audit_detects_missing_read_event(runs):
    tsys, tr, _ = runs["port"]
    snap = list(tr.spans)
    try:
        i = next(i for i, r in enumerate(tr.spans) if r[2] == "storage_read")
        del tr.spans[i]
        with pytest.raises(TraceAuditError, match="storage_read"):
            audit_serving(tsys, tr, check_persists=False)
    finally:
        tr.spans[:] = snap
    audit_serving(tsys, tr, check_persists=True)


def test_port_stats_schema_two_way(runs):
    st = runs["port"][0].stats()
    assert conforming(st, "serving") is st
    assert orphans(st, "serving") == set()
    assert {"engine_deaths", "recovered_rounds", "hedged_reads",
            "hedge_moved_tokens", "n_pe_final", "n_de_final"} <= set(st)


def test_stats_runs_through_the_schema(runs, monkeypatch):
    """``stats()`` calls the port's own ``conforming`` on every call."""
    from repro_torch.serving import system
    seen = []
    monkeypatch.setattr(system, "conforming",
                        lambda d, rt: seen.append(rt) or d)
    runs["port"][0].stats()
    runs["untraced"][0].stats()
    assert seen == ["serving", "serving"]
