"""The online SLO layer in the port against the JAX reference: the
admission gate, chunked prefill and priority classes.

* Unit behaviour (the port of tests/test_slo.py's unit tests): the gate's
  TTFT estimate, its defer -> reject escalation and counter reset, the
  scheduler's class order, ``class_insert_index``, ``PrefillWork.key``
  and the load signals' pressures, each on the port's and the
  reference's objects with the same inputs and equal results.
* ``QuotaPacker(chunk_tokens=)`` packs the same batches as the
  reference's over the same fifo, for several caps and quotas.
* Chunked prefill on the port's ServingSystem (f32, reduced qwen): the
  context is the unchunked run's bit for bit, and the PREFILL_CHUNKED
  sub-state is entered.  An all-default SloConfig changes nothing.
* Online serving of both ServingSystems under an SloConfig that defers,
  rejects, chunks and orders by class, on bridged bf16 weights and the
  reference's ``REDUCED_TEST_NODE``: equal contexts, admission and chunk
  counters, byte counters and lifecycle transitions; ``latency_by_class``
  and ``wall_s`` within 1e-9 relative.  In the first setting an
  interactive round overtakes a part-prefilled batch round.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import admission as jax_admission
from repro.core import intra as jax_intra
from repro.core.autoscale import LoadSignals as JaxLoadSignals
from repro.core.config import SloConfig as JaxSloConfig
from repro.core.scheduler import Request as JaxRequest
from repro.core.scheduler import Scheduler as JaxScheduler
from repro.models import init_params as jax_init_params
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.spec import REDUCED_TEST_NODE
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import admission, intra
from repro_torch.core.autoscale import LoadSignals
from repro_torch.core.config import SloConfig
from repro_torch.core.scheduler import Request, Scheduler
from repro_torch.models import init_params
from repro_torch.serving import ServingSystem
from repro_torch.sim.spec import GPUSpec, NodeSpec
from repro_torch.sim.traces import Round, Trajectory

# tiny CPU tensors: extra intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

NODE = NodeSpec(**{k: v for k, v in dataclasses.asdict(
    REDUCED_TEST_NODE).items() if k != "gpu"},
    gpu=GPUSpec(**dataclasses.asdict(REDUCED_TEST_NODE.gpu)))
# both packages' objects, by role
PKGS = {"port": dict(gate=admission.AdmissionGate, slo=SloConfig,
                     sig=LoadSignals, req=Request, sched=Scheduler,
                     intra=intra),
        "jax": dict(gate=jax_admission.AdmissionGate, slo=JaxSloConfig,
                    sig=JaxLoadSignals, req=JaxRequest, sched=JaxScheduler,
                    intra=jax_intra)}


def both(fn):
    """``fn(objects)`` on the port's and the reference's objects; the two
    results must be equal.  Returns the port's."""
    got = {name: fn(objs) for name, objs in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


# ---------------------------------------------------------------------------
# the admission gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sig,read_s,prefill_s", [
    (dict(n_pe=2, n_de=1, pe_queued_s=3.0, pe_busy_s=1.0, de_queued_s=0.0,
          de_busy_s=0.0, pe_read_q_s=2.0), 0.5, 0.25),
    (dict(n_pe=0, n_de=1, pe_queued_s=0.7, pe_busy_s=0.0, de_queued_s=9.0,
          de_busy_s=4.0, de_read_q_s=5.0), 0.0, 0.125),
    (dict(n_pe=3, n_de=2, pe_queued_s=0.0, pe_busy_s=0.0, de_queued_s=1.0,
          de_busy_s=1.0, pe_queued_interactive_s=6.0), 1.5, 0.0),
], ids=["backlog-over-2-pes", "no-admitting-pe", "decode-and-interactive"])
def test_gate_estimate_is_backlog_over_servers_plus_own_service(
        sig, read_s, prefill_s):
    est = both(lambda o: o["gate"](o["slo"](admission=True)).ttft_estimate(
        o["sig"](**sig), read_s=read_s, prefill_s=prefill_s))
    backlog = sig["pe_queued_s"] + sig["pe_busy_s"] + \
        sig.get("pe_read_q_s", 0.0)
    assert est == pytest.approx(backlog / max(sig["n_pe"], 1) + read_s +
                                prefill_s)


# (max_defers, [(key, estimate)], expected decisions, expected counters)
ESCALATIONS = {
    "defer-to-reject-and-reset": (
        3, [((7, 0), 0.8)] + [((7, 0), 2.0)] * 5,
        ["admit", "defer", "defer", "defer", "reject", "defer"], (1, 4, 1)),
    "admit-clears-counter": (
        2, [("k", 5.0), ("k", 0.5), ("k", 5.0), ("k", 5.0), ("k", 5.0)],
        ["defer", "admit", "defer", "defer", "reject"], (1, 3, 1)),
    "keys-count-apart": (
        1, [("a", 2.0), ("b", 2.0), ("a", 2.0), ("b", 1.0), ("b", 2.0)],
        ["defer", "defer", "reject", "admit", "defer"], (1, 3, 1)),
    "no-defers-rejects-at-once": (
        0, [("a", 2.0), ("a", 1.0)], ["reject", "admit"], (1, 0, 1)),
}


@pytest.mark.parametrize("case", list(ESCALATIONS))
def test_gate_escalates_defer_to_reject(case):
    max_defers, calls, want, counters = ESCALATIONS[case]

    def run(o):
        gate = o["gate"](o["slo"](admission=True, admission_ttft_slo_s=1.0,
                                  admission_max_defers=max_defers))
        out = [gate.decide(k, est) for k, est in calls]
        return out, gate.counters()

    decisions, got = both(run)
    assert decisions == want
    assert (got["admitted_rounds"], got["deferred_rounds"],
            got["rejected_rounds"]) == counters


# ---------------------------------------------------------------------------
# class order: scheduler queues, the PE fifo, the load signals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("class_aware,want", [(False, [0, 1, 2, 3, 4]),
                                              (True, [3, 2, 4, 0, 1])])
def test_scheduler_queues_order_by_class_then_arrival(class_aware, want):
    reqs = [(0, "batch", 0.0), (1, "batch", 1.0), (2, "interactive", 2.0),
            (3, "interactive", 0.5), (4, "interactive", 2.0)]

    def run(o):
        s = o["sched"](alpha=1, beta=1, class_aware=class_aware)
        for rid, cls, t in reqs:
            s.submit(o["req"](rid=rid, cached_tokens=0, new_tokens=8,
                              gen_tokens=4, arrival=t, slo_class=cls))
        return ([r.rid for r in s.pe_queue],
                [r.rid for r in s.de_global_queue],
                [r.class_rank for r in s.pe_queue])

    pe, de, _ = both(run)
    assert pe == de == want


@pytest.mark.parametrize("keys,new,want", [
    ([(0, 1.0, 1), (1, 0.0, 2), (1, 2.0, 3)], (1, 2.0, 4), 3),
    ([(0, 1.0, 1), (1, 0.0, 2), (1, 2.0, 3)], (0, 5.0, 5), 1),
    ([(0, 1.0, 1), (1, 0.0, 2), (1, 2.0, 3)], (0, 0.5, 6), 0),
    ([], (1, 0.0, 0), 0),
    ([(0, 1.0, 1), (0, 1.0, 3)], (0, 1.0, 2), 1),
], ids=["end-of-band", "interactive-ahead-of-batch", "head",
        "empty", "rid-tie-break"])
def test_class_insert_index_is_stable_and_rank_ordered(keys, new, want):
    assert both(lambda o: o["intra"].class_insert_index(keys, new)) == want


@pytest.mark.parametrize("rid,rank,arrival", [(9, 1, 3.0), (2, 0, 0.25)])
def test_prefill_work_key(rid, rank, arrival):
    def run(o):
        w = o["intra"].PrefillWork(rid, 0, 8, rank=rank, arrival=arrival)
        w.advance(3)
        return w.key(), w.cached, w.remaining

    assert both(run) == ((rank, arrival, rid), 3, 5)


@pytest.mark.parametrize("interactive", [True, False])
def test_load_signals_count_interactive_backlog_twice(interactive):
    kw = dict(n_pe=2, n_de=2, pe_queued_s=4.0, pe_busy_s=1.0,
              de_queued_s=2.0, de_busy_s=1.0)
    if interactive:
        kw.update(pe_queued_interactive_s=3.0, de_queued_interactive_s=1.0)
    pe, de = both(lambda o: (o["sig"](**kw).pe_pressure,
                             o["sig"](**kw).de_pressure))
    assert pe == pytest.approx((5.0 + (3.0 if interactive else 0.0)) / 2)
    assert de == pytest.approx((3.0 + (1.0 if interactive else 0.0)) / 2)


# ---------------------------------------------------------------------------
# the quota packer's chunk cap
# ---------------------------------------------------------------------------


FIFO = [(0, 0, 200), (1, 64, 40), (2, 0, 500), (3, 100, 7), (4, 16, 33)]


@pytest.mark.parametrize("quota_tokens", [150, 1000])
@pytest.mark.parametrize("cap", [None, 8, 16, 50, 128])
def test_quota_packer_chunks_like_the_reference(cap, quota_tokens):
    """Pack the same fifo until it empties; every batch (rid, cached,
    bsz, chunked) is the reference's.  The quota fits about
    ``quota_tokens`` fresh tokens, so 150 makes the binary search cut
    straddling requests and 1000 leaves only the cap to cut them."""
    cfgs = {"port": get_config("qwen1.5-0.5b").reduced(),
            "jax": jax_get_config("qwen1.5-0.5b").reduced()}
    tm = intra.AttnTimeModel.from_config(cfgs["port"])
    quota = tm.seconds(intra.attn_flops(cfgs["port"], [(0, quota_tokens)]))

    def run(o):
        cfg = cfgs["port" if o is PKGS["port"] else "jax"]
        m = o["intra"]
        packer = m.QuotaPacker(cfg, m.AttnTimeModel.from_config(cfg),
                               quota_s=quota, chunk_tokens=cap)
        fifo = [m.PrefillWork(*w) for w in FIFO]
        batches = []
        while fifo:
            b = packer.pack(fifo)
            assert b, "the packer stalled"
            batches.append([(i.rid, i.cached, i.bsz, i.chunked) for i in b])
        return batches

    batches = both(run)
    # every token computed once, in order, each slice within the cap
    for rid, cached, n in FIFO:
        items = [i for b in batches for i in b if i[0] == rid]
        assert sum(i[2] for i in items) == n
        assert [i[1] for i in items] == list(np.cumsum(
            [cached] + [i[2] for i in items])[:-1])
        if cap is not None:
            assert all(i[2] <= max(cap, 16) for i in items)
    if cap is not None and quota_tokens > 500:
        assert any(i[3] for b in batches for i in b)


# ---------------------------------------------------------------------------
# the serving runtime
# ---------------------------------------------------------------------------


def record_states(system):
    """Log every lifecycle transition as (rid, state name)."""
    log, orig = [], system._set_state

    def rec(er, state):
        log.append((er.req.rid, state.name))
        orig(er, state)

    system._set_state = rec
    return log


@pytest.fixture(scope="module")
def cfg32_params():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              param_dtype="float32",
                              kv_cache_dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("chunk", [16, 24])
def test_chunked_prefill_is_bit_identical_and_enters_substate(cfg32_params,
                                                             chunk):
    """The port of test_serving_chunked_prefill_is_bit_identical_and_
    enters_substate, f32, with a second round that hits the cache."""
    cfg, params = cfg32_params
    rounds = [(40, 4), (33, 4)]

    def run(slo):
        s = ServingSystem(cfg, params, n_pe=1, n_de=1, block_tokens=16,
                          max_seq=96, de_slots=2, node=NODE, device="cpu",
                          **({} if slo is None else dict(slo=slo)))
        states = record_states(s)
        out = s.run_offline([Trajectory(0, [Round(*r) for r in rounds])])
        return out[0].context, s.stats(), states

    plain_ctx, plain_st, plain_states = run(None)
    ctx, st, states = run(SloConfig(prefill_chunk_tokens=chunk))
    assert ctx == plain_ctx
    assert plain_st["prefill_chunks"] == 0
    assert st["prefill_chunks"] > 0
    assert ("PREFILL_CHUNKED" in {s for _, s in states}) and \
        ("PREFILL_CHUNKED" not in {s for _, s in plain_states})
    assert st["store_reads"] > 0 and st["prefill_tokens"] == \
        plain_st["prefill_tokens"]


def test_default_slo_config_changes_nothing(cfg32_params):
    cfg, params = cfg32_params
    trajs = lambda: [Trajectory(i, [Round(24, 3), Round(16, 3, 0.2)],
                                slo_class=c)
                     for i, c in enumerate(["batch", "interactive"])]

    def run(**kw):
        s = ServingSystem(cfg, params, n_pe=1, n_de=1, block_tokens=16,
                          max_seq=96, de_slots=2, node=NODE, device="cpu",
                          **kw)
        states = record_states(s)
        ses = s.run_online(trajs(), [0.0, 0.001])
        return [x.context for x in ses], s.stats(), states

    assert run() == run(slo=SloConfig())


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen1.5-0.5b").reduced()
    return jcfg, jp, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                                 cfg, device="cpu")


# Two batch agents arrive at t = 0 and two interactive ones just after, on
# REDUCED_TEST_NODE, whose modelled seconds make a round-1 estimate
# 0.0026 s into an empty system and 0.0026 s more per queued round-1
# request, and a round-2 estimate ~0.1 s (its storage read alone).
SHAPE = [(48, 3, 0.0), (16, 3, 0.2)]
CLASSES = ["batch", "batch", "interactive", "interactive"]
ARRIVALS = [0.0, 0.0, 0.001, 0.002]
SLO_CASES = {
    # round 1: the third arrival waits behind two -> deferred; round 2's
    # own read is over the SLO -> deferred 3 times, then rejected
    "defers-and-rejects": dict(admission=True, admission_ttft_slo_s=0.0055,
                               admission_defer_s=0.01,
                               admission_max_defers=3,
                               prefill_chunk_tokens=16, class_aware=True),
    # every round admitted: round 2 reads its hit from storage, chunked
    # and class-ordered
    "admits-the-cache-hits": dict(admission=True, admission_ttft_slo_s=0.15,
                                  admission_defer_s=0.02,
                                  prefill_chunk_tokens=16, class_aware=True),
}
COUNTERS = ("admitted_rounds", "deferred_rounds", "rejected_rounds",
            "prefill_chunks", "store_reads", "store_writes",
            "read_bytes_pe_side", "read_bytes_de_side", "split_reads",
            "trie_blocks", "prefill_tokens", "decode_steps", "gen_tokens",
            "finished_rounds")


@pytest.fixture(scope="module")
def online_runs(weights):
    """Each SLO case served once by each package: {case: (jax system,
    jax contexts, jax states, port system, port contexts, port states)}."""
    jcfg, jp, cfg, tp = weights
    kw = dict(n_pe=1, n_de=1, mode="dualpath", block_tokens=16, max_seq=96,
              de_slots=4)
    out = {}
    for case, slo in SLO_CASES.items():
        jsys = JaxServingSystem(jcfg, jp, node=REDUCED_TEST_NODE,
                                slo=JaxSloConfig(**slo), **kw)
        jstates = record_states(jsys)
        jses = jsys.run_online(
            [JaxTrajectory(i, [JaxRound(*r) for r in SHAPE], slo_class=c)
             for i, c in enumerate(CLASSES)], ARRIVALS)
        tsys = ServingSystem(cfg, tp, node=NODE, slo=SloConfig(**slo),
                             device="cpu", **kw)
        tstates = record_states(tsys)
        tses = tsys.run_online(
            [Trajectory(i, [Round(*r) for r in SHAPE], slo_class=c)
             for i, c in enumerate(CLASSES)], ARRIVALS)
        assert all(s.done() for s in tses)
        out[case] = (jsys, [[int(t) for t in s.context] for s in jses],
                     jstates, tsys, [s.context for s in tses], tstates)
    return out


@pytest.mark.parametrize("case", list(SLO_CASES))
def test_slo_online_matches_jax(online_runs, case):
    jsys, jctx, jstates, tsys, tctx, tstates = online_runs[case]
    assert tctx == jctx
    jst, tst = jsys.stats(), tsys.stats()
    for k in COUNTERS:
        assert tst[k] == jst[k], (k, jst[k], tst[k])
    assert tstates == jstates
    assert tst["wall_s"] == pytest.approx(jst["wall_s"], rel=1e-9, abs=0)
    assert set(tst["latency_by_class"]) == set(jst["latency_by_class"]) \
        == {"interactive", "batch"}
    for cls, summary in jst["latency_by_class"].items():
        for k, v in summary.items():
            assert tst["latency_by_class"][cls][k] == pytest.approx(
                v, rel=1e-9, abs=0, nan_ok=True), (cls, k)
    # every admitted round finished, and chunking ran
    assert tst["finished_rounds"] == tst["admitted_rounds"] > 0
    assert tst["prefill_chunks"] > 0
    if case == "defers-and-rejects":
        assert tst["deferred_rounds"] > 0 and tst["rejected_rounds"] > 0
    else:
        assert tst["rejected_rounds"] == 0 and tst["store_reads"] > 0


def test_interactive_overtakes_part_prefilled_batch(online_runs):
    """Batch round 1 (rid 1) has run a capped slice when interactive
    round 2 enters the PE fifo ahead of it: the interactive round reaches
    its first token first, and the preempted batch round resumes at its
    own offset (the contexts equal the reference's, test above)."""
    _, _, _, tsys, _, states = online_runs["defers-and-rejects"]
    m = tsys.metrics
    batch, inter = m[1], m[2]
    assert (batch.slo_class, inter.slo_class) == ("batch", "interactive")
    assert inter.submit_t > batch.submit_t
    assert inter.prefill_done_t < batch.prefill_done_t
    i = states.index
    assert i((1, "PREFILL_CHUNKED")) < i((2, "PREFILL")) < \
        i((2, "PD_TRANSFER")) < i((1, "PD_TRANSFER"))
