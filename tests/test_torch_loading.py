"""The port's pure-Python leaves against the JAX package's: loading plans,
the bottleneck-free analysis, the simulator specs, block packing, the
trie's LRU eviction, the accounting store, the attention time fit and the
submission cost model.

Every input is drawn from a seeded numpy generator, and every case calls
the reference's function and the port's on the same input: plans must
carry the same legs (name, bytes, resources, layerwise flag, phase and
traffic class) and ``resource_bytes`` the same bytes per resource
(compared with ``.get(k, 0)``: pure plans keep zero-byte keys that split
plans drop); closed forms and fits must be equal as floats; blocks must be
equal byte for byte.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import analysis as jax_analysis
from repro.core import blocks as jax_blocks
from repro.core import intra as jax_intra
from repro.core import loading as jax_loading
from repro.core.traffic import SubmitCostModel as JaxSubmitCostModel
from repro.kvcache.store import AccountingKVStore as JaxAccountingKVStore
from repro.kvcache.trie import BlockTrie as JaxBlockTrie
from repro.sim import spec as jax_spec
from repro_torch.configs import get_config
from repro_torch.core import analysis, blocks, intra, loading
from repro_torch.core.traffic import SubmitCostModel
from repro_torch.kvcache.store import AccountingKVStore
from repro_torch.kvcache.trie import BlockTrie
from repro_torch.sim import spec


def legs(plan):
    return [(leg.name, leg.nbytes, leg.resources, leg.layerwise, leg.phase,
             int(leg.tclass)) for leg in plan]


def same_resource_bytes(a, b):
    for k in set(a) | set(b):
        assert a.get(k, 0) == b.get(k, 0), (k, a.get(k, 0), b.get(k, 0))


def hmg(seed, n=8):
    """``n`` seeded (hit, miss, gen) byte triples, zero hits included."""
    rng = np.random.default_rng(seed)
    out = [(0, int(rng.integers(1, 10**6)), int(rng.integers(0, 10**5)))]
    out += [tuple(int(x) for x in (rng.integers(0, 10**9),
                                   rng.integers(0, 10**7),
                                   rng.integers(0, 10**7)))
            for _ in range(n - 1)]
    return out


# ---------------------------------------------------------------------------
# loading plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pe", "de", "basic", "oracle"])
def test_pure_plans_match(name):
    for hit, miss, gen in hmg(1):
        want = jax_loading.PLANS[name](hit, miss, gen)
        got = loading.PLANS[name](hit, miss, gen)
        assert legs(got) == legs(want)
        same_resource_bytes(loading.resource_bytes(got),
                            jax_loading.resource_bytes(want))


@pytest.mark.parametrize("seed", [2, 3])
def test_split_and_tiered_plans_match(seed):
    rng = np.random.default_rng(seed)
    for hit, miss, gen in hmg(seed):
        pe = int(hit * rng.random())
        assert legs(loading.split_read_plan(hit, miss, gen, pe)) == \
            legs(jax_loading.split_read_plan(hit, miss, gen, pe))
        # a four-way hit partition that sums to hit
        cuts = np.sort(rng.integers(0, hit + 1, 3))
        part = tuple(int(x) for x in np.diff(np.concatenate(
            [[0], cuts, [hit]])))
        got = loading.tiered_read_plan(hit, miss, gen, *part)
        want = jax_loading.tiered_read_plan(hit, miss, gen, *part)
        assert legs(got) == legs(want)
        same_resource_bytes(loading.resource_bytes(got),
                            jax_loading.resource_bytes(want))


@pytest.mark.parametrize("read_path,read_split,tier", [
    ("pe", 1.0, None), ("de", 1.0, None), ("pe", 0.6, None),
    ("de", 0.7, None), ("basic", 1.0, None), ("oracle", 1.0, None),
    ("pe", 0.5, (0.25, 0.25, 0.5, 0.0)), ("de", 1.0, (0.0, 0.1, 0.0, 0.9)),
])
def test_plan_for_dispatches_like_the_reference(read_path, read_split, tier):
    for hit, miss, gen in hmg(4):
        part = None
        if tier is not None:
            part = [int(hit * f) for f in tier]
            part[1] += hit - sum(part)        # exact sum
            part = tuple(part)
        got = loading.plan_for(read_path, read_split, hit, miss, gen,
                               tier=part)
        want = jax_loading.plan_for(read_path, read_split, hit, miss, gen,
                                    tier=part)
        assert legs(got) == legs(want)
    with pytest.raises(ValueError):
        loading.plan_for(None, 1.0, 1, 1, 1)


def test_rebalance_remainder_and_hedge_water_fill_match():
    rng = np.random.default_rng(5)
    for _ in range(200):
        pe, de = (int(x) for x in rng.integers(0, 1 << 20, 2))
        side = ("pe", "de")[int(rng.integers(2))]
        rem = int((pe if side == "pe" else de) * rng.random())
        move = int(rng.integers(-(1 << 10), 1 << 21))
        assert loading.rebalance_remainder(pe, de, side, rem, move) == \
            jax_loading.rebalance_remainder(pe, de, side, rem, move)
        sev = float(rng.uniform(1.0, 128.0))
        backlog = int(rng.integers(0, 1 << 20))
        assert loading.hedge_water_fill(rem, sev, backlog) == \
            jax_loading.hedge_water_fill(rem, sev, backlog)
    with pytest.raises(AssertionError):
        loading.rebalance_remainder(10, 50, "pe", 11, 5)
    with pytest.raises(AssertionError):
        loading.hedge_water_fill(10, 0.5)


def test_hedge_water_fill_batch_matches():
    rng = np.random.default_rng(6)
    rem = rng.integers(0, 1 << 20, 256)
    sev = rng.uniform(1.0, 64.0, 256)
    backlog = rng.integers(0, 1 << 20, 256)
    got = loading.hedge_water_fill_batch(rem, sev, backlog)
    np.testing.assert_array_equal(
        got, jax_loading.hedge_water_fill_batch(rem, sev, backlog))
    np.testing.assert_array_equal(got, [
        loading.hedge_water_fill(int(r), float(s), int(b))
        for r, s, b in zip(rem, sev, backlog)])


@pytest.mark.parametrize("mode", ["dualpath", "basic", "oracle"])
def test_resource_bytes_batch_matches(mode):
    rng = np.random.default_rng(7)
    n = 64
    hit = rng.integers(0, 10**9, n)
    miss = rng.integers(0, 10**7, n)
    gen = rng.integers(0, 10**7, n)
    w = rng.dirichlet(np.ones(4), n)
    part = np.floor(w * hit[:, None]).astype(np.int64)
    part[:, 1] += hit - part.sum(axis=1)
    kw = dict(zip(("pe_snic", "de_snic", "pe_tier", "de_tier"), part.T))
    got = loading.resource_bytes_batch(mode, hit, miss, gen, **kw)
    want = jax_loading.resource_bytes_batch(mode, hit, miss, gen, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if mode == "dualpath":
        # element by element, the per-request plan's bytes
        for i in range(0, n, 16):
            rb = loading.resource_bytes(loading.plan_for(
                "pe", 1.0, int(hit[i]), int(miss[i]), int(gen[i]),
                tier=tuple(int(x) for x in part[i])))
            for k in got:
                assert got[k][i] == rb.get(k, 0), k
        with pytest.raises(ValueError):
            loading.resource_bytes_batch(mode, hit + 1, miss, gen, **kw)


# ---------------------------------------------------------------------------
# the bottleneck-free analysis (Eq. 1-9) and the specs
# ---------------------------------------------------------------------------

SPECS = [dict(), dict(g=8, B=50e9, s=1.0, M=500e9),
         dict(g=4, B=45e9, s=25 / 45, M=200e9), dict(g=16, B=25e9, s=0.5,
                                                     M=800e9)]


@pytest.mark.parametrize("kw", SPECS, ids=["default", "paper", "v5e-like",
                                           "wide"])
def test_analysis_equations_match(kw):
    cs, jcs = analysis.ClusterSpec(**kw), jax_analysis.ClusterSpec(**kw)
    assert cs.snic_bw == jcs.snic_bw
    assert analysis.bottleneck_free_range(cs) == \
        jax_analysis.bottleneck_free_range(jcs)
    rng = np.random.default_rng(8)
    for P, D in [(1, 1), (2, 4), (8, 1), (1, 8)] + [
            tuple(int(x) for x in rng.integers(1, 64, 2)) for _ in range(8)]:
        assert analysis.pair_traffic(P, D, cs) == \
            jax_analysis.pair_traffic(P, D, jcs)
        assert analysis.link_utilisation(P, D, cs) == \
            jax_analysis.link_utilisation(P, D, jcs)
        for phi in (None, 0.0, 1.0, float(rng.random())):
            assert analysis.link_utilisation_mix(P, D, cs, phi) == \
                jax_analysis.link_utilisation_mix(P, D, jcs, phi)
        assert analysis.is_bottleneck_free(P, D, cs) == \
            jax_analysis.is_bottleneck_free(P, D, jcs)
        for dp in (True, False):
            assert analysis.max_aggregate_load_bw(P, D, cs, dp) == \
                jax_analysis.max_aggregate_load_bw(P, D, jcs, dp)
    for n in (2, 6, 17, 64):
        assert analysis.safe_pd_splits(n, cs) == \
            jax_analysis.safe_pd_splits(n, jcs)
    with pytest.raises(ValueError):
        analysis.link_utilisation_mix(1, 1, cs, 1.5)


@pytest.mark.parametrize("node", ["HOPPER_NODE", "REDUCED_TEST_NODE"])
def test_cluster_spec_matches(node):
    got = getattr(spec, node).cluster_spec()
    want = getattr(jax_spec, node).cluster_spec()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(getattr(spec, node)) == \
        dataclasses.asdict(getattr(jax_spec, node))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_prefill_flops_and_cache_compute_ratio_match(reduced):
    cfg, jcfg = get_config("qwen1.5-0.5b"), jax_get_config("qwen1.5-0.5b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    ms = spec.ModelSimSpec.from_config(cfg)
    jms = jax_spec.ModelSimSpec.from_config(jcfg)
    rng = np.random.default_rng(9)
    for cached, bsz in [(0, 1), (0, 1024), (1024, 128)] + [
            tuple(int(x) for x in rng.integers(0, 4096, 2)) for _ in range(8)]:
        assert ms.prefill_flops(cached, bsz) == \
            jms.prefill_flops(cached, bsz)
        if bsz:
            assert ms.cache_compute_ratio(cached, bsz) == \
                jms.cache_compute_ratio(cached, bsz)


# ---------------------------------------------------------------------------
# blocks, trie, store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens", [0, 7, 64, 200])
def test_block_pack_unpack_byte_exact(tokens):
    lay = blocks.BlockLayout(n_layers=3, block_tokens=16,
                             bytes_per_token_layer=24)
    jlay = jax_blocks.BlockLayout(3, 16, 24)
    kv = np.random.default_rng(tokens).integers(
        0, 256, (3, tokens, 24), dtype=np.uint8)
    got = blocks.pack_kv_to_blocks(kv, lay)
    want = jax_blocks.pack_kv_to_blocks(kv, jlay)
    assert len(got) == len(want) == lay.n_blocks(tokens)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes() and g.shape == w.shape
    back = blocks.unpack_blocks_to_kv(got, lay)
    assert back.tobytes() == jax_blocks.unpack_blocks_to_kv(
        want, jlay).tobytes()
    assert back.shape == (3, lay.n_blocks(tokens) * 16, 24)
    for full in got:
        layers = blocks.layer_blocks_from_full(full)
        jlayers = jax_blocks.layer_blocks_from_full(full)
        assert [x.tobytes() for x in layers] == \
            [x.tobytes() for x in jlayers]
        assert blocks.full_from_layer_blocks(layers).tobytes() == \
            jax_blocks.full_from_layer_blocks(jlayers).tobytes() == \
            full.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trie_missing_blocks_and_evict_lru_match(seed):
    """The same inserts, matches and evictions on both tries give the
    same hits, missing-block counts and evicted refs."""
    rng = np.random.default_rng(seed)
    bt = int(rng.integers(1, 5))
    tries = (BlockTrie(bt), JaxBlockTrie(bt))
    ref = 0
    seqs = [list(rng.integers(0, 3, int(rng.integers(0, 30))))
            for _ in range(12)]
    for i, s in enumerate(seqs):
        n = tries[1].missing_blocks(s)
        assert tries[0].missing_blocks(s) == n
        refs = list(range(ref, ref + n))
        ref += n
        assert tries[0].insert(s, refs) == tries[1].insert(s, refs)
        if i % 3 == 2:
            probe = seqs[int(rng.integers(0, i + 1))]
            assert tries[0].match(probe) == tries[1].match(probe)
            k = int(rng.integers(1, 4))
            assert tries[0].evict_lru(k) == tries[1].evict_lru(k)
            assert tries[0].n_blocks == tries[1].n_blocks
    for s in seqs:
        assert tries[0].match(s) == tries[1].match(s)
    assert tries[0].evict_lru(10**6) == tries[1].evict_lru(10**6)
    assert tries[0].n_blocks == tries[1].n_blocks == 0


def test_accounting_store_counters_match():
    lay = blocks.BlockLayout(2, 16, 8)
    stores = (AccountingKVStore(lay),
              JaxAccountingKVStore(jax_blocks.BlockLayout(2, 16, 8)))
    rng = np.random.default_rng(10)
    for s in stores:
        refs = [s.alloc_ref() for _ in range(5)]
        for r in refs:
            s.write_block(r, None)
        assert s.read_blocks(refs[:3]) == [None] * 3
        for r in rng.integers(1, 6, 4):
            assert s.read_block(int(r)) is None
        assert s.peek(refs[0]) is None       # no accounting
    counters = [(s.reads, s.writes, s.bytes_read, s.bytes_written)
                for s in stores]
    assert counters[0] == counters[1] == (7, 5, 7 * lay.full_block_bytes,
                                          5 * lay.full_block_bytes)


# ---------------------------------------------------------------------------
# the attention time fit and the submission cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["affine", "noisy", "degenerate",
                                  "negative-intercept"])
def test_attn_time_model_fit_matches(case):
    rng = np.random.default_rng(11)
    f = rng.uniform(1e9, 1e12, 16)
    if case == "affine":
        t = 3e-5 + f / 80e12
    elif case == "noisy":
        t = 2e-5 + f / 60e12 + rng.normal(0, 1e-6, 16)
    elif case == "degenerate":
        f = np.full(16, 5e10)
        t = rng.uniform(1e-4, 2e-4, 16)
    else:
        t = -1e-3 + f / 90e12
    samples = [(float(a), float(b)) for a, b in zip(f, t)]
    got = intra.AttnTimeModel.fit(samples)
    want = jax_intra.AttnTimeModel.fit(samples)
    assert (got.effective_flops, got.base_overhead_s) == \
        (want.effective_flops, want.base_overhead_s)
    for x in f[:4]:
        assert got.seconds(float(x)) == want.seconds(float(x))
    # from_config keeps the reference's modelled constants (opt-in fit)
    cfg = get_config("qwen1.5-0.5b")
    assert intra.AttnTimeModel.from_config(cfg) == intra.AttnTimeModel(
        effective_flops=197e12 * 0.35)


def test_submit_cost_model_matches():
    got, want = SubmitCostModel(), JaxSubmitCostModel()
    for n in (0, 1, 7, 32, 1000):
        assert got.cuda_seconds(n) == want.cuda_seconds(n)
        assert got.rdma_unbatched_seconds(n) == \
            want.rdma_unbatched_seconds(n)
        assert got.rdma_batch_seconds(n) == want.rdma_batch_seconds(n)
