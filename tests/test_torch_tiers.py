"""The port's DRAM tier, prefetcher and tier-aware read path against the
JAX reference's.

Each case runs one sequence of operations through the reference's object
and through the port's, and records every result and counter on the way;
the two records must be equal.  The cases are those of tests/test_tiers.py
that the serving slice runs: pinning under eviction pressure, LRU and
agentic-TTL victim order, read-through accounting over a backing store,
the resident prefix, the prefetch plan's stage order and the tier-aware
``choose_read_path``.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.blocks as jax_blocks
import repro.core.scheduler as jax_sched
import repro.kvcache.store as jax_store
import repro.kvcache.tiers as jax_tiers
import repro_torch.core.blocks as port_blocks
import repro_torch.core.scheduler as port_sched
import repro_torch.kvcache.store as port_store
import repro_torch.kvcache.tiers as port_tiers

BLOCK = 100          # bytes per block in the accounting-only cases
PACKAGES = ((jax_tiers, jax_store, jax_blocks),
            (port_tiers, port_store, port_blocks))


def both(case, **kw):
    """Run ``case(tiers, store, blocks, **kw)`` on each package and
    require equal records."""
    want, got = (case(*pkg, **kw) for pkg in PACKAGES)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# pinning, eviction order, read-through accounting
# ---------------------------------------------------------------------------


def _pinned_under_pressure(tiers, store, blocks, *, cap_blocks, n_pinned,
                           pressure, policy):
    tier = tiers.DramTier(cap_blocks * BLOCK, policy=policy)
    n_pinned = min(n_pinned, cap_blocks)
    pinned = [("pin", i) for i in range(n_pinned)]
    rec = dict(admits=[tier.admit(r, BLOCK, owner="infl", now=float(i))
                       for i, r in enumerate(pinned)])
    tier.pin(pinned)
    for i in range(pressure):
        rec["admits"].append(tier.admit(("flood", i), BLOCK,
                                        owner=f"o{i % 7}",
                                        now=float(n_pinned + i)))
        tier.note_done(f"o{i % 3}")
    rec["pinned_resident"] = [tier.contains(r) for r in pinned]
    rec["pinned_bytes"] = tier.pinned_bytes()
    tier.unpin(pinned)
    for i in range(cap_blocks + n_pinned):
        rec["admits"].append(tier.admit(("flood2", i), BLOCK, owner="o-new",
                                        now=float(1000 + i)))
    rec["resident"] = sorted(map(str, tier._entries))
    rec["counters"] = tier.stats()
    return rec


@given(cap_blocks=st.integers(2, 24), n_pinned=st.integers(1, 8),
       pressure=st.integers(0, 120),
       policy=st.sampled_from(["lru", "agentic-ttl"]))
@settings(max_examples=30, deadline=None)
def test_pinned_blocks_and_eviction_match_under_pressure(
        cap_blocks, n_pinned, pressure, policy):
    rec = both(_pinned_under_pressure, cap_blocks=cap_blocks,
               n_pinned=n_pinned, pressure=pressure, policy=policy)
    assert all(rec["pinned_resident"])
    assert rec["counters"]["used_bytes"] <= cap_blocks * BLOCK


def _fully_pinned(tiers, store, blocks):
    tier = tiers.DramTier(3 * BLOCK)
    refs = ["a", "b", "c"]
    for r in refs:
        tier.admit(r, BLOCK)
    tier.pin(refs)
    rec = [tier.admit("d", BLOCK), tier.rejected_bytes]
    tier.unpin(["a"])
    rec += [tier.admit("d", BLOCK), tier.contains("a"), tier.stats()]
    return rec


def _lru_order(tiers, store, blocks):
    tier = tiers.DramTier(3 * BLOCK, policy="lru")
    for r in ("a", "b", "c"):
        tier.admit(r, BLOCK)
    tier.touch(["a"])
    tier.admit("d", BLOCK)
    rec = [tier.contains(r) for r in "abcd"]
    tier.admit("e", BLOCK)
    rec += [tier.contains(r) for r in "abcde"]
    return rec + [tier.stats()]


def _ttl_dead_first(tiers, store, blocks):
    tier = tiers.DramTier(4 * BLOCK, policy="agentic-ttl", ttl_s=100.0)
    tier.admit("live1", BLOCK, owner="t_live", now=0.0)
    tier.admit("dead1", BLOCK, owner="t_dead", now=1.0)
    tier.admit("dead2", BLOCK, owner="t_dead", now=2.0)
    tier.admit("live2", BLOCK, owner="t_live", now=3.0)
    tier.note_alive("t_live", now=3.0)
    tier.note_done("t_dead")
    tier.admit("new1", BLOCK, owner="t_live", now=4.0)
    tier.admit("new2", BLOCK, owner="t_live", now=4.0)
    return [tier.contains(r) for r in
            ("live1", "dead1", "dead2", "live2", "new1", "new2")] + \
        [tier.stats()]


def _ttl_expiry(tiers, store, blocks):
    tier = tiers.DramTier(2 * BLOCK, policy="agentic-ttl", ttl_s=10.0)
    tier.admit("idle", BLOCK, owner="t_idle", now=0.0)
    tier.note_alive("t_idle", now=0.0)
    tier.admit("act", BLOCK, owner="t_act", now=50.0)
    tier.note_alive("t_act", now=50.0)
    tier.admit("new", BLOCK, owner="t_act", now=51.0)
    return [tier.contains(r) for r in ("idle", "act", "new")] + \
        [tier.stats()]


def _policies(tiers, store, blocks):
    rec = [type(tiers.make_policy("lru")).__name__,
           type(tiers.make_policy("agentic-ttl")).__name__,
           tiers.make_policy("agentic-ttl").ttl_s,
           tiers.make_policy("agentic-ttl", ttl_s=5.0).ttl_s]
    with pytest.raises(ValueError):
        tiers.make_policy("fifo")
    return rec


def _read_through(tiers, store, blocks, *, cap_blocks=3, n_reads=40):
    """Reads, write-through and prefetch over a backing store: which
    payloads come back and every byte counter on both sides."""
    layout = blocks.BlockLayout(n_layers=2, block_tokens=4,
                                bytes_per_token_layer=8)
    backing = store.MemoryKVStore(layout)
    tier = tiers.DramTier(cap_blocks * layout.full_block_bytes,
                          backing=backing)
    refs = []
    for i in range(8):
        r = tier.alloc_ref()
        tier.write_block(r, np.full(layout.full_block_shape(), i, np.uint8),
                         now=float(i))
        refs.append(r)
    rng = np.random.default_rng(0)
    rec = []
    for k in range(n_reads):
        ref = refs[int(rng.integers(0, len(refs)))]
        blk = tier.read_block(ref, owner=k % 2, now=10.0 + k)
        rec.append(int(blk[0, 0, 0]))
    rec.append([tier.prefetch_block(r, owner=0, now=100.0) for r in refs])
    rec.append(int(backing.peek(refs[0])[0, 0, 0]))
    rec.append((backing.bytes_read, backing.bytes_written,
                tier.stats()))
    assert tier.dram_hit_bytes + tier.miss_bytes == \
        n_reads * layout.full_block_bytes
    return rec


@pytest.mark.parametrize("case", [_fully_pinned, _lru_order,
                                  _ttl_dead_first, _ttl_expiry, _policies,
                                  _read_through],
                         ids=lambda c: c.__name__.strip("_"))
def test_tier_case_matches_reference(case):
    both(case)


# ---------------------------------------------------------------------------
# resident prefix + prefetch planning
# ---------------------------------------------------------------------------


def _prefix_and_prefetch(tiers, store, blocks):
    tier = tiers.DramTier(100 * BLOCK)
    refs = [("t", i) for i in range(10)]
    rec = []
    for r in (refs[0], refs[1], refs[3]):          # hole at index 2
        tier.admit(r, BLOCK)
    rec.append(tier.resident_prefix(refs))
    tier.admit(refs[2], BLOCK)
    rec.append(tier.resident_prefix(refs))
    pf = tiers.ThinkTimePrefetcher(chunk_blocks=4)
    plan = lambda: pf.plan(tier, refs)
    rec.append(plan())
    rec.append((pf.rounds_planned, pf.blocks_planned))
    for r in refs:
        tier.admit(r, BLOCK)
    rec.append(plan())
    return rec


def test_resident_prefix_and_prefetch_chunks_match_reference():
    rec = both(_prefix_and_prefetch)
    assert rec[:2] == [2, 4]
    assert rec[2] == [[("t", i) for i in range(4, 8)], [("t", 8), ("t", 9)]]
    assert rec[3] == (1, 6)
    assert rec[4] == []


# ---------------------------------------------------------------------------
# tier-aware read-path selection
# ---------------------------------------------------------------------------


def _choose(sched, *, cached, queues, tier_tokens, split_reads=False,
            n_blocks=10):
    s = sched.Scheduler(alpha=1 << 30, beta=1 << 30, split_reads=split_reads)
    s.register_engine((0, 0), node=0, kind="pe", group=0)
    s.register_engine((1, 0), node=1, kind="de",
                      group=1000).free_hbm_tokens = 1 << 30
    s.engines[(0, 0)].read_q, s.engines[(1, 0)].read_q = queues
    r = sched.Request(rid=0, cached_tokens=cached, new_tokens=10,
                      gen_tokens=10)
    r.pe, r.de = (0, 0), (1, 0)
    path = s.choose_read_path(r, tier_tokens=tier_tokens)
    return dict(path=path, dram_side=r.dram_side, dram_tokens=r.dram_tokens,
                snic=r.snic_tokens, split=r.read_split,
                pe_frac=r.pe_read_frac, tokens=r.read_tokens_by_side(),
                blocks=r.hit_blocks_by_side(n_blocks),
                read_q=(s.engines[(0, 0)].read_q, s.engines[(1, 0)].read_q))


@pytest.mark.parametrize("kw", [
    # the DE tier holds the hit although the PE queue is shorter
    dict(cached=100, queues=(0, 50), tier_tokens={"pe": 0, "de": 60}),
    # a one-block warm prefix must not drag the cold read onto a
    # backlogged NIC
    dict(cached=10016, queues=(100_000, 0),
         tier_tokens={"pe": 16, "de": 0}, n_blocks=626),
    # tier prefix + water-filled split remainder
    dict(cached=100, queues=(0, 0), tier_tokens={"pe": 40, "de": 0},
         split_reads=True),
    # equal prefixes on both sides: the shorter queue takes the tier side
    dict(cached=100, queues=(30, 10), tier_tokens={"pe": 20, "de": 20}),
    # a tier covering the whole hit
    dict(cached=100, queues=(0, 0), tier_tokens={"pe": 0, "de": 100}),
    # no tier tokens: the tier-less choice
    dict(cached=100, queues=(0, 0), tier_tokens=None),
    dict(cached=100, queues=(7, 3), tier_tokens={"pe": 0, "de": 0},
         split_reads=True),
], ids=["de-tier", "tiny-prefix", "tier+split", "equal-prefixes",
        "all-tier", "no-tier", "zero-tier-split"])
def test_tier_aware_read_path_matches_reference(kw):
    want = _choose(jax_sched, **kw)
    got = _choose(port_sched, **kw)
    assert got == want
    if kw["tier_tokens"] and any(kw["tier_tokens"].values()):
        assert got["dram_tokens"] > 0
        assert sum(got["tokens"].values()) + got["dram_tokens"] == \
            kw["cached"]
    else:
        assert got["dram_tokens"] == 0 and got["snic"] is None
