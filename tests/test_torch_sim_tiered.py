"""The DRAM-tier claims of the reference's tests/test_sim.py on the
port's simulator, at the reference's sizes (the port's parity with the
reference, tier and prefetcher included, is in tests/test_torch_sim.py):
the tier conserves hit bytes per round and saves storage-NIC reads, the
think-time prefetcher stages bytes without lowering the hit ratio, every
pin is released, and occupancy never exceeds capacity under both
eviction policies.
"""
from repro_torch.core.config import TierConfig
from repro_torch.sim import (DS_660B, HOPPER_NODE, Sim, SimConfig,
                             generate_dataset)


def test_tiered_sim_conserves_bytes_and_saves_snic_reads():
    trajs = generate_dataset(16, 32768, seed=0, think_mean_s=2.0)
    res = {}
    for label, tier, pf in (("off", 0.0, False), ("lru", 1.5e9, False),
                            ("lru+pf", 1.5e9, True)):
        cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=1, D=2,
                        mode="dualpath",
                        tier=TierConfig(dram_tier_bytes=tier, prefetch=pf))
        sim = Sim(cfg, trajs).run()
        r = sim.results()
        assert r["finished_agents"] == 16, (label, r)
        checked = 0
        for rs in sim.rounds:
            if rs.done_t < 0 or rs.req.read_path is None:
                continue
            c = rs.charged
            served = (c.get("pe_snic", 0) + c.get("de_snic", 0) +
                      c.get("pe_tier", 0) + c.get("de_tier", 0))
            assert served == rs.req.cached_tokens * sim.kv_per_token, \
                (label, rs.req.rid)
            checked += 1
        assert checked > 0
        res[label] = r
    assert res["off"]["dram_hit_ratio"] == 0.0
    for arm in ("lru", "lru+pf"):
        assert res[arm]["dram_hit_ratio"] > 0.0, arm
        assert res[arm]["snic_hit_read_bytes"] < \
            res["off"]["snic_hit_read_bytes"], arm
    assert res["lru+pf"]["tier_prefetch_bytes"] > 0
    assert res["lru+pf"]["dram_hit_ratio"] >= res["lru"]["dram_hit_ratio"]


def test_tiered_sim_pins_never_exceed_capacity_and_policies_run():
    for policy in ("lru", "agentic-ttl"):
        trajs = generate_dataset(8, 32768, seed=3, think_mean_s=1.0)
        cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=1, D=1,
                        mode="dualpath",
                        tier=TierConfig(dram_tier_bytes=1e9,
                                        tier_policy=policy, prefetch=True))
        sim = Sim(cfg, trajs).run()
        assert sim.results()["finished_agents"] == 8
        for tier in sim.tiers.values():
            assert tier.used_bytes <= tier.capacity_bytes
            assert tier.pinned_bytes() == 0, policy
