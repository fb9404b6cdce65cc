"""Online serving with node DRAM tiers and the think-time prefetcher: the
port's ``ServingSystem.run_online`` against the JAX reference's.

Both systems serve the same trajectories (reduced qwen1.5-0.5b on bridged
bf16 weights) with arrivals and think gaps on the modelled clock, on the
reference's ``REDUCED_TEST_NODE`` (storage reads cost modelled seconds
comparable to compute), with a DRAM tier on every node:

* generated contexts, every byte counter (storage and DRAM reads per
  side, tier miss, prefetch and eviction bytes) and the trie are equal;
* the modelled ``wall_s`` and ``ttft_mean`` agree to 1e-9 relative (the
  tiers' eviction order depends on those floats, so they must match);
* every FullBlock the port persisted (through the scatter kernel's plain
  version) sits under the same ref as the reference's and holds the same
  KV: layer 0 equal in over 99 % of its values, every layer within 2e-2
  of the block's largest value, because the two frameworks round bf16
  differently in the attention and MLP that produce them (the tolerance
  the model tests give bf16 logits; a misplaced token, layer or half of
  a row is off by the values themselves).  The persist layout alone is
  byte-identical to the reference's (tests/test_torch_kvio.py);
* the port's blocking arm generates the same contexts and bytes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.config import TierConfig as JaxTierConfig
from repro.models import init_params as jax_init_params
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.spec import REDUCED_TEST_NODE
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from _torch_served import bf16_values
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.config import TierConfig
from repro_torch.serving import ServingSystem
from repro_torch.sim.spec import GPUSpec, NodeSpec
from repro_torch.sim.traces import Round, Trajectory

# tiny CPU tensors: extra intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

SHAPE = [(24, 3, 0.0), (16, 3, 0.5), (8, 3, 0.3)]   # (append, gen, think)
ARRIVALS = [0.0, 0.1, 0.25, 0.3]
COUNTERS = ("store_reads", "store_writes", "read_bytes_pe_side",
            "read_bytes_de_side", "dram_bytes_pe_side", "dram_bytes_de_side",
            "dram_hit_bytes", "tier_miss_bytes", "tier_prefetch_bytes",
            "tier_evicted_bytes", "split_reads", "trie_blocks",
            "prefill_tokens", "decode_steps", "gen_tokens", "finished_rounds")
NODE = NodeSpec(**{k: v for k, v in dataclasses.asdict(
    REDUCED_TEST_NODE).items() if k != "gpu"},
    gpu=GPUSpec(**dataclasses.asdict(REDUCED_TEST_NODE.gpu)))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen1.5-0.5b").reduced()
    return jcfg, jp, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                                 cfg, device="cpu")


@pytest.mark.parametrize("tier,split_reads", [
    (dict(dram_tier_bytes=32768, prefetch=True), True),
    (dict(dram_tier_bytes=32768, prefetch=True, tier_policy="agentic-ttl",
          tier_ttl_s=0.05), True),
    # two FullBlocks per tier: DRAM-served prefixes, prefetches and
    # evictions all happen
    (dict(dram_tier_bytes=65536, prefetch=True, tier_policy="agentic-ttl",
          tier_ttl_s=0.05), False),
], ids=["lru", "agentic-ttl", "agentic-ttl-2-blocks"])
def test_run_online_with_tiers_matches_jax(weights, tier, split_reads):
    jcfg, jp, cfg, tp = weights
    kw = dict(n_pe=1, n_de=1, mode="dualpath", split_reads=split_reads,
              block_tokens=16, max_seq=160, de_slots=4)
    jsys = JaxServingSystem(jcfg, jp, node=REDUCED_TEST_NODE,
                            tier=JaxTierConfig(**tier), **kw)
    jses = jsys.run_online(
        [JaxTrajectory(i, [JaxRound(*r) for r in SHAPE]) for i in range(4)],
        ARRIVALS)

    def port(pipelined):
        sys_ = ServingSystem(cfg, tp, node=NODE, tier=TierConfig(**tier),
                             pipelined=pipelined, device="cpu", **kw)
        ses = sys_.run_online(
            [Trajectory(i, [Round(*r) for r in SHAPE]) for i in range(4)],
            ARRIVALS)
        assert all(s.done() for s in ses)
        return sys_, [s.context for s in ses]

    tsys, ctx = port(True)
    bsys, ctx_b = port(False)
    assert ctx == [[int(t) for t in s.context] for s in jses]
    assert ctx_b == ctx
    jst, tst, bst = jsys.stats(), tsys.stats(), bsys.stats()
    for k in COUNTERS:
        assert tst[k] == jst[k], (k, jst[k], tst[k])
    for k in ("wall_s", "ttft_mean", "tpot_mean"):
        assert tst[k] == pytest.approx(jst[k], rel=1e-9, abs=0), k
    assert tsys.slo_attainment(1.0, 0.5) == jsys.slo_attainment(1.0, 0.5)
    for k in ("store_reads", "store_writes", "read_bytes_pe_side",
              "read_bytes_de_side", "dram_bytes_pe_side",
              "dram_bytes_de_side", "dram_hit_bytes", "tier_miss_bytes",
              "gen_tokens"):
        assert bst[k] == tst[k], (k, tst[k], bst[k])
    # the tiers really worked, and every hit byte came from DRAM or a NIC
    assert tst["tier_evicted_bytes"] > 0 and tst["tier_prefetch_bytes"] > 0
    assert tst["tier_miss_bytes"] == (tst["read_bytes_pe_side"] +
                                      tst["read_bytes_de_side"])
    assert tst["dram_hit_bytes"] == (tst["dram_bytes_pe_side"] +
                                     tst["dram_bytes_de_side"])
    if tier["dram_tier_bytes"] > 32768:
        assert tst["dram_hit_bytes"] > 0
    assert all(t.pinned_bytes() == 0 for t in tsys.tiers.values())
    # the wall clock honoured the last arrival and a think gap
    assert tst["wall_s"] >= ARRIVALS[-1] + SHAPE[1][2]
    jdata, tdata = jsys.store._data, tsys.store._data
    assert sorted(tdata) == sorted(jdata) and len(tdata) == tst["trie_blocks"]
    for ref, blk in jdata.items():
        assert tdata[ref].dtype == np.uint8 and tdata[ref].shape == blk.shape
        want, got = (bf16_values(b) for b in (blk, tdata[ref]))
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), ref
        assert np.mean(got[0] == want[0]) > 0.99, ref

