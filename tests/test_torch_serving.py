"""The port's ServingSystem end to end (CPU, reduced qwen1.5-0.5b).

1. Cache reuse: multi-round generation through trie hits, FullBlock
   reads on either side (or split), the layerwise install, chunked
   prefill, the PD transfer, slot-batched decode and block persistence
   must give the same tokens as the port's cache-free reference, as
   tests/test_serving.py requires of the JAX system.
2. The pipelined and blocking runtimes give identical tokens and bytes.
3. Against the JAX ServingSystem on bridged weights (bf16, the only KV
   type the reference serves): every byte and token counter is equal
   (they depend on lengths only) and so are the generated contexts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import (append_step, decode_step, forward,
                                init_decode_state, init_params)
from repro_torch.serving import ServingSystem
from repro_torch.sim.traces import Round, Trajectory

# tiny CPU tensors: extra intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

COUNTERS = ("store_reads", "store_writes", "read_bytes_pe_side",
            "read_bytes_de_side", "split_reads", "trie_blocks",
            "prefill_tokens", "decode_steps", "gen_tokens")


def reference_generate(cfg, params, rounds, rng):
    """Cache-free oracle: full forward per round for the first token,
    then the whole prompt appended into a fresh state and greedy decode."""
    context = []
    for rnd in rounds:
        prompt = context + list(rng.integers(2, cfg.vocab_size,
                                             size=rnd.append))
        toks = torch.tensor([prompt])
        logits, _ = forward(params, cfg, toks)
        cur = int(torch.argmax(logits[0, -1]))
        gen = [cur]
        st = init_decode_state(cfg, 1, len(prompt) + rnd.gen + 4, "cpu")
        append_step(params, cfg, toks, st, torch.zeros(1))
        for i in range(rnd.gen - 1):
            lg, st = decode_step(params, cfg, torch.tensor([cur]), st,
                                 torch.tensor([len(prompt) + i]))
            cur = int(torch.argmax(lg[0]))
            gen.append(cur)
        context = prompt + gen
    return context


@pytest.fixture(scope="module")
def cfg_params():
    cfg = get_config("qwen1.5-0.5b").reduced()
    return cfg, init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("mode", ["dualpath", "basic", "split"])
def test_generation_with_cache_reuse_matches_reference(cfg_params, mode):
    cfg, params = cfg_params
    rounds = [Round(20, 4), Round(13, 3), Round(9, 4)]
    sys_ = ServingSystem(cfg, params, n_pe=1, n_de=1,
                         mode="basic" if mode == "basic" else "dualpath",
                         split_reads=(mode == "split"), block_tokens=16,
                         max_seq=160, de_slots=2, device="cpu")
    sessions = sys_.run_offline([Trajectory(0, rounds)])
    assert sessions[0].rounds_done == 3
    assert sys_.stats()["store_reads"] > 0
    want = reference_generate(cfg, params, rounds,
                              np.random.default_rng(1000))
    assert sessions[0].context == want


@pytest.mark.parametrize("kw", [
    dict(split_reads=True),
    dict(split_reads=False, layerwise=False, n_pe=2, n_de=2,
         de_group_size=1),
], ids=["split", "bulk-install-2pe-2de-groups"])
def test_pipelined_equals_blocking(cfg_params, kw):
    cfg, params = cfg_params
    kw = dict(dict(n_pe=1, n_de=1), **kw)

    def run(pipelined):
        sys_ = ServingSystem(cfg, params, block_tokens=16, max_seq=160,
                             de_slots=4, pipelined=pipelined, device="cpu",
                             **kw)
        trajs = [Trajectory(i, [Round(24, 3), Round(16, 3), Round(8, 3)])
                 for i in range(4)]
        contexts = [s.context for s in sys_.run_offline(trajs)]
        return sys_.stats(), contexts

    st_b, ctx_b = run(False)
    st_p, ctx_p = run(True)
    assert ctx_p == ctx_b
    for k in COUNTERS:
        assert st_p[k] == st_b[k], k


def test_matches_jax_serving_system():
    """The same trajectories through both packages' systems on bridged
    bf16 weights: equal counters and equal generated contexts."""
    shape = [(24, 3), (16, 3), (8, 3)]
    kw = dict(n_pe=1, n_de=1, mode="dualpath", split_reads=True,
              block_tokens=16, max_seq=160, de_slots=4)
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jsys = JaxServingSystem(jcfg, jp, **kw)
    jses = jsys.run_offline([JaxTrajectory(i, [JaxRound(*r) for r in shape])
                             for i in range(4)])
    cfg = get_config("qwen1.5-0.5b").reduced()
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")
    tsys = ServingSystem(cfg, tp, device="cpu", **kw)
    tses = tsys.run_offline([Trajectory(i, [Round(*r) for r in shape])
                             for i in range(4)])
    jst, tst = jsys.stats(), tsys.stats()
    for k in COUNTERS:
        assert tst[k] == jst[k], (k, jst[k], tst[k])
    assert tst["split_reads"] > 0
    assert tst["read_bytes_pe_side"] > 0 and tst["read_bytes_de_side"] > 0
    assert [s.context for s in tses] == [[int(t) for t in s.context]
                                         for s in jses]
