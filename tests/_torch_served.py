"""Both packages' ``ServingSystem`` on one reduced architecture, held
alike: the shared run and checks of the llama4 and llava serving tests,
and the FullBlock decoding that tests/test_torch_online.py uses too."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serving import ServingSystem
from repro_torch.sim.traces import Round, Trajectory

ROUNDS = [(40, 4), (20, 4), (24, 4)]
AGENTS = 3
SERVE_KW = dict(n_pe=1, n_de=1, mode="dualpath", block_tokens=16,
                max_seq=160, de_slots=4, split_reads=True)


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """A persistent XLA compilation cache in the session's temp directory
    for the reference's eager scans (test_torch_ds27b.py's pattern: the
    same executables, no result changes); restored when the module ends."""
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


def bf16_values(block: np.ndarray) -> np.ndarray:
    """A (L, T, row) uint8 FullBlock of bf16 KV as float32 values."""
    block = np.ascontiguousarray(block)
    return (block.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def serve_both(arch: str):
    """Both ServingSystems on the reduced ``arch`` with bridged f32
    weights (and the bf16 KV cache the reference's FullBlock assumes);
    returns (reference system, its sessions, port system, its
    sessions)."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")
    jsys = JaxServingSystem(jcfg, jp, **SERVE_KW)
    jses = jsys.run_offline([JaxTrajectory(i, [JaxRound(*r) for r in ROUNDS])
                             for i in range(AGENTS)])
    tsys = ServingSystem(cfg, tp, device="cpu", **SERVE_KW)
    tses = tsys.run_offline([Trajectory(i, [Round(*r) for r in ROUNDS])
                             for i in range(AGENTS)])
    return jsys, jses, tsys, tses


def check_served_alike(jsys, jses, tsys, tses):
    """Equal contexts, ``stats()`` equal on every shared key, the same
    FullBlock refs and shapes, values within 2e-2 of each block's
    largest, layer 0 equal in over 99 % of its values."""
    assert [s.context for s in tses] == \
        [[int(t) for t in s.context] for s in jses]
    assert all(s.rounds_done == len(ROUNDS) for s in tses)
    jst, tst = jsys.stats(), tsys.stats()
    shared = sorted(set(jst) & set(tst))
    assert {k for k in shared if jst[k] != tst[k]
            and not (jst[k] != jst[k] and tst[k] != tst[k])} == set()
    assert tst["store_reads"] > 0 and tst["split_reads"] > 0
    assert tst["read_bytes_pe_side"] > 0 and tst["read_bytes_de_side"] > 0
    jdata, tdata = jsys.store._data, tsys.store._data
    assert sorted(tdata) == sorted(jdata) and len(tdata) == tst["trie_blocks"]
    for ref, blk in jdata.items():
        blk = np.asarray(blk)
        assert tdata[ref].dtype == np.uint8 and tdata[ref].shape == blk.shape
        want, got = bf16_values(blk), bf16_values(tdata[ref])
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), ref
        assert np.mean(got[0] == want[0]) > 0.99, ref
