"""zamba2 served by both packages' ServingSystem (CPU, reduced zamba2-2.7b).

The hybrid's cache is one opaque state blob per session, as the SSM
family's: its Mamba2 states and its shared attention block's K/V per
application, padded to ``max_seq`` (the reference pickles the whole
slot).  It is reusable only at the exact context it was taken at
(``StateBlobStore``), read whole from the side the path decision chose
and never split.  One workload, 2 agents x 3 rounds, runs on both
packages with bridged bf16 weights, once per module on each: offline
(the port pipelined and blocking) and online (arrivals on the modelled
clock).

* The tokens are identical; every round after the first reads its
  session's blob; no read was split (each side's bytes are whole blobs,
  ``split_reads`` 0); the port's pipelined and blocking runtimes give
  the same tokens and per-side bytes.
* ``stats()`` equals the reference's on every key, offline and online.
  The reference runs with its ``pickle`` wrapped to report each blob's
  payload size (test_torch_mamba2_serving.py's shim), and the byte
  totals reconcile, the framing constant per blob.  The serving clock
  prices a PE step by ``attn_flops``, which counts the shared block once
  per application in both packages; at this size that term is too small
  to move a TTFT, so the two systems' step prices are compared
  directly.
* The blob's bytes are the Mamba2 leaves plus the shared K/V at
  ``max_seq``, derived from the config.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.engines import runtime as jax_runtime
from repro.models import init_params as jax_init_params
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serving import ServingSystem
from repro_torch.sim.traces import Round, Trajectory

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
ROUNDS, AGENTS = [(16, 3), (8, 3), (12, 2)], 2
KW = dict(n_pe=1, n_de=1, max_seq=128, de_slots=2)


class _PayloadPickle:
    """The reference's ``pickle`` as its runtime uses it, whose ``dumps``
    returns the same pickle bytes reporting the tree's payload size as
    ``len`` (what the modelled clock and the blob store count) and
    records the real length."""

    class Blob(bytes):
        def __len__(self):
            return self.payload

    def __init__(self):
        self.framing = []                 # len(pickle) - payload, per blob

    def dumps(self, tree):
        raw = pickle.dumps(tree)
        blob = self.Blob(raw)
        blob.payload = sum(a.nbytes for a in jax.tree.leaves(tree))
        self.framing.append(bytes.__len__(blob) - blob.payload)
        return blob

    loads = staticmethod(pickle.loads)


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """A persistent XLA compilation cache for the reference's eager scans
    (test_torch_gemma2.py's pattern); restored when the module ends."""
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
    """One run of the reference and the port's pipelined and blocking
    runs, for the module."""
    jcfg = jax_get_config(ARCH).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")
    trajs = lambda mk_t, mk_r: [mk_t(i, [mk_r(*r) for r in ROUNDS])
                                for i in range(AGENTS)]
    shim = _PayloadPickle()
    real = jax_runtime.pickle
    jax_runtime.pickle = shim
    try:
        jsys = JaxServingSystem(jcfg, jp, seed=0, **KW)
        jses = jsys.run_offline(trajs(JaxTrajectory, JaxRound))
    finally:
        jax_runtime.pickle = real
    port = {}
    for pipelined in (True, False):
        tsys = ServingSystem(cfg, tp, device="cpu", pipelined=pipelined,
                             **KW)
        port[pipelined] = (tsys, tsys.run_offline(trajs(Trajectory, Round)))
    # online: the second agent arrives while the first one's first round
    # is prefilled, on the modelled clock
    arrivals = [0.0, 1e-4]
    jax_runtime.pickle = _PayloadPickle()
    try:
        jon = JaxServingSystem(jcfg, jp, seed=0, **KW)
        jon.run_online(trajs(JaxTrajectory, JaxRound), arrivals)
    finally:
        jax_runtime.pickle = real
    ton = ServingSystem(cfg, tp, device="cpu", **KW)
    ton.run_online(trajs(Trajectory, Round), arrivals)
    return cfg, jsys, jses, shim, port, (jon, ton)


def _blob_bytes(cfg, max_seq) -> int:
    """One session's state from the config: per layer the f32 SSD state
    and the bf16 conv tails of x, B and C, then the shared block's bf16
    K and V for each application at ``max_seq`` tokens."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_state = s.n_groups * s.d_state
    mamba = cfg.n_layers * (d_inner * s.d_state * 4 + (s.conv_width - 1) *
                            (d_inner + 2 * n_state) * 2)
    shared = 2 * (cfg.n_layers // cfg.hybrid_period) * max_seq * \
        cfg.n_kv_heads * cfg.head_dim * 2
    return mamba + shared


def test_tokens_and_blob_reuse_match_reference(runs):
    cfg, jsys, jses, _, port, _ = runs
    tsys, tses = port[True]
    assert [s.context for s in tses] == \
        [[int(t) for t in s.context] for s in jses]
    assert all(s.rounds_done == len(ROUNDS) for s in tses)
    # every round after the first continued from its session's blob
    blob_bytes = _blob_bytes(cfg, KW["max_seq"])
    assert {len(b) for b, _ in tsys.blob_store._blobs.values()} == \
        {blob_bytes}
    reads = tsys.blob_store.bytes_read // blob_bytes
    assert tsys.blob_store.bytes_read == reads * blob_bytes
    assert reads == AGENTS * (len(ROUNDS) - 1)
    # no read was split: each side holds whole blobs
    st = tsys.stats()
    assert st["split_reads"] == 0
    pe, de = st["read_bytes_pe_side"], st["read_bytes_de_side"]
    assert pe % blob_bytes == 0 and de % blob_bytes == 0
    assert pe + de == tsys.blob_store.bytes_read
    assert st["store_reads"] == st["store_writes"] == 0


def test_pipelined_and_blocking_agree(runs):
    port = runs[4]
    (a, sa), (b, sb) = port[True], port[False]
    assert [s.context for s in sa] == [s.context for s in sb]
    for k in ("read_bytes_pe_side", "read_bytes_de_side", "split_reads"):
        assert a.stats()[k] == b.stats()[k], k
    assert a.blob_store.bytes_read == b.blob_store.bytes_read
    assert a.blob_store.bytes_written == b.blob_store.bytes_written


def test_online_stats_equal_reference(runs):
    """The modelled TTFT, TPOT and wall of an online run equal the
    reference's, and so does the price of a PE step on each system's
    clock (the shared block's applications priced alike)."""
    jon, ton = runs[5]
    jst, tst = jon.stats(), ton.stats()
    assert set(jst) == set(tst)
    assert tst["ttft_p99"] > 0
    for k in jst:
        assert tst[k] == jst[k], (k, jst[k], tst[k])
    for items in ([(0, 16)], [(16, 3), (32, 9)], [(0, 1000), (1000, 64)]):
        assert ton.time_model.pe_step_seconds(items) == \
            jon.time_model.pe_step_seconds(items), items


def test_stats_equal_reference_and_blob_bytes_reconcile(runs):
    cfg, jsys, _, shim, port, _ = runs
    tsys, _ = port[True]
    jst, tst = jsys.stats(), tsys.stats()
    assert set(jst) == set(tst)
    for k in jst:
        assert tst[k] == jst[k], (k, jst[k], tst[k])
    # the blob byte totals: the reference's pickles against raw bytes
    framing = set(shim.framing)
    assert len(framing) == 1 and framing.pop() > 0, shim.framing
    blob_bytes = _blob_bytes(cfg, KW["max_seq"])
    payloads = {b.payload for b, _ in jsys.blob_store._blobs.values()}
    assert payloads == {blob_bytes}       # the pickled slot's payload
    j_reads = jsys.blob_store.bytes_read // blob_bytes
    t_reads = tsys.blob_store.bytes_read // blob_bytes
    assert j_reads == t_reads > 0
    assert jsys.blob_store.bytes_written == tsys.blob_store.bytes_written \
        == len(shim.framing) * blob_bytes
