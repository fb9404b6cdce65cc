"""mamba2 served by both packages' ServingSystem (CPU, reduced mamba2-1.3b).

An SSM's cache is one opaque state blob per session, reusable only at
the exact context it was taken at (``StateBlobStore``), read whole from
the side the path decision chose and never split.  Two workloads run on
both packages with bridged bf16 weights: the reference's own
``tests/test_serving.py::test_ssm_state_blob_reuse`` trajectory, and 2
agents x 3 rounds with split reads and a DRAM tier on every node.

* The tokens are identical; the blob was reused (every round after the
  first reads one); no read was split (each side's bytes are whole
  blobs, ``split_reads`` 0); the port's pipelined and blocking runtimes
  give the same tokens and per-side bytes.
* ``stats()`` equals the reference's on every key.  The blobs differ in
  size by design: the reference pickles a numpy tree, the port moves
  the raw bytes of its state (``kvio.state_to_blob``).  The modelled
  clock charges a read or a persist by its bytes, so the reference runs
  with its ``pickle`` wrapped to report each blob's payload size (the
  pickle itself unchanged: ``loads`` reads the same bytes).  The wrapper
  records each pickle's real length, and the byte totals are reconciled
  as (the reference's reads) x (its pickle's length) against (the
  port's reads) x (the raw state bytes), the framing difference the
  same for every blob.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.config import TierConfig as JaxTierConfig
from repro.engines import runtime as jax_runtime
from repro.models import init_params as jax_init_params
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.config import TierConfig
from repro_torch.models import init_decode_state
from repro_torch.serving import ServingSystem
from repro_torch.sim.traces import Round, Trajectory

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
# (rounds of each agent, agents, extra ServingSystem arguments)
WORKLOADS = {
    "reference": ([(16, 3), (8, 3)], 1, {}),
    "split_tier": ([(20, 3), (9, 3), (5, 2)], 2,
                   dict(split_reads=True, tier=(1 << 20, True))),
}


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


def _kw(extra, tier_cls):
    kw = dict(n_pe=1, n_de=1, max_seq=128, de_slots=2)
    kw.update({k: v for k, v in extra.items() if k != "tier"})
    if "tier" in extra:
        nbytes, prefetch = extra["tier"]
        kw["tier"] = tier_cls(dram_tier_bytes=nbytes, prefetch=prefetch)
    return kw


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
def weights():
    jcfg = jax_get_config(ARCH).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    return jcfg, jp, cfg, bridge.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _state_bytes(cfg) -> int:
    """The raw bytes of one sequence's state: f32 ``ssm`` and the conv
    tails in the activation dtype, every layer."""
    st = init_decode_state(cfg, 1, 0, device="meta")["mamba"]
    return sum(v.numel() * v.element_size() for v in st.values())


_RUNS = {}


def _runs(name, weights):
    """One run of the reference and the port's pipelined and blocking
    runs of workload ``name``, cached for the module."""
    if name in _RUNS:
        return _RUNS[name]
    jcfg, jp, cfg, tp = weights
    rounds, agents, extra = WORKLOADS[name]
    shim = _PayloadPickle()
    real = jax_runtime.pickle
    jax_runtime.pickle = shim
    try:
        jsys = JaxServingSystem(jcfg, jp, seed=0, **_kw(extra,
                                                        JaxTierConfig))
        jses = jsys.run_offline([JaxTrajectory(i, [JaxRound(*r)
                                                   for r in rounds])
                                 for i in range(agents)])
    finally:
        jax_runtime.pickle = real
    port = {}
    for pipelined in (True, False):
        tsys = ServingSystem(cfg, tp, device="cpu", pipelined=pipelined,
                             **_kw(extra, TierConfig))
        tses = tsys.run_offline([Trajectory(i, [Round(*r) for r in rounds])
                                 for i in range(agents)])
        port[pipelined] = (tsys, tses)
    _RUNS[name] = (jsys, jses, shim, port)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_tokens_and_blob_reuse_match_reference(name, weights,
                                               jax_compile_cache):
    jsys, jses, _, port = _runs(name, weights)
    tsys, tses = port[True]
    rounds, agents, _ = WORKLOADS[name]
    assert [s.context for s in tses] == \
        [[int(t) for t in s.context] for s in jses]
    assert all(s.rounds_done == len(rounds) for s in tses)
    # every round after the first continued from its session's blob
    blob_bytes = _state_bytes(weights[2])
    assert {len(b) for b, _ in tsys.blob_store._blobs.values()} == \
        {blob_bytes}
    reads = tsys.blob_store.bytes_read // blob_bytes
    assert tsys.blob_store.bytes_read == reads * blob_bytes
    assert reads == agents * (len(rounds) - 1)
    # no read was split: each side holds whole blobs
    st = tsys.stats()
    assert st["split_reads"] == 0
    pe, de = st["read_bytes_pe_side"], st["read_bytes_de_side"]
    assert pe % blob_bytes == 0 and de % blob_bytes == 0
    assert pe + de == tsys.blob_store.bytes_read


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_pipelined_and_blocking_agree(name, weights):
    _, _, _, port = _runs(name, weights)
    (a, sa), (b, sb) = port[True], port[False]
    assert [s.context for s in sa] == [s.context for s in sb]
    for k in ("read_bytes_pe_side", "read_bytes_de_side", "split_reads"):
        assert a.stats()[k] == b.stats()[k], k
    assert a.blob_store.bytes_read == b.blob_store.bytes_read
    assert a.blob_store.bytes_written == b.blob_store.bytes_written


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_stats_equal_reference_and_blob_bytes_reconcile(name, weights,
                                                        jax_compile_cache):
    jsys, _, shim, port = _runs(name, weights)
    tsys, _ = port[True]
    jst, tst = jsys.stats(), tsys.stats()
    assert set(jst) == set(tst)
    for k in jst:
        assert tst[k] == jst[k], (k, jst[k], tst[k])
    # the blob byte totals: the reference's pickles against raw bytes
    framing = set(shim.framing)
    assert len(framing) == 1 and framing.pop() > 0, shim.framing
    blob_bytes = _state_bytes(weights[2])
    payloads = {b.payload for b, _ in jsys.blob_store._blobs.values()}
    assert payloads == {blob_bytes}       # the pickled tree's payload
    j_reads = jsys.blob_store.bytes_read // blob_bytes
    t_reads = tsys.blob_store.bytes_read // blob_bytes
    assert j_reads == t_reads > 0
    pickled = blob_bytes + shim.framing[0]
    # unwrapped, the reference would count j_reads x len(pickle)
    assert j_reads * pickled - t_reads * blob_bytes == \
        t_reads * shim.framing[0]
    assert jsys.blob_store.bytes_written == tsys.blob_store.bytes_written \
        == len(shim.framing) * blob_bytes
