"""The port's KV serialisation against the JAX reference's.

FullBlocks are bytes, so every comparison here is exact: a state bridged
from JAX must serialise to the same bytes in both packages (the persist's
``serialize_blocks`` through the scatter kernel's plain version on the
CPU, too), and JAX-made
FullBlocks installed through the port's layerwise stream (the gather
kernel's plain version on the CPU) must rebuild the JAX state bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.engines import kvio as jax_kvio
from repro.models import init_decode_state as jax_init_state
from repro.models import init_params as jax_init_params
from repro.models.model import append_step as jax_append
from repro_torch import bridge, kernels
from repro_torch.configs import get_config
from repro_torch.engines import kvio
from repro_torch.models import init_decode_state

# tiny CPU tensors: extra intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

B, T, CAP, PT = 2, 16, 24, 8


@pytest.fixture(scope="module")
def jax_state():
    """A JAX decode state holding T tokens of real KV in both slots."""
    cfg = jax_get_config("qwen1.5-0.5b").reduced()
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T))
    st = jax_init_state(cfg, B, CAP)
    _, st = jax_append(params, cfg, jnp.asarray(toks, jnp.int32), st,
                       jnp.zeros((B,), jnp.int32))
    return cfg, st


def test_serialize_is_byte_identical_to_jax(jax_state):
    jcfg, jst = jax_state
    cfg = get_config("qwen1.5-0.5b").reduced()
    st = bridge.state_from_jax(jax.tree.map(np.asarray, jst),
                              device="cpu")
    for slot in range(B):
        want = jax_kvio.serialize_kv(jcfg, jst, slot, 0, T)
        got = kvio.serialize_kv(cfg, st, slot, 0, T)
        assert got.dtype == np.uint8
        bridge.assert_exact(got, want)
        bridge.assert_exact(kvio.serialize_kv_layer(cfg, st, slot, 4, 12, 2),
                            jax_kvio.serialize_kv_layer(jcfg, jst, slot, 4,
                                                        12, 2))
    assert kvio.kv_row_bytes(cfg) == jax_kvio.kv_row_bytes(jcfg)


@pytest.mark.parametrize("b0,b1", [(0, 2), (1, 2), (0, 1)])
def test_serialize_blocks_is_byte_identical_to_jax_fullblocks(jax_state,
                                                              b0, b1):
    """The scatter-built persist: FullBlock i equals the reference's
    per-block slice of ``serialize_kv``, byte for byte, and is a
    contiguous (L, PT, row) array of its own."""
    jcfg, jst = jax_state
    cfg = get_config("qwen1.5-0.5b").reduced()
    st = bridge.state_from_jax(jax.tree.map(np.asarray, jst),
                              device="cpu")
    for slot in range(B):
        got = kvio.serialize_blocks(cfg, st, slot, b0, b1, PT)
        kv = jax_kvio.serialize_kv(jcfg, jst, slot, b0 * PT, b1 * PT)
        assert got.shape == (b1 - b0, kv.shape[0], PT, kv.shape[2])
        for i in range(b1 - b0):
            assert got[i].flags.c_contiguous
            bridge.assert_exact(got[i], np.ascontiguousarray(
                kv[:, i * PT:(i + 1) * PT]))


def test_serialize_blocks_scatters_every_layer_in_one_call(jax_state,
                                                         monkeypatch):
    """The persist is one scatter call over every layer (one kernel launch
    on the card), with the layer-major rows as its (L, n, bt, row)
    stream."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    st = bridge.state_from_jax(jax.tree.map(np.asarray, jax_state[1]),
                               device="cpu")
    calls = []

    def counting(pool, table, stream, *, layer):
        calls.append((tuple(stream.shape), layer))
        return kernels.kv_layer_scatter(pool, table, stream, layer=layer)

    monkeypatch.setattr(kvio, "kv_layer_scatter", counting)
    got = kvio.serialize_blocks(cfg, st, 1, 0, 2, PT)
    row = kvio.kv_row_bytes(cfg)
    assert calls == [((cfg.n_layers, 2, PT, row), range(cfg.n_layers))]
    bridge.assert_exact(got[1], np.ascontiguousarray(
        kvio.serialize_kv(cfg, st, 1, PT, 2 * PT)))


def test_deferred_persist_keeps_the_snapshot_of_its_round(jax_state):
    """The DE serialises at persist time: a slot overwritten (re-admitted)
    before the deferred writes land leaves the persisted FullBlocks as
    they were when the round finished."""
    from repro_torch.core.blocks import layout_for
    from repro_torch.core.scheduler import Request
    from repro_torch.engines.runtime import DecodeEngine, EngineRequest
    from repro_torch.kvcache.store import MemoryKVStore
    from repro_torch.kvcache.trie import BlockTrie
    jcfg, jst = jax_state
    cfg = get_config("qwen1.5-0.5b").reduced()
    layout = layout_for(cfg, PT, 2)
    store = MemoryKVStore(layout)
    de = DecodeEngine((1, 0), cfg, None, store, BlockTrie(PT), layout, CAP,
                      n_slots=B, device="cpu")
    de.state = bridge.state_from_jax(jax.tree.map(np.asarray, jst),
                                     device="cpu")
    de.defer_persist = True
    er = EngineRequest(req=Request(rid=0, cached_tokens=0, new_tokens=T,
                                   gen_tokens=0),
                       context_tokens=[], append_tokens=list(range(T)))
    de._persist(1, er)
    assert store.bytes_written == 0                  # writes not landed
    sub = kvio.slot_get(de.state, de.axes, 1)
    kvio.slot_set(de.state, de.axes, 1,
                  {"kv": {k: torch.ones_like(v)
                          for k, v in sub["kv"].items()}})
    de.tm.drain()
    (_, fin), = de.pending_persist
    fin()
    hit, refs = de.trie.match(list(range(T)))
    assert hit == T and len(refs) == T // PT
    kv = jax_kvio.serialize_kv(jcfg, jst, 1, 0, T)
    for i, ref in enumerate(refs):
        bridge.assert_exact(store.read_block(ref), np.ascontiguousarray(
            kv[:, i * PT:(i + 1) * PT]))


@pytest.mark.parametrize("layerwise", [True, False])
def test_jax_fullblocks_install_to_the_jax_state(jax_state, layerwise):
    """JAX FullBlocks -> the port's install (layerwise through
    layer_stream + deserialize_kv_layer, or bulk deserialize_kv) -> the
    bridged JAX state, exactly."""
    jcfg, jst = jax_state
    cfg = get_config("qwen1.5-0.5b").reduced()
    kv = jax_kvio.serialize_kv(jcfg, jst, 1, 0, T)          # (L, T, row)
    blocks = [np.ascontiguousarray(kv[:, i:i + PT]) for i in range(0, T, PT)]
    st = init_decode_state(cfg, 1, CAP, device="cpu")
    if layerwise:
        layers = []
        for li, rows in kvio.layer_stream(cfg, blocks, device="cpu"):
            assert isinstance(rows, torch.Tensor) and rows.shape == (T, kv.shape[2])
            layers.append(li)
            kvio.deserialize_kv_layer(cfg, st, 0, 0, li, rows)
        assert layers == list(range(cfg.n_layers))
    else:
        kvio.deserialize_kv(cfg, st, 0, 0, np.concatenate(blocks, axis=1))
    for key in ("k", "v"):
        want = np.asarray(jst["kv"][key][:, 1:2, :T]).view(np.uint16)
        got = st["kv"][key][:, :, :T].view(torch.int16).numpy()
        np.testing.assert_array_equal(got.view(np.uint16), want)
        assert not st["kv"][key][:, :, T:].any()


def test_slot_get_set_roundtrip():
    cfg = get_config("qwen1.5-0.5b").reduced()
    st = init_decode_state(cfg, 3, 16, device="cpu")
    axes = kvio.batch_axes_of_state(cfg)
    assert axes == {"kv": {"k": 1, "v": 1}}
    rnd = {"kv": {k: torch.randn(v.shape).to(v.dtype)
                  for k, v in st["kv"].items()}}
    sub = kvio.slot_get(rnd, axes, 1)
    kvio.slot_set(st, axes, 2, sub)
    sub2 = kvio.slot_get(st, axes, 2)
    for k in ("k", "v"):
        assert torch.equal(sub["kv"][k], sub2["kv"][k])
        assert torch.equal(st["kv"][k][:, 2], rnd["kv"][k][:, 1])
        assert not st["kv"][k][:, :2].any()
