"""ds27b in the port against the JAX reference (CPU, reduced ds27b).

ds27b is the paper's own evaluation model: MoE (72 routed experts of
d_ff 1536, top-6, 2 shared, one dense layer first) over MLA attention
(latent rank 512 + rope 64 = 1152 bytes per token and layer in bf16).
The reduced config keeps it at test size: 4 layers (1 dense + 3 MoE),
8 experts, top-2, r 32, rd 16, 4 heads.  The JAX parameters go through
``repro_torch.bridge``; inputs come from numpy with a seed.

* The config, field for field, its layer kinds and KV bytes, and the
  analytic parameter counts of full-size ds27b (27.03 B, 4.455 B
  active) against the reference's, without allocating.
* ``forward``, ``append_step`` (b = 1 chunks, then a ragged b = 2) and
  ``decode_step`` logits and caches against the reference model in f32
  and bf16, greedy tokens equal in f32; the bridged state equal to the
  port's own.
* MLA FullBlock bytes (row = c ‖ krope) from ``serialize_kv_layer`` and
  ``deserialize_kv_layer`` byte-exact against the reference's on a
  bridged state; the persist's block-major pool and the slot utilities.
* Both packages' ``ServingSystem`` in the scenario of
  tests/test_serving.py::test_mla_arch_serving: equal contexts, store
  reads, byte and tier counters.
* The time models use MLA's q/k width (nope + rope); ``require_ported``
  still refuses an MoE period that does not divide the layers after the
  dense one, SSM and hybrid without their config, and MLA with a window;
  the launcher serves ds27b.

Tolerances: 2e-5 in f32 and 2e-2 in bf16, of the largest logit
(test_torch_model.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import intra as jax_intra
from repro.engines import kvio as jax_kvio
from repro.models import init_decode_state as jax_init_state
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.spec import ModelSimSpec as JaxModelSimSpec
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import intra
from repro_torch.engines import kvio
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (append_step, decode_step, forward,
                                init_decode_state, init_params)
from repro_torch.models.params import require_ported
from repro_torch.serving import ServingSystem
from repro_torch.sim.spec import ModelSimSpec
from repro_torch.sim.traces import Round, Trajectory

torch.set_num_threads(1)

jax_forward = jax.jit(jax_model.forward, static_argnums=1,
                      static_argnames=("return_state",))
jax_decode = jax.jit(jax_model.decode_step, static_argnums=1)
jax_append = jax.jit(jax_model.append_step, static_argnums=1)

ARCH = "ds27b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
S, CAP = 40, 64               # tokens per sequence, cache length


def _close(got, want, tol):
    """|got - want| <= tol * max|want| elementwise (test_torch_model.py)."""
    want = np.asarray(want, np.float32)
    bridge.assert_close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert cfg.moe_layer_mask() == jcfg.moe_layer_mask()
    assert cfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token()
    assert kvio.kv_row_bytes(cfg) == jax_kvio.kv_row_bytes(jcfg)
    assert ARCH in ARCH_IDS


def test_full_counts_match_the_reference_without_allocating():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count() == 27_033_546_240
    assert cfg.active_param_count() == jcfg.active_param_count() \
        == 4_455_083_520
    assert cfg.kv_bytes_per_token() == 34_560          # 30 x 1152
    assert kvio.kv_row_bytes(cfg) == 1152
    red = cfg.reduced()
    assert red.active_param_count() == \
        jax_get_config(ARCH).reduced().active_param_count()
    # dense models: every parameter is active
    qwen = get_config("qwen1.5-0.5b")
    assert qwen.active_param_count() == qwen.param_count()


def test_time_models_use_the_mla_qk_width():
    """Reduced ds27b's head_dim (32) is not its q/k width (32 + 16): the
    chunk packer's FLOPs and the simulator spec follow the reference."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    for c, b in ((0, 64), (100, 7)):
        assert intra.attn_flops_per_layer(cfg, c, b) == \
            jax_intra.attn_flops_per_layer(jcfg, c, b)
    assert ModelSimSpec.from_config(cfg).qk_head_dim == \
        JaxModelSimSpec.from_config(jcfg).qk_head_dim == 48


@pytest.mark.parametrize("change,match", [
    # period 2 over the 3 layers after the dense one: does not divide
    (dict(moe=dataclasses.replace(get_config(ARCH).moe, period=2)), "MoE"),
    (dict(family="ssm"), "SSM"), (dict(family="hybrid"), "SSM"),
    (dict(local_window=64), "MLA")])
def test_unported_features_still_raise(change, match):
    cfg = get_config(ARCH).reduced()
    require_ported(cfg)
    with pytest.raises(NotImplementedError, match=match):
        init_params(dataclasses.replace(cfg, **change), device="cpu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, S)).astype(np.int32)
    return dt, jcfg, tcfg, jp, tp, toks


def test_bridged_params_follow_the_layer_kinds(models):
    _, _, tcfg, _, tp, _ = models
    assert len(tp["blocks"]) == tcfg.n_layers
    assert ["moe" in b for b in tp["blocks"]] == list(tcfg.moe_layer_mask())
    own = init_params(tcfg, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(own) == shapes(tp)


def test_forward_matches_jax(models):
    dt, jcfg, tcfg, jp, tp, toks = models
    want, jst = jax_forward(jp, jcfg, jnp.asarray(toks), return_state=True)
    got, tst = forward(tp, tcfg, _t(toks), return_state=True)
    _close(got, np.asarray(want), TOLS[dt])
    if dt == "float32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
    joined = bridge.state_from_jax(jax.tree.map(np.asarray, jst),
                                   device="cpu")
    for k in ("c", "krope"):
        _close(tst["mla"][k], bridge.to_numpy(joined["mla"][k]), TOLS[dt])


def test_append_matches_jax_b1_and_ragged_b2(models):
    """b = 1 chunks (the reference's own append, not its forward: bf16
    chunk shapes may flip top-k routing, ROADMAP Queue 3), then a ragged
    b = 2 append."""
    dt, jcfg, tcfg, jp, tp, toks = models
    js = jax_init_state(jcfg, 1, CAP)
    ts = init_decode_state(tcfg, 1, CAP, device="cpu")
    off = 0
    for chunk in (17, 15, 8):
        want, js = jax_append(jp, jcfg, jnp.asarray(toks[:1, off:off + chunk]),
                              js, jnp.full((1,), off, jnp.int32))
        got, ts = append_step(tp, tcfg, _t(toks[:1, off:off + chunk]), ts,
                              torch.full((1,), off))
        _close(got, np.asarray(want), TOLS[dt])
        off += chunk
    joined = bridge.state_from_jax(jax.tree.map(np.asarray, js),
                                   device="cpu")
    _close(ts["mla"]["c"], bridge.to_numpy(joined["mla"]["c"]), TOLS[dt])
    lengths = np.array([30, 11], np.int32)
    js = jax_init_state(jcfg, 2, CAP)
    ts = init_decode_state(tcfg, 2, CAP, device="cpu")
    _, js = jax_append(jp, jcfg, jnp.asarray(toks[:, :30]), js,
                       jnp.zeros((2,), jnp.int32))
    _, ts = append_step(tp, tcfg, _t(toks[:, :30]), ts, torch.zeros(2))
    want, js = jax_append(jp, jcfg, jnp.asarray(toks[:, 30:]), js,
                          jnp.asarray(lengths))
    got, ts = append_step(tp, tcfg, _t(toks[:, 30:]), ts, _t(lengths))
    _close(got, np.asarray(want), TOLS[dt])
    joined = bridge.state_from_jax(jax.tree.map(np.asarray, js),
                                   device="cpu")
    for k in ("c", "krope"):
        _close(ts["mla"][k], bridge.to_numpy(joined["mla"][k]), TOLS[dt])


@pytest.mark.parametrize("tree,key", [
    ({"kv": {"k": (3,), "v": (3,)}}, "kv"),
    ({"dense": {"c": (1,), "krope": (1,)},
      "moe": {"c": (3,), "krope": (3,)}}, "mla"),
    ({"dense": {"k": (1,), "v": (1,)}, "moe": {"k": (3,), "v": (3,)}}, "kv"),
    ({"moe": {"k": (4,), "v": (4,)}}, "kv"),
], ids=["dense-gqa", "moe-mla", "moe-gqa", "moe-only"])
def test_state_from_jax_joins_by_the_trees_keys(tree, key):
    """The reference's state, dense (one ``kv`` stack) or MoE (``dense``
    then ``moe`` stacks), becomes the port's one stack over all layers in
    layer order, under ``mla`` where the leaves are latent rows."""
    rng = np.random.default_rng(3)
    np_state = {part: {name: rng.standard_normal(
        (n, 2, 5, 2)).astype(np.float32) for name, (n,) in leaves.items()}
        for part, leaves in tree.items()}
    got = bridge.state_from_jax(np_state, device="cpu")
    assert list(got) == [key]
    parts = [np_state[p] for p in ("kv", "dense", "moe") if p in np_state]
    assert sorted(got[key]) == sorted(parts[0])
    for name in parts[0]:
        np.testing.assert_array_equal(
            got[key][name].numpy(),
            np.concatenate([p[name] for p in parts]))


def _prefilled(jcfg, tcfg, jp, tp, toks, n):
    """Both packages' b = 2 states after appending ``toks[:, :n]``."""
    js = jax_init_state(jcfg, 2, CAP)
    ts = init_decode_state(tcfg, 2, CAP, device="cpu")
    _, js = jax_append(jp, jcfg, jnp.asarray(toks[:, :n]), js,
                       jnp.zeros((2,), jnp.int32))
    _, ts = append_step(tp, tcfg, _t(toks[:, :n]), ts, torch.zeros(2))
    return js, ts


def test_decode_matches_jax_greedy_in_f32(models):
    """Decode steps with the two rows at different lengths; in f32 each
    step's greedy token is the reference's."""
    dt, jcfg, tcfg, jp, tp, toks = models
    js, ts = _prefilled(jcfg, tcfg, jp, tp, toks, 30)
    lengths = np.array([30, 26])
    for i in range(8):
        cur = toks[np.arange(2), lengths + i]
        want, js = jax_decode(jp, jcfg, jnp.asarray(cur), js,
                              jnp.asarray(lengths + i, dtype=jnp.int32))
        got, ts = decode_step(tp, tcfg, _t(cur), ts, _t(lengths + i))
        _close(got, np.asarray(want), TOLS[dt])
        if dt == "float32":
            np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                          np.asarray(want).argmax(-1))


# ---------------------------------------------------------------------------
# FullBlock bytes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bridged_state():
    """A bf16 reference decode state after a real append, and the port's
    copy of it through the bridge."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 36))
    _, js = jax_append(jp, jcfg, jnp.asarray(toks, jnp.int32),
                       jax_init_state(jcfg, 2, CAP),
                       jnp.zeros((2,), jnp.int32))
    ts = bridge.state_from_jax(jax.tree.map(np.asarray, js),
                               device="cpu")
    return jcfg, tcfg, js, ts


def test_fullblock_bytes_match_reference(bridged_state):
    jcfg, tcfg, js, ts = bridged_state
    row = kvio.kv_row_bytes(tcfg)
    assert row == (32 + 16) * 2
    for layer in range(tcfg.n_layers):
        want = jax_kvio.serialize_kv_layer(jcfg, js, 1, 3, 33, layer)
        got = kvio.serialize_kv_layer(tcfg, ts, 1, 3, 33, layer)
        assert got.shape == (30, row)
        bridge.assert_exact(got, want)
    bridge.assert_exact(kvio.serialize_kv(tcfg, ts, 0, 0, 32),
                        jax_kvio.serialize_kv(jcfg, js, 0, 0, 32))


def test_fullblock_bytes_round_trip(bridged_state):
    """Rows written back by ``deserialize_kv_layer`` (both packages) and
    ``deserialize_kv`` land where they came from; the persist's
    block-major pool holds the same bytes as the layer-major rows."""
    jcfg, tcfg, js, ts = bridged_state
    rows = [kvio.serialize_kv_layer(tcfg, ts, 0, 0, 32, li)
            for li in range(tcfg.n_layers)]
    fresh = init_decode_state(tcfg, 2, CAP, device="cpu")
    jfresh = jax_init_state(jcfg, 2, CAP)
    for li, r in enumerate(rows):
        kvio.deserialize_kv_layer(tcfg, fresh, 1, 4, li, r)
        jfresh = jax_kvio.deserialize_kv_layer(jcfg, jfresh, 1, 4, li, r)
    for li in range(tcfg.n_layers):
        bridge.assert_exact(kvio.serialize_kv_layer(tcfg, fresh, 1, 4, 36,
                                                    li), rows[li])
        bridge.assert_exact(jax_kvio.serialize_kv_layer(jcfg, jfresh, 1, 4,
                                                        36, li), rows[li])
    bulk = init_decode_state(tcfg, 2, CAP, device="cpu")
    kvio.deserialize_kv(tcfg, bulk, 1, 4, np.stack(rows))
    bridge.assert_exact(bulk["mla"]["c"], fresh["mla"]["c"])
    blocks = kvio.serialize_blocks(tcfg, ts, 0, 0, 2, 16)
    layer_major = kvio.serialize_kv(tcfg, ts, 0, 0, 32)
    for i in range(2):
        bridge.assert_exact(blocks[i], np.ascontiguousarray(
            layer_major[:, 16 * i:16 * (i + 1)]))


def test_slot_utilities_on_the_mla_state(bridged_state):
    _, tcfg, _, ts = bridged_state
    axes = kvio.batch_axes_of_state(tcfg)
    assert axes == {"mla": {"c": 1, "krope": 1}}
    sub = kvio.slot_get(ts, axes, 1)
    assert sub["mla"]["c"].shape == (tcfg.n_layers, 1, CAP, 32)
    other = init_decode_state(tcfg, 3, CAP, device="cpu")
    kvio.slot_set(other, axes, 2, sub)
    assert torch.equal(other["mla"]["krope"][:, 2], ts["mla"]["krope"][:, 1])
    assert not other["mla"]["c"][:, :2].any()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

COUNTERS = ("store_reads", "store_writes", "read_bytes_pe_side",
            "read_bytes_de_side", "split_reads", "trie_blocks",
            "prefill_tokens", "decode_steps", "gen_tokens", "dram_hit_bytes",
            "dram_bytes_pe_side", "dram_bytes_de_side", "tier_miss_bytes",
            "tier_prefetch_bytes", "tier_evicted_bytes", "wall_s")


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """A persistent XLA compilation cache in the session's temp directory
    for the reference's eager scans (test_torch_gemma2.py's pattern: the
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


def test_matches_jax_mla_arch_serving(jax_compile_cache):
    """tests/test_serving.py::test_mla_arch_serving on both packages with
    bridged bf16 weights: equal contexts and counters (the modelled wall
    included: the packer's FLOPs use MLA's q/k width in both)."""
    rounds = [(18, 3), (10, 3)]
    kw = dict(n_pe=1, n_de=1, max_seq=128, block_tokens=16, de_slots=2)
    jcfg = jax_get_config(ARCH).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jsys = JaxServingSystem(jcfg, jp, seed=0, **kw)
    jses = jsys.run_offline([JaxTrajectory(0, [JaxRound(*r)
                                               for r in rounds])])
    cfg = get_config(ARCH).reduced()
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")
    tsys = ServingSystem(cfg, tp, device="cpu", **kw)
    tses = tsys.run_offline([Trajectory(0, [Round(*r) for r in rounds])])
    jst, tst = jsys.stats(), tsys.stats()
    for k in COUNTERS:
        assert tst[k] == jst[k], (k, jst[k], tst[k])
    assert tses[0].rounds_done == 2 and tst["store_reads"] > 0
    assert tses[0].context == [int(t) for t in jses[0].context]
    assert tsys.layout.bytes_per_token_layer == 96


def test_launcher_serves_ds27b(capsys):
    serve_launcher.main(["--arch", ARCH, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 12 rounds across 4 agents (dualpath, cpu)" in out
