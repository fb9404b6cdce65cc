"""llama4-maverick-400b-a17b in the port against the JAX reference (CPU,
reduced llama4).

llama4 interleaves dense and MoE FFNs with period 2 (no dense layers
first): layer 2i is dense, layer 2i + 1 routes each token to one of 128
experts (top-1) beside one shared expert, over GQA attention (40 heads
over 8 KV heads of 128).  The reference stacks its blocks and its decode
state as ``super_blocks.pre`` (n_super, period - 1) and
``super_blocks.moe`` (n_super); the port keeps one list of blocks and one
KV stack in layer order, so the bridge interleaves them.  The reduced
config keeps it at test size: 4 layers (dense, MoE, dense, MoE), 8
experts, top-1, 4 heads over 1 KV head of 32 (g 4).

* The config, field for field, and the analytic parameter counts of the
  full-size model (397.7 B, 14.2 B active) against the reference's.
* The bridge places every layer: the reference's ``dense_blocks``,
  ``pre`` and ``moe`` leaves are made distinct, converted, and each port
  block and each layer of the decode state is the one expected, at
  period 2 and at period 3 after a dense layer.
* ``forward``, ``append_step`` (a first append, then a second over rows
  at different lengths, each from the reference's state bridged over)
  and ``decode_step`` logits against the reference model, f32 and bf16.
  In bf16 the two packages round the attention and norms before the
  router differently, and at top-1 a token whose two best experts are
  near-tied can land on the other expert (as granite's did,
  tests/test_torch_registrations.py); the tokens after it in its row
  attend to it.  So in bf16 each step is held row by row, at most two
  of its token rows off; in f32 every row agrees and the greedy tokens
  are equal.
* A period-2 depth that does not divide raises.
* FullBlock bytes of a bridged state equal the reference's byte for
  byte, layer for layer (the port's one KV stack is in the reference's
  ``kvio._kv_rows`` order with no new rows).
* Both packages' ``ServingSystem``: dualpath, 1 PE + 1 DE, FullBlocks of
  16 tokens, split reads, 3 agents over three rounds, f32 weights.
  Equal tokens and ``stats()`` equal on every counter the two share.
  The persisted FullBlocks sit under the same refs; their values agree
  within 2e-2 of each block's largest value, layer 0 in over 99 % of
  them: the reference's FullBlock holds 2-byte KV, so both runs keep a
  bf16 cache, and the two frameworks' f32 K/V (equal to ~1e-6) round to
  bf16 differently in a few values per block (tests/test_torch_online.py
  holds bf16 runs the same way).

Tolerances: 2e-5 of the largest logit in f32, 2e-2 in bf16
(test_torch_model.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.engines import kvio as jax_kvio
from repro.models import init_decode_state as jax_init_state
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.engines import kvio
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (append_step, decode_step, forward,
                                init_decode_state, init_params)
from repro_torch.models.params import require_ported
from _torch_served import (  # noqa: F401 (a fixture)
    check_served_alike, jax_compile_cache, serve_both)

torch.set_num_threads(1)

jax_forward = jax.jit(jax_model.forward, static_argnums=1)
jax_decode = jax.jit(jax_model.decode_step, static_argnums=1)
jax_append = jax.jit(jax_model.append_step, static_argnums=1)

ARCH = "llama4-maverick-400b-a17b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
S, CAP = 24, 40
BF16_FLIPS = 2


def _close(got, want, tol):
    """|got - want| <= tol * max|want| elementwise (test_torch_model.py)."""
    want = np.asarray(want, np.float32)
    bridge.assert_close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _close_rows(got, want, tol, flips: int):
    """:func:`_close` on every token row but at most ``flips`` rows (a
    routing flip and a token attending to it)."""
    want = np.asarray(want, np.float32)
    bound = tol * max(1.0, float(np.abs(want).max()))
    off = np.abs(bridge.to_numpy(got) - want) > bound * (1 + np.abs(want))
    off = off.reshape(-1, off.shape[-1]).any(-1)
    assert off.sum() <= flips, off


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
    assert ARCH in ARCH_IDS
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.moe_layer_mask() == jcfg.moe_layer_mask()
    assert cfg.moe_layer_mask()[:4] == (False, True, False, True)
    assert cfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token()
    assert kvio.kv_row_bytes(cfg) == jax_kvio.kv_row_bytes(jcfg)
    require_ported(cfg)


def test_full_counts_match_the_reference_without_allocating():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    # the reference's analytic counts: 397.7 B, 14.2 B active (one of
    # 128 routed experts and the shared one on each of 24 MoE layers)
    assert cfg.param_count() == 397_691_950_080
    assert cfg.active_param_count() == 14_164_792_320
    assert kvio.kv_row_bytes(cfg) == 2 * 8 * 128 * 2
    # depth 2 (the card's phase): one dense layer, then one MoE layer,
    # 37.1 GB in bf16
    two = dataclasses.replace(cfg, n_layers=2)
    assert two.param_count() == \
        dataclasses.replace(jcfg, n_layers=2).param_count() == 18_553_267_200
    assert cfg.reduced().active_param_count() == \
        jcfg.reduced().active_param_count()


@pytest.mark.parametrize("n_layers", [3, 5])
def test_a_depth_the_period_does_not_divide_raises(n_layers):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=n_layers)
    with pytest.raises(NotImplementedError, match="MoE config"):
        require_ported(cfg)
    with pytest.raises(NotImplementedError, match="period"):
        init_params(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the bridge's layer order
# ---------------------------------------------------------------------------

PERIODS = {"period2": dict(),
           "period3-after-dense": dict(n_layers=7, period=3,
                                       first_k_dense=1)}


def _layer_value(li: int, first_k_dense: int, period: int) -> float:
    """The mark each layer's leaves carry: dense_blocks[li] 200 + li,
    pre[i, j] 1 + 10 i + j, moe[i] 100 + i."""
    if li < first_k_dense:
        return 200.0 + li
    i, j = divmod(li - first_k_dense, period)
    return 100.0 + i if j == period - 1 else 1.0 + 10 * i + j


def _period_cfgs(name):
    over = dict(PERIODS[name])
    n_layers = over.pop("n_layers", None)
    out = []
    for base in (get_config(ARCH).reduced(),
                 jax_get_config(ARCH).reduced()):
        kw = dict(moe=dataclasses.replace(base.moe, **over))
        if n_layers:
            kw["n_layers"] = n_layers
        out.append(dataclasses.replace(base, **kw))
    return out


def _mark(tree, stack: str, first_k_dense: int, period: int):
    """Writable numpy copies of a reference stack, each layer's leaves
    set to its mark."""
    def fill(a):
        a = np.array(a)
        for idx in np.ndindex(a.shape[:2 if stack == "pre" else 1]):
            if stack == "dense":
                li = idx[0]
            elif stack == "pre":
                li = first_k_dense + idx[0] * period + idx[1]
            else:
                li = first_k_dense + idx[0] * period + period - 1
            a[idx] = _layer_value(li, first_k_dense, period)
        return a
    return jax.tree.map(fill, tree)


@pytest.mark.parametrize("name", list(PERIODS))
def test_bridge_places_every_block(name):
    cfg, jcfg = _period_cfgs(name)
    m = cfg.moe
    require_ported(cfg)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(0)))
    sb = tree["super_blocks"]
    sb["moe"] = _mark(sb["moe"], "moe", m.first_k_dense, m.period)
    sb["pre"] = _mark(sb["pre"], "pre", m.first_k_dense, m.period)
    if m.first_k_dense:
        tree["dense_blocks"] = _mark(tree["dense_blocks"], "dense",
                                     m.first_k_dense, m.period)
    tp = bridge.params_from_jax(tree, cfg, device="cpu")
    assert len(tp["blocks"]) == cfg.n_layers
    for li, (blk, is_moe) in enumerate(zip(tp["blocks"],
                                           cfg.moe_layer_mask())):
        assert ("moe" in blk) == is_moe and ("ffn" in blk) != is_moe, li
        want = _layer_value(li, m.first_k_dense, m.period)
        for leaf in (blk["ln1"], blk["attn"]["wq"], blk["ln2"]):
            assert torch.all(leaf.float() == want), (li, want)
    # the port's own schema has the same leaves, block for block
    own = init_params(cfg, device="cpu")
    for a, b in zip(own["blocks"], tp["blocks"]):
        assert jax.tree.map(lambda t: tuple(t.shape), a) == \
            jax.tree.map(lambda t: tuple(t.shape), b)


@pytest.mark.parametrize("name", list(PERIODS))
def test_bridge_places_every_state_layer(name):
    cfg, jcfg = _period_cfgs(name)
    m = cfg.moe
    js = jax.tree.map(np.asarray, jax_init_state(jcfg, 2, 8))
    assert set(js) == {"moe", "pre"} | ({"dense"} if m.first_k_dense
                                        else set())
    for part in js:
        js[part] = _mark(js[part], part, m.first_k_dense, m.period)
    ts = bridge.state_from_jax(js, device="cpu")
    want = init_decode_state(cfg, 2, 8, device="cpu")
    for k in ("k", "v"):
        assert ts["kv"][k].shape == want["kv"][k].shape
        assert ts["kv"][k].dtype == want["kv"][k].dtype
        for li in range(cfg.n_layers):
            assert torch.all(ts["kv"][k][li].float() == _layer_value(
                li, m.first_k_dense, m.period)), (k, li)


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


def _bridged(js):
    return bridge.state_from_jax(jax.tree.map(np.asarray, js), "cpu")


def _held(got, want, dt):
    if dt == "bfloat16":
        _close_rows(got, want, TOLS[dt], BF16_FLIPS)
    else:
        _close(got, want, TOLS[dt])


def test_forward_matches_jax(models):
    dt, jcfg, tcfg, jp, tp, toks = models
    want, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    got, _ = forward(tp, tcfg, _t(toks))
    assert got.shape == (2, S, tcfg.vocab_size) and got.dtype == torch.float32
    _held(got, want, dt)


def test_append_and_decode_match_jax(models):
    """A first append of 16 tokens from empty caches; a second append
    (rows at 16 and 11 tokens) and two decode steps, each from the
    reference's state bridged over, so each step is held on its own
    arithmetic; the caches they write equal the reference's, layer for
    layer in the port's order."""
    dt, jcfg, tcfg, jp, tp, toks = models
    lengths = np.zeros(2, np.int32)
    want, js = jax_append(jp, jcfg, jnp.asarray(toks[:, :16]),
                          jax_init_state(jcfg, 2, CAP), jnp.asarray(lengths))
    got, ts = append_step(tp, tcfg, _t(toks[:, :16]),
                          init_decode_state(tcfg, 2, CAP, device="cpu"),
                          _t(lengths))
    _held(got, want, dt)
    lengths = np.array([16, 11], np.int32)
    steps = [("append", toks[:, 16:], lengths)] + \
        [("decode", toks[:, i], lengths + S - 16 + i) for i in range(2)]
    for kind, tk, ln in steps:
        ts = _bridged(js)
        if kind == "append":
            want, js = jax_append(jp, jcfg, jnp.asarray(tk), js,
                                  jnp.asarray(ln))
            got, ts = append_step(tp, tcfg, _t(tk), ts, _t(ln))
        else:
            want, js = jax_decode(jp, jcfg, jnp.asarray(tk), js,
                                  jnp.asarray(ln))
            got, ts = decode_step(tp, tcfg, _t(tk), ts, _t(ln))
            if dt == "float32":
                np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                              np.asarray(want).argmax(-1))
        _held(got, want, dt)
        joined = _bridged(js)
        for k in ("k", "v"):
            _close(ts["kv"][k], bridge.to_numpy(joined["kv"][k]), TOLS[dt])


# ---------------------------------------------------------------------------
# FullBlock bytes
# ---------------------------------------------------------------------------


def test_fullblock_bytes_match_reference():
    """A bf16 reference decode state after a real append, bridged over:
    the port's FullBlock rows equal the reference's byte for byte in
    every layer, dense and MoE alike."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 36))
    _, js = jax_append(jp, jcfg, jnp.asarray(toks, jnp.int32),
                       jax_init_state(jcfg, 2, CAP),
                       jnp.zeros((2,), jnp.int32))
    ts = _bridged(js)
    assert kvio.kv_row_bytes(tcfg) == 2 * 1 * 32 * 2
    for layer in range(tcfg.n_layers):
        bridge.assert_exact(
            kvio.serialize_kv_layer(tcfg, ts, 1, 3, 33, layer),
            jax_kvio.serialize_kv_layer(jcfg, js, 1, 3, 33, layer))
    bridge.assert_exact(kvio.serialize_kv(tcfg, ts, 0, 0, 32),
                        jax_kvio.serialize_kv(jcfg, js, 0, 0, 32))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_matches_jax_serving_system(jax_compile_cache):
    check_served_alike(*serve_both(ARCH))


def test_launcher_serves_llama4(capsys):
    serve_launcher.main(["--arch", ARCH, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 12 rounds across 4 agents (dualpath, cpu)" in out
