"""gemma2 in the port against the JAX reference (CPU, reduced gemma2-2b).

The reduced config keeps gemma2's structure at test size: 4 layers
(local, global, local, global), window 64, 4 heads over 2 KV heads x 32,
vocab 512, attention softcap 50, final softcap 30, the post-attention
and post-FFN norms, embeddings scaled by sqrt(d_model), tied embeddings.
The JAX parameters go through ``repro_torch.bridge``; inputs come from
numpy with a seed; every sequence that matters runs past the window.

* The config, field for field, and its layer kinds.
* The plain paged version with a window (the port's ``decode_attend``)
  against the reference's ``decode_attend`` at head dims 32 and 256, and
  the plain flash version with a window at head dim 256 against the
  reference's ``flash_attention_ref``, on lengths below, at and past the
  window.
* ``forward``, ``append_step`` (b = 1 chunks, then a ragged b = 2) and
  ``decode_step`` against the reference model; a decode with the window
  zeroed differs once the context passes it.
* Both packages' ``ServingSystem`` on one workload whose contexts pass
  the window: equal counters and contexts.
* The port's launcher serves gemma2.

Tolerances: test_torch_model.py's (2e-5 of the largest logit in f32,
2e-2 in bf16; kernels: 2e-5 / 2e-2 elementwise, tests/test_kernels.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro.models import init_decode_state as jax_init_state
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.serving import ServingSystem as JaxServingSystem
from repro.sim.traces import Round as JaxRound
from repro.sim.traces import Trajectory as JaxTrajectory
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (append_step, decode_step, forward,
                                init_decode_state)
from repro_torch.models import layers
from repro_torch.models.model import layer_windows
from repro_torch.serving import ServingSystem
from repro_torch.sim.traces import Round, Trajectory

# tiny CPU tensors: extra intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

jax_forward = jax.jit(jax_model.forward, static_argnums=1)
jax_decode = jax.jit(jax_model.decode_step, static_argnums=1)
jax_append = jax.jit(jax_model.append_step, static_argnums=1)

ARCH = "gemma2-2b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
WINDOW = 64                   # the reduced config's local window
S, CAP = 100, 128             # tokens per sequence, cache length


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a CPU torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x).astype(dtype)
    return j, bridge.to_torch(np.asarray(j), "cpu")


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
    assert cfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token()
    assert cfg.param_count() == jcfg.param_count()
    assert ARCH in ARCH_IDS
    # local layers get the window, global ones none (the reference's
    # BIG_WINDOW masks nothing at these lengths)
    assert layer_windows(cfg) == [cfg.local_window if k == "local_attn"
                                  else 0 for k in jcfg.layer_kinds()]


def test_full_config_is_gemma2_2b():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (26, 2304, 8, 4, 256, 9216, 256000)
    assert layer_windows(cfg)[:4] == [4096, 0, 4096, 0]
    assert cfg.param_count() == 2_614_341_888


@pytest.mark.parametrize("change,match", [
    (dict(family="moe"), "MoE"), (dict(attn_variant="mla"), "MLA"),
    (dict(family="ssm"), "SSM"), (dict(attn_variant="none"), "not ported")])
def test_other_features_still_refused(change, match):
    """Only the window's refusal went: MoE and MLA without their configs,
    SSM without its config and attention-free layers outside the SSM
    family still raise, on top of gemma2 as on any config."""
    from repro_torch.models import init_params
    from repro_torch.models.params import require_ported
    cfg = get_config(ARCH).reduced()
    require_ported(cfg)
    with pytest.raises(NotImplementedError, match=match):
        init_params(dataclasses.replace(cfg, **change), device="cpu")


# ---------------------------------------------------------------------------
# the kernels' plain versions with a window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 256])
def test_paged_window_plain_matches_decode_attend(dh, dtype):
    """The port's decode attention (the plain paged version over the
    padded cache's paged view) with a window against the reference's
    ``decode_attend``, on lengths below, at and past the window."""
    rng = np.random.default_rng(dh)
    b, hq, hkv, S_ = 7, 4, 2, 160
    qj, qt = _pair(rng, (b, 1, hq, dh), dtype)
    kj, kt = _pair(rng, (b, S_, hkv, dh), dtype)
    vj, vt = _pair(rng, (b, S_, hkv, dh), dtype)
    lengths = np.array([1, 40, WINDOW - 1, WINDOW, WINDOW + 1, 131, S_],
                       np.int32)
    kw = dict(softcap=50.0)
    want = jax_layers.decode_attend(qj, kj, vj, jnp.asarray(lengths),
                                    window=WINDOW, **kw)
    got = layers.decode_attend(qt, kt, vt, torch.from_numpy(lengths),
                               window=WINDOW, **kw)
    assert got.dtype == qt.dtype
    bridge.assert_close(got, np.asarray(want.astype(jnp.float32)),
                        TOLS[dtype])
    # the window masks: without it the rows past the window differ
    full = layers.decode_attend(qt, kt, vt, torch.from_numpy(lengths), **kw)
    past = lengths > WINDOW
    assert torch.equal(full[~past], got[~past])
    assert not torch.allclose(full[past].float(), got[past].float(),
                              atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 37, 100])
def test_flash_window_plain_matches_reference_dh256(sq, dtype):
    """The plain flash version at head dim 256 with a window and softcap
    against the reference's ``flash_attention_ref``: the queries sit at
    the end of a 150-key sequence, so their windows start inside it."""
    rng = np.random.default_rng(sq)
    b, hq, hkv, skv, dh = 2, 8, 4, 150, 256
    qj, qt = _pair(rng, (b, hq, sq, dh), dtype)
    kj, kt = _pair(rng, (b, hkv, skv, dh), dtype)
    vj, vt = _pair(rng, (b, hkv, skv, dh), dtype)
    kw = dict(causal=True, softcap=50.0, window=WINDOW)
    want = jax_ref.flash_attention_ref(qj, kj, vj, **kw)
    got = flash_attention(qt, kt, vt, **kw)
    bridge.assert_close(got, np.asarray(want.astype(jnp.float32)),
                        TOLS[dtype])


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


def test_forward_matches_jax_past_the_window(models):
    dt, jcfg, tcfg, jp, tp, toks = models
    want, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    got, _ = forward(tp, tcfg, _t(toks))
    _close(got, np.asarray(want), TOLS[dt])


def test_append_matches_jax_b1_and_ragged_b2(models):
    """b = 1 chunks across the window's edge, then a ragged b = 2 append
    whose rows start below and past the window."""
    dt, jcfg, tcfg, jp, tp, toks = models
    js = jax_init_state(jcfg, 1, CAP)
    ts = init_decode_state(tcfg, 1, CAP, device="cpu")
    off = 0
    for chunk in (40, 36, 24):
        want, js = jax_append(jp, jcfg, jnp.asarray(toks[:1, off:off + chunk]),
                              js, jnp.full((1,), off, jnp.int32))
        got, ts = append_step(tp, tcfg, _t(toks[:1, off:off + chunk]), ts,
                              torch.full((1,), off))
        _close(got, np.asarray(want), TOLS[dt])
        off += chunk
    _close(ts["kv"]["k"], js["kv"]["k"].astype(jnp.float32), TOLS[dt])
    lengths = np.array([70, 30], np.int32)
    js = jax_init_state(jcfg, 2, CAP)
    ts = init_decode_state(tcfg, 2, CAP, device="cpu")
    _, js = jax_append(jp, jcfg, jnp.asarray(toks[:, :70]), js,
                       jnp.zeros((2,), jnp.int32))
    _, ts = append_step(tp, tcfg, _t(toks[:, :70]), ts, torch.zeros(2))
    want, js = jax_append(jp, jcfg, jnp.asarray(toks[:, 70:]), js,
                          jnp.asarray(lengths))
    got, ts = append_step(tp, tcfg, _t(toks[:, 70:]), ts, _t(lengths))
    _close(got, np.asarray(want), TOLS[dt])
    _close(ts["kv"]["k"], js["kv"]["k"].astype(jnp.float32), TOLS[dt])


def _prefilled(jcfg, tcfg, jp, tp, toks, n):
    """Both packages' b = 2 states after appending ``toks[:, :n]``."""
    js = jax_init_state(jcfg, 2, CAP)
    ts = init_decode_state(tcfg, 2, CAP, device="cpu")
    _, js = jax_append(jp, jcfg, jnp.asarray(toks[:, :n]), js,
                       jnp.zeros((2,), jnp.int32))
    _, ts = append_step(tp, tcfg, _t(toks[:, :n]), ts, torch.zeros(2))
    return js, ts


def test_decode_matches_jax_across_the_window(models):
    """Decode steps whose contexts cross the window (60 -> 72 tokens),
    with the two rows at different lengths."""
    dt, jcfg, tcfg, jp, tp, toks = models
    js, ts = _prefilled(jcfg, tcfg, jp, tp, toks, 60)
    lengths = np.array([60, 57])
    for i in range(12):
        cur = toks[np.arange(2), lengths + i]
        want, js = jax_decode(jp, jcfg, jnp.asarray(cur), js,
                              jnp.asarray(lengths + i, dtype=jnp.int32))
        got, ts = decode_step(tp, tcfg, _t(cur), ts, _t(lengths + i))
        _close(got, np.asarray(want), TOLS[dt])


def test_window_is_wired(models):
    """The same decode with the window zeroed: equal logits while every
    context fits the window, different ones once a context passes it."""
    _, jcfg, tcfg, jp, tp, toks = models
    nowin = dataclasses.replace(tcfg, local_window=0)
    assert layer_windows(nowin) == [0] * tcfg.n_layers
    for n, equal in ((40, True), (90, False)):
        _, ts = _prefilled(jcfg, tcfg, jp, tp, toks, n)
        ts2 = {"kv": {k: v.clone() for k, v in ts["kv"].items()}}
        cur, lens = _t(toks[:, n]), torch.full((2,), n)
        a, _ = decode_step(tp, tcfg, cur, ts, lens)
        b, _ = decode_step(tp, nowin, cur, ts2, lens)
        assert torch.equal(a, b) == equal, n


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

COUNTERS = ("store_reads", "store_writes", "read_bytes_pe_side",
            "read_bytes_de_side", "split_reads", "trie_blocks",
            "prefill_tokens", "decode_steps", "gen_tokens")


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """A persistent XLA compilation cache in the session's temp directory
    for the reference's eager scans (test_torch_faults.py's pattern: the
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


def test_matches_jax_serving_system_past_the_window(jax_compile_cache):
    """Both ServingSystems on bridged bf16 weights, 3 agents whose
    contexts reach 116 tokens (the window is 64): equal counters and
    equal contexts."""
    rounds = [(72, 4), (16, 4), (16, 4)]
    kw = dict(n_pe=1, n_de=1, mode="dualpath", split_reads=True,
              block_tokens=16, max_seq=160, de_slots=4)
    jcfg = jax_get_config(ARCH).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jsys = JaxServingSystem(jcfg, jp, **kw)
    jses = jsys.run_offline([JaxTrajectory(i, [JaxRound(*r) for r in rounds])
                             for i in range(3)])
    cfg = get_config(ARCH).reduced()
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")
    tsys = ServingSystem(cfg, tp, device="cpu", **kw)
    tses = tsys.run_offline([Trajectory(i, [Round(*r) for r in rounds])
                             for i in range(3)])
    jst, tst = jsys.stats(), tsys.stats()
    for k in COUNTERS:
        assert tst[k] == jst[k], (k, jst[k], tst[k])
    assert tst["store_reads"] > 0 and tst["split_reads"] > 0
    ctx = [[int(t) for t in s.context] for s in jses]
    assert min(len(c) for c in ctx) == 116 > cfg.local_window
    assert [s.context for s in tses] == ctx


def test_launcher_serves_gemma2(capsys):
    serve_launcher.main(["--arch", ARCH, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 12 rounds across 4 agents (dualpath, cpu)" in out
