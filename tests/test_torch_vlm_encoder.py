"""llava-next-34b (the VLM connector) and hubert-xlarge (the encoder) in
the port against the JAX reference (CPU, reduced configs), with the time
models of the last three registered architectures.

Both configs carry a stubbed modality frontend: the model takes
precomputed patch (llava) or frame (hubert) embeddings (b, s,
frontend_embed_dim), cast to the embedding dtype and projected by the
connector ``embed["frontend_proj"]``.  llava's backbone is a GQA decoder
(56 heads over 8 of 128; reduced 4 over 1 of 32) served by token ids
through the FullBlock path; hubert's is a bidirectional encoder (16 MHA
heads of 80, GELU; reduced 4 over 4 of 32) with no decode step.

* Each config equals the reference's field for field, with its analytic
  parameter counts at full width.
* llava: ``forward`` over token ids and over float embeddings (b, s, 128)
  from a numpy seed; ``append_step`` with embeddings, then with token ids
  against the carried state; ``decode_step`` -- logits and caches against
  the reference's, f32 and bf16.  Both ServingSystems on a reduced f32
  run (dualpath, 1 PE + 1 DE, 16-token FullBlocks, split reads, 3 agents
  over three rounds): equal tokens and ``stats()``, the same FullBlock
  refs with values within 2e-2 of each block's largest, layer 0 equal in
  over 99 % (the reference's FullBlock holds 2-byte KV, so both keep a
  bf16 cache, which the two frameworks' f32 K/V round to differently in
  a few values; tests/test_torch_llama4.py says more).  The launcher
  serves it.
* hubert: ``forward`` over frame embeddings, f32 and bf16; moving the
  last frame moves the first frame's logits (the reference's
  test_encoder_bidirectional); ``decode_step``, ``append_step``,
  ``init_decode_state`` and ``ServingSystem`` raise.
* The chunk packer's attention FLOPs, the FullBlock layout, the
  simulator's model spec and the attention time model equal the
  reference's for llama4, llava and hubert, full and reduced.

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
from repro.core import blocks as jax_blocks
from repro.core import intra as jax_intra
from repro.models import init_decode_state as jax_init_state
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.sim.spec import ModelSimSpec as JaxModelSimSpec
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import blocks, intra
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (append_step, decode_step, forward,
                                init_decode_state, init_params)
from repro_torch.models.params import require_ported
from repro_torch.serving import ServingSystem
from repro_torch.sim.spec import ModelSimSpec
from _torch_served import (  # noqa: F401 (a fixture)
    check_served_alike, jax_compile_cache, serve_both)

torch.set_num_threads(1)

jax_forward = jax.jit(jax_model.forward, static_argnums=1)
jax_decode = jax.jit(jax_model.decode_step, static_argnums=1)
jax_append = jax.jit(jax_model.append_step, static_argnums=1)

LLAVA, HUBERT = "llava-next-34b", "hubert-xlarge"
LLAMA4 = "llama4-maverick-400b-a17b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
S, CAP = 24, 48
DTYPES = ("float32", "bfloat16")


def _close(got, want, tol):
    """|got - want| <= tol * max|want| elementwise (test_torch_model.py)."""
    want = np.asarray(want, np.float32)
    bridge.assert_close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def _pair(arch, dt):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jp, tp


def _embeddings(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.frontend_embed_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and time models
# ---------------------------------------------------------------------------

COUNTS = {LLAVA: 34_440_297_472, HUBERT: 946_771_200}


@pytest.mark.parametrize("arch", [LLAVA, HUBERT])
def test_config_and_full_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert arch in ARCH_IDS
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.param_count() == jcfg.param_count() == COUNTS[arch]
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token()
    assert cfg.reduced().param_count() == jcfg.reduced().param_count()
    require_ported(cfg)
    # the connector is the only leaf outside the blocks a frontend adds
    no_frontend = dataclasses.replace(cfg, frontend_embed_dim=0)
    assert cfg.param_count() - no_frontend.param_count() == \
        cfg.frontend_embed_dim * cfg.d_model


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", [LLAMA4, LLAVA, HUBERT])
def test_time_models_match_reference(arch, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for c, b in ((0, 4096), (4096, 400), (17, 1)):
        assert intra.attn_flops_per_layer(cfg, c, b) == \
            jax_intra.attn_flops_per_layer(jcfg, c, b)
    items = [(0, 4096), (4015, 301)]
    assert intra.attn_flops(cfg, items) == jax_intra.attn_flops(jcfg, items)
    for bt, itemsize in ((16, 2), (64, 2)):
        assert blocks.layout_for(cfg, bt, itemsize).full_block_shape() == \
            jax_blocks.layout_for(jcfg, bt, itemsize).full_block_shape()
    assert dataclasses.asdict(ModelSimSpec.from_config(cfg)) == \
        dataclasses.asdict(JaxModelSimSpec.from_config(jcfg))
    assert dataclasses.asdict(intra.AttnTimeModel.from_config(cfg)) == \
        dataclasses.asdict(jax_intra.AttnTimeModel.from_config(jcfg))


# ---------------------------------------------------------------------------
# llava: the VLM connector
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=DTYPES)
def llava(request):
    return (request.param,) + _pair(LLAVA, request.param)


def test_llava_forward_over_ids_and_embeddings(llava):
    dt, jcfg, tcfg, jp, tp = llava
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, S)).astype(np.int32)
    emb = _embeddings(tcfg, 2, S)
    assert "frontend_proj" in tp["embed"]
    assert tuple(tp["embed"]["frontend_proj"].shape) == \
        (tcfg.frontend_embed_dim, tcfg.d_model)
    for x, tx in ((toks, _t(toks)), (emb, torch.from_numpy(emb))):
        want, _ = jax_forward(jp, jcfg, jnp.asarray(x))
        got, _ = forward(tp, tcfg, tx)
        assert got.shape == (2, S, tcfg.vocab_size)
        _close(got, want, TOLS[dt])


def test_llava_append_embeddings_then_ids_then_decode(llava):
    """An image's patch embeddings appended from empty caches, then a
    text append by token ids and two decode steps, each from the
    reference's state bridged over; the caches they write equal the
    reference's."""
    dt, jcfg, tcfg, jp, tp = llava
    emb = _embeddings(tcfg, 2, 16)
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    lengths = np.zeros(2, np.int32)
    want, js = jax_append(jp, jcfg, jnp.asarray(emb),
                          jax_init_state(jcfg, 2, CAP), jnp.asarray(lengths))
    got, ts = append_step(tp, tcfg, torch.from_numpy(emb),
                          init_decode_state(tcfg, 2, CAP, device="cpu"),
                          _t(lengths))
    _close(got, want, TOLS[dt])
    lengths = np.array([16, 11], np.int32)
    steps = [("append", toks, lengths)] + \
        [("decode", toks[:, i], lengths + 8 + i) for i in range(2)]
    for kind, tk, ln in steps:
        ts = bridge.state_from_jax(jax.tree.map(np.asarray, js), "cpu")
        step, jstep = (append_step, jax_append) if kind == "append" else \
            (decode_step, jax_decode)
        want, js = jstep(jp, jcfg, jnp.asarray(tk), js, jnp.asarray(ln))
        got, ts = step(tp, tcfg, _t(tk), ts, _t(ln))
        _close(got, want, TOLS[dt])
        if kind == "decode" and dt == "float32":
            np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                          np.asarray(want).argmax(-1))
        joined = bridge.state_from_jax(jax.tree.map(np.asarray, js), "cpu")
        for k in ("k", "v"):
            _close(ts["kv"][k], bridge.to_numpy(joined["kv"][k]), TOLS[dt])


def test_llava_embeddings_need_a_frontend():
    """Float embeddings given to a model without a connector raise."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = init_params(cfg, device="cpu")
    assert "frontend_proj" not in params["embed"]
    with pytest.raises(ValueError, match="frontend"):
        forward(params, cfg, torch.zeros(1, 4, cfg.d_model))


# serving, as tests/test_torch_llama4.py serves llama4


def test_llava_matches_jax_serving_system(jax_compile_cache):
    check_served_alike(*serve_both(LLAVA))


def test_launcher_serves_llava(capsys):
    serve_launcher.main(["--arch", LLAVA, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 12 rounds across 4 agents (dualpath, cpu)" in out


# ---------------------------------------------------------------------------
# hubert: the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
def test_hubert_forward_over_frames(dt):
    jcfg, tcfg, jp, tp = _pair(HUBERT, dt)
    assert not tcfg.causal and tcfg.family == "encoder"
    frames = _embeddings(tcfg, 2, S)
    want, _ = jax_forward(jp, jcfg, jnp.asarray(frames))
    got, _ = forward(tp, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, S, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, TOLS[dt])


def test_hubert_is_bidirectional():
    """Moving the last frame moves the first frame's logits (the
    reference's test_encoder_bidirectional), and a causal copy of the
    same model does not."""
    cfg = get_config(HUBERT).reduced()
    params = init_params(cfg, device="cpu")
    x = torch.from_numpy(_embeddings(cfg, 1, 8))
    x2 = x.clone()
    x2[:, -1] += 1.0
    l1, _ = forward(params, cfg, x)
    l2, _ = forward(params, cfg, x2)
    assert (l1[:, 0] - l2[:, 0]).abs().max() > 0, \
        "encoder is unexpectedly causal"
    causal = dataclasses.replace(cfg, causal=True)
    l1, _ = forward(params, causal, x)
    l2, _ = forward(params, causal, x2)
    assert torch.equal(l1[:, :-1], l2[:, :-1])


@pytest.mark.parametrize("entry", ["init_decode_state", "decode_step",
                                   "append_step", "ServingSystem"])
def test_hubert_has_no_decode(entry):
    cfg = get_config(HUBERT).reduced()
    params = init_params(cfg, device="cpu")
    dcfg = dataclasses.replace(cfg, family="dense", supports_decode=True,
                               causal=True)
    state = init_decode_state(dcfg, 1, 16, device="cpu")
    lengths = torch.zeros(1, dtype=torch.long)
    calls = {
        "init_decode_state": lambda: init_decode_state(cfg, 1, 16, "cpu"),
        "decode_step": lambda: decode_step(
            params, cfg, torch.zeros(1, dtype=torch.long), state, lengths),
        "append_step": lambda: append_step(
            params, cfg, torch.from_numpy(_embeddings(cfg, 1, 4)), state,
            lengths),
        "ServingSystem": lambda: ServingSystem(cfg, params, device="cpu"),
    }
    with pytest.raises(ValueError, match="supports_decode"):
        calls[entry]()
