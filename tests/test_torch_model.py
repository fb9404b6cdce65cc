"""The port's dense model against the JAX reference on bridged weights.

The JAX parameters (``init_params``) go through ``repro_torch.bridge``;
token ids come from numpy with a seed.  The JAX model runs its jnp
attention, the port (on the CPU) the plain versions of its kernels.

Tolerances are relative to the largest logit, which reaches ~90 (the
tied embedding is drawn with std 1): the error of a logit is a sum over
d_model products, so it scales with the logits' magnitude, not with the
one entry's.  float32 2e-5 (XLA and PyTorch sum matmuls and softmax in
different orders); bfloat16 2e-2, about two bf16 ulps of the largest
logit (the two frameworks round bf16 intermediates at different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_decode_state as jax_init_state
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import (append_step, decode_step, forward,
                                init_decode_state)

# tiny CPU tensors: extra intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

# the reference's functions, jitted (the config is static)
jax_forward = jax.jit(jax_model.forward, static_argnums=1)
jax_decode = jax.jit(jax_model.decode_step, static_argnums=1)
jax_append = jax.jit(jax_model.append_step, static_argnums=1)

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
B, S, CAP = 2, 12, 24


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jcfg = dataclasses.replace(jax_get_config("qwen1.5-0.5b").reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    tcfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return dt, jcfg, tcfg, jp, tp, toks


def _close(got, want, tol):
    """|got - want| <= tol * max|want| elementwise (see the docstring)."""
    want = np.asarray(want, np.float32)
    bridge.assert_close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def test_bridge_unstacks_every_leaf(models):
    _, jcfg, tcfg, jp, tp, _ = models
    assert len(tp["blocks"]) == tcfg.n_layers
    for li in (0, tcfg.n_layers - 1):
        bridge.assert_exact(tp["blocks"][li]["attn"]["wq"],
                            np.asarray(jp["blocks"]["attn"]["wq"][li]
                                       ).astype(np.float32))


def test_forward_matches_jax(models):
    dt, jcfg, tcfg, jp, tp, toks = models
    want, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    got, _ = forward(tp, tcfg, _t(toks))
    _close(got, np.asarray(want), TOLS[dt])


def test_append_matches_jax_b1_and_ragged_b2(models):
    """b=1 chunks as the PE runs them, then a ragged b=2 append whose
    rows sit at different cached lengths."""
    dt, jcfg, tcfg, jp, tp, toks = models
    js = jax_init_state(jcfg, 1, CAP)
    ts = init_decode_state(tcfg, 1, CAP, device="cpu")
    off = 0
    for chunk in (5, 4, 3):
        want, js = jax_append(jp, jcfg, jnp.asarray(toks[:1, off:off + chunk]),
                              js, jnp.full((1,), off, jnp.int32))
        got, ts = append_step(tp, tcfg, _t(toks[:1, off:off + chunk]), ts,
                              torch.full((1,), off))
        _close(got, np.asarray(want), TOLS[dt])
        off += chunk
    lengths = np.array([3, 7], np.int32)
    js = jax_init_state(jcfg, B, CAP)
    ts = init_decode_state(tcfg, B, CAP, device="cpu")
    _, js = jax_append(jp, jcfg, jnp.asarray(toks[:, :8]), js,
                       jnp.zeros((B,), jnp.int32))
    _, ts = append_step(tp, tcfg, _t(toks[:, :8]), ts, torch.zeros(B))
    want, js = jax_append(jp, jcfg, jnp.asarray(toks[:, 8:]), js,
                          jnp.asarray(lengths))
    got, ts = append_step(tp, tcfg, _t(toks[:, 8:]), ts, _t(lengths))
    _close(got, np.asarray(want), TOLS[dt])
    _close(ts["kv"]["k"], js["kv"]["k"].astype(jnp.float32), TOLS[dt])


def test_decode_matches_jax(models):
    dt, jcfg, tcfg, jp, tp, toks = models
    js = jax_init_state(jcfg, B, CAP)
    ts = init_decode_state(tcfg, B, CAP, device="cpu")
    for i in range(S):
        want, js = jax_decode(jp, jcfg, jnp.asarray(toks[:, i]), js,
                              jnp.full((B,), i, jnp.int32))
        got, ts = decode_step(tp, tcfg, _t(toks[:, i]), ts,
                              torch.full((B,), i))
        _close(got, np.asarray(want), TOLS[dt])


def test_append_and_decode_match_forward_within_port(models):
    """The port's own oracle (tests/test_models.py:64-100): chunked
    append and token-by-token decode reproduce the full forward.  In
    bf16 exactly; in f32 within 2e-5 of the largest logit, because PyTorch's CPU matmul picks
    its blocking by shape, so a row's sums change order with the batch."""
    dt, _, tcfg, _, tp, toks = models
    full, _ = forward(tp, tcfg, _t(toks))
    tol = 0.0 if dt == "bfloat16" else TOLS[dt]
    ts = init_decode_state(tcfg, B, CAP, device="cpu")
    off = 0
    for chunk in (5, 4, 3):
        lg, ts = append_step(tp, tcfg, _t(toks[:, off:off + chunk]), ts,
                             torch.full((B,), off))
        _close(lg, bridge.to_numpy(full[:, off:off + chunk]), tol)
        off += chunk
    ts = init_decode_state(tcfg, B, CAP, device="cpu")
    for i in range(S):
        lg, ts = decode_step(tp, tcfg, _t(toks[:, i]), ts,
                             torch.full((B,), i))
        _close(lg, bridge.to_numpy(full[:, i]), tol)


def test_writes_past_the_cache_raise():
    cfg = get_config("qwen1.5-0.5b").reduced()
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, device="cpu")
    st = init_decode_state(cfg, 1, 8, device="cpu")
    with pytest.raises(IndexError):
        append_step(params, cfg, torch.zeros((1, 3), dtype=torch.long), st,
                    torch.tensor([6]))
    with pytest.raises(IndexError):
        decode_step(params, cfg, torch.zeros(1, dtype=torch.long), st,
                    torch.tensor([8]))
