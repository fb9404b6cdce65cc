"""The port's MLA attention against the JAX reference (CPU, reduced ds27b).

The reduced config keeps ds27b's MLA at test size: 4 heads, latent rank
r 32, rope 16, nope 32, v 32, so queries and keys are 48 wide and values
32.  The JAX parameters go through ``repro_torch.bridge``; inputs come
from numpy with a seed.

* ``mla_latent`` / ``mla_q``, ``mla_full``, ``mla_append`` (ragged b = 2,
  expanding only up to the longest row) and the absorbed ``mla_decode``
  (through the kernel wrapper's plain version) against the reference's,
  in f32 and bf16, caches included.
* The plain flash version at q/k 48 and v 32 against the reference's
  ``layers.append_attend``, and its key-split form against the unsplit.
* The absorbed decode's plain version against the reference's einsums,
  and its key-split form (the bf16 kernel's arithmetic) against the
  unsplit; the kernel's split plan from shapes only.

Tolerances: 2e-5 in f32 and 2e-2 in bf16, of the largest value
(test_torch_model.py's).
"""
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import mla as jax_mla
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, mla_decode, ref
from repro_torch.models import mla

_mla_mod = importlib.import_module("repro_torch.kernels.mla_decode")

torch.set_num_threads(1)

ARCH = "ds27b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
S, CAP = 24, 48                           # tokens per sequence, cache length


def _close(got, want, tol):
    """|got - want| <= tol * max|want| elementwise."""
    want = np.asarray(want, np.float32)
    bridge.assert_close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def attn(request):
    """Both packages' layer-0 attention params and a (2, S, d) input."""
    dt = request.param
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    jattn = jax.tree.map(lambda a: a[0], jp["dense_blocks"]["attn"])
    x = np.random.default_rng(0).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dt)
    return (dt, jcfg, tcfg, jattn, tp["blocks"][0]["attn"], jx,
            bridge.to_torch(np.asarray(jx), "cpu"))


def test_reduced_config_widths():
    cfg = get_config(ARCH).reduced()
    m = cfg.mla
    assert (cfg.n_heads, m.kv_lora_rank, m.rope_head_dim, m.nope_head_dim,
            m.v_head_dim) == (4, 32, 16, 32, 32)
    assert cfg.head_dim == 32 != m.nope_head_dim + m.rope_head_dim


def test_latent_and_q_match_jax(attn):
    dt, jcfg, tcfg, jp, tp, jx, tx = attn
    pos = np.arange(S)
    for jfn, tfn in ((jax_mla.mla_latent, mla.mla_latent),
                     (jax_mla.mla_q, mla.mla_q)):
        want = jfn(jp, jcfg, jx, jnp.asarray(pos))
        got = tfn(tp, tcfg, tx, torch.from_numpy(pos))
        for g, w in zip(got, want):
            assert g.dtype == tx.dtype
            _close(g, np.asarray(w, np.float32), TOLS[dt])


def test_full_matches_jax(attn):
    dt, jcfg, tcfg, jp, tp, jx, tx = attn
    pos = np.arange(S)
    want, (wc, wk) = jax_mla.mla_full(jp, jcfg, jx, jnp.asarray(pos))
    got, (gc, gk) = mla.mla_full(tp, tcfg, tx, torch.from_numpy(pos))
    for g, w in ((got, want), (gc, wc), (gk, wk)):
        _close(g, np.asarray(w, np.float32), TOLS[dt])


def _caches(jcfg, tcfg, dt, b):
    m = tcfg.mla
    jc = jnp.zeros((b, CAP, m.kv_lora_rank), dt)
    jk = jnp.zeros((b, CAP, m.rope_head_dim), dt)
    tc = torch.zeros((b, CAP, m.kv_lora_rank), dtype=getattr(torch, dt))
    tk = torch.zeros((b, CAP, m.rope_head_dim), dtype=getattr(torch, dt))
    return jc, jk, tc, tk


def test_append_matches_jax_ragged(attn):
    """Two rows appended from 0, then a ragged append (rows at 20 and 7):
    the port expands only up to the longest row (``top``), the reference
    the whole padded cache; outputs and caches agree."""
    dt, jcfg, tcfg, jp, tp, jx, tx = attn
    jc, jk, tc, tk = _caches(jcfg, tcfg, dt, 2)
    want, (jc, jk) = jax_mla.mla_append(jp, jcfg, jx[:, :20], jc, jk,
                                        jnp.zeros((2,), jnp.int32))
    got = mla.mla_append(tp, tcfg, tx[:, :20], tc, tk, torch.zeros(
        2, dtype=torch.long), top=20)
    _close(got, np.asarray(want, np.float32), TOLS[dt])
    lengths = np.array([20, 7])
    want, (jc, jk) = jax_mla.mla_append(jp, jcfg, jx[:, 20:], jc, jk,
                                        jnp.asarray(lengths, jnp.int32))
    got = mla.mla_append(tp, tcfg, tx[:, 20:], tc, tk, _t(lengths),
                         top=int(lengths.max()) + S - 20)
    _close(got, np.asarray(want, np.float32), TOLS[dt])
    _close(tc, np.asarray(jc, np.float32), TOLS[dt])
    _close(tk, np.asarray(jk, np.float32), TOLS[dt])


def test_absorbed_decode_matches_jax(attn):
    dt, jcfg, tcfg, jp, tp, jx, tx = attn
    jc, jk, tc, tk = _caches(jcfg, tcfg, dt, 2)
    _, (jc, jk) = jax_mla.mla_append(jp, jcfg, jx[:, :20], jc, jk,
                                     jnp.zeros((2,), jnp.int32))
    mla.mla_append(tp, tcfg, tx[:, :20], tc, tk,
                   torch.zeros(2, dtype=torch.long), top=20)
    lengths = np.array([20, 13])         # the new token sits at lengths - 1
    before = mla_decode.launches
    want = jax_mla.mla_decode(jp, jcfg, jx[:, 20:21], jc, jk,
                              jnp.asarray(lengths, jnp.int32))
    got = mla.mla_decode(tp, tcfg, tx[:, 20:21], tc, tk, _t(lengths))
    assert mla_decode.launches == before       # CPU tensors never count
    assert got.shape == (2, 1, tcfg.d_model) and got.dtype == tx.dtype
    _close(got, np.asarray(want, np.float32), TOLS[dt])


def _flash_inputs(rng, b, hq, sq, S_, dk, dv, dtype):
    f = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32)
                               ).astype(dtype)
    return f(b, sq, hq, dk), f(b, S_, hq, dk), f(b, S_, hq, dv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_48_32_matches_append_attend(dtype):
    """The flash plain version at q/k 48 and v 32 (the reduced MLA
    append) against the reference's ``append_attend`` scaled by
    1/sqrt(48), on a ragged append."""
    rng = np.random.default_rng(3)
    q, k, v = _flash_inputs(rng, 2, 4, 9, 40, 48, 32, dtype)
    lengths = np.array([20, 31], np.int32)
    want = jax_layers.append_attend(q, k, v, jnp.asarray(lengths),
                                    scale=1.0 / math.sqrt(48))
    tq, tk, tv = (bridge.to_torch(np.asarray(a), "cpu") for a in (q, k, v))
    got = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), causal=True,
                          kv_lens=torch.from_numpy(lengths + 9))
    assert got.shape == (2, 4, 9, 32)
    _close(got.transpose(1, 2), np.asarray(want, np.float32), TOLS[dtype])


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_flash_split_ref_with_unequal_widths(chunk):
    rng = np.random.default_rng(chunk)
    q, k, v = (bridge.to_torch(np.asarray(a), "cpu").transpose(1, 2)
               for a in _flash_inputs(rng, 2, 4, 5, 40, 48, 32, "float32"))
    lens = torch.tensor([17, 40], dtype=torch.int32)
    want = ref.flash_attention_ref(q, k, v, kv_lens=lens)
    got = ref.flash_attention_split_ref(q, k, v, chunk=chunk, kv_lens=lens)
    _close(got, want.numpy(), TOLS["float32"])


def _latent_inputs(rng, b, h, r, rd, S_, dtype):
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    return f(b, h, r), f(b, h, rd), f(b, S_, r), f(b, S_, rd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plain_matches_reference_einsums(dtype):
    """``mla_decode_ref`` against the reference's absorbed einsums
    between q_lat and o_lat (``mla.py:120-131``), written out in jnp."""
    rng = np.random.default_rng(7)
    ql, qr, c, kr = _latent_inputs(rng, 3, 4, 32, 16, 40, dtype)
    lengths = np.array([1, 17, 40], np.int32)
    scale = 1.0 / math.sqrt(48)
    j = [jnp.asarray(bridge.to_numpy(t)).astype(
        "bfloat16" if dtype == torch.bfloat16 else "float32")
        for t in (ql, qr, c, kr)]
    s = (jnp.einsum("bhr,bsr->bhs", j[0], j[2]) +
         jnp.einsum("bhd,bsd->bhs", j[1], j[3])).astype(jnp.float32) * scale
    mask = jnp.arange(40)[None, :] < jnp.asarray(lengths)[:, None]
    p = jax.nn.softmax(s + jnp.where(mask, 0.0, -1e30)[:, None, :], axis=-1)
    want = jnp.einsum("bhs,bsr->bhr", p.astype(j[2].dtype), j[2])
    got = mla_decode(ql, qr, c, kr, torch.from_numpy(lengths), scale=scale)
    assert got.dtype == dtype
    _close(got, np.asarray(want, np.float32),
           TOLS["bfloat16" if dtype == torch.bfloat16 else "float32"])


@pytest.mark.parametrize("chunk", [32, 64, 96])
def test_decode_split_ref_matches_unsplit(chunk):
    """The bf16 kernel's arithmetic (partials per key range, then the
    merge) against the unsplit plain version, on lengths at the edges of
    the ranges and of the cache."""
    rng = np.random.default_rng(chunk)
    ql, qr, c, kr = _latent_inputs(rng, 6, 4, 32, 16, 192, torch.float32)
    lengths = torch.tensor([1, 31, 32, 33, 100, 192], dtype=torch.int32)
    want = ref.mla_decode_ref(ql, qr, c, kr, lengths, scale=0.1)
    got = ref.mla_decode_split_ref(ql, qr, c, kr, lengths, scale=0.1,
                                   chunk=chunk)
    _close(got, want.numpy(), TOLS["float32"])


def test_decode_plan_covers_every_key_once():
    """The split plan, from shapes only: ds27b's 8 slots over a 6144-token
    cache make about one block per SM (the kernel fits one an SM, and
    its last split of a row merges the row's partials, so fewer splits
    mean fewer partial bytes): 16 splits of 384 keys; f32 never splits;
    every key position falls in exactly one split."""
    plan = _mla_mod.plan
    assert plan(8, 6144, 132) == (16, 384)
    assert plan(8, 6144, 132, bf16=False) == (1, 6144)
    for b, s_max in ((1, 64), (8, 6144), (3, 100), (16, 4096)):
        n_split, chunk = plan(b, s_max, 132)
        assert chunk % _mla_mod.KEY_TILE == 0
        assert (n_split - 1) * chunk < s_max <= n_split * chunk
        assert n_split * b <= 132 + b      # about one block per SM


@pytest.mark.parametrize("lengths", [[1, 383, 384, 385, 4600, 5040, 6143,
                                      6144],
                                     [6144, 1, 2, 3, 5, 8, 13, 64]])
def test_decode_split_ref_at_the_plan_matches_unsplit(lengths):
    """The bf16 kernel's arithmetic at the plan's own cut of ds27b's
    cache (8 slots of 6144 positions on 132 SMs: 16 splits of 384 keys;
    narrow heads keep it quick) against the unsplit plain version:
    lengths at the splits' edges and the phase's, and one row at the
    cache's end with seven short ones (their other splits hold no key)."""
    rng = np.random.default_rng(lengths[1])
    n_split, chunk = _mla_mod.plan(8, 6144, 132)
    assert (n_split, chunk) == (16, 384)
    ql, qr, c, kr = _latent_inputs(rng, 8, 4, 32, 16, 6144, torch.float32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    want = ref.mla_decode_ref(ql, qr, c, kr, lens, scale=0.1)
    got = ref.mla_decode_split_ref(ql, qr, c, kr, lens, scale=0.1,
                                   chunk=chunk)
    _close(got, want.numpy(), TOLS["float32"])


def test_decode_wrapper_rejects_mismatched_shapes():
    ql, qr, c, kr = _latent_inputs(np.random.default_rng(0), 2, 4, 32, 16,
                                   8, torch.float32)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    with pytest.raises(ValueError):
        mla_decode(ql, qr[:, :, :8], c, kr, lens, scale=1.0)
    with pytest.raises(ValueError):
        mla_decode(ql, qr, c, kr, lens[:1], scale=1.0)
