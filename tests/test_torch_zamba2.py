"""zamba2 in the port against the JAX reference (CPU, reduced zamba2-2.7b).

The reduced config keeps the hybrid's structure at test size: 4 Mamba2
layers (d_model 128, d_inner 256 in 16 SSD heads of 16, d_state 16,
chunks of 32, conv width 4) and one shared attention block (MHA 4 x 32,
d_ff 256) after every 2nd layer, 2 applications, each with its own K/V;
tied embeddings.  The same model also runs at head dim 80 (zamba2's
width, through ``dataclasses.replace``), so the plain flash and paged
versions see dh 80.  The JAX parameters go through
``repro_torch.bridge``; inputs come from numpy with a seed.  The port
runs on the CPU, so every kernel wrapper computes its plain version.

* The config, its full-size counts and its reduction equal the
  reference's; the port's ``attn_flops`` counts the shared block's 9
  applications (2 reduced) as the reference does.
* The model: ``forward`` (logits, the Mamba2 states and the shared
  block's K/V per application), ``append_step`` from zeros and from a
  carried state (unchunked and in slices) and ``decode_step`` after it,
  against the reference, in f32 and bf16, at head dim 32 and 80.
* The bridged state, the slot utilities, the blob (the Mamba2 leaves and
  the shared K/V padded to ``max_seq``, byte for byte the reference
  state's leaves, and back) and the attention-row enumeration.
* The plain SSD scan at zamba2's N 64 (and P 64) inside a Mamba2 layer
  against the reference's ``ssd_scan``; the decode step's wrapper at N 64
  over three consecutive steps from one carried state (every tail in
  place) against the reference's ``ssm_decode_step``.  The launcher
  serves zamba2.

Tolerances: logits and states 2e-5 of the largest value in f32, 2e-2 in
bf16 (test_torch_model.py's).
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
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import intra
from repro_torch.engines import kvio
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (append_step, decode_step, forward,
                                init_decode_state, ssm)

torch.set_num_threads(1)

jax_forward = jax.jit(jax_model.forward, static_argnums=1,
                      static_argnames="return_state")
jax_decode = jax.jit(jax_model.decode_step, static_argnums=1)
jax_append = jax.jit(jax_model.append_step, static_argnums=1)
jax_scan = jax.jit(jax_ssm.ssd_scan, static_argnums=1)
jax_step = jax.jit(jax_ssm.ssm_decode_step, static_argnums=1)

ARCH = "zamba2-2.7b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
S = 96                                  # the decode state's max_seq


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|) elementwise."""
    if isinstance(want, torch.Tensor):
        want = bridge.to_numpy(want)
    want = np.asarray(want, np.float32)
    bridge.assert_close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _cfgs(dt, head_dim=None, ssm_kw=None):
    """The reduced config in both packages, in ``dt``, at ``head_dim``
    (the reduced 32 by default) and with the SSM fields ``ssm_kw``."""
    out = []
    for cfg in (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()):
        kw = dict(param_dtype=dt, kv_cache_dtype=dt)
        if head_dim:
            kw["head_dim"] = head_dim
        if ssm_kw:
            kw["ssm"] = dataclasses.replace(cfg.ssm, **ssm_kw)
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module",
                params=[(d, h) for h in (32, 80)
                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-dh{p[1]}")
def models(request):
    dt, dh = request.param
    jcfg, tcfg = _cfgs(dt, dh)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(_np(jp), tcfg, device="cpu")
    return dt, jcfg, tcfg, jp, tp


def _close_state(got, want_np, tol):
    """The port's state against the reference's bridged one: every
    Mamba2 leaf and the shared K/V."""
    want = bridge.state_from_jax(want_np, "cpu")
    assert set(got) == set(want) == {"mamba", "shared"}
    for g, leaves in want.items():
        for k, v in leaves.items():
            _close(got[g][k], v, tol)


# ---------------------------------------------------------------------------
# the config and the cost model
# ---------------------------------------------------------------------------


def test_config_and_full_counts_match_reference():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert ARCH in ARCH_IDS
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.kv_bytes_per_token() == jcfg.kv_bytes_per_token() == \
        9 * 2 * 32 * 80 * 2
    assert cfg.ssm_state_bytes() == jcfg.ssm_state_bytes()
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert kvio.n_attn_layers(cfg) == jax_kvio.n_attn_layers(jcfg) == 9
    assert kvio._kv_rows(cfg) == jax_kvio._kv_rows(jcfg)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_attn_flops_counts_the_shared_applications(reduced):
    """The packer's and the clock's cost: the shared block once per
    application (9 at full size, 2 reduced), as the reference counts it;
    before the repair the port counted one attention layer."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    items = [(0, 4000), (4016, 301), (4332, 501), (100, 1)]
    assert intra.attn_flops(cfg, items) == jax_intra.attn_flops(jcfg, items)
    apps = cfg.n_layers // cfg.hybrid_period
    per_layer = sum(intra.attn_flops_per_layer(cfg, c, b) for c, b in items)
    assert intra.attn_flops(cfg, items) == apps * per_layer > 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_matches_jax(models):
    """Logits, the Mamba2 states and each application's exact-length
    K/V."""
    dt, jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(0).integers(
        2, tcfg.vocab_size, (2, 45)).astype(np.int32)
    jl, jst = jax_forward(jp, jcfg, jnp.asarray(toks), return_state=True)
    tl, tst = forward(tp, tcfg, _t(toks), return_state=True)
    _close(tl, jl, TOLS[dt])
    _close_state(tst, _np(jst), TOLS[dt])
    n_apps = tcfg.n_layers // tcfg.hybrid_period
    assert tst["shared"]["k"].shape == (n_apps, 2, 45, tcfg.n_kv_heads,
                                        tcfg.head_dim)


@pytest.mark.parametrize("slices", [(45,), (20, 13, 12)],
                         ids=["unchunked", "slices"])
def test_append_then_decode_match_jax(models, slices):
    """A 45-token prefill from zeros (the reference's in one append; the
    port's unchunked or in slices), a 37-token append from that carried
    state, then a decode step: logits and the whole state (Mamba2 and
    the shared K/V, padded to S) against the reference."""
    dt, jcfg, tcfg, jp, tp = models
    tol = TOLS[dt]
    rng = np.random.default_rng(1)
    b = 2
    pre = rng.integers(2, tcfg.vocab_size, (b, 45)).astype(np.int32)
    app = rng.integers(2, tcfg.vocab_size, (b, 37)).astype(np.int32)
    nxt = rng.integers(2, tcfg.vocab_size, (b,)).astype(np.int32)
    jst = jax_model.init_decode_state(jcfg, b, S)
    jl1, jst = jax_append(jp, jcfg, jnp.asarray(pre), jst,
                          jnp.zeros(b, jnp.int32))
    state = init_decode_state(tcfg, b, S, "cpu")
    got, n = [], 0
    for k in slices:
        lg, out = append_step(tp, tcfg, _t(pre[:, n:n + k]), state,
                              torch.full((b,), n))
        assert out is state                      # updated in place
        got.append(lg)
        n += k
    _close(torch.cat(got, dim=1), jl1, tol)
    _close_state(state, _np(jst), tol)
    lengths = np.full(b, 45, np.int32)
    jl2, jst = jax_append(jp, jcfg, jnp.asarray(app), jst,
                          jnp.asarray(lengths))
    tl2, _ = append_step(tp, tcfg, _t(app), state, _t(lengths))
    _close(tl2, jl2, tol)
    jl3, jst = jax_decode(jp, jcfg, jnp.asarray(nxt), jst,
                          jnp.asarray(lengths + 37))
    tl3, _ = decode_step(tp, tcfg, _t(nxt), state, _t(lengths + 37))
    _close(tl3, jl3, tol)
    _close_state(state, _np(jst), tol)
    if dt == "float32":
        assert (np.argmax(np.asarray(jl3), -1) ==
                bridge.to_numpy(tl3).argmax(-1)).all()


def test_append_from_the_bridged_reference_state(models):
    """The port continues from the reference's own state (its (n_super,
    period) stacks flattened by the bridge), with ragged lengths."""
    dt, jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(2)
    b = 2
    pre = rng.integers(2, tcfg.vocab_size, (b, 30)).astype(np.int32)
    app = rng.integers(2, tcfg.vocab_size, (b, 9)).astype(np.int32)
    jst = jax_model.init_decode_state(jcfg, b, S)
    _, jst = jax_append(jp, jcfg, jnp.asarray(pre), jst,
                        jnp.zeros(b, jnp.int32))
    state = bridge.state_from_jax(_np(jst), "cpu")
    lengths = np.array([30, 21], np.int32)
    jl, jst2 = jax_append(jp, jcfg, jnp.asarray(app), jst,
                          jnp.asarray(lengths))
    tl, _ = append_step(tp, tcfg, _t(app), state, _t(lengths))
    _close(tl, jl, TOLS[dt])
    _close_state(state, _np(jst2), TOLS[dt])


def test_writes_past_the_cache_raise(models):
    """The shared block's K/V are the hybrid's one per-token part: an
    append or a decode past ``max_seq`` raises (JAX would drop it)."""
    _, _, tcfg, _, tp = models
    state = init_decode_state(tcfg, 1, 16, "cpu")
    with pytest.raises(IndexError, match="past the cache"):
        append_step(tp, tcfg, torch.full((1, 5), 3), state,
                    torch.tensor([12]))
    with pytest.raises(IndexError, match="past the cache"):
        decode_step(tp, tcfg, torch.tensor([3]), state, torch.tensor([16]))


# ---------------------------------------------------------------------------
# the state, its blob and the attention rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_bridged_state_is_the_ports_layout(dt):
    jcfg, tcfg = _cfgs(dt)
    jst = jax_model.init_decode_state(jcfg, 3, 16)
    got = bridge.state_from_jax(_np(jst), "cpu")
    want = init_decode_state(tcfg, 3, 16, "cpu")
    assert set(got) == set(want) == {"mamba", "shared"}
    for g in want:
        for k, v in want[g].items():
            assert got[g][k].shape == v.shape, (g, k)
            assert got[g][k].dtype == v.dtype, (g, k)
            assert v.shape[1] == 3
    assert want["mamba"]["ssm"].shape[0] == tcfg.n_layers
    assert want["shared"]["k"].shape == (2, 3, 16, tcfg.n_kv_heads,
                                         tcfg.head_dim)
    assert kvio.batch_axes_of_state(tcfg) == {
        "mamba": {k: 1 for k in kvio.BLOB_LEAVES},
        "shared": {"k": 1, "v": 1}}


def test_slot_get_set_on_the_hybrid_state():
    _, tcfg = _cfgs("bfloat16")
    rng = np.random.default_rng(5)
    state = init_decode_state(tcfg, 4, 16, "cpu")
    for g in state.values():
        for v in g.values():
            v.copy_(torch.from_numpy(rng.standard_normal(v.shape)))
    axes = kvio.batch_axes_of_state(tcfg)
    one = kvio.slot_get(state, axes, 2)
    other = init_decode_state(tcfg, 4, 16, "cpu")
    kvio.slot_set(other, axes, 1, one)
    for g, leaves in state.items():
        for k, v in leaves.items():
            assert torch.equal(other[g][k][:, 1], v[:, 2]), (g, k)
            assert not other[g][k][:, 0].any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_blob_is_the_states_bytes_and_round_trips(dt):
    """The blob holds the reference state's Mamba2 leaves in
    ``BLOB_LEAVES`` order, then the shared ``k`` and ``v`` padded to
    ``max_seq``, byte for byte, end to end; decoding it at the same
    ``max_seq`` gives the state back, and its length is the payload of
    the reference's pickle of the slot.  Another ``max_seq`` raises."""
    jcfg, tcfg = _cfgs(dt)
    rng = np.random.default_rng(11)
    jst = jax_model.init_decode_state(jcfg, 1, 16)
    jst = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), jst)
    np_st = _np(jst)
    state = bridge.state_from_jax(np_st, "cpu")
    blob = kvio.state_to_blob(state)
    want = b"".join([np_st["mamba"][k].tobytes() for k in kvio.BLOB_LEAVES] +
                    [np_st["shared"][k].tobytes() for k in ("k", "v")])
    assert blob.dtype == np.uint8 and blob.ndim == 1
    assert blob.tobytes() == want
    assert len(blob) == sum(a.nbytes for a in jax.tree.leaves(np_st))
    back = kvio.blob_to_state(tcfg, blob, "cpu", max_seq=16)
    for g, leaves in state.items():
        for k, v in leaves.items():
            bridge.assert_exact(back[g][k], v)
    assert kvio.state_to_blob(back).tobytes() == want
    with pytest.raises(ValueError, match="blob"):
        kvio.blob_to_state(tcfg, blob, "cpu", max_seq=32)
    with pytest.raises(ValueError, match="blob"):
        kvio.blob_to_state(tcfg, blob[:-2], "cpu", max_seq=16)


def test_blob_bytes_at_full_size():
    """One session's blob at zamba2-2.7b's widths and a 5120-token cache:
    54 layers' f32 states and bf16 conv tails, then 2 x 9 applications
    of 5120 x 32 x 80 bf16 K/V, from the meta state."""
    cfg = get_config(ARCH)
    st = init_decode_state(cfg, 1, 5120, "meta")
    d_inner = cfg.ssm.expand * cfg.d_model
    n_ch = d_inner + 2 * cfg.ssm.d_state
    mamba = cfg.n_layers * (d_inner * cfg.ssm.d_state * 4 +
                            (cfg.ssm.conv_width - 1) * n_ch * 2)
    shared = 2 * (cfg.n_layers // cfg.hybrid_period) * 5120 * \
        cfg.n_kv_heads * cfg.head_dim * 2
    got = sum(v.numel() * v.element_size()
              for g in st.values() for v in g.values())
    assert (n_ch, mamba, shared) == (5248, 72_479_232, 471_859_200)
    assert got == mamba + shared == 544_338_432


def test_kv_rows_serialise_the_shared_applications():
    """The attention rows are the shared block's applications, in the
    reference's order, and each row's bytes are that application's K ‖
    V, as the reference serialises them."""
    jcfg, tcfg = _cfgs("bfloat16")
    rng = np.random.default_rng(4)
    jst = jax_model.init_decode_state(jcfg, 2, 16)
    jst = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), jst)
    state = bridge.state_from_jax(_np(jst), "cpu")
    assert kvio._kv_rows(tcfg) == jax_kvio._kv_rows(jcfg) == \
        [("shared", (0,)), ("shared", (1,))]
    for layer in range(kvio.n_attn_layers(tcfg)):
        got = kvio.serialize_kv_layer(tcfg, state, 1, 3, 11, layer)
        want = jax_kvio.serialize_kv_layer(jcfg, jst, 1, 3, 11, layer)
        bridge.assert_exact(got, want)


# ---------------------------------------------------------------------------
# the plain SSD scan at N 64, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 70, 20])     # 2 chunks, 2 + 6, < 1
def test_plain_ssd_scan_at_n64_matches_reference(dt, s):
    """One Mamba2 layer at zamba2's d_state 64 and SSD head dim 64 (4
    heads of the reduced d_inner 256): the port's ``ssd_scan`` (the conv
    and the plain chunked scan) against the reference's."""
    jcfg, tcfg = _cfgs(dt, ssm_kw=dict(d_state=64, head_dim=64))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.params_from_jax(_np(jp), tcfg, device="cpu")
    jl = jax.tree.map(lambda a: a[0, 1], jp["blocks"])
    tl = tp["blocks"][1]
    x = np.random.default_rng(s).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dt)
    tx = bridge.to_torch(np.asarray(jx), "cpu")
    jy, jst = jax_scan(jl, jcfg, jx)
    y, st = ssm.ssd_scan(tl, tcfg, tx)
    assert st["ssm"].shape == (2, 4, 64, 64)
    _close(y, jy, TOLS[dt])
    for k in jst:
        _close(st[k], jst[k], TOLS[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_decode_three_steps_at_n64_match_reference(dt):
    """Three consecutive decode steps of one Mamba2 layer at zamba2's
    d_state 64 and SSD head dim 64, through the decode step's wrapper
    (the token's conv and the recurrence, the state and all three tails
    in place), from one nonzero carried state, against three of the
    reference's ``ssm_decode_step``: each step's layer output and the
    state and tails after it."""
    from repro_torch.kernels import ssm_step
    jcfg, tcfg = _cfgs(dt, ssm_kw=dict(d_state=64, head_dim=64))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(2))
    tp = bridge.params_from_jax(_np(jp), tcfg, device="cpu")
    jl = jax.tree.map(lambda a: a[0, 1], jp["blocks"])
    tl = tp["blocks"][1]
    d_inner, H, P, N = ssm._dims(tcfg)
    b, cw = 3, tcfg.ssm.conv_width
    rng = np.random.default_rng(31)
    draw = lambda *shape: (0.5 * rng.standard_normal(shape)).astype(
        np.float32)
    leaves = dict(ssm=(draw(b, H, P, N), "float32"),
                  conv_x=(draw(b, cw - 1, d_inner), dt),
                  conv_B=(draw(b, cw - 1, N), dt),
                  conv_C=(draw(b, cw - 1, N), dt))
    jstate = {k: jnp.asarray(v).astype(d) for k, (v, d) in leaves.items()}
    state = {k: bridge.to_torch(np.asarray(v), "cpu")
             for k, v in jstate.items()}
    assert state["ssm"].shape == (3, 4, 64, 64)
    for _ in range(3):
        jx = jnp.asarray(rng.standard_normal(
            (b, 1, tcfg.d_model)).astype(np.float32)).astype(dt)
        tx = bridge.to_torch(np.asarray(jx), "cpu")
        jy, jstate = jax_step(jl, jcfg, jx, jstate)
        x = tx[:, 0]
        y = ssm_step(
            state["ssm"], (x @ tl["w_x"]).view(b, H, P), x @ tl["w_B"],
            x @ tl["w_C"], tl["conv_x"], tl["conv_B"], tl["conv_C"],
            state["conv_x"], state["conv_B"], state["conv_C"],
            ssm._dt(tl, x), -torch.exp(tl["A_log"].float()), tl["D"])
        _close(ssm._gated_out(tl, tcfg, y.view(b, 1, d_inner),
                              tx @ tl["w_z"]), jy, TOLS[dt])
        for k in jstate:
            _close(state[k], jstate[k], TOLS[dt])


def test_launcher_serves_zamba2(capsys):
    serve_launcher.main(["--arch", ARCH, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 12 rounds across 4 agents (dualpath, cpu)" in out
