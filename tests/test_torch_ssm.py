"""mamba2 in the port against the JAX reference (CPU, reduced mamba2-1.3b).

The reduced config keeps Mamba2's structure at test size: 4 layers,
d_model 128, d_inner 256 in 16 SSD heads of 16, d_state 16, chunks of
32, conv width 4, tied embeddings.  The JAX parameters go through
``repro_torch.bridge``; inputs come from numpy with a seed.  The port
runs on the CPU, so every kernel wrapper computes its plain version.

* The plain causal conv against the reference's ``_causal_conv`` (its
  bf16 order reproduced), s shorter than, equal to and past the tail.
* One Mamba2 layer: the port's ``ssd_scan`` (the conv and the plain
  chunked scan) against the reference's at s a multiple of the chunk,
  not a multiple, and shorter than it; ``ssd_scan_with_tails`` from a
  nonzero state and tails, updating it in place; ``ssm_decode_step``
  (the plain recurrent step), in place.  The planted faults of the
  card's check change the results; its plain TF32 control (TF32 rounding
  as ``cvt.rna``) errs by TF32's steps.  Both conv wrappers take the
  same widths.
* The model: ``forward`` (logits and the state it returns),
  ``append_step`` from a carried state and ``decode_step`` against the
  reference; the bridged state; the slot utilities on the state.
* The state blob: byte for byte the reference state's leaves end to
  end, and back.  The port's launcher serves mamba2.
* The card's decompositions, plain: the SSD scan split into its four
  steps (C·Bᵀ per chunk, chunk states, state passing, chunk outputs)
  against the chunk loop (one chunk, two, a short last chunk, s under
  the chunk, two sequences from carried states, the final state written
  over h0) and, inside the layer, against the reference's ``ssd_scan``
  and ``ssd_scan_with_tails``; the decode step's wrapper (the token's
  conv, then the recurrence, every tail in place) against
  ``ssm_decode_step`` with one slot all zeros, and over three consecutive
  steps from one carried state (B's tail left behind must fail).  The
  wrappers refuse wrong shapes, mixed dtypes and
  tensors that are neither on the CPU nor on a card.

Tolerances: the kernels' plain versions 1e-5 in f32 and 2e-2 in bf16
elementwise, relative to the largest output (the chunk sums are f32 in
both, in other orders); the four-step split against the chunk loop 2e-5
in f32 (the card's check); logits test_torch_model.py's (2e-5 of the
largest logit in f32, 2e-2 in bf16).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.engines import kvio
from repro_torch.kernels import ref
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (append_step, decode_step, forward,
                                init_decode_state, ssm)

torch.set_num_threads(1)

jax_forward = jax.jit(jax_model.forward, static_argnums=1,
                      static_argnames="return_state")
jax_decode = jax.jit(jax_model.decode_step, static_argnums=1)
jax_append = jax.jit(jax_model.append_step, static_argnums=1)
jax_scan = jax.jit(jax_ssm.ssd_scan, static_argnums=1)
jax_scan_tails = jax.jit(jax_ssm.ssd_scan_with_tails, static_argnums=1)
jax_step = jax.jit(jax_ssm.ssm_decode_step, static_argnums=1)

ARCH = "mamba2-1.3b"
KTOLS = {"float32": 1e-5, "bfloat16": 2e-2}     # the plain versions
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}      # logits


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|) elementwise."""
    want = np.asarray(want, np.float32)
    bridge.assert_close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a CPU torch tensor."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(x).astype(dtype)
    return j, bridge.to_torch(np.asarray(j), "cpu")


def _cfgs(dt):
    return (dataclasses.replace(jax_get_config(ARCH).reduced(),
                                param_dtype=dt),
            dataclasses.replace(get_config(ARCH).reduced(), param_dtype=dt))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jcfg, tcfg = _cfgs(dt)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return dt, jcfg, tcfg, jp, tp


def _layer(jp, tp, i=1):
    """Block ``i``'s parameters in both packages."""
    return jax.tree.map(lambda a: a[i], jp["blocks"]), tp["blocks"][i]


def _random_state(rng, tcfg, b, dt):
    """A nonzero one-layer state in both packages: f32 ssm, tails in the
    activation dtype."""
    d_inner, H, P, N = ssm._dims(tcfg)
    cw = tcfg.ssm.conv_width
    shapes = dict(ssm=((b, H, P, N), "float32"),
                  conv_x=((b, cw - 1, d_inner), dt),
                  conv_B=((b, cw - 1, N), dt), conv_C=((b, cw - 1, N), dt))
    pairs = {k: _pair(rng, s, d, 0.5) for k, (s, d) in shapes.items()}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


# ---------------------------------------------------------------------------
# the plain versions against the reference's functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 3, 37])
def test_causal_conv_plain_matches_reference(dt, s):
    rng = np.random.default_rng(s)
    jx, tx = _pair(rng, (2, s, 48), dt)
    jw, tw = _pair(rng, (4, 48), dt, 0.5)
    jt, tt = _pair(rng, (2, 3, 48), dt)
    jout, jtail = jax_ssm._causal_conv(jx, jw, jt)
    out, tail = ref.causal_conv_ref(tx, tw, tt)
    _close(out, jout, KTOLS[dt])
    bridge.assert_exact(tail, np.asarray(jtail).astype(np.float32))
    # the model's call: no tail is zeros
    jout0, _ = jax_ssm._causal_conv(jx, jw)
    out0, _ = ref.causal_conv_ref(tx, tw, torch.zeros_like(tt))
    _close(out0, jout0, KTOLS[dt])


@pytest.mark.parametrize("s", [64, 70, 20])     # 2 chunks, 2 + 6, < 1
def test_ssd_scan_matches_reference(models, s):
    dt, jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(s)
    jx, tx = _pair(rng, (2, s, tcfg.d_model), dt)
    jy, jst = jax_scan(jl, jcfg, jx)
    y, st = ssm.ssd_scan(tl, tcfg, tx)
    _close(y, jy, KTOLS[dt])
    for k in jst:
        _close(st[k], jst[k], KTOLS[dt])
        assert st[k].dtype == bridge.to_torch(np.asarray(jst[k]),
                                              "cpu").dtype


@pytest.mark.parametrize("s", [70, 20])
def test_ssd_scan_with_tails_continues_in_place(models, s):
    dt, jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(100 + s)
    jstate, state = _random_state(rng, tcfg, 2, dt)
    jx, tx = _pair(rng, (2, s, tcfg.d_model), dt)
    jy, jnew = jax_scan_tails(jl, jcfg, jx, jstate)
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    y, new = ssm.ssd_scan_with_tails(tl, tcfg, tx, state)
    _close(y, jy, KTOLS[dt])
    assert new is state
    for k in jnew:
        assert state[k].data_ptr() == ptrs[k]         # updated in place
        _close(state[k], jnew[k], KTOLS[dt])


def test_decode_step_updates_in_place(models):
    dt, jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(7)
    jstate, state = _random_state(rng, tcfg, 3, dt)
    jx, tx = _pair(rng, (3, 1, tcfg.d_model), dt)
    jy, jnew = jax_step(jl, jcfg, jx, jstate)
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    y, _ = ssm.ssm_decode_step(tl, tcfg, tx, state)
    _close(y, jy, KTOLS[dt])
    for k in jnew:
        assert state[k].data_ptr() == ptrs[k]
        _close(state[k], jnew[k], KTOLS[dt])


def test_planted_faults_change_the_results():
    """The faults the card's check plants in the plain versions are not
    no-ops: the carried state dropped, the cumulative sum shifted by a
    row, the decay applied after the update."""
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    b, s, H, P, N = 1, 70, 4, 8, 16
    x, B, C, h0 = f(b, s, H, P), f(b, s, N), f(b, s, N), f(b, H, P, N)
    dt = torch.nn.functional.softplus(f(b, s, H) - 3.0)
    A = -(1.0 + 15.0 * torch.from_numpy(rng.random(H).astype(np.float32)))
    D = f(H)
    want, _ = ref.ssd_chunk_scan_ref(x, B, C, dt, A, D, h0, 32)
    for kw in (dict(carry=False), dict(shift=1)):
        got, _ = ref._ssd_scan(x, B, C, dt, A, D, h0, 32, **kw)
        assert (got - want).abs().max() > 1e-2, kw
    h = f(2, H, P, N)
    xs, Bs, Cs, dts = f(2, H, P), f(2, N), f(2, N), dt[0, :2]
    y = ref.ssm_step_ref(h.clone(), xs, Bs, Cs, dts, A, D)
    y_bad = ref.ssm_step_ref(h.clone(), xs, Bs, Cs, dts, A, D,
                             decay_after=True)
    assert (y - y_bad).abs().max() > 1e-2


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """``ref._tf32`` rounds as ``cvt.rna.tf32.f32``: to the nearest value
    with 10 mantissa bits, ties away from zero; bf16 values (7 bits) and
    zero stay as they are."""
    one = 1.0
    got = ref._tf32(torch.tensor(
        [one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
         one + 3 * 2 ** -12, 0.0, -2.5], dtype=torch.float32))
    want = [one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -10, 0.0,
            -2.5]
    assert got.tolist() == want
    bf = torch.randn(1000, generator=torch.Generator().manual_seed(0)) \
        .bfloat16().float()
    assert torch.equal(ref._tf32(bf), bf)
    r = ref._tf32(torch.randn(1000, generator=torch.Generator().manual_seed(1)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("h0", [False, True])
def test_plain_tf32_control_moves_the_scan_by_tf32_steps(h0):
    """The plain TF32 control the card's check must see fail (the split
    products' low parts dropped) is not a no-op, and it stays an error of
    TF32's size: above 1e-5 of the output's scale, under 1e-2 of it."""
    rng = np.random.default_rng(13)
    args = _scan_inputs(rng, 1, 70, 4, 8, 16, "bfloat16", h0)
    want, _ = ref.ssd_chunk_scan_ref(*args, 32)
    got, _ = ref._ssd_scan(*args, 32, tf32=True)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert 1e-5 * scale < err < 1e-2 * scale, (err, scale)


def test_conv_wrappers_take_the_same_widths():
    """The prefill conv and the decode step (which folds the token's conv
    in) refuse the same conv widths: a model's prefill and decode run or
    refuse together."""
    import importlib
    mod = lambda name: importlib.import_module(f"repro_torch.kernels.{name}")
    assert mod("ssm_step").MAX_CW == mod("causal_conv").MAX_CW == 4


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_model_matches_jax(models):
    """forward (logits and state), then append_step from that carried
    state and decode_step after it, against the reference."""
    dt, jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(0)
    toks = rng.integers(2, tcfg.vocab_size, (2, 45)).astype(np.int32)
    jl, jst = jax_forward(jp, jcfg, jnp.asarray(toks), return_state=True)
    tl, tst = forward(tp, tcfg, torch.from_numpy(toks).long(),
                      return_state=True)
    _close(tl, jl, TOLS[dt])
    for k, v in jst["mamba"].items():
        _close(tst["mamba"][k], v, KTOLS[dt])
    lengths = np.array([45, 45], np.int32)
    app = rng.integers(2, tcfg.vocab_size, (2, 37)).astype(np.int32)
    jl2, jst2 = jax_append(jp, jcfg, jnp.asarray(app), jst,
                           jnp.asarray(lengths))
    state = bridge.state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    tl2, state2 = append_step(tp, tcfg, torch.from_numpy(app).long(), state,
                              torch.from_numpy(lengths).long())
    assert state2 is state
    _close(tl2, jl2, TOLS[dt])
    nxt = rng.integers(2, tcfg.vocab_size, (2,)).astype(np.int32)
    jl3, jst3 = jax_decode(jp, jcfg, jnp.asarray(nxt), jst2,
                           jnp.asarray(lengths + 37))
    tl3, _ = decode_step(tp, tcfg, torch.from_numpy(nxt).long(), state,
                         torch.from_numpy(lengths + 37).long())
    _close(tl3, jl3, TOLS[dt])
    for k, v in jst3["mamba"].items():
        _close(state["mamba"][k], v, KTOLS[dt])
    if dt == "float32":
        assert (np.argmax(np.asarray(jl3), -1) ==
                bridge.to_numpy(tl3).argmax(-1)).all()


def test_bridged_state_is_the_ports_layout(models):
    dt, jcfg, tcfg, jp, tp = models
    jst = jax_model.init_decode_state(jcfg, 3, 16)
    got = bridge.state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    want = init_decode_state(tcfg, 3, 16, "cpu")
    assert set(got) == set(want) == {"mamba"}
    for k, v in want["mamba"].items():
        assert got["mamba"][k].shape == v.shape, k
        assert got["mamba"][k].dtype == v.dtype, k
        assert v.shape[:2] == (tcfg.n_layers, 3)
    assert kvio.batch_axes_of_state(tcfg) == {
        "mamba": {k: 1 for k in kvio.BLOB_LEAVES}}


def test_slot_get_set_on_the_mamba_state():
    _, tcfg = _cfgs("bfloat16")
    rng = np.random.default_rng(5)
    state = init_decode_state(tcfg, 4, 16, "cpu")
    for k, v in state["mamba"].items():
        v.copy_(torch.from_numpy(rng.standard_normal(v.shape)))
    axes = kvio.batch_axes_of_state(tcfg)
    one = kvio.slot_get(state, axes, 2)
    other = init_decode_state(tcfg, 4, 16, "cpu")
    kvio.slot_set(other, axes, 1, one)
    for k in kvio.BLOB_LEAVES:
        assert torch.equal(other["mamba"][k][:, 1], state["mamba"][k][:, 2])
        assert not other["mamba"][k][:, 0].any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_blob_is_the_states_bytes_and_round_trips(dt):
    """The blob holds the reference state's leaves end to end, byte for
    byte, in ``BLOB_LEAVES`` order; decoding it gives the state back and
    encoding that gives the same bytes.  Its length is the raw state
    size, the reference's pickle framing excluded."""
    jcfg, tcfg = _cfgs(dt)
    rng = np.random.default_rng(11)
    jst = jax_model.init_decode_state(jcfg, 1, 16)
    jst = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), jst)
    np_st = jax.tree.map(np.asarray, jst)
    state = bridge.state_from_jax(np_st, "cpu")
    blob = kvio.state_to_blob(state)
    want = b"".join(np_st["mamba"][k].tobytes() for k in kvio.BLOB_LEAVES)
    assert blob.dtype == np.uint8 and blob.ndim == 1
    assert blob.tobytes() == want
    back = kvio.blob_to_state(tcfg, blob, "cpu")
    for k in kvio.BLOB_LEAVES:
        bridge.assert_exact(back["mamba"][k], state["mamba"][k])
    assert kvio.state_to_blob(back).tobytes() == want
    with pytest.raises(ValueError, match="blob"):
        kvio.blob_to_state(tcfg, blob[:-2], "cpu")


def test_launcher_serves_mamba2(capsys):
    serve_launcher.main(["--arch", ARCH, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 12 rounds across 4 agents (dualpath, cpu)" in out


def test_wrappers_refuse_bad_shapes():
    """The kernel wrappers check shapes before anything else, on any
    device: a wrong shape raises, it never reaches a kernel or the plain
    version.  The decode step also refuses a wrong tail, mixed dtypes,
    and tensors off the CPU that are not on a card: there is no fallback
    to the plain version."""
    from repro_torch.kernels import causal_conv, ssd_chunk_scan, ssm_step
    z = torch.zeros
    with pytest.raises(ValueError, match="causal_conv"):
        causal_conv(z(1, 5, 8), z(4, 8), z(1, 2, 8))
    with pytest.raises(ValueError, match="ssd_chunk_scan"):
        ssd_chunk_scan(z(1, 5, 2, 4), z(1, 5, 8), z(1, 5, 8), z(1, 5, 3),
                       z(2), z(2), None, 4)
    with pytest.raises(ValueError, match="ssd_chunk_scan"):
        ssd_chunk_scan(z(1, 5, 2, 4), z(1, 5, 8), z(1, 5, 8), z(1, 5, 2),
                       z(2), z(2), z(1, 2, 4, 9), 4)

    def step(dev="cpu", x_shape=(2, 2, 4), tail_B=(2, 3, 8),
             tail_dtype=torch.float32):
        zz = lambda *sh, dtype=torch.float32: torch.zeros(sh, dtype=dtype,
                                                          device=dev)
        return ssm_step(zz(2, 2, 4, 8), zz(*x_shape), zz(2, 8), zz(2, 8),
                        zz(4, 8), zz(4, 8), zz(4, 8), zz(2, 3, 8),
                        zz(*tail_B, dtype=tail_dtype), zz(2, 3, 8),
                        zz(2, 2), zz(2), zz(2))

    step()                                      # the shapes that fit
    with pytest.raises(ValueError, match="ssm_step: shapes"):
        step(x_shape=(2, 2, 5))
    with pytest.raises(ValueError, match="ssm_step: shapes"):
        step(tail_B=(2, 2, 8))                  # a tail one row short
    with pytest.raises(ValueError, match="ssm_step: dtypes"):
        step(tail_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        step(dev="meta")                        # not the CPU, no card
    for fn, args in ((causal_conv, (z(1, 5, 8), z(4, 8), z(1, 3, 8))),
                     (ssd_chunk_scan, (z(1, 5, 2, 4), z(1, 5, 8),
                                       z(1, 5, 8), z(1, 5, 2), z(2), z(2),
                                       None, 4))):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args))


# ---------------------------------------------------------------------------
# the card's decompositions, plain: the chunk-parallel SSD scan and the
# fused decode step
# ---------------------------------------------------------------------------


def _scan_inputs(rng, b, s, H, P, N, dt, h0):
    """Random scan inputs at test widths, dt after softplus, A in [-16,
    -1]: the shapes ``ssd_chunk_scan`` takes, on the CPU."""
    f = lambda *sh: torch.from_numpy(
        rng.standard_normal(sh).astype(np.float32))
    x, B, C = (f(b, s, H, P).to(getattr(torch, dt)),
               f(b, s, N).to(getattr(torch, dt)),
               f(b, s, N).to(getattr(torch, dt)))
    dtv = torch.nn.functional.softplus(f(b, s, H) - 2.0)
    A = -(1.0 + 15.0 * torch.from_numpy(rng.random(H).astype(np.float32)))
    D = 1.0 + 0.1 * f(H)
    return x, B, C, dtv, A, D, (f(b, H, P, N) if h0 else None)


# (b, s, chunk, carried state): one chunk, two, a short last chunk, s
# under the chunk, two sequences from carried states
CHUNK_CASES = [(1, 32, 32, False), (1, 64, 32, False), (1, 70, 32, True),
               (1, 20, 32, True), (2, 70, 32, True)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,chunk,h0", CHUNK_CASES)
def test_chunk_parallel_plain_matches_chunk_loop(dt, b, s, chunk, h0):
    """The four-step split (C·Bᵀ per chunk, chunk states, state passing,
    chunk outputs) against the chunk loop of the plain version: f32 to
    2e-5, bf16 to the plain versions' tolerance."""
    rng = np.random.default_rng(s + 7 * b)
    args = _scan_inputs(rng, b, s, 4, 8, 16, dt, h0)
    want_y, want_h = ref.ssd_chunk_scan_ref(*args, chunk)
    y, h = ref.ssd_chunk_parallel_ref(*args, chunk)
    tol = 2e-5 if dt == "float32" else KTOLS[dt]
    _close(y, want_y, tol)
    _close(h, want_h, tol)


def test_chunk_parallel_plain_out_state_may_be_h0():
    """``out_state`` is h0 itself, as the engines pass it: the state
    entering the first chunk is read before the final one is written."""
    rng = np.random.default_rng(5)
    x, B, C, dtv, A, D, h0 = _scan_inputs(rng, 2, 70, 4, 8, 16, "float32",
                                          True)
    want_y, want_h = ref.ssd_chunk_scan_ref(x, B, C, dtv, A, D, h0.clone(),
                                            32)
    ptr = h0.data_ptr()
    y, h = ref.ssd_chunk_parallel_ref(x, B, C, dtv, A, D, h0, 32,
                                      out_state=h0)
    assert h is h0 and h0.data_ptr() == ptr
    _close(y, want_y, 2e-5)
    _close(h0, want_h, 2e-5)


@pytest.mark.parametrize("s", [64, 70, 20])     # 2 chunks, 2 + 6, < 1
def test_chunk_parallel_plain_in_the_layer_matches_reference(models, s,
                                                             monkeypatch):
    """The layer's scan through the four-step split in place of the
    chunk loop, against the reference's ``ssd_scan`` from zeros and
    ``ssd_scan_with_tails`` from a carried state (there the final state
    is written over the state it starts from)."""
    dt, jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp)

    def split(x, B, C, dtv, A, D, h0, chunk, out_state=None):
        return ref.ssd_chunk_parallel_ref(x, B, C, dtv, A, D, h0, chunk,
                                          out_state)

    monkeypatch.setattr(ssm, "ssd_chunk_scan", split)
    rng = np.random.default_rng(200 + s)
    jx, tx = _pair(rng, (2, s, tcfg.d_model), dt)
    jy, jst = jax_scan(jl, jcfg, jx)
    y, st = ssm.ssd_scan(tl, tcfg, tx)
    _close(y, jy, KTOLS[dt])
    for k in jst:
        _close(st[k], jst[k], KTOLS[dt])
    jstate, state = _random_state(rng, tcfg, 2, dt)
    jy, jnew = jax_scan_tails(jl, jcfg, jx, jstate)
    y, _ = ssm.ssd_scan_with_tails(tl, tcfg, tx, state)
    _close(y, jy, KTOLS[dt])
    for k in jnew:
        _close(state[k], jnew[k], KTOLS[dt])


@pytest.mark.parametrize("f32_conv", [False, True])
def test_fused_decode_plain_matches_reference(models, f32_conv,
                                              monkeypatch):
    """The decode step's wrapper on the CPU (the token's conv, then the
    recurrence) over 4 slots, slot 2's state and tails all zeros, against
    the reference's ``ssm_decode_step``: the state and tails it leaves and
    the layer's output.  All three tails are updated in place, and the
    wrapper returns y alone.  ``f32_conv`` sums the
    conv as the card's kernel does (f32, one rounding), which the card's
    check compares the kernel with: it too stays within the plain
    versions' tolerance of the reference."""
    from repro_torch.kernels import ssm_step
    if f32_conv:
        monkeypatch.setattr(ref, "ssm_conv_step_ref", functools.partial(
            ref.ssm_conv_step_ref, f32_conv=True))
    dt, jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp)
    d_inner, H, P, N = ssm._dims(tcfg)
    rng = np.random.default_rng(17)
    jstate, state = _random_state(rng, tcfg, 4, dt)
    for k in state:
        state[k][2] = 0
        jstate[k] = jstate[k].at[2].set(0)
    jx, tx = _pair(rng, (4, 1, tcfg.d_model), dt)
    jy, jnew = jax_step(jl, jcfg, jx, jstate)
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    old = {k: state[k].clone() for k in ssm._CONV}
    y = _fused_step(tl, tx, state, H, P)
    assert isinstance(y, torch.Tensor) and y.shape == (4, H, P)
    for k in jnew:
        assert state[k].data_ptr() == ptrs[k]
        _close(state[k], jnew[k], KTOLS[dt])
    for k in ssm._CONV:                         # every tail moved
        assert not torch.equal(state[k], old[k]), k
    out = ssm._gated_out(tl, tcfg, y.view(4, 1, d_inner), tx @ tl["w_z"])
    _close(out, jy, KTOLS[dt])


def _fused_step(tl, tx, state, H, P):
    """The decode step's wrapper on one layer's projections of ``tx`` (b,
    1, d_model) against ``state``, which it updates in place; returns
    y."""
    from repro_torch.kernels import ssm_step
    x = tx[:, 0]
    return ssm_step(
        state["ssm"], (x @ tl["w_x"]).view(x.shape[0], H, P), x @ tl["w_B"],
        x @ tl["w_C"], tl["conv_x"], tl["conv_B"], tl["conv_C"],
        state["conv_x"], state["conv_B"], state["conv_C"],
        ssm._dt(tl, x), -torch.exp(tl["A_log"].float()), tl["D"])


@pytest.mark.parametrize("f32_conv", [False, True])
def test_fused_decode_three_steps_match_reference(models, f32_conv,
                                                  monkeypatch):
    """Three consecutive decode steps of the wrapper from one carried
    state (the tails in place each step, so each step convolves the
    tails the previous one left) against three of the reference's
    ``ssm_decode_step``: each step's layer output and the state and tails
    after it.  With B's tail left as it was after each step (the fault
    the card's check plants), the third step's output moves past the
    tolerance."""
    if f32_conv:
        monkeypatch.setattr(ref, "ssm_conv_step_ref", functools.partial(
            ref.ssm_conv_step_ref, f32_conv=True))
    dt, jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, tp)
    d_inner, H, P, N = ssm._dims(tcfg)
    rng = np.random.default_rng(29)
    jstate, state = _random_state(rng, tcfg, 3, dt)
    faulty = {k: v.clone() for k, v in state.items()}
    for _ in range(3):
        jx, tx = _pair(rng, (3, 1, tcfg.d_model), dt)
        jy, jstate = jax_step(jl, jcfg, jx, jstate)
        y = _fused_step(tl, tx, state, H, P)
        out = ssm._gated_out(tl, tcfg, y.view(3, 1, d_inner), tx @ tl["w_z"])
        _close(out, jy, KTOLS[dt])
        for k in jstate:
            _close(state[k], jstate[k], KTOLS[dt])
        old_B = faulty["conv_B"].clone()
        y_bad = _fused_step(tl, tx, faulty, H, P)
        faulty["conv_B"].copy_(old_B)
    with pytest.raises(AssertionError):
        _close(ssm._gated_out(tl, tcfg, y_bad.view(3, 1, d_inner),
                              tx @ tl["w_z"]), jy, KTOLS[dt])
