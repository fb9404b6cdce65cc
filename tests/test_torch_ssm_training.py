"""SSM and hybrid training in the port against the JAX reference (CPU,
reduced mamba2-1.3b and zamba2-2.7b).

The port trains the Mamba2 blocks through two autograd Functions,
``_SSDChunkScan`` and ``_CausalConv``, whose backwards on CPU tensors are
the plain ones (``ref.ssd_chunk_scan_bwd_ref``, ``ref.causal_conv_bwd_ref``:
autograd of the plain forwards).  Held here:

* The plain SSD forward's mask: ``exp`` of the kept entries alone gives
  the old ``where(causal, exp(seg), 0)`` bit for bit, and its gradient
  stays finite where ``seg`` overflows ``exp`` (the old form's gradient
  is NaN there: 0 * inf).
* ``chip_smoke.ssd_bwd_plain``, the card's backward as it splits
  the work (the reverse state pass, then each chunk's gradients), against
  autograd of the plain forward, with and without a carried state and a
  cotangent on the final state; its planted faults change the result.
* The conv's plain backward against ``jax.vjp`` of the reference's
  ``_causal_conv`` (cotangents on the output and on the new tail).
* The Functions on CPU tensors: gradients equal autograd of the plain
  forwards; ``out_state`` under grad and cotangents of the wrong shape
  raise; the card's backward takes the forward's scratch only at its
  call's shapes, f32 and contiguous.
* One Mamba2 layer's ``ssm.ssd_scan`` under autograd against ``jax.vjp``
  of the reference's ``ssd_scan``: reduced mamba2 in f32, 80 tokens
  (chunks of 32, the last short), a nonzero carried state and tails,
  cotangents on y, the final state and the tails; every gradient (the
  layer's parameters, x, the state, the tails) within 1e-4 of its own
  largest |value|.
* Reduced mamba2 at the published chunk of 256 over 256 tokens: the
  reference's ``jax.grad`` has non-finite leaves (``ssm.py:102``), as it
  has at the reduced config's own chunk of 32 over these tokens; the
  port's gradients are all finite and match the reference's at chunk 16,
  where its gradient is finite (chunking is an exact rewrite of the
  recurrence), within 1e-4 of each leaf's largest |g|.
* Remat "full" is bit-identical to none for both families.

The model-level gradients, five train steps and the launcher are in
tests/test_torch_training.py.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro.training import loss_fn as jax_loss_fn
from repro_torch import bridge, kernels
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import init_params, ssm
from repro_torch.training import SyntheticLM, loss_and_grads
from repro_torch.training.tree import leaves, leaves_with_paths

# the card's check keeps its fault-planting split of the SSD backward
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"


def _scan_inputs(rng, b, s, H, P, N, h0, a_max=16.0, dt_shift=-2.0):
    """Random f32 scan inputs at test widths, dt after softplus, A in [-a_max,
    -1]."""
    f = lambda *sh: torch.from_numpy(
        rng.standard_normal(sh).astype(np.float32))
    x, B, C = f(b, s, H, P), f(b, s, N), f(b, s, N)
    dtv = torch.nn.functional.softplus(f(b, s, H) + dt_shift)
    A = -(1.0 + (a_max - 1.0) * torch.from_numpy(
        rng.random(H).astype(np.float32)))
    D = 1.0 + 0.1 * f(H)
    return x, B, C, dtv, A, D, (f(b, H, P, N) if h0 else None)


def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.float()
    top = float(want.abs().max())
    return float((got.float() - want).abs().max()) / (top or 1.0)


def _old_ssd_scan(x, B, C, dt, A, D, h0, chunk):
    """The plain chunk loop as it was before the mask repair: ``exp`` of
    every entry, then ``where(causal, ., 0)``."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    L = min(chunk, s)
    pad = (-s) % L
    nc = (s + pad) // L
    padded = lambda t: torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
    xh = padded(x.float().reshape(b, s, H * P)).reshape(b, nc, L, H, P)
    Bc = padded(B.float()).reshape(b, nc, L, N)
    Cc = padded(C.float()).reshape(b, nc, L, N)
    dtc = padded(dt.float()).reshape(b, nc, L, H)
    h = torch.zeros((b, H, P, N)) if h0 is None else h0.float()
    idx = torch.arange(L)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]
    ys = []
    for c in range(nc):
        xc, Bj, Ci, dtj = xh[:, c], Bc[:, c], Cc[:, c], dtc[:, c]
        cs = torch.cumsum((dtj * A.float()).double(), dim=1).float()
        seg = cs[:, :, None, :] - cs[:, None, :, :]
        Lmat = torch.where(causal[None], torch.exp(seg), 0.0)
        CB = torch.einsum("bin,bjn->bij", Ci, Bj)
        w = CB[..., None] * Lmat * dtj[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + torch.einsum("bin,bhpn,bih->bihp", Ci, h, torch.exp(cs))
        decay_to_end = torch.exp(cs[:, -1:, :] - cs)
        S = torch.einsum("blh,bln,blhp->bhpn", decay_to_end * dtj, Bj, xc)
        h = h * torch.exp(cs[:, -1, :])[:, :, None, None] + S
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * L, H, P)[:, :s]
    return y + x.float() * D.float()[None, None, :, None], h


# ---------------------------------------------------------------------------
# the plain SSD scan's mask and backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,chunk,h0", [(1, 64, 32, False),
                                          (2, 70, 32, True),
                                          (1, 20, 32, True)])
def test_mask_repair_keeps_the_plain_forward_bit_for_bit(b, s, chunk, h0):
    """``exp(where(causal, seg, -inf))`` is ``where(causal, exp(seg), 0)``
    to the bit: the plain scan's y and final state equal the chunk loop's
    before the repair, and so do the chunk-parallel split's masks."""
    rng = np.random.default_rng(s + b)
    args = _scan_inputs(rng, b, s, 4, 8, 16, h0)
    y, h = ref.ssd_chunk_scan_ref(*args, chunk)
    y_old, h_old = _old_ssd_scan(*args, chunk)
    assert torch.equal(y, y_old) and torch.equal(h, h_old)
    seg = torch.from_numpy(rng.standard_normal((3, 40, 40)).astype(
        np.float32)) * 60.0
    keep = torch.ones((40, 40), dtype=torch.bool).tril()
    assert torch.equal(torch.exp(torch.where(keep, seg, float("-inf"))),
                       torch.where(keep, torch.exp(seg), 0.0))


def test_plain_backward_is_finite_where_the_old_mask_gave_nan():
    """One 256-row chunk whose cumulative sum falls past -88 (A down to
    -16, dt ~ 1): seg for j > i passes exp's range.  The repaired plain
    scan's gradient is finite; the old form's is NaN (its where passes a
    zero cotangent to exp(seg) = inf)."""
    rng = np.random.default_rng(3)
    args = _scan_inputs(rng, 1, 256, 2, 4, 8, False, dt_shift=0.0)
    dy = torch.ones((1, 256, 2, 4))
    grads = ref.ssd_chunk_scan_bwd_ref(*args, 256, dy)
    assert all(bool(g.isfinite().all()) for g in grads[:6])
    with torch.enable_grad():
        ins = [t.clone().requires_grad_(True) for t in args[:6]]
        y, _ = _old_ssd_scan(*ins, None, 256)
        old = torch.autograd.grad(y, ins, dy)
    assert not all(bool(g.isfinite().all()) for g in old)


# (b, s, chunk, carried state, cotangent on the final state, heads, heads
# a group of the card's chunk kernel (None: ssd_scan.bwd_plan's), rows of
# its column tiles)
_BWD = lambda *c: pytest.param(*c, id="-".join(map(str, c[:5])) + (
    "" if c[5:] == (3, None, 64) else "-" + "-".join(map(str, c[5:]))))
BWD_CASES = [_BWD(1, 64, 32, False, False, 3, None, 64),
             _BWD(2, 70, 32, True, True, 3, None, 64),
             _BWD(1, 20, 32, True, True, 3, None, 64),
             _BWD(2, 96, 32, False, True, 3, None, 64),
             # 5 heads in groups of 2 (2, 2, 1); chunks of 20 rows in
             # column tiles of 8 (8, 8, 4)
             _BWD(2, 50, 20, True, True, 5, 2, 8),
             # 7 heads in groups of 3 (3, 3, 1), one short chunk in tiles
             # of 16 over 37 rows
             _BWD(1, 37, 40, False, True, 7, 3, 16),
             # 4 heads in groups of 3; the last chunk of 5 rows under one
             # tile of 8
             _BWD(2, 29, 24, True, False, 4, 3, 8)]


@pytest.mark.parametrize("b,s,chunk,h0,dh,heads,group,tile", BWD_CASES)
def test_chunk_parallel_backward_matches_autograd(b, s, chunk, h0, dh,
                                                  heads, group, tile):
    """The card's backward as it splits the work (the reverse state pass
    over the chunks, then each chunk's per-head gradients, the cotangent
    of C·Bᵀ summed over each group's heads and then over the groups, dB
    and dC from it and from the carried terms contracted over H·P, W's
    row sums a column tile at a time, the reverse cumulative sum of dcs)
    against autograd of the plain forward: every gradient within 2e-5 of
    its own largest |value|.  Its planted faults move the gradients they
    touch past 1e-2 of theirs."""
    rng = np.random.default_rng(s + 10 * b)
    args = _scan_inputs(rng, b, s, heads, 8, 16, h0)
    dy = torch.from_numpy(rng.standard_normal((b, s, heads, 8)).astype(
        np.float32))
    dhv = torch.from_numpy(rng.standard_normal((b, heads, 8, 16)).astype(
        np.float32)) if dh else None
    split = dict(head_group=group, tile=tile)
    want = ref.ssd_chunk_scan_bwd_ref(*args, chunk, dy, dhv)
    got = chip_smoke.ssd_bwd_plain(*args, chunk, dy, dhv, **split)
    assert (got[6] is None) == (want[6] is None) == (not h0)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert _rel_err(g, w) <= 2e-5
    faults = {"da_cumsum": (3, 4), "dbc_heads": (1, 2)}
    if s > chunk:
        faults["carry"] = (0, 1, 3)
    for knob, touched in faults.items():
        bad = chip_smoke.ssd_bwd_plain(*args, chunk, dy, dhv, **split,
                                       **{knob: 1 if knob == "dbc_heads"
                                          else False})
        assert max(_rel_err(bad[i], want[i]) for i in touched) > 1e-2, knob


@pytest.mark.parametrize("b,s,H,L,want", [
    (2, 1023, 64, 256, (8, 8)),    # mamba2-1.3b's microbatch: 32 tiles
    (2, 1023, 80, 256, (9, 9)),    # zamba2-2.7b's: groups of 9, the last 8
    (2, 77, 64, 77, (4, 16)),      # 4 tiles: MAX_GROUPS
    (1, 301, 64, 256, (4, 16)),    # the append: 4 + 1 tiles
    (8, 4096, 3, 256, (3, 1))])    # 512 tiles: one group of all heads
def test_ssd_bwd_plan(b, s, H, L, want):
    """The chunk kernel's head groups as ``ssd_scan.bwd_plan`` computes
    them (the card checks that its ``Plan`` agrees): enough groups that
    the column tiles times the groups reach GRID_AIM blocks, at most
    MAX_GROUPS, every group non-empty."""
    from repro_torch.kernels.ssd_scan import bwd_plan
    hpg, groups = bwd_plan(b, s, H, L)
    assert (hpg, groups) == want
    assert (groups - 1) * hpg < H <= groups * hpg


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,dnew", [(1, True), (3, False), (37, True)])
def test_conv_backward_plain_matches_jax_vjp(dt, s, dnew):
    """``ref.causal_conv_bwd_ref`` (autograd of the plain conv in the
    reference's rounding order) against ``jax.vjp`` of ``_causal_conv``:
    dx, dw and dtail within 1e-5 (f32) or 2e-2 (bf16) of each one's
    largest |value|; s 1 and 3 are under the tail, whose rows then reach
    the new tail."""
    rng = np.random.default_rng(s)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    jt = lambda a: jnp.asarray(a).astype(dt)
    x, w, tail, dout = f(2, s, 24), f(4, 24) * 0.5, f(2, 3, 24), f(2, s, 24)
    dnt = f(2, 3, 24) if dnew else np.zeros((2, 3, 24), np.float32)
    _, vjp = jax.vjp(jax_ssm._causal_conv, jt(x), jt(w), jt(tail))
    want = vjp((jt(dout), jt(dnt)))
    tt = lambda a: bridge.to_torch(np.asarray(jt(a)), "cpu")
    got = ref.causal_conv_bwd_ref(tt(x), tt(w), tt(tail), tt(dout),
                                  tt(dnt) if dnew else None)
    tol = 1e-5 if dt == "float32" else 2e-2
    for g, e in zip(got, want):
        assert g.dtype == getattr(torch, dt)
        assert _rel_err(g, bridge.to_torch(np.asarray(e), "cpu")) <= tol


# ---------------------------------------------------------------------------
# the autograd Functions on CPU tensors
# ---------------------------------------------------------------------------


def _scratch(b, s, H, P, N, L, dtype=torch.float32):
    nc, lt = -(-s // L), -(-L // 64) * 64
    return [torch.zeros(shape, dtype=dtype) for shape in
            ((b, nc, lt, lt), (b, nc, H, lt), (b, nc, H, P, N))]


@pytest.mark.parametrize("fault", [None, "missing", "another chunk",
                                   "bf16", "not contiguous", "two of three"])
def test_ssd_bwd_takes_only_a_scratch_that_fits(fault):
    """The card's backward reads the forward's scratch through raw
    pointers, so ``_check_saved`` passes (cb, cs, the chunk states) only
    at this call's shapes (b 2, s 300 in chunks of 256: two chunks of
    256-row tiles), f32 and contiguous on x's device, and raises on
    anything else rather than let a kernel read out of bounds."""
    from repro_torch.kernels.ssd_scan import _check_saved
    b, s, H, P, N, L = 2, 300, 3, 64, 128, 256
    x = torch.zeros((b, s, H, P))
    saved = {None: lambda: _scratch(b, s, H, P, N, L),
             "missing": lambda: None,
             "another chunk": lambda: _scratch(b, s, H, P, N, 128),
             "bf16": lambda: _scratch(b, s, H, P, N, L, torch.bfloat16),
             "not contiguous": lambda: [t.transpose(-1, -2) if t.dim() == 4
                                        and t.shape[-1] == t.shape[-2]
                                        else t for t in
                                        _scratch(b, s, H, P, N, L)],
             "two of three": lambda: _scratch(b, s, H, P, N, L)[:2]}[fault]()
    if fault is None:
        assert _check_saved(saved, x, b, s, H, P, N, L) is saved
    else:
        with pytest.raises(ValueError, match="scratch"):
            _check_saved(saved, x, b, s, H, P, N, L)


def test_ssd_function_on_cpu_tensors_is_autograd_of_the_plain_scan():
    """Under grad ``kernels.ssd_chunk_scan`` goes through ``_SSDChunkScan``:
    its gradients (cotangents on y and the final state, a carried state)
    equal autograd of the plain forward bit for bit; a cotangent on y
    alone (the final state unused, as training leaves it) works too;
    ``out_state`` under grad and a dy of the wrong shape raise."""
    rng = np.random.default_rng(11)
    args = _scan_inputs(rng, 2, 45, 3, 8, 16, True)
    dy = torch.from_numpy(rng.standard_normal((2, 45, 3, 8)).astype(
        np.float32))
    dh = torch.from_numpy(rng.standard_normal((2, 3, 8, 16)).astype(
        np.float32))
    for with_dh in (True, False):
        ins = [t.clone().requires_grad_(True) for t in args]
        y, h = kernels.ssd_chunk_scan(*ins, 32)
        outs, cots = ([y, h], [dy, dh]) if with_dh else ([y], [dy])
        got = torch.autograd.grad(outs, ins, cots)
        ins2 = [t.clone().requires_grad_(True) for t in args]
        y2, h2 = ref.ssd_chunk_scan_ref(*ins2, 32)
        want = torch.autograd.grad([y2, h2][:len(outs)], ins2, cots)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    ins = [t.clone().requires_grad_(True) for t in args]
    with pytest.raises(ValueError, match="out_state"):
        kernels.ssd_chunk_scan(*ins, 32, out_state=torch.zeros(2, 3, 8, 16))
    with pytest.raises(ValueError, match="dy"):
        kernels.ssd_chunk_scan_bwd(*args, 32, dy[:, :-1])
    with torch.no_grad():
        y, h = kernels.ssd_chunk_scan(*ins, 32)
    assert y.grad_fn is None


def test_conv_function_on_cpu_tensors_is_autograd_of_the_plain_conv():
    """Under grad ``kernels.causal_conv`` goes through ``_CausalConv``: dx,
    dw and dtail (cotangents on the output and the new tail, or on the
    output alone) equal autograd of the plain conv bit for bit; a dout of
    the wrong shape raises."""
    rng = np.random.default_rng(12)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32))
    x, w, tail, dout, dnt = f(2, 9, 20), f(4, 20), f(2, 3, 20), f(2, 9, 20), \
        f(2, 3, 20)
    for with_dnt in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (x, w, tail)]
        out, nt = kernels.causal_conv(*ins)
        outs, cots = ([out, nt], [dout, dnt]) if with_dnt else ([out],
                                                                [dout])
        got = torch.autograd.grad(outs, ins, cots)
        ins2 = [t.clone().requires_grad_(True) for t in (x, w, tail)]
        want = torch.autograd.grad(
            list(ref.causal_conv_ref(*ins2))[:len(outs)], ins2, cots)
        for g, e in zip(got, want):
            assert torch.equal(g, e)
    with pytest.raises(ValueError, match="dout"):
        kernels.causal_conv_bwd(x, w, tail, dout[:, 1:])


# ---------------------------------------------------------------------------
# one Mamba2 layer against jax.vjp, and the chunk of 256
# ---------------------------------------------------------------------------


def _cfgs(arch, **ssm_kw):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32")
    if ssm_kw:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
            jcfg.ssm, **ssm_kw))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(
            tcfg.ssm, **ssm_kw))
    return jcfg, tcfg


def test_layer_gradients_match_jax_vjp():
    """One Mamba2 layer's ``ssd_scan`` (the conv and the scan through
    their Functions) against ``jax.vjp`` of the reference's: 80 tokens in
    chunks of 32, from a nonzero carried state and tails, cotangents on
    y, the final state and the new tails; the gradients of the layer's
    parameters, x, the state and the tails within 1e-4 of each one's
    largest |value|."""
    jcfg, tcfg = _cfgs(ARCH)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    jl = jax.tree.map(lambda a: a[1], jp["blocks"])
    tl = tp["blocks"][1]
    rng = np.random.default_rng(4)
    d_inner, H, P, N = ssm._dims(tcfg)
    cw, b, s = tcfg.ssm.conv_width, 2, 80
    f = lambda *sh: (rng.standard_normal(sh) * 0.5).astype(np.float32)
    x = f(b, s, tcfg.d_model)
    state = dict(ssm=f(b, H, P, N), conv_x=f(b, cw - 1, d_inner),
                 conv_B=f(b, cw - 1, N), conv_C=f(b, cw - 1, N))
    cot_y = f(b, s, tcfg.d_model)
    cot_st = {k: f(*v.shape) for k, v in state.items()}
    tails = ("conv_x", "conv_B", "conv_C")

    def jfn(p, x_, st):
        y, new = jax_ssm.ssd_scan(p, jcfg, x_, initial_state=st["ssm"],
                                  conv_tails_in={k: st[k] for k in tails})
        return y, new

    _, vjp = jax.vjp(jfn, jl, jnp.asarray(x),
                     jax.tree.map(jnp.asarray, state))
    jg_p, jg_x, jg_st = vjp((jnp.asarray(cot_y),
                             jax.tree.map(jnp.asarray, cot_st)))
    paths, flat = zip(*leaves_with_paths(tl))
    req = [t.detach().clone().requires_grad_(True) for t in flat]
    tx = torch.from_numpy(x).requires_grad_(True)
    tst = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in state.items()}
    p = dict(zip((pth[0] for pth in paths), req))
    y, new = ssm.ssd_scan(p, tcfg, tx, initial_state=tst["ssm"],
                          conv_tails_in={k: tst[k] for k in tails})
    keys = list(new)
    wrt = req + [tx] + list(tst.values())
    got = torch.autograd.grad(
        [y] + [new[k] for k in keys], wrt,
        [torch.from_numpy(cot_y)] + [torch.from_numpy(cot_st[k])
                                     for k in keys], allow_unused=True)
    # the block's pre-norm ``ln`` is applied outside ssd_scan: no gradient
    # reaches it here, and the reference's is zeros
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(got, wrt)]
    want = [np.asarray(jg_p[pth[0]]) for pth in paths] + \
        [np.asarray(jg_x)] + [np.asarray(jg_st[k]) for k in tst]
    names = [pth[0] for pth in paths] + ["x"] + list(tst)
    for name, g, w in zip(names, got, want):
        assert _rel_err(g, torch.from_numpy(w)) <= 1e-4, name


def test_chunk_256_reference_gradient_is_not_finite_and_the_ports_is():
    """Reduced mamba2 at the published chunk of 256 over 256 tokens: the
    reference's ``jax.grad`` has non-finite leaves (``ssm.py:102``: where
    masks exp(seg) only after exp overflowed), and so it has at the
    reduced config's own chunk of 32 over these tokens; the port's are all
    finite and equal the reference's at chunk 16, where its gradient is
    finite, on the same parameters and tokens (chunking rewrites the
    recurrence exactly) within 1e-4 of each leaf's largest |g|."""
    j256, t256 = _cfgs(ARCH, chunk_size=256)
    jp = jax_init_params(j256, jax.random.PRNGKey(1))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), t256,
                                device="cpu")
    batch = {"tokens": SyntheticLM(t256.vocab_size, 1, 257,
                                   seed=5).next_batch()}
    grad = lambda chunk: jax.grad(lambda p: jax_loss_fn(
        p, _cfgs(ARCH, chunk_size=chunk)[0],
        jax.tree.map(jnp.asarray, batch), remat=False))(jp)
    finite = lambda g: [bool(np.isfinite(np.asarray(x)).all())
                        for x in jax.tree.leaves(g)]
    for chunk in (256, 32):
        assert not all(finite(grad(chunk))), chunk
    want16 = grad(16)
    assert all(finite(want16))
    _, grads = loss_and_grads(tp, t256, batch, remat=False)
    assert all(bool(g.isfinite().all()) for g in leaves(grads))
    want = bridge.params_from_jax(jax.tree.map(np.asarray, want16), t256,
                                  device="cpu")
    for (path, g), w in zip(leaves_with_paths(grads), leaves(want)):
        assert _rel_err(g, w) <= 1e-4, path


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_remat_full_is_bit_identical_for_ssm_and_hybrid(arch):
    """Recomputing each Mamba2 block (and the hybrid's shared block) in
    the backward changes nothing: the loss and every gradient equal those
    without remat, bit for bit."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed=1, device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 4, 41, seed=8).next_batch()
    la, ga = loss_and_grads(params, cfg, batch, n_microbatches=2,
                            remat="full")
    lb, gb = loss_and_grads(params, cfg, batch, n_microbatches=2,
                            remat=False)
    assert torch.equal(la, lb)
    for a, b in zip(leaves(ga), leaves(gb)):
        assert torch.equal(a, b)
