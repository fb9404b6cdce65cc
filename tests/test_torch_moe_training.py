"""MoE training: the grouped GEMM's gradient and the MoE layer's backward
against the JAX reference on the CPU.

The reference trains its MoE through ``jax.grad`` of
``jax.lax.ragged_dot`` (``repro/models/moe.py:64-67``); the port through
``kernels.grouped_gemm``'s autograd Function, whose backward is
``grouped_gemm_bwd`` (on CPU tensors ``ref.grouped_gemm_bwd_ref``), and
the dispatch's own backward (``models.moe._Dispatch``).

* The grouped GEMM's gradients (dx, dw) against ``jax.vjp`` of
  ``ragged_dot`` on test_torch_moe.py's group sizes and the tile walk's
  edges (empty groups, all rows in one group, rows past the groups, M <
  E, groups past M, M = 0), within 2e-5 (f32) and 2e-2 (bf16) of the
  largest value; dx is 0 on the rows past the groups and dw on an empty
  group.
* ``ref.grouped_gemm_bwd_ref`` against ``torch.autograd`` of
  ``ref.grouped_gemm_ref``, and asked for one gradient at a time.
* ``moe_ffn``'s gradients (the input, the router, wg, wu, wd and the
  shared expert) against JAX's on reduced granite's, llama4's and ds27b's
  MoE layers in f32, on bridged weights: every token routed alike first,
  then each gradient within 2e-5 of its leaf's largest |g| (llama4's
  router, top-1, in shape only: its gradient is 0 in exact arithmetic).
* Two CPU backward runs of the layer give the same bits.
* The bf16 backward kernel's persistent work list
  (``grouped_gemm.bwd_work``, a plain copy of its ``item_at``) covers
  every gradient element once, each dW unit's reduction walking exactly
  its group's rows in order and masking only other groups' rows; the
  gradients computed item by item from it equal the plain backward.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import grouped_gemm, grouped_gemm_bwd, ref
from repro_torch.models import moe

_gg_mod = importlib.import_module("repro_torch.kernels.grouped_gemm")

torch.set_num_threads(1)

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
# (group sizes, M): test_torch_moe.py's SIZES (M 30) and WALK_SIZES
CASES = {
    "routed": ([5, 0, 9, 3, 0, 7, 1, 5], 30),
    "all in one group": ([0, 0, 30, 0, 0, 0, 0, 0], 30),
    "empty ends": ([0, 12, 6, 12, 0, 0, 0, 0], 30),
    "rows past the groups": ([4, 4, 4, 4, 4, 4, 0, 0], 30),
    "empty groups at both ends": ([0, 0, 12, 6, 12, 0, 0, 0], 30),
    "all rows in one group": ([0, 0, 300, 0], 300),
    "M < E": ([1, 0, 0, 2, 0, 0, 0, 0, 1, 0], 4),
    "groups past M": ([20, 20, 20], 33),
    "M = 0": ([0, 0, 0], 0),
}
K, N = 48, 24


def _close(got, want, tol):
    """|got - want| <= tol * max|want| (1 at least) elementwise."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    bridge.assert_close(got, want, tol * scale)


def _inputs(case: str, dtype: str):
    sizes, m = CASES[case]
    rng = np.random.default_rng(len(case))
    x, dy = (jnp.asarray(rng.standard_normal(s).astype(np.float32)
                         ).astype(dtype) for s in ((m, K), (m, N)))
    w = jnp.asarray(rng.standard_normal((len(sizes), K, N)).astype(
        np.float32)).astype(dtype)
    return np.array(sizes, np.int32), m, x, w, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_grouped_gemm_gradients_match_ragged_dot_vjp(case, dtype):
    gs, m, x, w, dy = _inputs(case, dtype)
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(gs)),
                     x, w)
    jdx, jdw = vjp(dy)
    tx, tw = (bridge.to_torch(np.asarray(t), "cpu").requires_grad_(True)
              for t in (x, w))
    before = grouped_gemm_bwd.launches
    y = grouped_gemm(tx, tw, torch.from_numpy(gs))
    y.backward(bridge.to_torch(np.asarray(dy), "cpu"))
    assert grouped_gemm_bwd.launches == before   # CPU tensors never count
    assert tx.grad.dtype == tw.grad.dtype == getattr(torch, dtype)
    _close(tx.grad, np.asarray(jdx, np.float32), TOLS[dtype])
    _close(tw.grad, np.asarray(jdw, np.float32), TOLS[dtype])
    routed = min(int(gs.sum()), m)
    assert not tx.grad[routed:].any()
    bounds = np.minimum(np.concatenate([[0], np.cumsum(gs)]), m)
    for e in range(len(gs)):
        if bounds[e + 1] == bounds[e]:
            assert not tw.grad[e].any(), e


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["routed", "rows past the groups",
                                  "groups past M", "M = 0"])
def test_plain_backward_matches_autograd_of_the_plain_forward(case, dtype):
    """Each gradient accumulated in f32 and rounded once, as autograd of
    the per-group matmuls gives it; one gradient asked for alone is the
    same tensor, and the other None."""
    gs, m, x, w, dy = _inputs(case, dtype)
    tx, tw, tdy = (bridge.to_torch(np.asarray(t), "cpu") for t in (x, w, dy))
    sizes = torch.from_numpy(gs)
    xl, wl = (t.clone().requires_grad_(True) for t in (tx, tw))
    y = ref.grouped_gemm_ref(xl, wl, sizes)
    want = torch.autograd.grad(y, (xl, wl), tdy) if y.requires_grad else (
        torch.zeros_like(tx), torch.zeros_like(tw))
    dx, dw = ref.grouped_gemm_bwd_ref(tx, tw, sizes, tdy)
    for got, exp in ((dx, want[0]), (dw, want[1])):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        _close(got, exp.float().numpy(), TOLS[dtype])
    only_dx = grouped_gemm_bwd(tx, tw, sizes, tdy, need_dw=False)
    only_dw = grouped_gemm_bwd(tx, tw, sizes, tdy, need_dx=False)
    assert only_dx[1] is None and torch.equal(only_dx[0], dx)
    assert only_dw[0] is None and torch.equal(only_dw[1], dw)


def test_grouped_gemm_bwd_rejects_a_cotangent_of_another_shape():
    x, w = torch.zeros(6, 4), torch.zeros(3, 4, 5)
    sizes = torch.tensor([2, 2, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="dy"):
        grouped_gemm_bwd(x, w, sizes, torch.zeros(6, 4))


def test_only_the_gradients_autograd_needs_are_computed(monkeypatch):
    """Weights that do not require grad get no dw: the backward is asked
    for dx alone (and for dw alone when the input does not)."""
    asked = []
    plain = ref.grouped_gemm_bwd_ref

    def spy(x, w, sizes, dy, need_dx, need_dw):
        asked.append((need_dx, need_dw))
        return plain(x, w, sizes, dy, need_dx, need_dw)

    monkeypatch.setattr(ref, "grouped_gemm_bwd_ref", spy)
    sizes = torch.tensor([3, 3], dtype=torch.int32)
    x, w = torch.randn(6, 8), torch.randn(2, 8, 4)
    for xg, wg in ((True, False), (False, True), (True, True)):
        xa, wa = x.clone().requires_grad_(xg), w.clone().requires_grad_(wg)
        grouped_gemm(xa, wa, sizes).sum().backward()
        assert (xa.grad is not None, wa.grad is not None) == (xg, wg)
    assert asked == [(True, False), (False, True), (True, True)]


# test_torch_moe.py's WALK_SIZES and chip_smoke.py's GG_BWD_EDGES are among
# CASES; one more puts every group boundary inside a 64-row slice
BWD_WORK_CASES = {**CASES,
                  "every boundary mid-slice": ([70, 130, 1, 65, 200], 466)}


def _bwd_from_work(items, x, w, dy, mask=True):
    """dx and dw computed item by item as the kernel's work list says (in
    f64): each dX tile from its rows and columns, each dW unit summing its
    slices in order over the 64-row boxes the kernel loads, the masked
    rows zeroed in x's box (or not, with ``mask`` False)."""
    dx, dw = np.full(x.shape, np.nan), np.full(w.shape, np.nan)
    for it in items:
        if it[0] == "dx":
            _, e, r0, rows, c0, _ = it
            cols = slice(c0, c0 + _gg_mod.BWD_BN)
            dx[r0:r0 + rows, cols] = 0.0 if e < 0 else \
                dy[r0:r0 + rows] @ w[e, cols].T
            continue
        _, e, k0, n0, slices = it
        ks = slice(k0, k0 + _gg_mod.BWD_BM)
        ns = slice(n0, n0 + _gg_mod.BWD_BN)
        acc = np.zeros(dw[e, ks, ns].shape)
        for first, taken, masked in slices:
            a = x[first:first + taken + masked, ks].copy()
            if mask:
                a[taken:] = 0.0
            acc += a.T @ dy[first:first + taken + masked, ns]
        dw[e, ks, ns] = acc
    return dx, dw


@pytest.mark.parametrize("kn", [(64, 64), (200, 520), (1536, 512)])
@pytest.mark.parametrize("case", list(BWD_WORK_CASES))
def test_bwd_work_list_covers_each_gradient_once(case, kn):
    """The bf16 backward's persistent work list (bwd_work in
    kernels/grouped_gemm.py, the kernel's item_at): dW's units first, one per (expert, K tile, N
    tile), then dX's tiles, every (row, column tile) of dx in exactly one
    tile of its own group; each unit's slices take exactly the group's rows,
    once and in order, and mask only rows of other groups, boxes cut by M
    alone; the host's grid is positive exactly when there is work, and
    the blocks' strided walk visits every item once.  Computed item by
    item, the list gives the plain backward; without the mask, a unit
    whose box reaches into the next group does not."""
    sizes, m = BWD_WORK_CASES[case]
    k, n = kn
    e_n = len(sizes)
    owner, off = np.full(m, -1), [0]
    for e, size in enumerate(sizes):
        hi = min(off[-1] + size, m)
        owner[off[-1]:hi] = e
        off.append(hi)
    rng = np.random.default_rng(len(case) + k)
    x, dy = rng.standard_normal((m, k)), rng.standard_normal((m, n))
    w = rng.standard_normal((e_n, k, n))
    tt = lambda a: torch.from_numpy(a.astype(np.float32))
    want = ref.grouped_gemm_bwd_ref(tt(x), tt(w), torch.tensor(sizes), tt(dy))
    for need_dx, need_dw in ((True, True), (True, False), (False, True)):
        items = _gg_mod.bwd_work(sizes, m, k, n, need_dx, need_dw)
        dx_items = [it for it in items if it[0] == "dx"]
        dw_items = [it for it in items if it[0] == "dw"]
        assert items == dw_items + dx_items
        seen = np.zeros((m, -(-k // _gg_mod.BWD_BN)), int)
        for _, e, r0, rows, c0, n_slices in dx_items:
            assert 0 < rows <= _gg_mod.BWD_BM
            assert (owner[r0:r0 + rows] == e).all()
            assert n_slices == (-(-n // _gg_mod.BWD_BK) if e >= 0 else 0)
            seen[r0:r0 + rows, c0 // _gg_mod.BWD_BN] += 1
        assert (seen == int(need_dx)).all()
        units = [(e, k0, n0) for _, e, k0, n0, _ in dw_items]
        assert sorted(units) == (sorted(
            (e, k0, n0) for e in range(e_n)
            for k0 in range(0, k, _gg_mod.BWD_BM)
            for n0 in range(0, n, _gg_mod.BWD_BN)) if need_dw else [])
        for _, e, k0, n0, slices in dw_items:
            taken, masked = [], []
            for first, t, mk in slices:
                assert 0 < t <= _gg_mod.BWD_BK and mk >= 0
                assert t + mk == min(_gg_mod.BWD_BK, m - first)
                taken += range(first, first + t)
                masked += range(first + t, first + t + mk)
            assert taken == list(range(off[e], off[e + 1]))
            assert all(owner[r] != e for r in masked)
        grid = _gg_mod.bwd_grid(m, e_n, k, n, 132, need_dx, need_dw)
        assert (grid > 0) == bool(items) and grid <= 132
        walked = sorted(t for b in range(grid)
                        for t in range(b, len(items), grid))
        assert walked == list(range(len(items)))
        dx, dw = _bwd_from_work(items, x, w, dy)
        for got, exp, need in ((dx, want[0], need_dx),
                               (dw, want[1], need_dw)):
            if need:
                _close(got, exp.numpy(), 1e-5)
        leaky = any(mk and x[first + t:first + t + mk].any()
                    for it in dw_items for first, t, mk in it[4])
        if leaky:
            unmasked = _bwd_from_work(dw_items, x, w, dy, mask=False)[1]
            assert not np.allclose(unmasked, want[1].numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# moe_ffn's backward against JAX's, on bridged reduced MoE layers
# ---------------------------------------------------------------------------

ARCHS = {"granite": "granite-moe-3b-a800m",
         "llama4": "llama4-maverick-400b-a17b", "ds27b": "ds27b"}
B, S = 2, 20


def _jax_moe_layer(jp, jcfg):
    """The reference's first MoE layer's ``moe`` params: the first of the
    ``super_blocks.moe`` stack."""
    return jax.tree.map(lambda a: a[0], jp["super_blocks"]["moe"]["moe"])


@pytest.fixture(scope="module", params=list(ARCHS))
def moe_grads(request):
    """Both packages' gradients of sum(moe_ffn(x) * g) for one MoE layer
    of the reduced config in f32, on bridged weights, and the port's
    routes of x."""
    arch = ARCHS[request.param]
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    layer = next(i for i, m in enumerate(tcfg.moe_layer_mask()) if m)
    jmoe = _jax_moe_layer(jp, jcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jax_moe.moe_ffn(p, jcfg, xx, impl="ragged") * g)

    jgx, jgp = jax.grad(lambda xx, p: jloss(p, xx), argnums=(0, 1))(
        jnp.asarray(x), jmoe)

    def tgrads():
        p = tp["blocks"][layer]["moe"]
        flat = {k: v.detach().clone().requires_grad_(True)
                for k, v in p.items() if isinstance(v, torch.Tensor)}
        shared = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.get("shared", {}).items()}
        params = dict(flat, **({"shared": shared} if shared else {}))
        xx = torch.from_numpy(x).requires_grad_(True)
        loss = (moe.moe_ffn(params, tcfg, xx) * torch.from_numpy(g)).sum()
        leaves = [xx, *flat.values(), *shared.values()]
        got = torch.autograd.grad(loss, leaves)
        names = ["x", *flat, *(f"shared.{k}" for k in shared)]
        return dict(zip(names, got))

    want = {"x": np.asarray(jgx)}
    for k, v in jgp.items():
        if isinstance(v, dict):
            want.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            want[k] = np.asarray(v)
    jroutes = np.asarray(jax_moe.route(jmoe, jcfg, jnp.asarray(
        x.reshape(B * S, -1)))[1])
    troutes = moe.route(tp["blocks"][layer]["moe"], tcfg,
                        torch.from_numpy(x.reshape(B * S, -1)))[1]
    return request.param, tcfg, tgrads, want, jroutes, troutes


def test_moe_ffn_gradients_match_jax(moe_grads):
    arch, tcfg, tgrads, want, jroutes, troutes = moe_grads
    np.testing.assert_array_equal(troutes.numpy(), jroutes)
    got = tgrads()
    keys = {"x", "router", "wg", "wu", "wd"}
    if tcfg.moe.n_shared_experts:
        keys |= {f"shared.{k}" for k in ("wi_gate", "wi_up", "wo")}
    assert keys <= set(got) and set(got) == set(want), (set(got), set(want))
    # top-1 normalises its one weight to p / p = 1: the router's gradient
    # is 0 in exact arithmetic, and both packages' are rounding residue
    residue = {"router"} if tcfg.moe.top_k == 1 else set()
    for name, g in got.items():
        w = want[name]
        assert tuple(g.shape) == w.shape, name
        if name in residue:
            continue
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 2e-5 * float(np.abs(w).max()), (arch, name, err)


def test_moe_ffn_backward_is_bit_identical_over_two_runs(moe_grads):
    _, _, tgrads, _, _, _ = moe_grads
    a, b = tgrads(), tgrads()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_dispatch_backward_sums_each_tokens_copies():
    """The dispatch's gradient: token t's is the sum of its k copies'
    gradients, wherever the sort put them."""
    T, k, d = 5, 3, 4
    idx = torch.tensor([[2, 0, 1], [1, 1, 0], [0, 2, 2], [1, 0, 2],
                        [2, 2, 2]])
    order = torch.argsort(idx.reshape(-1), stable=True)
    x = torch.randn(T, d, requires_grad=True)
    xs = moe._Dispatch.apply(x, order, k)
    assert torch.equal(xs, x.detach()[order // k])
    g = torch.randn(T * k, d)
    (gx,) = torch.autograd.grad(xs, x, g)
    want = torch.zeros(T, d)
    for pos, copy in enumerate(order.tolist()):
        want[copy // k] += g[pos]
    torch.testing.assert_close(gx, want, rtol=1e-6, atol=1e-6)
