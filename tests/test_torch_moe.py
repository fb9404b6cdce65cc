"""The port's MoE layer against the JAX reference (CPU, reduced ds27b).

The reduced config keeps ds27b's MoE at test size: d_model 128, 8
routed experts of d_ff 64, top-2, 2 shared experts, one dense layer
before the MoE layers.  The JAX parameters go through
``repro_torch.bridge``; inputs come from numpy with a seed.

* ``route``: weights within 2e-5 and expert indices exactly, in f32;
  a tie keeps the lower expert first, as ``jax.lax.top_k`` does.
* ``_sort_by_expert``: order, tokens, experts and group sizes exactly.
* The grouped GEMM's plain version (the wrapper on CPU tensors) against
  ``jax.lax.ragged_dot``, with empty groups, with all rows in one group
  and with rows past the groups.
* ``moe_ffn`` with its shared experts against the reference's ``ragged``
  form, in f32 and bf16.
* The bf16 kernel's regime, from shapes only, at every M the smoke's
  ds27b phase runs; the plain-Python copy of the kernels' tile walk:
  every row of every group in exactly one tile, no tile mixing two
  groups, rows past the groups covered (to be zeroed), with empty
  groups, all rows in one group, M < E and M = 0.

Tolerances: 2e-5 in f32 and 2e-2 in bf16, of the largest value
(test_torch_model.py's).
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
from repro_torch.kernels import grouped_gemm
from repro_torch.models import moe

_gg_mod = importlib.import_module("repro_torch.kernels.grouped_gemm")

torch.set_num_threads(1)

ARCH = "ds27b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
T = 40                                    # tokens


def _close(got, want, tol):
    """|got - want| <= tol * max|want| elementwise."""
    want = np.asarray(want, np.float32)
    bridge.assert_close(got, want, tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def layer(request):
    """Both packages' first MoE layer (its ``moe`` params) and a (T, d)
    input, in one dtype."""
    dt = request.param
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               param_dtype=dt, kv_cache_dtype=dt)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    jmoe = jax.tree.map(lambda a: a[0], jp["super_blocks"]["moe"]["moe"])
    tmoe = tp["blocks"][tcfg.moe.first_k_dense]["moe"]
    x = np.random.default_rng(0).standard_normal(
        (T, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dt)
    return dt, jcfg, tcfg, jmoe, tmoe, jx, bridge.to_torch(np.asarray(jx),
                                                          "cpu")


def test_reduced_config_has_the_moe_under_test():
    cfg = get_config(ARCH).reduced()
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_ff_expert, m.n_shared_experts,
            m.first_k_dense, m.period) == (8, 2, 64, 2, 1, 1)
    assert cfg.moe_layer_mask() == (False, True, True, True)


def test_route_matches_jax(layer):
    dt, jcfg, tcfg, jmoe, tmoe, jx, tx = layer
    jw, ji = jax_moe.route(jmoe, jcfg, jx)
    tw, ti = moe.route(tmoe, tcfg, tx)
    if dt == "float32":
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tw, np.asarray(jw), TOLS[dt])
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_route_ties_keep_the_lower_expert_first():
    """A zero router makes every expert equally likely: both packages
    take experts 0 and 1, in that order."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    d, e = cfg.d_model, cfg.moe.n_experts
    x = np.random.default_rng(1).standard_normal((5, d)).astype(np.float32)
    _, ji = jax_moe.route({"router": jnp.zeros((d, e))}, jcfg,
                          jnp.asarray(x))
    tw, ti = moe.route({"router": torch.zeros(d, e)}, cfg,
                       torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [[0, 1]] * 5
    np.testing.assert_array_equal(tw.numpy(), 0.5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_by_expert_matches_jax(seed):
    k, E, n = 3, 8, 17
    idx = np.random.default_rng(seed).integers(0, E, (n, k)).astype(np.int32)
    idx[0] = [5, 5, 5] if seed == 2 else idx[0]     # repeated experts
    want = jax_moe._sort_by_expert(jnp.asarray(idx), n, k, E)
    got = moe._sort_by_expert(torch.from_numpy(idx).long(), n, k, E)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].dtype == torch.int32


SIZES = {
    "routed": [5, 0, 9, 3, 0, 7, 1, 5],
    "all in one group": [0, 0, 30, 0, 0, 0, 0, 0],
    "empty ends": [0, 12, 6, 12, 0, 0, 0, 0],
    "rows past the groups": [4, 4, 4, 4, 4, 4, 0, 0],
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", list(SIZES))
def test_grouped_gemm_plain_matches_ragged_dot(sizes, dtype):
    rng = np.random.default_rng(len(sizes))
    m, k, n = 30, 48, 24
    gs = np.array(SIZES[sizes], np.int32)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)).astype(
        dtype)
    w = jnp.asarray(rng.standard_normal((8, k, n)).astype(np.float32)
                    ).astype(dtype)
    want = jax.lax.ragged_dot(x, w, jnp.asarray(gs))
    before = grouped_gemm.launches
    got = grouped_gemm(bridge.to_torch(np.asarray(x), "cpu"),
                       bridge.to_torch(np.asarray(w), "cpu"),
                       torch.from_numpy(gs))
    assert grouped_gemm.launches == before        # CPU tensors never count
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    _close(got, np.asarray(want, np.float32), TOLS[dtype])
    if sizes == "rows past the groups":
        assert not got[gs.sum():].any()


def test_grouped_gemm_rejects_mismatched_shapes():
    x, w = torch.zeros(6, 4), torch.zeros(3, 4, 5)
    with pytest.raises(ValueError):
        grouped_gemm(x, torch.zeros(3, 5, 5),
                     torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        grouped_gemm(x, w, torch.zeros(2, dtype=torch.int32))


def test_moe_ffn_with_shared_experts_matches_jax(layer):
    dt, jcfg, tcfg, jmoe, tmoe, jx, tx = layer
    assert "shared" in tmoe
    b, s = 2, T // 2
    want = jax_moe.moe_ffn(jmoe, jcfg, jx.reshape(b, s, -1), impl="ragged")
    got = moe.moe_ffn(tmoe, tcfg, tx.reshape(b, s, -1))
    assert got.dtype == tx.dtype
    _close(got, np.asarray(want, np.float32), TOLS[dt])


# the copies (tokens x top-6) of every grouped GEMM the smoke's ds27b
# phase runs: the 8-slot decode, the appends of DS27B_APPENDS, and M < 16
PHASE_M = {"decode": [48, 12], "append": [24576, 14394, 10182, 2400, 3264]}


@pytest.mark.parametrize("k, n", [(2560, 1536), (1536, 2560)])
@pytest.mark.parametrize("want", list(PHASE_M))
def test_regime_from_shapes_at_the_phase(want, k, n):
    """ds27b (72 experts): the decode's 48 copies and a 2-token call take
    the decode regime, every append's copies the append regime, for both
    projections; the cut is at 8 rows per expert."""
    for m in PHASE_M[want]:
        assert _gg_mod.regime(m, 72, k, n) == want
    cut = _gg_mod.DECODE_ROWS_PER_GROUP * 72
    assert _gg_mod.regime(cut, 72, k, n) == "decode"
    assert _gg_mod.regime(cut + 1, 72, k, n) == "append"


WALK_SIZES = {
    "routed": ([5, 0, 9, 3, 0, 7, 1, 5], 30),
    "empty groups at both ends": ([0, 0, 12, 6, 12, 0, 0, 0], 30),
    "all rows in one group": ([0, 0, 300, 0], 300),
    "rows past the groups": ([4, 4, 4, 4, 4, 4, 0, 0], 30),
    "M < E": ([1, 0, 0, 2, 0, 0, 0, 0, 1, 0], 4),
    "groups past M": ([20, 20, 20], 33),
    "M = 0": ([0, 0, 0], 0),
}


@pytest.mark.parametrize("bm", [8, 64, 128])
@pytest.mark.parametrize("case", list(WALK_SIZES))
def test_tile_walk_covers_every_row_once(case, bm):
    """The kernels' device tile walk, emulated: each (row, column tile)
    lands in exactly one tile; a tile holds rows of one group only,
    never more than bm; the rows past the groups form tiles of group -1;
    column tiles are the fastest index."""
    sizes, m = WALK_SIZES[case]
    n_ct = 3
    tiles = _gg_mod.tile_walk(sizes, m, bm, n_ct)
    owner = {}                            # row -> group, from the sizes
    lo = 0
    for e, size in enumerate(sizes):
        for r in range(lo, min(lo + size, m)):
            owner[r] = e
        lo = min(lo + size, m)
    seen = {}
    for t, (e, r0, rows, ct) in enumerate(tiles):
        assert 0 < rows <= bm and ct == t % n_ct
        for r in range(r0, r0 + rows):
            assert owner.get(r, -1) == e, (case, t, r)
            assert (r, ct) not in seen
            seen[(r, ct)] = t
    assert set(seen) == {(r, ct) for r in range(m) for ct in range(n_ct)}
    if m == 0:
        assert tiles == []
