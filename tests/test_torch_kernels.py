"""The port's kernel plain versions against the JAX Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as
tests/test_kernels.py runs them; the port's wrappers, given CPU tensors,
compute their plain PyTorch versions (the CUDA kernels are held against
those same plain versions on the card by chip_smoke.py).  Inputs are made
with numpy from a seed and handed to both packages.

Tolerances are tests/test_kernels.py's: 2e-5 in float32 (two softmax
implementations summing in different orders) and 2e-2 in bfloat16 (one
bf16 rounding of p and of the output).  The gather and the scatter must
be exact.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models.layers import append_attend as jax_append_attend
from repro.models.layers import decode_attend as jax_decode_attend
from repro_torch import kernels
from repro_torch.bridge import assert_close, assert_exact, to_torch
from repro_torch.kernels import ref

# tiny CPU tensors: extra intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounds from the same float32 in both)."""
    x = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x).astype(dtype)
    return j, to_torch(np.asarray(j), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,bq,bk", [
    (1, 4, 4, 64, 64, 64, 32, 32),       # MHA square
    (2, 8, 2, 32, 256, 64, 32, 64),      # GQA append (short q, long kv)
    (1, 8, 1, 17, 130, 32, 16, 64),      # g = 8, ragged (padding paths)
])
def test_flash_plain_matches_pallas(dtype, b, hq, hkv, sq, skv, dh, bq, bk):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (b, hq, sq, dh), dtype)
    kj, kt = _pair(rng, (b, hkv, skv, dh), dtype)
    vj, vt = _pair(rng, (b, hkv, skv, dh), dtype)
    want = ops.flash_attention(qj, kj, vj, block_q=bq, block_k=bk)
    got = kernels.flash_attention(qt, kt, vt)
    assert got.dtype == qt.dtype
    assert_close(got, np.asarray(want.astype(jnp.float32)), TOLS[dtype])


@pytest.mark.parametrize("softcap,window,causal", [
    (30.0, 0, True), (0.0, 64, True), (50.0, 48, True), (0.0, 0, False)])
def test_flash_plain_softcap_window_noncausal(softcap, window, causal):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (1, 4, 96, 64), "float32")
    kj, kt = _pair(rng, (1, 2, 160, 64), "float32")
    vj, vt = _pair(rng, (1, 2, 160, 64), "float32")
    want = ops.flash_attention(qj, kj, vj, softcap=softcap, window=window,
                               causal=causal, block_q=32, block_k=32)
    got = kernels.flash_attention(qt, kt, vt, softcap=softcap, window=window,
                                  causal=causal)
    assert_close(got, np.asarray(want), 3e-5)   # test_kernels.py's 3e-5


def test_flash_kv_lens_is_ragged_append_attend():
    """Per-row kv_lens covers the model's ragged append (layers.py:213):
    the flash contract with kv_lens = lengths + s_app over the padded
    cache equals JAX append_attend, and kv_lens = skv everywhere is the
    Pallas contract exactly."""
    rng = np.random.default_rng(2)
    b, s_app, hq, hkv, S, dh = 2, 5, 8, 2, 40, 32
    qj, qt = _pair(rng, (b, s_app, hq, dh), "float32")
    kj, kt = _pair(rng, (b, S, hkv, dh), "float32")
    vj, vt = _pair(rng, (b, S, hkv, dh), "float32")
    lengths = np.array([3, 21], np.int32)
    want = jax_append_attend(qj, kj, vj, jnp.asarray(lengths))
    got = kernels.flash_attention(
        qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
        kv_lens=torch.from_numpy(lengths + s_app)).transpose(1, 2)
    assert_close(got, np.asarray(want), 2e-5)
    full = torch.full((b,), S, dtype=torch.int32)
    q2 = qt.transpose(1, 2)
    k2, v2 = kt.transpose(1, 2), vt.transpose(1, 2)
    assert torch.equal(kernels.flash_attention(q2, k2, v2, kv_lens=full),
                       kernels.flash_attention(q2, k2, v2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hkv,g,dh,npool,pt,npages", [
    (2, 4, 2, 64, 16, 16, 6),
    (1, 1, 8, 128, 8, 32, 4),
    (3, 2, 1, 32, 32, 8, 10),
])
def test_paged_plain_matches_pallas(dtype, b, hkv, g, dh, npool, pt, npages):
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, (b, hkv, g, dh), dtype)
    kj, kt = _pair(rng, (npool, pt, hkv, dh), dtype)
    vj, vt = _pair(rng, (npool, pt, hkv, dh), dtype)
    tbl = rng.integers(0, npool, (b, npages)).astype(np.int32)
    lengths = rng.integers(1, npages * pt, (b,)).astype(np.int32)
    want = ops.paged_attention(qj, kj, vj, jnp.asarray(tbl),
                               jnp.asarray(lengths))
    got = kernels.paged_attention(qt, kt, vt, torch.from_numpy(tbl),
                                  torch.from_numpy(lengths))
    assert_close(got, np.asarray(want.astype(jnp.float32)), TOLS[dtype])


@pytest.mark.parametrize("dtype", ["uint8", "bfloat16", "float32"])
def test_gather_plain_matches_pallas_exactly(dtype):
    rng = np.random.default_rng(4)
    npool, nl, pt, feat, n = 8, 4, 16, 32, 5
    if dtype == "uint8":
        pool_np = rng.integers(0, 255, (npool, nl, pt, feat)).astype(np.uint8)
        pool_j = jnp.asarray(pool_np)
    else:
        pool_j = jnp.asarray(rng.standard_normal(
            (npool, nl, pt, feat)).astype(np.float32)).astype(dtype)
    pool_t = to_torch(np.asarray(pool_j), "cpu")
    tbl = rng.choice(npool, n, replace=False).astype(np.int32)
    for layer in (0, nl - 1):
        want = ops.kv_layer_gather(pool_j, jnp.asarray(tbl), layer=layer)
        got = kernels.kv_layer_gather(pool_t, torch.from_numpy(tbl),
                                      layer=layer)
        assert_exact(got.view(torch.uint8) if dtype != "uint8" else got,
                     np.asarray(want).view(np.uint8))


@pytest.mark.parametrize("dtype", ["uint8", "bfloat16", "float32"])
def test_scatter_plain_matches_pallas_exactly(dtype):
    """pool[table[i], layer] = stream[i] with a permuted distinct table:
    the plain version equals the Pallas kernel (interpret mode) byte for
    byte, and the CPU wrapper writes the given pool in place, returns it
    and counts no launch."""
    rng = np.random.default_rng(6)
    npool, nl, pt, feat, n = 8, 4, 16, 32, 5
    if dtype == "uint8":
        pool_j = jnp.asarray(rng.integers(0, 255, (npool, nl, pt, feat)
                                          ).astype(np.uint8))
        stream_j = jnp.asarray(rng.integers(0, 255, (n, pt, feat)
                                            ).astype(np.uint8))
    else:
        pool_j, stream_j = (jnp.asarray(rng.standard_normal(shape).astype(
            np.float32)).astype(dtype)
            for shape in ((npool, nl, pt, feat), (n, pt, feat)))
    tbl = rng.permutation(npool)[:n].astype(np.int32)
    as_u8 = lambda t: t.view(torch.uint8) if dtype != "uint8" else t
    kernels.reset_launch_counts()
    for layer in (0, nl - 1):
        want = ops.kv_layer_scatter(pool_j.copy(), jnp.asarray(tbl),
                                    stream_j, layer=layer)
        pool_t = to_torch(np.asarray(pool_j), "cpu")
        stream_t = to_torch(np.asarray(stream_j), "cpu")
        plain = ref.kv_layer_scatter_ref(pool_t.clone(), torch.from_numpy(tbl),
                                         stream_t, layer=layer)
        assert_exact(as_u8(plain), np.asarray(want).view(np.uint8))
        got = kernels.kv_layer_scatter(pool_t, torch.from_numpy(tbl),
                                       stream_t, layer=layer)
        assert got is pool_t
        assert_exact(as_u8(pool_t), np.asarray(want).view(np.uint8))
    assert kernels.kv_layer_scatter.launches == 0


def _bytes_pair(rng, shape, dtype):
    """Random values of ``dtype`` as a JAX array and a CPU torch tensor."""
    if dtype == "uint8":
        x = jnp.asarray(rng.integers(0, 256, shape).astype(np.uint8))
    else:
        x = jnp.asarray(rng.standard_normal(shape).astype(
            np.float32)).astype(dtype)
    return x, to_torch(np.asarray(x), "cpu")


@pytest.mark.parametrize("dtype", ["uint8", "bfloat16", "float32"])
@pytest.mark.parametrize("layers", ["all", "sub"])
def test_multi_layer_scatter_matches_pallas_per_layer(dtype, layers):
    """A range of layers in one call is the Pallas kernel (interpret mode)
    applied to each layer of the range: the plain version and the CPU
    wrapper give its bytes, through a permuted distinct table on a pool
    larger than the table, and the wrapper writes the given pool in
    place, returns it and counts no launch."""
    rng = np.random.default_rng(10)
    npool, nl, pt, feat, n = 24, 6, 4, 48, 7
    rng_layers = range(nl) if layers == "all" else range(2, 5)
    pool_j, pool_t = _bytes_pair(rng, (npool, nl, pt, feat), dtype)
    stream_j, stream_t = _bytes_pair(rng, (len(rng_layers), n, pt, feat),
                                     dtype)
    tbl = rng.permutation(npool)[:n].astype(np.int32)
    want = pool_j.copy()
    for j, li in enumerate(rng_layers):
        want = ops.kv_layer_scatter(want, jnp.asarray(tbl), stream_j[j],
                                    layer=li)
    want = np.asarray(want).view(np.uint8)
    as_u8 = lambda t: t.view(torch.uint8) if dtype != "uint8" else t
    plain = ref.kv_layer_scatter_ref(pool_t.clone(), torch.from_numpy(tbl),
                                     stream_t, layer=rng_layers)
    assert_exact(as_u8(plain), want)
    kernels.reset_launch_counts()
    got = kernels.kv_layer_scatter(pool_t, torch.from_numpy(tbl), stream_t,
                                   layer=rng_layers)
    assert got is pool_t
    assert_exact(as_u8(pool_t), want)
    assert kernels.kv_layer_scatter.launches == 0


def test_scatter_rejects_streams_and_ranges_that_do_not_match():
    pool = torch.zeros((4, 3, 2, 16), dtype=torch.uint8)
    tbl = torch.tensor([2, 0], dtype=torch.int32)
    ok = torch.ones((3, 2, 2, 16), dtype=torch.uint8)
    kernels.kv_layer_scatter(pool, tbl, ok, layer=range(3))
    assert (pool[[2, 0]] == 1).all() and (pool[[1, 3]] == 0).all()
    for bad in (ok[:2], ok[0], ok.view(torch.int8),
                torch.ones((3, 2, 2, 8), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            kernels.kv_layer_scatter(pool, tbl, bad, layer=range(3))
    with pytest.raises(ValueError):        # one layer takes (n, pt, feat)
        kernels.kv_layer_scatter(pool, tbl, ok, layer=0)
    with pytest.raises(ValueError):        # not consecutive
        kernels.kv_layer_scatter(pool, tbl, ok[:2], layer=range(0, 3, 2))
    with pytest.raises(ValueError):        # empty
        kernels.kv_layer_scatter(pool, tbl, ok[:0], layer=range(1, 1))
    with pytest.raises(IndexError):
        kernels.kv_layer_scatter(pool, tbl, ok[:2], layer=range(2, 4))
    with pytest.raises(IndexError):
        kernels.kv_layer_scatter(pool, tbl, ok[:2], layer=range(-1, 1))


def test_cpu_wrappers_compute_plain_versions_without_counting():
    """On CPU tensors every wrapper returns its plain version and counts
    no launch: a launch count means the CUDA kernel ran."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 2, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 9, 32)).astype(np.float32))
    assert torch.equal(kernels.flash_attention(q, k, k),
                       ref.flash_attention_ref(q, k, k))
    pool = torch.arange(2 * 3 * 4 * 16, dtype=torch.uint8).view(2, 3, 4, 16)
    tbl = torch.tensor([1, 0], dtype=torch.int32)
    assert torch.equal(kernels.kv_layer_gather(pool, tbl, layer=2),
                       pool[[1, 0], 2])
    with pytest.raises(IndexError):
        kernels.kv_layer_gather(pool, tbl, layer=3)
    stream = torch.full((2, 4, 16), 7, dtype=torch.uint8)
    before = pool.clone()
    assert kernels.kv_layer_scatter(pool, tbl, stream, layer=1) is pool
    assert (pool[:, 1] == 7).all()
    assert torch.equal(pool[:, 0::2], before[:, 0::2])
    with pytest.raises(IndexError):
        kernels.kv_layer_scatter(pool, tbl, stream, layer=3)
    with pytest.raises(ValueError):
        kernels.kv_layer_scatter(pool, tbl, stream[:1], layer=0)
    assert set(kernels.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# What surrounds the split-K kernels: the key-split arithmetic (the combine
# kernels' plain version), the host's launch plan, the alignment checks
# ---------------------------------------------------------------------------

_flash_mod = importlib.import_module("repro_torch.kernels.flash_attention")
_paged_mod = importlib.import_module("repro_torch.kernels.paged_attention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pt,chunk,window", [
    pytest.param(4, 8, 0, id="4-8"), pytest.param(4, 64, 0, id="4-64"),
    pytest.param(16, 24, 0, id="16-24"), pytest.param(1, 5, 0, id="1-5"),
    # windows whose start falls inside a page and inside a split
    pytest.param(4, 8, 6, id="4-8-w6"), pytest.param(4, 64, 50, id="4-64-w50"),
    pytest.param(16, 24, 37, id="16-24-w37")])
def test_paged_split_ref_matches_unsplit_and_pallas(dtype, pt, chunk,
                                                    window):
    """Partials over key ranges of ``chunk`` then the merge equal the
    unsplit plain version and the Pallas kernel (interpret mode), at
    ragged lengths around the range and page edges.  The Pallas kernel
    has no window: with one, the reference model's ``decode_attend`` over
    the gathered pages is the yardstick."""
    rng = np.random.default_rng(7)
    b, hkv, g, dh, npages = 6, 2, 4, 32, 80 // pt
    npool = b * npages
    qj, qt = _pair(rng, (b, hkv, g, dh), dtype)
    kj, kt = _pair(rng, (npool, pt, hkv, dh), dtype)
    vj, vt = _pair(rng, (npool, pt, hkv, dh), dtype)
    tbl = rng.permutation(npool).reshape(b, npages).astype(np.int32)
    lengths = np.array([1, chunk - 1, chunk, chunk + 1, 63, npages * pt],
                       np.int32).clip(1, npages * pt)
    args = (qt, kt, vt, torch.from_numpy(tbl), torch.from_numpy(lengths))
    got = ref.paged_attention_split_ref(*args, chunk=chunk, window=window)
    assert got.dtype == qt.dtype
    assert_close(got, ref.paged_attention_ref(*args, window=window).float()
                 .numpy(), TOLS[dtype])
    if window:
        cache = lambda p: p[jnp.asarray(tbl)].reshape(b, npages * pt, hkv,
                                                      dh)
        want = jax_decode_attend(qj.reshape(b, 1, hkv * g, dh), cache(kj),
                                 cache(vj), jnp.asarray(lengths),
                                 window=window).reshape(b, hkv, g, dh)
    else:
        want = ops.paged_attention(qj, kj, vj, jnp.asarray(tbl),
                                   jnp.asarray(lengths))
    assert_close(got, np.asarray(want.astype(jnp.float32)), TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap,window,causal,sq,chunk", [
    (0.0, 0, True, 17, 64), (30.0, 48, True, 40, 32),
    (0.0, 0, False, 33, 64), (0.0, 0, True, 1, 16)])
def test_flash_split_ref_matches_unsplit_and_pallas(dtype, softcap, window,
                                                    causal, sq, chunk):
    rng = np.random.default_rng(8)
    b, hq, hkv, skv, dh = 2, 8, 2, 150, 32
    qj, qt = _pair(rng, (b, hq, sq, dh), dtype)
    kj, kt = _pair(rng, (b, hkv, skv, dh), dtype)
    vj, vt = _pair(rng, (b, hkv, skv, dh), dtype)
    kw = dict(causal=causal, softcap=softcap, window=window)
    got = ref.flash_attention_split_ref(qt, kt, vt, chunk=chunk, **kw)
    assert_close(got, ref.flash_attention_ref(qt, kt, vt, **kw).float()
                 .numpy(), TOLS[dtype])
    want = ops.flash_attention(qj, kj, vj, block_q=16, block_k=32, **kw)
    assert_close(got, np.asarray(want.astype(jnp.float32)),
                 3e-5 if dtype == "float32" else TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_split_ref_ragged_kv_lens(dtype):
    """Per-row kv_lens with ranges that straddle each row's end: the
    split arithmetic equals the unsplit plain version."""
    rng = np.random.default_rng(9)
    _, qt = _pair(rng, (3, 4, 9, 64), dtype)
    _, kt = _pair(rng, (3, 4, 200, 64), dtype)
    _, vt = _pair(rng, (3, 4, 200, 64), dtype)
    lens = torch.tensor([9, 64, 200], dtype=torch.int32)
    for chunk in (64, 128):
        got = ref.flash_attention_split_ref(qt, kt, vt, chunk=chunk,
                                            kv_lens=lens, window=40)
        want = ref.flash_attention_ref(qt, kt, vt, kv_lens=lens, window=40)
        assert_close(got, want.float().numpy(), TOLS[dtype])


def test_combine_ignores_splits_without_valid_keys():
    """A split with no valid key (l = 0) does not enter the merge, and a
    row with no valid key at all comes out as 0, the kernels' contract."""
    s = torch.tensor([[[1.0, 2.0, 3.0, 4.0], [0.5, 0.5, 0.5, 0.5]]])
    valid = torch.tensor([[[True, True, False, False],
                           [False, False, False, False]]])
    v = torch.arange(8, dtype=torch.float32).view(1, 4, 2)
    m, l, acc = ref.split_partials_ref(s, valid, v, 2)
    assert l[1].eq(0).all() and l[0, 0, 1] == 0
    out = ref.combine_ref(m, l, acc)
    p = torch.softmax(torch.tensor([1.0, 2.0]), 0)
    assert torch.allclose(out[0, 0], p @ v[0, :2])
    assert torch.equal(out[0, 1], torch.zeros(2))


@pytest.mark.parametrize("pt", [1, 4, 16, 64])
def test_paged_plan_puts_every_key_in_exactly_one_split(pt):
    """For any page size, page count and grid, split i takes keys [i *
    chunk, (i + 1) * chunk): every key position below max_pages * pt lands
    in exactly one split and no split lies wholly past the keys."""
    for max_pages in (1, 2, 3, 31, 32, 67, 129, 512):
        for b, hkv, n_sm in ((1, 1, 132), (8, 16, 132), (2, 16, 132),
                             (64, 16, 132), (3, 2, 7)):
            n_keys = max_pages * pt
            n_split, chunk = _paged_mod.plan(b, hkv, pt, max_pages, n_sm)
            assert chunk > 0 and chunk % _paged_mod.KEY_UNIT == 0
            split_of = np.arange(n_keys) // chunk
            assert split_of.max() == n_split - 1       # none past the keys
            assert np.bincount(split_of, minlength=n_split).min() > 0
            assert n_split * chunk >= n_keys > (n_split - 1) * chunk


@pytest.mark.parametrize("g", [1, 4, 16, 64])
def test_flash_plan_puts_every_key_in_exactly_one_split(g):
    for skv in (1, 63, 64, 65, 130, 2048, 5000):
        for b, hkv, sq in ((1, 16 // min(g, 16), 128), (2, 1, 1),
                           (4, 8, 1024), (1, 1, 77)):
            for bf16 in (True, False):
                n_split, chunk = _flash_mod.plan(b, hkv * g, hkv, sq, skv,
                                                 132, bf16)
                assert chunk % _flash_mod.KEY_TILE == 0
                assert n_split * chunk >= skv > (n_split - 1) * chunk
                if not bf16:
                    assert n_split == 1


def test_plans_at_the_main_path_shapes():
    """The append (32 query tiles) splits so the grid fills 132 SMs; the
    1024-token prefill (256 tiles) does not split; the decode of 8
    sequences x 16 kv heads splits 2048 key positions 8 ways, with GQA
    g = 4 (4 kv heads) 16 ways."""
    assert _flash_mod.plan(1, 16, 16, 128, 2048, 132) == (16, 128)
    assert _flash_mod.plan(1, 16, 16, 1024, 2048, 132) == (1, 2048)
    assert _flash_mod.plan(1, 16, 16, 128, 2048, 132, False) == (1, 2048)
    assert _paged_mod.plan(8, 16, 64, 32, 132) == (8, 256)
    assert _paged_mod.plan(8, 4, 64, 32, 132) == (16, 128)
    assert _paged_mod.plan(2, 16, 4, 67, 132) == (3, 128)


def test_require_aligned_raises_on_misalignment():
    from repro_torch.kernels import build
    build.require_aligned("k", {"q": 0x7f0000000100}, {"q": (8192, 64, 1024)},
                          2)
    build.require_aligned("k", {"q": 0x10}, {"q": (4, 12)}, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        build.require_aligned("k", {"q": 0x7f0000000102}, {}, 2)
    with pytest.raises(ValueError, match="multiples of 8"):
        build.require_aligned("k", {"q": 0x100}, {"q": (8192, 68, 1028)}, 2)
    with pytest.raises(ValueError, match="multiples of 4"):
        build.require_aligned("k", {"q": 0x100}, {"q": (6,)}, 4)


def test_main_path_views_pass_the_alignment_check():
    """The model's attention operands, transposed views of contiguous
    (b, s, h, dh) activations and of one layer of the stacked padded
    cache, satisfy the bf16 kernel's 16-byte rule; a view one element in
    does not."""
    from repro_torch.kernels import build
    q = torch.empty(2, 128, 16, 64, dtype=torch.bfloat16).transpose(1, 2)
    kc_all = torch.empty(3, 2, 2048, 16, 64, dtype=torch.bfloat16)
    k = kc_all[1].transpose(1, 2)
    ts = {"q": q, "k": k}
    build.require_aligned("flash_attention",
                          {n: t.data_ptr() for n, t in ts.items()},
                          {n: t.stride()[:3] for n, t in ts.items()}, 2)
    off = kc_all[1].view(-1)[1:].view(-1)[:2048 * 16 * 64].view(
        1, 2048, 16, 64)
    with pytest.raises(ValueError):
        build.require_aligned("flash_attention", {"k": off.data_ptr()},
                              {"k": off.stride()[:3]}, 2)


# ---------------------------------------------------------------------------
# The copy engine's plan (csrc/kv_copy.cuh, kernels/kv_copy.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pt", [4, 16, 64])
@pytest.mark.parametrize("chunk_bytes", [32 << 10, 4096, 48])
def test_copy_plan_puts_every_byte_in_exactly_one_chunk(monkeypatch, pt,
                                                        chunk_bytes):
    """Every byte of every slab lies in exactly one work item: the chunks
    tile the slab, ``(n_chunks - 1) * chunk < slab <= n_chunks * chunk``
    (the kernel's host check refuses any other plan), chunks are whole
    16-byte vectors, only a slab's last chunk is short, and the grid
    is within the items and the SMs, at 4-, 16- and 64-token pages of
    rows that do and do not divide into chunks."""
    from repro_torch.kernels import kv_copy
    monkeypatch.setattr(kv_copy, "CHUNK_BYTES", chunk_bytes)
    for row in (16, 4096, 10240, 10252, 8192 + 48):
        slab = pt * row
        for n_slabs, n_sm in ((1, 132), (3, 132), (16, 132), (384, 132),
                              (5, 2)):
            chunk, n_chunks, grid = kv_copy.plan(n_slabs, slab, n_sm)
            assert chunk % 16 == 0 and chunk <= max(chunk_bytes, 16)
            assert (n_chunks - 1) * chunk < slab <= n_chunks * chunk
            assert 1 <= grid <= min(n_slabs * n_chunks,
                                    n_sm * kv_copy.BLOCKS_PER_SM)
            # chunk c of a slab covers [c * chunk, min((c + 1) * chunk,
            # slab)): the last is the only short one, a whole number of
            # 16-byte vectors, and none is empty
            last = slab - (n_chunks - 1) * chunk
            assert 0 < last <= chunk and last % 16 == 0


def test_copy_plan_at_the_main_path_shapes():
    """One layer of 16 (or 19) 64-token pages of 4096-byte rows is 128
    (152) items of 32 KiB, a block each; the round-1 persist of 16 blocks
    x 24 layers is 3072 items over 8 blocks per SM, the round-2 persist
    (3 blocks) 576 items; a 4-token page of 4096-byte rows is one
    chunk, of 10240-byte rows two even ones, of 10252-byte rows two with
    the last 16 bytes short."""
    from repro_torch.kernels import kv_copy
    slab = 64 * 4096
    assert kv_copy.plan(16, slab, 132) == (32768, 8, 128)
    assert kv_copy.plan(19, slab, 132) == (32768, 8, 152)
    assert kv_copy.plan(16 * 24, slab, 132) == (32768, 8, 1056)
    assert kv_copy.plan(3 * 24, slab, 132) == (32768, 8, 576)
    assert kv_copy.plan(1, 4 * 4096, 132) == (16384, 1, 1)
    assert kv_copy.plan(16, 4 * 10240, 132) == (20480, 2, 32)
    chunk, n_chunks, _ = kv_copy.plan(16, 4 * 10252, 132)
    assert (chunk, n_chunks) == (20512, 2)
    assert 4 * 10252 - (n_chunks - 1) * chunk == 20496   # the short last


# ---------------------------------------------------------------------------
# flash's gradient: the plain backward against jax.grad of the reference's
# jnp attention (its training path: XLA differentiates _attend_dense_impl,
# repro/models/layers.py:100), and the autograd glue on CPU tensors
# ---------------------------------------------------------------------------

def _grads_close(got, want, tol):
    """Each of (dq, dk, dv) within ``tol`` of its own largest |value|."""
    for g, w in zip(got, want):
        g = np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), \
            (np.abs(g - w).max(), np.abs(w).max())


_BWD_CASES = [
    pytest.param(dict(hq=4, hkv=4, s=48), id="causal-mha"),
    pytest.param(dict(hq=8, hkv=2, s=48), id="gqa-g4"),
    pytest.param(dict(hq=4, hkv=4, s=48, causal=False), id="bidirectional"),
    pytest.param(dict(hq=4, hkv=2, s=48, window=16), id="window"),
    pytest.param(dict(hq=4, hkv=2, s=48, softcap=5.0), id="softcap"),
    pytest.param(dict(hq=4, hkv=4, s=77), id="s77"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_bwd_plain_matches_jax_grad(dtype, case):
    """ref.flash_attention_bwd_ref against jax.vjp of the reference's
    _attend_dense_impl on the same numpy inputs, q scaled by 2 so the
    softcap bends: within 2e-5 (f32) and 2e-2 (bf16) of each gradient's
    largest |value| (bf16: the two frameworks round p, dP and the
    outputs at their own places)."""
    import jax
    from repro.models.layers import _attend_dense_impl
    causal = case.get("causal", True)
    softcap, window = case.get("softcap", 0.0), case.get("window", 0)
    b, s, dh = 2, case["s"], 32
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng, (b, s, case["hq"], dh), dtype)
    qj, qt = qj * 2, qt * 2
    kj, kt = _pair(rng, (b, s, case["hkv"], dh), dtype)
    vj, vt = _pair(rng, (b, s, case["hkv"], dh), dtype)
    dj, dt = _pair(rng, (b, s, case["hq"], dh), dtype)

    def attend(q, k, v):
        return _attend_dense_impl(q, k, v, causal=causal,
                                  window=window or None, softcap=softcap,
                                  q_offset=0, kv_offset=0, kv_valid=None,
                                  scale=None)

    _, vjp = jax.vjp(attend, qj, kj, vj)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(dj)]
    got = ref.flash_attention_bwd_ref(
        *(x.transpose(1, 2) for x in (qt, kt, vt, dt)), causal=causal,
        softcap=softcap, window=window)
    assert all(g.dtype == qt.dtype for g in got)
    _grads_close([g.transpose(1, 2).float().numpy() for g in got], want,
                 TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_lse_plain_matches_jax_logsumexp(dtype, case):
    """The plain log-sum-exp (ref.flash_attention_ref(..., return_lse=True),
    what the forward kernel writes for the backward) against
    jax.nn.logsumexp of the reference's masked, scaled, softcapped scores
    (its own _scores, _softcap and _mask_bias) on the same numpy inputs, q
    scaled by 2 so the softcap bends: within 1e-5 (atol and rtol) in both
    dtypes, the scores being f32 products of the same values in both
    frameworks, summed in different orders.  The output beside it is the
    plain forward's, bit for bit."""
    import jax
    from repro.models.layers import _mask_bias, _scores, _softcap
    causal = case.get("causal", True)
    softcap, window = case.get("softcap", 0.0), case.get("window", 0)
    b, s, dh, hq, hkv = 2, case["s"], 32, case["hq"], case["hkv"]
    rng = np.random.default_rng(12)
    qj, qt = _pair(rng, (b, s, hq, dh), dtype)
    qj, qt = qj * 2, qt * 2
    kj, kt = _pair(rng, (b, s, hkv, dh), dtype)
    _, vt = _pair(rng, (b, s, hkv, dh), dtype)
    sj = _softcap(_scores(qj.reshape(b, s, hkv, hq // hkv, dh), kj,
                          1.0 / np.sqrt(dh)), softcap)
    ids = jnp.arange(s)
    sj = sj + _mask_bias(ids, ids, causal=causal, window=window or None,
                         kv_valid=None)
    want = np.asarray(jax.nn.logsumexp(sj, axis=-1)).reshape(b, hq, s)
    q, k, v = (x.transpose(1, 2) for x in (qt, kt, vt))
    kw = dict(causal=causal, softcap=softcap, window=window)
    o, lse = ref.flash_attention_ref(q, k, v, **kw, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, ref.flash_attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("kw", [
    dict(), dict(causal=False), dict(window=7, softcap=3.0)])
def test_flash_function_on_cpu_gives_autograd_of_the_plain_forward(kw):
    """With grad on, flash_attention on CPU tensors goes through its
    autograd Function (forward: the plain version; backward: the plain
    backward) and gives the gradients autograd takes through the plain
    forward, and it counts no launch.  Its forward saves q, k, v, o and
    the plain log-sum-exp, which the card's backward reads."""
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g).transpose(1, 2)
               .requires_grad_(True)
               for shape in ((2, 21, 4, 32), (2, 21, 2, 32), (2, 21, 2, 32)))
    out = kernels.flash_attention(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "_FlashBackward"
    with torch.no_grad():
        want_o, want_lse = ref.flash_attention_ref(q, k, v, **kw,
                                                   return_lse=True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and torch.equal(saved[3], want_o)
    assert saved[4].shape == (2, 4, 21) and torch.equal(saved[4], want_lse)
    do = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, **kw),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert set(kernels.launch_counts().values()) == {0}


def test_flash_without_grad_is_the_forward_alone():
    """Without grad (no input requiring it, or grad mode off) the call
    is the forward alone: no autograd node and the plain version's
    output; append calls with kv_lens and MLA's widths keep serving."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn((1, 4, 9, 32), generator=g)
    k = torch.randn((1, 2, 30, 32), generator=g)
    lens = torch.tensor([30], dtype=torch.int32)
    out = kernels.flash_attention(q, k, k, kv_lens=lens)
    assert out.grad_fn is None
    assert torch.equal(out, ref.flash_attention_ref(q, k, k, kv_lens=lens))
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert kernels.flash_attention(qg, k, k, kv_lens=lens).grad_fn is None
    # with grad, an append (kv_lens, or sq != skv) has no backward
    with pytest.raises(NotImplementedError, match="full-sequence"):
        kernels.flash_attention(qg, k, k, kv_lens=lens)
    with pytest.raises(NotImplementedError, match="full-sequence"):
        kernels.flash_attention(qg, k, k)
    # MLA's widths serve without grad and, with it, go through the
    # autograd Function
    q6 = torch.randn((1, 4, 9, 192), generator=g, requires_grad=True)
    k6 = torch.randn((1, 4, 9, 192), generator=g)
    v6 = torch.randn((1, 4, 9, 128), generator=g)
    assert type(kernels.flash_attention(q6, k6, v6).grad_fn).__name__ \
        == "_FlashBackward"
    assert kernels.flash_attention(q6.detach(), k6, v6).shape == (1, 4, 9, 128)


def test_flash_return_lse_is_the_forward_alone():
    """return_lse gives the plain forward's output and log-sum-exp on CPU
    tensors, with kv_lens too (an append's rows), and refuses inputs that
    would need the autograd Function."""
    g = torch.Generator().manual_seed(6)
    q = torch.randn((2, 4, 9, 32), generator=g)
    k, v = (torch.randn((2, 2, 30, 32), generator=g) for _ in range(2))
    lens = torch.tensor([30, 17], dtype=torch.int32)
    for kw in (dict(window=5, softcap=2.0), dict(kv_lens=lens)):
        got = kernels.flash_attention(q, k, v, **kw, return_lse=True)
        want = ref.flash_attention_ref(q, k, v, **kw, return_lse=True)
        assert got[1].shape == (2, 4, 9)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="return_lse"):
        kernels.flash_attention(q.clone().requires_grad_(True), k, k,
                                return_lse=True)


def test_flash_bwd_wrapper_refuses_a_wrong_lse_on_any_device():
    """An lse of another shape or dtype is refused on CPU and non-CPU
    tensors alike, before any launch; a non-CPU call without lse is
    refused (the card's backward reads the forward's); on CPU tensors a
    right lse is accepted and the plain backward does not need it."""
    g = torch.Generator().manual_seed(7)
    q, o, do = (torch.randn((2, 4, 13, 64), generator=g) for _ in range(3))
    k, v = (torch.randn((2, 1, 13, 64), generator=g) for _ in range(2))
    for device in ("cpu", "meta"):
        on = [x.to(device) for x in (q, k, v, o, do)]
        lse = torch.zeros((2, 4, 13), device=device)
        for bad in (lse[:, :, :12], lse.transpose(1, 2), lse[:, :1],
                    lse.double(), lse.bfloat16()):
            with pytest.raises(ValueError, match="lse"):
                kernels.flash_attention_bwd(*on, lse=bad)
    with pytest.raises(ValueError, match="forward's lse"):
        kernels.flash_attention_bwd(*on)
    got = kernels.flash_attention_bwd(q, k, v, o, do,
                                      lse=torch.zeros((2, 4, 13)))
    want = ref.flash_attention_bwd_ref(q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_bwd_groups_split_only_grids_under_one_block_an_sm():
    """The bf16 backward's dK/dV launch takes two warp groups a block
    exactly when its blocks (b x kv heads x key tiles of 64, 32 at dh 256)
    fit one an SM: GQA over 1000 tokens and gemma2's 1024 (128 blocks of
    132 SMs), not qwen's training microbatch or hubert's clips."""
    from repro_torch.kernels.flash_attention import bwd_groups
    assert bwd_groups(2, 4, 1000, 128, 132) == 2      # 2 x 4 x 16 = 128
    assert bwd_groups(1, 4, 1024, 256, 132) == 2      # 1 x 4 x 32 = 128
    assert bwd_groups(4, 16, 1023, 64, 132) == 1      # 1024 blocks
    assert bwd_groups(2, 16, 1500, 80, 132) == 1      # 768 blocks
    assert bwd_groups(1, 2, 64 * 66, 64, 132) == 2    # 132: one each
    assert bwd_groups(1, 2, 64 * 66 + 1, 64, 132) == 1
    assert bwd_groups(2, 16, 1, 64, 132) == 2


def test_flash_bwd_wrapper_on_cpu_is_the_plain_backward():
    g = torch.Generator().manual_seed(5)
    q, o, do = (torch.randn((2, 4, 13, 64), generator=g) for _ in range(3))
    k, v = (torch.randn((2, 1, 13, 64), generator=g) for _ in range(2))
    got = kernels.flash_attention_bwd(q, k, v, o, do, window=5)
    want = ref.flash_attention_bwd_ref(q, k, v, do, window=5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        kernels.flash_attention_bwd(q, k, v, o[:, :, :12], do)


@pytest.mark.parametrize("dk,dv", [(48, 32), (192, 128)],
                         ids=["reduced-mla", "ds27b-mla"])
def test_flash_function_at_mla_widths_matches_jax_grad(dk, dv):
    """flash_attention under grad at unequal widths (q and k dk wide, v dv
    wide: reduced ds27b's and ds27b's) on CPU tensors: the gradients
    autograd takes through the port's _Flash against jax.grad of the
    reference's attend(..., scale=1/sqrt(dk)) on the same numpy inputs,
    causal, f32, within 1e-5 of each gradient's largest |value|; dv's
    width is v's, dq's and dk's q's."""
    import jax
    from repro.models.layers import attend
    b, s, h = 1, 40, 2
    rng = np.random.default_rng(13)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((b, s, h, dv)).astype(np.float32)
             for _ in range(2))

    def loss(q, k, v):
        o = attend(q, k, v, causal=True, scale=1.0 / np.sqrt(dk))
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    out = kernels.flash_attention(qt, kt, vt, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashBackward"
    assert out.shape == (b, h, s, dv)
    got = torch.autograd.grad(out, (qt, kt, vt),
                              torch.from_numpy(do).transpose(1, 2))
    assert [g.shape[-1] for g in got] == [dk, dk, dv]
    _grads_close([g.transpose(1, 2).numpy() for g in got],
                 [np.asarray(w) for w in want], 1e-5)


def test_flash_bwd_wrapper_refuses_a_v_o_or_do_of_the_wrong_width():
    """At q/k 48 and v 32, a v, o or dO of q's width (or o and dO of a
    width apart from v's) is refused on CPU and non-CPU tensors alike,
    before any launch; the right widths give the plain backward, dq and
    dk 48 wide and dv 32."""
    g = torch.Generator().manual_seed(8)
    q, k = (torch.randn((1, 2, 11, 48), generator=g) for _ in range(2))
    v, o, do = (torch.randn((1, 2, 11, 32), generator=g) for _ in range(3))
    wide = torch.randn((1, 2, 11, 48), generator=g)
    for device in ("cpu", "meta"):
        right = [x.to(device) for x in (q, k, v, o, do)]
        for i in (2, 3, 4):
            bad = list(right)
            bad[i] = wide.to(device)
            with pytest.raises(ValueError, match="shapes"):
                kernels.flash_attention_bwd(
                    *bad, lse=torch.zeros((1, 2, 11), device=device))
        with pytest.raises(ValueError, match="shapes"):
            kernels.flash_attention_bwd(
                *right[:3], wide.to(device), wide.to(device),
                lse=torch.zeros((1, 2, 11), device=device))
    got = kernels.flash_attention_bwd(q, k, v, o, do)
    want = ref.flash_attention_bwd_ref(q, k, v, do)
    assert [x.shape[-1] for x in got] == [48, 48, 32]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
