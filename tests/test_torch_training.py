"""Training and checkpoints: the port (``repro_torch.training``,
``repro_torch.ckpt``, ``repro_torch.launch.train``) against the JAX
reference on the CPU.

The reference's own training tests (tests/test_training.py) are ported
case for case; then both packages get the same inputs: data batches
(byte-equal), schedules (equal), optimizer updates on shared numpy trees
(within 1e-6 of each leaf's largest |value|), reduced qwen's loss and
gradients on bridged parameters (the loss within 2e-5 relative, each
gradient within 1e-4 of its leaf's largest |g|: XLA and PyTorch sum the
matmuls, the softmax and the embedding's scatter in different orders),
five train steps from a shared init (losses within 1e-4 relative in f32,
2e-2 in bf16, where the two frameworks round bf16 activations and
gradients at their own places) with both optimizer states held after
them, gemma2's (window, softcaps) and hubert's (bidirectional, frame
embeddings) gradients through flash's autograd glue, and the MoE
family's: reduced granite's (top-2) and llama4's (period 2, top-1, a
shared expert) gradients through the grouped GEMM's autograd glue, and
granite's five steps in both dtypes with its AdamW state after them; the
SSM and hybrid families' (reduced mamba2 and zamba2) gradients through
the SSD scan's and the conv's autograd glue, their five steps in both
dtypes and their AdamW states after them, the launcher on mamba2.  The
decode kernels raise under grad.  The JAX train step of each model and
dtype is compiled once for the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.training import SyntheticLM as JaxSyntheticLM
from repro.training import TrajectoryLM as JaxTrajectoryLM
from repro.training import cosine as jax_cosine
from repro.training import loss_fn as jax_loss_fn
from repro.training import make_optimizer as jax_make_optimizer
from repro.training import make_train_step as jax_make_train_step
from repro.training import wsd as jax_wsd
from repro_torch import bridge
from repro_torch.ckpt import (FaultTolerantRunner, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.models import forward, init_params
from repro_torch.training import (SyntheticLM, TrajectoryLM, cosine,
                                  loss_and_grads, loss_fn, make_optimizer,
                                  make_train_step, require_trainable, wsd)
from repro_torch.training.tree import leaves, leaves_with_paths

# tiny CPU tensors: extra intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

CFG = get_config("qwen1.5-0.5b").reduced()


def _setup():
    params = init_params(CFG, seed=0, device="cpu")
    opt_init, train_step = make_train_step(CFG, lr=1e-3, n_microbatches=2)
    return params, opt_init, train_step


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().view(torch.uint8).numpy().tobytes() \
        if t.dim() else t.numpy().tobytes()


# ---------------------------------------------------------------------------
# tests/test_training.py, ported
# ---------------------------------------------------------------------------


def test_loss_decreases():
    params, opt_init, ts = _setup()
    opt = opt_init(params)
    pipe = SyntheticLM(CFG.vocab_size, batch=4, seq=32, seed=1)
    losses = []
    for _ in range(10):
        params, opt, loss = ts(params, opt, pipe.next_batch())
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_microbatching_equivalent():
    """Grad accumulation over n microbatches == one big batch (f32
    grads); the step updates in place, so each arm starts from its own
    copy of one init."""
    batch = SyntheticLM(CFG.vocab_size, batch=4, seq=16, seed=2).next_batch()
    outs = []
    for n in (1, 2, 4):
        opt_init, ts = make_train_step(CFG, lr=1e-3, n_microbatches=n)
        p = init_params(CFG, seed=0, device="cpu")
        p, _, loss = ts(p, opt_init(p), batch)
        outs.append((loss, p))
    for loss, p in outs[1:]:
        # microbatch means of per-µb losses differ from the full-batch loss
        # only by averaging order
        assert abs(float(loss) - float(outs[0][0])) < 0.05
        for a, b in zip(leaves(p), leaves(outs[0][1])):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       atol=5e-2)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates(name):
    init, update = make_optimizer(name)
    params = {"w": torch.ones((8, 4)), "b": torch.zeros((4,))}
    before = {k: v.clone() for k, v in params.items()}
    grads = {"w": torch.full((8, 4), 0.5), "b": torch.full((4,), -0.5)}
    st = init(params)
    p2, st2 = update(params, grads, st, lr=0.1)
    assert bool((p2["w"] < before["w"]).all())
    assert bool((p2["b"] > before["b"]).all())
    assert int(st2["step"]) == 1 and st2["step"].dtype == torch.int32


def test_adafactor_state_is_factored():
    init, _ = make_optimizer("adafactor")
    st = init({"w": torch.ones((64, 32))})
    assert sum(t.numel() for t in leaves(st["fac"])) == 64 + 32


def test_wsd_schedule():
    kw = dict(peak_lr=1.0, warmup=10, stable=100, decay=20)
    assert wsd(0, **kw) < wsd(9, **kw) <= 1.0
    assert wsd(50, **kw) == 1.0
    assert wsd(129, **kw) < 0.2
    assert cosine(0, peak_lr=1.0, warmup=5, total=50) < 1.0


def test_pipeline_checkpointable():
    p1 = SyntheticLM(100, 2, 8, seed=3)
    p1.next_batch()
    b = p1.next_batch()
    p2 = SyntheticLM(100, 2, 8, seed=3)
    p2.load_state_dict(dict(seed=3, step=1))
    np.testing.assert_array_equal(p2.next_batch(), b)


def test_trajectory_pipeline():
    p = TrajectoryLM(100, 2, 64, max_len=32768, seed=0)
    assert p.next_batch().shape == (2, 64)


def test_crash_resume_bitwise(tmp_path):
    params, opt_init, ts = _setup()
    pipe = lambda: SyntheticLM(CFG.vocab_size, batch=4, seq=32, seed=1)
    r = FaultTolerantRunner(str(tmp_path / "a"), ts, params,
                            opt_init(params), pipe(), ckpt_every=3)
    with pytest.raises(RuntimeError, match="injected crash"):
        r.run(8, crash_at=5)
    p2 = init_params(CFG, seed=0, device="cpu")
    r2 = FaultTolerantRunner(str(tmp_path / "a"), ts, p2, opt_init(p2),
                             pipe(), ckpt_every=3)
    assert r2.try_resume() and r2.step == 3
    r2.run(8)
    # uninterrupted reference
    p3 = init_params(CFG, seed=0, device="cpu")
    r3 = FaultTolerantRunner(str(tmp_path / "b"), ts, p3, opt_init(p3),
                             pipe(), ckpt_every=100)
    ref = r3.run(8)
    assert ref[3:] == r2.losses, (ref[3:], r2.losses)
    for a, b in zip(leaves((r2.params, r2.opt_state)),
                    leaves((r3.params, r3.opt_state))):
        assert _bits(a) == _bits(b)


def test_checkpoint_atomic_and_latest(tmp_path):
    params = {"w": torch.arange(4, dtype=torch.bfloat16) / 3,
              "blocks": [{"b": torch.ones(2)}]}
    opt = {"m": torch.zeros((4,)), "step": torch.zeros((), dtype=torch.int32)}
    d = str(tmp_path)
    save_checkpoint(d, 1, params, opt)
    save_checkpoint(d, 2, params, opt, extra=dict(note="x"))
    assert latest_step(d) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000001.npz", "ckpt_00000002.npz"]     # no temp file left
    r = restore_checkpoint(d, params, opt)
    assert r["step"] == 2 and r["extra"] == dict(note="x")
    assert r["params"]["w"].dtype == torch.bfloat16
    assert _bits(r["params"]["w"]) == _bits(params["w"])
    assert torch.equal(r["params"]["blocks"][0]["b"], torch.ones(2))
    assert r["opt_state"]["step"].dtype == torch.int32
    # the reference's layout: params//<path> and opt//<path>, bf16 as uint16
    with np.load(tmp_path / "ckpt_00000002.npz") as z:
        assert set(z.files) == {"__meta__", "params//w", "params//blocks//0//b",
                                "opt//m", "opt//step"}
        assert z["params//w"].dtype == np.uint16
    assert restore_checkpoint(str(tmp_path / "none"), params, opt) is None


# ---------------------------------------------------------------------------
# against the reference: data, schedules, optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["synthetic", "trajectory"])
def test_pipelines_byte_equal_to_reference(source):
    kind = {"synthetic": (SyntheticLM, JaxSyntheticLM),
            "trajectory": (TrajectoryLM, JaxTrajectoryLM)}[source]
    port, jx = (k(CFG.vocab_size, 3, 40, seed=5) for k in kind)
    for _ in range(3):
        a, b = port.next_batch(), jx.next_batch()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert port.state_dict() == jx.state_dict()


def test_schedules_equal_reference():
    for step in range(200):
        kw = dict(peak_lr=3e-4, warmup=10, stable=120, decay=50)
        assert wsd(step, **kw) == jax_wsd(step, **kw)
        kw = dict(peak_lr=3e-4, warmup=10, total=150)
        assert cosine(step, **kw) == jax_cosine(step, **kw)


def _np_tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((8, 4)) * scale).astype(np.float32),
            "b": (rng.standard_normal(4) * scale).astype(np.float32),
            "t": (rng.standard_normal((3, 5, 6)) * scale).astype(np.float32)}


def _close_tree(got, want, tol, skip=()):
    """Each leaf within ``tol`` of its own largest |value|, equal shapes;
    leaves whose last key is in ``skip`` only in shape."""
    flat = dict(leaves_with_paths(got))
    for path, w in leaves_with_paths(want):
        if path[-1] in skip:
            assert tuple(flat[path].shape) == np.shape(w), path
            continue
        g = np.asarray(flat[path].float() if isinstance(flat[path],
                                                        torch.Tensor)
                       else flat[path], np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), \
            (path, np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name):
    """Three updates on a shared tree (a matrix, a vector, a 3-D leaf)
    with fresh gradients each step: parameters and states within 1e-6 of
    each leaf's largest |value|."""
    rng = np.random.default_rng(6)
    p_np = _np_tree(rng)
    g_nps = [_np_tree(rng, 0.1) for _ in range(3)]
    j_init, j_update = jax_make_optimizer(name)
    t_init, t_update = make_optimizer(name)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    js, ts = j_init(jp), t_init(tp)
    for g in g_nps:
        jp, js = j_update(jp, jax.tree.map(jnp.asarray, g), js, lr=0.05)
        tp, ts = t_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, lr=0.05)
    _close_tree(tp, jax.tree.map(np.asarray, jp), 1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    key = "fac" if name == "adafactor" else "m"
    _close_tree(ts[key], jax.tree.map(np.asarray, js[key]), 1e-6)
    if name == "adamw":
        _close_tree(ts["v"], jax.tree.map(np.asarray, js["v"]), 1e-6)


# ---------------------------------------------------------------------------
# against the reference: loss, gradients and train steps on bridged weights
# ---------------------------------------------------------------------------


def _configs(arch: str, dtype: str):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)
    return jcfg, tcfg


def _bridged(arch: str, dtype: str, key: int = 0):
    jcfg, tcfg = _configs(arch, dtype)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(key))
    return jcfg, tcfg, jp, bridge.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(tcfg, b: int, s: int, seed: int):
    """{'tokens'} for token LMs; frame embeddings and labels for the
    encoder (both packages' loss_fn take either)."""
    rng = np.random.default_rng(seed)
    if tcfg.frontend_embed_dim:
        return {"inputs": rng.standard_normal(
                    (b, s, tcfg.frontend_embed_dim)).astype(np.float32),
                "labels": rng.integers(0, tcfg.vocab_size,
                                       (b, s)).astype(np.int32)}
    return {"tokens": SyntheticLM(tcfg.vocab_size, b, s + 1,
                                  seed=seed).next_batch()}


@pytest.mark.parametrize("arch,s,residue", [
    pytest.param("qwen1.5-0.5b", 16, (), id="qwen"),
    # past the reduced window of 64, with both softcaps
    pytest.param("gemma2-2b", 80, (), id="gemma2"),
    # bidirectional, frame embeddings through the connector
    pytest.param("hubert-xlarge", 24, (), id="hubert"),
    # MoE, top-2 of 8 experts
    pytest.param("granite-moe-3b-a800m", 16, (), id="granite"),
    # MoE of period 2 (a dense layer, then an MoE layer with a shared
    # expert), top-1: its one weight is normalised to p / p = 1, so the
    # router's gradient is 0 in exact arithmetic (held in shape only)
    pytest.param("llama4-maverick-400b-a17b", 16, ("router",),
                 id="llama4"),
    # MoE over MLA: a dense layer, then 3 MoE layers of 8 experts, top-2,
    # 2 shared; flash at q/k 48, v 32 through its autograd glue
    pytest.param("ds27b", 16, (), id="ds27b"),
    # SSM: 4 Mamba2 layers, chunks of 32 (the last one 8 rows), through
    # the SSD scan's and the conv's autograd glue
    pytest.param("mamba2-1.3b", 40, (), id="mamba2"),
    # hybrid: 4 Mamba2 layers of period 2, the shared block applied twice
    # (its gradients summed over the applications), flash at dh 32
    pytest.param("zamba2-2.7b", 40, (), id="zamba2"),
])
def test_loss_and_gradients_match_reference(arch, s, residue):
    """f32, no remat on either side: loss_fn within 2e-5 relative, and
    every gradient (the reference's unstacked through params_from_jax)
    within 1e-4 of its leaf's largest |g|; the port's attention gradient
    comes through flash's autograd glue, the MoE experts' through the
    grouped GEMM's, the Mamba2 blocks' through the SSD scan's and the
    conv's."""
    jcfg, tcfg, jp, tp = _bridged(arch, "float32")
    batch = _batch(tcfg, 2, s, seed=7)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jax_loss_fn(p, jcfg, bt, remat=False)))(
        jp, jax.tree.map(jnp.asarray, batch))
    tloss = loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, remat=False)
    assert abs(float(tloss) - float(jloss)) <= 2e-5 * abs(float(jloss))
    loss, grads = loss_and_grads(tp, tcfg, batch, remat=False)
    assert float(loss) == float(tloss)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                                  device="cpu")
    _close_tree(grads, want, 1e-4, skip=residue)


def test_remat_full_is_bit_identical_on_cpu():
    """Recomputing each block in the backward changes nothing: the loss
    and every gradient equal those without remat, bit for bit."""
    params = init_params(CFG, seed=1, device="cpu")
    batch = SyntheticLM(CFG.vocab_size, 4, 17, seed=8).next_batch()
    la, ga = loss_and_grads(params, CFG, batch, n_microbatches=2,
                            remat="full")
    lb, gb = loss_and_grads(params, CFG, batch, n_microbatches=2,
                            remat=False)
    assert _bits(la) == _bits(lb)
    for a, b in zip(leaves(ga), leaves(gb)):
        assert _bits(a) == _bits(b)


@pytest.fixture(scope="module", params=["float32", "bfloat16",
                                        "granite-float32",
                                        "granite-bfloat16",
                                        "ds27b-float32", "ds27b-bfloat16",
                                        "mamba2-float32", "mamba2-bfloat16",
                                        "zamba2-float32", "zamba2-bfloat16"])
def five_steps(request):
    """Five AdamW steps of reduced qwen (the bare dtype), of reduced
    granite (MoE, top-2 of 8), of reduced ds27b (MoE over MLA), of reduced
    mamba2 (SSM) and of reduced zamba2 (hybrid) in both packages from one
    init and one batch stream (4 rows of 17 tokens, 2 microbatches, full
    remat): each train step compiled once for the module."""
    arch, _, dt = request.param.rpartition("-")
    arch = {"": "qwen1.5-0.5b", "granite": "granite-moe-3b-a800m",
            "ds27b": "ds27b", "mamba2": "mamba2-1.3b",
            "zamba2": "zamba2-2.7b"}[arch]
    jcfg, tcfg, jp, tp = _bridged(arch, dt, key=1)
    j_init, j_step = jax_make_train_step(jcfg, lr=1e-3, n_microbatches=2)
    t_init, t_step = make_train_step(tcfg, lr=1e-3, n_microbatches=2)
    j_step = jax.jit(j_step)
    js, ts = j_init(jp), t_init(tp)
    pipe = SyntheticLM(tcfg.vocab_size, 4, 17, seed=9)
    jl, tl = [], []
    for _ in range(5):
        bt = pipe.next_batch()
        jp, js, jloss = j_step(jp, js, jnp.asarray(bt))
        tp, ts, tloss = t_step(tp, ts, bt)
        jl.append(float(jloss))
        tl.append(float(tloss))
    return dt, tcfg, (jp, js, jl), (tp, ts, tl)


def test_train_steps_match_reference(five_steps):
    dt, _, (_, _, jl), (_, _, tl) = five_steps
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dt]
    for a, b in zip(tl, jl):
        assert abs(a - b) <= tol * abs(b), (tl, jl)
    assert tl[-1] < tl[0]


def test_optimizer_states_match_reference_after_the_steps(five_steps):
    """The reference's AdamW state after the five steps, through
    bridge.opt_state_from_jax, against the port's: the step counter
    equal; in f32 the moments and parameters within 1e-3 of each leaf's
    largest |value| (five steps of gradients that agree within 1e-4);
    in bf16 the shapes and dtypes.  The key bias ``bk`` is held in shape
    only: it adds the same q.bk to every score of a query, which the
    softmax cancels, so its gradient is 0 in exact arithmetic and both
    packages' values are rounding residue (Adam then scales that residue
    to steps of ~lr).  Reduced mamba2's ``out_proj`` has elements whose
    first gradient is such residue (~5e-8 of the leaf's largest |g| in
    both packages: a gated-norm feature near 0 at init); AdamW's first
    step, g / (|g| + eps), moves them by a share of lr that depends on
    the residue (0.27 lr in one package, 0.85 lr in the other).  So
    there the elements of ``out_proj`` whose first-step |g| is under 1e-6
    of the leaf's largest in either package (:func:`_residue_mask`, at
    most 1 % of the leaf) are held within the five steps' largest move,
    5 lr, and its other elements at 1e-3 of the leaf's largest |value|,
    as every other leaf; the moments at 1e-3 as every leaf's."""
    dt, tcfg, (jp, js, _), (tp, ts, _) = five_steps
    conv = bridge.opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                                     device="cpu")
    assert int(conv["step"]) == int(ts["step"]) == 5
    assert conv["step"].dtype == ts["step"].dtype == torch.int32
    flat = dict(leaves_with_paths(ts))
    for path, t in leaves_with_paths(conv):
        assert flat[path].shape == t.shape and flat[path].dtype == t.dtype
    if dt == "float32":
        residue = ("bk",)
        _close_tree(ts["m"], conv["m"], 1e-3, skip=residue)
        _close_tree(ts["v"], conv["v"], 1e-3, skip=residue)
        params = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                        device="cpu")
        eps_steps = ("out_proj",) if tcfg.family == "ssm" else ()
        _close_tree(tp, params, 1e-3, skip=residue + eps_steps)
        if not eps_steps:
            return
        masks = _residue_mask(tcfg, eps_steps)
        flat = dict(leaves_with_paths(tp))
        for path, w in leaves_with_paths(params):
            if path not in masks:
                continue
            d = (flat[path] - w).abs()
            mask = masks[path]
            assert float(mask.float().mean()) <= 1e-2, path
            assert float(d[~mask].max()) <= 1e-3 * float(w.abs().max()), \
                (path, float(d[~mask].max()), float(w.abs().max()))
            if mask.any():
                assert float(d[mask].max()) <= 5 * 1e-3, path


def _residue_mask(tcfg, names) -> dict:
    """For the five steps' init and first batch: the elements of each
    leaf named in ``names`` whose first-step gradient (the reference's
    jax.grad, the port's loss_and_grads over the same two microbatches)
    is under 1e-6 of the leaf's largest |g| in either package, by leaf
    path."""
    arch = {"ssm": "mamba2-1.3b"}[tcfg.family]
    jcfg, _, jp, tp = _bridged(arch, "float32", key=1)
    bt = SyntheticLM(tcfg.vocab_size, 4, 17, seed=9).next_batch()
    jg = bridge.params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p, b: jax_loss_fn(p, jcfg, {"tokens": b})))(
            jp, jnp.asarray(bt))), tcfg, device="cpu")
    _, tg = loss_and_grads(tp, tcfg, {"tokens": bt}, n_microbatches=2)
    flat = dict(leaves_with_paths(tg))
    out = {}
    for path, g in leaves_with_paths(jg):
        if path[-1] not in names:
            continue
        small = [a.abs() < 1e-6 * a.abs().max() for a in (g, flat[path])]
        out[path] = small[0] | small[1]
    return out


def test_adafactor_state_bridges_to_the_port_layout():
    """The reference's Adafactor state of reduced qwen (stacked layers)
    becomes the port's per-layer layout: factored (vr, vc) for every leaf
    of two or more dims per layer, a per-layer vector's (layer, width)
    factors as the second moment ``vr / mean(vr) * vc`` of that layer."""
    jcfg, tcfg, jp, tp = _bridged("qwen1.5-0.5b", "float32")
    j_init, j_update = jax_make_optimizer("adafactor")
    rng = np.random.default_rng(10)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), jp)
    _, js = jax.jit(lambda p, g, st: j_update(p, g, st, lr=1e-3))(
        jp, jg, j_init(jp))
    conv = bridge.opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                                     device="cpu")
    want = make_optimizer("adafactor")[0](tp)
    assert int(conv["step"]) == 1
    flat = dict(leaves_with_paths(conv["fac"]))
    for path, t in leaves_with_paths(want["fac"]):
        assert flat[path].shape == t.shape, path
    vr = np.asarray(js["fac"]["blocks"]["ln1"]["vr"])       # (L,)
    vc = np.asarray(js["fac"]["blocks"]["ln1"]["vc"])       # (d,)
    np.testing.assert_allclose(conv["fac"]["blocks"][1]["ln1"]["v"].numpy(),
                               vr[1] / vr.mean() * vc, rtol=1e-6)


def test_adafactor_state_of_an_moe_tree_bridges_in_layer_order():
    """llama4's own optimizer (Adafactor, bf16 state) on its reduced MoE
    tree of period 2, ``super_blocks.pre`` (dense layers, (n_super, 1,
    ...)) and ``.moe`` ((n_super, ...)): the bridged state has the port's
    per-layer leaves, shapes and dtypes, in layer order (pre 0, moe 0,
    pre 1, moe 1): each layer's expert and FFN factors are its stack's
    row, and a per-layer vector's v is ``vr / mean(vr) * vc`` of its own
    stack (the moe stack's (layer, width) factors, the pre stack's
    per-period ones)."""
    jcfg, tcfg, jp, tp = _bridged("llama4-maverick-400b-a17b", "float32")
    j_init, j_update = jax_make_optimizer(jcfg.optimizer,
                                          jcfg.opt_state_dtype)
    rng = np.random.default_rng(12)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), jp)
    _, js = jax.jit(lambda p, g, st: j_update(p, g, st, lr=1e-3))(
        jp, jg, j_init(jp))
    conv = bridge.opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                                     device="cpu")
    want = make_optimizer(tcfg.optimizer, tcfg.opt_state_dtype)[0](tp)
    flat = dict(leaves_with_paths(conv["fac"]))
    for path, t in leaves_with_paths(want["fac"]):
        assert flat[path].shape == t.shape and flat[path].dtype == t.dtype, \
            path
    fac = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       js["fac"]["super_blocks"])
    blocks = conv["fac"]["blocks"]
    assert tcfg.moe_layer_mask() == (False, True, False, True)
    for i in range(2):
        pre, moe_ = blocks[2 * i], blocks[2 * i + 1]
        np.testing.assert_array_equal(
            pre["ffn"]["wi_gate"]["vr"].float().numpy(),
            fac["pre"]["ffn"]["wi_gate"]["vr"][i, 0])
        np.testing.assert_array_equal(
            moe_["moe"]["wg"]["vc"].float().numpy(),
            fac["moe"]["moe"]["wg"]["vc"][i])
        vr, vc = fac["pre"]["ln1"]["vr"][i], fac["pre"]["ln1"]["vc"][i]
        np.testing.assert_allclose(pre["ln1"]["v"].float().numpy(),
                                   vr[0] / vr.mean() * vc, rtol=1e-2)
        vr, vc = fac["moe"]["ln1"]["vr"], fac["moe"]["ln1"]["vc"]
        np.testing.assert_allclose(moe_["ln1"]["v"].float().numpy(),
                                   vr[i] / vr.mean() * vc, rtol=1e-2)


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "steps 3: loss" in out and "resumed" not in out
    assert latest_step(str(tmp_path)) == 3
    train.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "resumed at step 3" in out and "steps 5: loss" in out


def test_launch_train_runs_and_resumes_an_moe_model(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    train.main(args + ["--steps", "2"])
    assert "steps 2: loss" in capsys.readouterr().out
    train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "steps 3: loss" in out


def test_launch_train_runs_and_resumes_an_ssm_model(tmp_path, capsys):
    """The launcher trains reduced mamba2 two steps and resumes from its
    checkpoint for a third."""
    from repro_torch.launch import train
    args = ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    train.main(args + ["--steps", "2"])
    assert "steps 2: loss" in capsys.readouterr().out
    train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "steps 3: loss" in out


def test_launch_train_runs_and_resumes_an_mla_model(tmp_path, capsys):
    """The launcher trains reduced ds27b (MoE over MLA) two steps and
    resumes from its checkpoint for a third."""
    from repro_torch.launch import train
    args = ["--arch", "ds27b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    train.main(args + ["--steps", "2"])
    assert "steps 2: loss" in capsys.readouterr().out
    train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "steps 3: loss" in out


# ---------------------------------------------------------------------------
# every family trains; the mesh forms name their slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_require_trainable_names_the_slice(arch):
    """The SSM and hybrid families, once refused naming ROADMAP Queue 1
    item 3c, pass ``require_trainable`` and build a train step, at full
    size and reduced."""
    for cfg in (get_config(arch), get_config(arch).reduced()):
        require_trainable(cfg)
        opt_init, train_step = make_train_step(cfg)
        assert callable(opt_init) and callable(train_step)


def test_mla_training_and_the_mesh_forms_name_their_slices():
    """MLA trains: ds27b (MoE over MLA) and its MLA-dense variant pass
    ``require_trainable`` and build a train step, at full size and
    reduced; the mesh forms still name ROADMAP Queue 1 item 4."""
    ds = get_config("ds27b")
    for cfg in (ds, ds.reduced()):
        mla_dense = dataclasses.replace(cfg, family="dense", moe=None)
        for c in (cfg, mla_dense):
            require_trainable(c)
            opt_init, train_step = make_train_step(c)
            assert callable(opt_init) and callable(train_step)
    for arch in ("qwen1.5-0.5b", "gemma2-2b", "minicpm-2b", "nemotron-4-15b",
                 "llava-next-34b", "hubert-xlarge", "granite-moe-3b-a800m",
                 "llama4-maverick-400b-a17b"):
        require_trainable(get_config(arch).reduced())
    params = init_params(CFG, seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for policy in ("dots", "dots_no_batch"):
        with pytest.raises(NotImplementedError, match="item 4"):
            forward(params, CFG, toks, remat=policy)
    with pytest.raises(NotImplementedError, match="item 4"):
        loss_fn(params, CFG, {"tokens": toks}, moe_impl="ep")
    with pytest.raises(NotImplementedError, match="item 4"):
        make_train_step(CFG, moe_impl="dense")
    with pytest.raises(ValueError):
        forward(params, CFG, toks, remat="full", return_state=True)


def test_wrappers_without_a_backward_raise_under_grad():
    """Each decode kernel (no backward) raises when grad mode is on and
    an input requires grad, on the CPU as on the card; without grad it
    serves as before.  The grouped GEMM, the SSD scan and the conv have
    their backwards: their gradients flow and equal autograd's of their
    plain versions."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    x = torch.randn((6, 8), requires_grad=True)
    w = torch.randn((2, 8, 4), requires_grad=True)
    sizes = torch.tensor([3, 3], dtype=torch.int32)
    dy = torch.randn((6, 4))
    got = torch.autograd.grad(kernels.grouped_gemm(x, w, sizes), (x, w), dy)
    want = torch.autograd.grad(ref.grouped_gemm_ref(x, w, sizes), (x, w),
                               dy)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        assert kernels.grouped_gemm(x, w, sizes).shape == (6, 4)
    b, s, H, P, N = 1, 8, 2, 4, 4
    xs = torch.randn((b, s, H, P), requires_grad=True)
    B_, C_ = torch.randn((b, s, N)), torch.randn((b, s, N))
    dt_ = torch.rand((b, s, H))
    A_, D_ = -torch.rand(H), torch.rand(H)
    dy_ = torch.randn((b, s, H, P))
    got = torch.autograd.grad(kernels.ssd_chunk_scan(
        xs, B_, C_, dt_, A_, D_, None, 4)[0], xs, dy_)
    want = torch.autograd.grad(ref.ssd_chunk_scan_ref(
        xs, B_, C_, dt_, A_, D_, None, 4)[0], xs, dy_)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    xc = torch.randn((b, s, 6), requires_grad=True)
    wc = torch.randn((4, 6), requires_grad=True)
    tail = torch.zeros((b, 3, 6))
    do = torch.randn((b, s, 6))
    got = torch.autograd.grad(kernels.causal_conv(xc, wc, tail)[0],
                              (xc, wc), do)
    want = torch.autograd.grad(ref.causal_conv_ref(xc, wc, tail)[0],
                               (xc, wc), do)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    xc.requires_grad_(False)
    kernels.causal_conv(xc, torch.randn((4, 6)), torch.zeros((b, 3, 6)))
    q = torch.randn((2, 1, 4, 32), requires_grad=True)
    pool = torch.randn((4, 4, 1, 32))
    table = torch.arange(4, dtype=torch.int32).view(2, 2)
    lens = torch.tensor([5, 8], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="decode kernel"):
        kernels.paged_attention(q, pool, pool, table, lens)
    with pytest.raises(NotImplementedError, match="decode kernel"):
        kernels.mla_decode(torch.randn((2, 4, 16), requires_grad=True),
                           torch.randn((2, 4, 8)), torch.randn((2, 8, 16)),
                           torch.randn((2, 8, 8)), lens, scale=0.1)
    assert kernels.paged_attention(q.detach(), pool, pool, table,
                                   lens).shape == (2, 1, 4, 32)


def test_a_gradient_cut_off_from_the_loss_raises(monkeypatch):
    """An attention output detached from the graph leaves the attention's
    norm and projections with no gradient: ``loss_and_grads`` names the
    first such leaf instead of handing the optimizer zeros.  Only the
    leaves a batch of its kind cannot reach get zeros: llava's connector
    under token ids, its untied token table under frontend embeddings."""
    from repro_torch.models import layers
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 9))
    params = init_params(CFG, seed=0, device="cpu")
    flash = layers.flash_attention
    with monkeypatch.context() as m:
        m.setattr(layers, "flash_attention",
                  lambda *a, **kw: flash(*a, **kw).detach())
        with pytest.raises(RuntimeError,
                           match=r"no gradient reached blocks\.0\.ln1"):
            loss_and_grads(params, CFG, {"tokens": toks}, remat=False)
    loss_and_grads(params, CFG, {"tokens": toks}, remat=False)
    cfg = get_config("llava-next-34b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    labels = rng.integers(0, cfg.vocab_size, (2, 8))
    embeds = rng.standard_normal((2, 8, cfg.frontend_embed_dim))
    for batch, zero in (({"tokens": toks}, "frontend_proj"),
                        ({"inputs": embeds.astype(np.float32),
                          "labels": labels}, "tok")):
        _, grads = loss_and_grads(params, cfg, batch, remat=False)
        for key, g in grads["embed"].items():
            assert bool(g.eq(0).all()) == (key == zero), key
