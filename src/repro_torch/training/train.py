"""Training step: microbatched gradient accumulation + per-layer remat
(port of ``repro.training.train``).

``make_train_step(cfg)`` returns ``(init_fn, train_step)``: batch
(global_batch, seq) int32 tokens (numpy or a tensor; moved to the
parameters' device); loss is next-token cross-entropy; gradients
accumulate in f32 over ``cfg.microbatches_train_4k`` microbatches (or
``n_microbatches``), are divided by their number, and one optimizer
update runs, in place.  Where the reference scans the microbatches under
``jit``, the port loops over them, each through autograd: the
parameters' leaves are handed to the model as tensors that require grad,
so the dense, MoE, VLM and encoder families' attention goes through
flash's hand-written backward (``kernels.flash_attention_bwd``) on the
card, MLA's at q/k 192 and v 128 among them, and the MoE family's expert
products through the grouped GEMM's (``kernels.grouped_gemm_bwd``): ds27b,
MoE over MLA, trains through both.  The SSM family's Mamba2 blocks go
through the SSD scan's and the causal conv's backwards
(``kernels.ssd_chunk_scan_bwd``, ``kernels.causal_conv_bwd``), and the
hybrid's through those and flash's, its shared block's gradients summed
over its applications.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, lm_loss
from repro_torch.models.params import require_ported
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.tree import leaves_with_paths, unflatten


def require_trainable(cfg: ModelConfig) -> None:
    """Raise for an architecture the port does not serve
    (``params.require_ported``).  Every family it serves trains: dense,
    MoE (over GQA or MLA: ds27b), VLM, encoder, SSM and hybrid."""
    require_ported(cfg)


def _require_moe_impl(moe_impl: str) -> None:
    if moe_impl != "ragged":
        raise NotImplementedError(
            f"moe_impl {moe_impl!r}: the expert-parallel forms come with the "
            f"mesh layer (ROADMAP Queue 1 item 4); the port runs 'ragged'")


def loss_fn(params, cfg: ModelConfig, batch, *, moe_impl: str = "ragged",
            remat="full"):
    """batch: {'tokens': (b, s)} for token LMs (causal shift internally)
    or {'inputs': (b, s, frontend_dim), 'labels': (b, s)} for stubbed-
    frontend archs (llava/hubert)."""
    _require_moe_impl(moe_impl)
    if "tokens" in batch:
        inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    else:
        inputs, labels = batch["inputs"], batch["labels"]
    logits, _ = forward(params, cfg, inputs, remat=remat)
    return lm_loss(logits, labels)


def _on_device(batch, device) -> dict:
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _unreached(cfg: ModelConfig, batch) -> set:
    """Paths of the leaves a batch of this kind cannot reach: the
    connector ``frontend_proj`` when it holds token ids, the token table
    when it holds frontend embeddings and the head is untied."""
    ids = "tokens" in batch or batch["inputs"].dim() == 2
    if ids:
        return {("embed", "frontend_proj")}
    return set() if cfg.tie_embeddings else {("embed", "tok")}


def loss_and_grads(params, cfg: ModelConfig, batch, *,
                   n_microbatches: int = 1, moe_impl: str = "ragged",
                   remat="full"):
    """(mean loss over the microbatches, gradients in f32 averaged over
    them): the batch's leading axis split into ``n_microbatches``, each
    microbatch's gradients added in f32, then divided by their number,
    as the reference's scan body does.  ``params`` is not changed.  A
    leaf that no gradient reaches raises, naming it, unless the batch's
    kind leaves it out by construction (:func:`_unreached`); those get
    zeros, as the reference's ``jax.grad`` gives them."""
    paths, flat = zip(*leaves_with_paths(params))
    batch = _on_device(batch, flat[0].device)
    unreached = _unreached(cfg, batch)
    gb = next(iter(batch.values())).shape[0]
    assert gb % n_microbatches == 0, (gb, n_microbatches)
    mb = gb // n_microbatches
    loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in flat]
    for i in range(n_microbatches):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        req = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, req), cfg, micro,
                           moe_impl=moe_impl, remat=remat)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        for path, a, g in zip(paths, acc, grads):
            if g is not None:
                a += g.float()
            elif path not in unreached:
                raise RuntimeError(
                    f"{cfg.name}: no gradient reached {'.'.join(path)}; "
                    f"a path of the forward is cut off from the loss")
        # the microbatch's gradients (a tree the size of the parameters)
        # are in the f32 sums now
        del grads
        loss_sum = loss_sum + loss.detach()
    # divided in place: a second f32 tree would double the sums' memory
    return (loss_sum / n_microbatches,
            unflatten(params, [a.div_(n_microbatches) for a in acc]))


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4,
                    moe_impl: str = "ragged",
                    n_microbatches: int | None = None,
                    remat="full"):
    """Returns (init_fn(params)->opt_state, train_step(params, opt_state,
    batch) -> (params, opt_state, mean loss)); the step updates params and
    opt_state in place and returns them."""
    require_trainable(cfg)
    _require_moe_impl(moe_impl)
    opt_init, opt_update = make_optimizer(cfg.optimizer, cfg.opt_state_dtype)
    n_micro = n_microbatches or cfg.microbatches_train_4k

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch,
                                     n_microbatches=n_micro,
                                     moe_impl=moe_impl, remat=remat)
        new_params, new_opt = opt_update(params, grads, opt_state, lr=lr)
        return new_params, new_opt, loss

    return opt_init, train_step
