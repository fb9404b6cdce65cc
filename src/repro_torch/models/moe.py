"""Mixture-of-experts FFN (port of ``repro.models.moe``, the dropless
``ragged`` form).

Top-k routing sorts the token copies by expert; the experts' gate, up
and down projections are three grouped matmuls over the expert groups
(the ``grouped_gemm`` kernel on CUDA tensors, the reference's
``jax.lax.ragged_dot``); the outputs are weighted and summed per token.
The reference's other forms (``ep``, ``ep_local``, ``dense``) shard over
an expert mesh axis and wait for the mesh layer.

No step reads a device value on the host: group sizes are counted on
the device (integer ``scatter_add_``), the grid of the grouped GEMM is
sized by a bound, and the combine undoes the sort by indexing and sums
each token's k slots in a fixed order, so two runs give the same bits
(a float ``index_add_`` would add with atomics).  The dispatch's
backward does the same in reverse (:class:`_Dispatch`): each token's
gradient is its k copies' gradients, gathered through the inverse
permutation and summed in slot order, where autograd's own backward of
the gather would accumulate them with ``index_put_``.  Ties in the
router's top-k keep the lower expert first, as ``jax.lax.top_k`` does (a
stable sort of the probabilities).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import grouped_gemm
from repro_torch.models import layers


def router_probs(p, cfg: ModelConfig, x2d):
    """Softmax over experts of the f32 router logits: (T, E) f32."""
    logits = x2d.float() @ p["router"].float()
    if cfg.moe.router_logit_softcap:
        logits = layers._softcap(logits, cfg.moe.router_logit_softcap)
    return torch.softmax(logits, dim=-1)


def route(p, cfg: ModelConfig, x2d):
    """Return (weights (T, k) f32 summing to 1, expert_idx (T, k) long),
    experts by falling probability, the lower index first on a tie."""
    probs = router_probs(p, cfg, x2d)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    vals, idx = vals[:, :k], idx[:, :k]
    return vals / vals.sum(dim=-1, keepdim=True), idx


def _sort_by_expert(idx, T: int, k: int, E: int):
    """The token copies in expert order: (order, token of each sorted
    copy, expert of each sorted copy, group sizes (E,) int32).  The sort
    is stable, as ``jnp.argsort`` is."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    token_of = torch.arange(T * k, device=idx.device) // k
    group_sizes = torch.zeros(E, dtype=torch.int32, device=idx.device)
    group_sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e,
                                                        dtype=torch.int32))
    return order, token_of[order], flat_e[order], group_sizes


class _Dispatch(torch.autograd.Function):
    """x2d (T, d) -> its token copies in expert order, ``x2d[order //
    k]``; the backward sums each token's k copies' gradients in slot
    order (gathered through the inverse of ``order``), with no
    accumulating scatter."""

    @staticmethod
    def forward(ctx, x2d, order, k):
        ctx.save_for_backward(order)
        ctx.k = k
        return x2d[order // k]

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        return g[inv].view(-1, ctx.k, g.shape[-1]).sum(dim=1), None, None


def moe_ragged(p, cfg: ModelConfig, x2d):
    """Routed experts over x2d (T, d) -> (T, d)."""
    T, d = x2d.shape
    m = cfg.moe
    vals, idx = route(p, cfg, x2d)
    order, _, _, group_sizes = _sort_by_expert(idx, T, m.top_k, m.n_experts)
    xs = _Dispatch.apply(x2d, order, m.top_k)
    gate = grouped_gemm(xs, p["wg"], group_sizes)
    up = grouped_gemm(xs, p["wu"], group_sizes)
    # silu with the reference's rounding (jax.nn.silu: x * sigmoid(x))
    h = (gate * torch.sigmoid(gate) * up).to(x2d.dtype)
    ys = grouped_gemm(h, p["wd"], group_sizes)
    w_sorted = vals.reshape(-1)[order].to(ys.dtype)
    # undo the sort (each copy to its (token, slot) place), then add each
    # token's k weighted slots in slot order
    slots = torch.empty_like(ys)
    slots[order] = ys * w_sorted[:, None]
    return slots.view(T, m.top_k, d).sum(dim=1).to(x2d.dtype)


def moe_ffn(p, cfg: ModelConfig, x):
    """x (b, s, d) -> (b, s, d): routed experts plus the shared expert."""
    b, s, d = x.shape
    y = moe_ragged(p, cfg, x.reshape(b * s, d)).reshape(b, s, d)
    if cfg.moe.n_shared_experts:
        y = y + layers.ffn(p["shared"], cfg, x)
    return y
