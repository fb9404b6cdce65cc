"""Optimizers: AdamW and Adafactor, with configurable state dtype (port of
``repro.training.optimizer``).

The state mirrors the parameter tree (``params["blocks"]`` a list of
per-layer dicts).  Updates run in place under ``torch.no_grad()``, with
the reference's arithmetic: f32 math, cast back to the parameter and
state dtypes; the step counter is an int32 scalar and the bias
corrections ``1 - b ** t`` (AdamW) and ``1 - t ** -decay`` (Adafactor)
are taken in f32 from it, as the reference takes them from its f32 ``t``
(Python floats would make them float64 and the updates differ by an
ulp).

Adafactor factors the second moment of every leaf with ndim >= 2 over
its last two dims.  The reference's leaves are stacked over layers, so
there a per-layer vector (a norm's weight, a bias) is a 2-D leaf that
it factors over (layer, width) and a leaf's update clip sees every
layer at once; the port's unstacked leaves are per layer.  The two agree
on the same tree (the CPU tests hold them on shared trees); on a model
they differ by design.  llama4 is the one config that names Adafactor
(with bf16 state); the port trains it at reduced size in the tests.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch

from repro_torch.training.tree import leaves, tree_map


def _device(tree) -> torch.device:
    return leaves(tree)[0].device


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, state_dtype: str = "float32") -> Dict:
    dt = getattr(torch, state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1) -> Tuple[Dict, Dict]:
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        # the reference's expression, op for op, with the f32 leaves
        # (``.float()`` of an f32 tensor is the tensor) updated in place
        g32 = g.float()
        m32 = m.float().mul_(b1).add_(g32 * (1 - b1))
        v32 = v.float().mul_(b2).add_(torch.square(g32).mul_(1 - b2))
        u = (m32 / c1).div_(torch.sqrt(v32 / c2).add_(eps))
        u.add_(p.float() * weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(u)
        else:
            p.copy_(p.float().sub_(u))
        for state, new in ((m, m32), (v, v32)):
            if new is not state:
                state.copy_(new)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment for >=2D params)
# ---------------------------------------------------------------------------


def adafactor_init(params, state_dtype: str = "float32") -> Dict:
    dt = getattr(torch, state_dtype)

    def init(p):
        z = lambda shape: torch.zeros(shape, dtype=dt, device=p.device)
        if p.dim() >= 2:
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"fac": tree_map(init, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


@torch.no_grad()
def adafactor_update(params, grads, state, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0):
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - torch.pow(t, -decay)

    def upd(p, g, s):
        g32 = g.float()
        g2 = torch.square(g32) + eps
        if p.dim() >= 2:
            vr = s["vr"].float() * beta2 + g2.mean(dim=-1) * (1 - beta2)
            vc = s["vc"].float() * beta2 + g2.mean(dim=-2) * (1 - beta2)
            denom = torch.sqrt(
                vr[..., None] / vr.mean(dim=-1, keepdim=True)[..., None]
                * vc[..., None, :])
            u = g32 / torch.clamp_min(denom, 1e-30)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = s["v"].float() * beta2 + g2 * (1 - beta2)
            u = g32 / torch.sqrt(v + 1e-30)
            s["v"].copy_(v)
        rms = torch.sqrt(torch.square(u).mean() + 1e-30)
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        p.copy_(p.float() - lr * (u + weight_decay * p.float()))

    tree_map(upd, params, grads, state["fac"])
    return params, {"fac": state["fac"], "step": step}


def make_optimizer(name: str, state_dtype: str = "float32"):
    if name == "adamw":
        return (partial(adamw_init, state_dtype=state_dtype), adamw_update)
    if name == "adafactor":
        return (partial(adafactor_init, state_dtype=state_dtype),
                adafactor_update)
    raise ValueError(name)
