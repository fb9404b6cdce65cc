"""Conversion between the JAX reference's trees and the port's, plus
parity helpers for the tests that compare the two packages.

The bridge takes the JAX trees as numpy (``jax.tree.map(np.asarray,
tree)``), so this module imports neither ``jax`` nor ``repro``.
``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``, so bf16 arrays go
through their uint16 bits: ``np.asarray(x).view(np.uint16)`` and then
``.view(torch.bfloat16)``.  The reference stacks block parameters along
a leading layer axis (an MoE model in up to three stacks,
``dense_blocks`` for the first ``first_k_dense`` layers, then per period
``super_blocks.pre`` for its dense layers and ``super_blocks.moe`` for
its last, and its decode state likewise in ``dense``, ``pre`` and
``moe``; the hybrid's Mamba2 blocks and their state as (n_super,
period)); the port keeps one dict per layer and one state stack over all
layers, so the blocks are unstacked and the state stacks interleaved or
flattened here.  Like every entry point of
the port, each converter puts its tensors on the card unless the caller
names the CPU.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve


def to_torch(x, device="cuda") -> torch.Tensor:
    """numpy array (bf16 included) -> torch tensor on ``device``."""
    device = resolve(device)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy; bf16 becomes float32 (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_torch(tree, device)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


_STACKS = ("blocks", "dense_blocks", "super_blocks", "shared_block")


def params_from_jax(np_tree: Dict, cfg: ModelConfig, device="cuda") -> Dict:
    """The reference's ``init_params`` tree (as numpy) -> the port's
    parameters: ``blocks`` (dense, VLM and encoder families, or the SSM
    family's Mamba2 blocks), or ``dense_blocks`` then, for each of the
    ``n_super`` periods, ``super_blocks["pre"][i, j]`` for j < period - 1
    and ``super_blocks["moe"][i]`` (MoE family; layer ``first_k_dense +
    i * period + j``, the reference's ``kvio._kv_rows`` order), or the
    hybrid's (n_super, period) Mamba2 blocks, unstacked into one list in
    layer order; the hybrid's ``shared_block`` is converted once, and
    ``embed`` whole (``frontend_proj`` included where the config has a
    frontend)."""
    device = resolve(device)
    out = {k: _convert(v, device) for k, v in np_tree.items()
           if k not in _STACKS}
    if cfg.family == "hybrid":
        period = cfg.hybrid_period
        out["shared_block"] = _convert(np_tree["shared_block"], device)
        out["blocks"] = [
            _convert(_unstack(_unstack(np_tree["blocks"], li // period),
                              li % period), device)
            for li in range(cfg.n_layers)]
        return out
    if cfg.family == "moe":
        m = cfg.moe
        sb = np_tree["super_blocks"]
        stacks = [_unstack(np_tree["dense_blocks"], i)
                  for i in range(m.first_k_dense)]
        for i in range((cfg.n_layers - m.first_k_dense) // m.period):
            stacks += [_unstack(_unstack(sb["pre"], i), j)
                       for j in range(m.period - 1)]
            stacks.append(_unstack(sb["moe"], i))
    else:
        stacks = [_unstack(np_tree["blocks"], i) for i in range(cfg.n_layers)]
    out["blocks"] = [_convert(tree, device) for tree in stacks]
    return out


def opt_state_from_jax(np_opt: Dict, cfg: ModelConfig,
                       device="cuda") -> Dict:
    """The reference's optimizer state (as numpy) -> the port's: AdamW's
    ``m`` and ``v`` and Adafactor's ``fac`` mirror the parameters, so they
    are unstacked as :func:`params_from_jax` unstacks them; ``step``
    becomes an int32 scalar.  Adafactor factors a stacked per-layer
    vector (a norm's weight, a bias) over (layer, width), where the port
    keeps one unfactored ``v`` per layer: such a leaf becomes the second
    moment the reference's update divides by, ``vr / mean(vr) * vc``,
    before it is unstacked."""
    device = resolve(device)
    step = torch.tensor(int(np.asarray(np_opt["step"])), dtype=torch.int32,
                        device=device)
    if "fac" not in np_opt:
        return {"m": params_from_jax(np_opt["m"], cfg, device),
                "v": params_from_jax(np_opt["v"], cfg, device),
                "step": step}
    # the stacked axes in front of each subtree's leaves
    stacks = {"blocks": 2 if cfg.family == "hybrid" else 1,
              "dense_blocks": 1, "super_blocks": {"pre": 2, "moe": 1}}
    fac = {k: _vectors_unfactored(v, stacks.get(k, 0))
           for k, v in np_opt["fac"].items()}
    return {"fac": params_from_jax(fac, cfg, device), "step": step}


def _vectors_unfactored(fac, n_stack):
    """Adafactor's (vr, vc) of a parameter that is one vector per layer
    (vr has only the ``n_stack`` stacked axes) as its ``v``."""
    if isinstance(n_stack, dict):
        return {k: _vectors_unfactored(v, n_stack[k]) for k, v in fac.items()}
    if set(fac) == {"vr", "vc"}:
        vr, vc = (np.asarray(fac[k]) for k in ("vr", "vc"))
        if vr.ndim != n_stack:
            return fac
        r, c = vr.astype(np.float32), vc.astype(np.float32)
        v = r[..., None] / r.mean(-1, keepdims=True)[..., None] \
            * c[..., None, :]
        return {"v": v.astype(vc.dtype)}
    if set(fac) == {"v"}:
        return fac
    return {k: _vectors_unfactored(v, n_stack) for k, v in fac.items()}


def _moe_layers(np_state: Dict, name: str) -> np.ndarray:
    """One leaf of the reference's MoE decode state in layer order: the
    ``dense`` rows, then per period the ``pre`` rows (n_super, period -
    1, ...) and the period's ``moe`` row."""
    rows = list(np_state["dense"][name]) if "dense" in np_state else []
    pre = np_state["pre"][name] if "pre" in np_state else None
    for i, moe_row in enumerate(np_state["moe"][name]):
        if pre is not None:
            rows.extend(pre[i])
        rows.append(moe_row)
    return np.stack(rows)


def state_from_jax(np_state: Dict, device="cuda") -> Dict:
    """Decode state.  Dense and VLM GQA: both packages use {"kv": {"k","v":
    (L,b,S,hkv,dh)}}; SSM: both use {"mamba": {"ssm": (L,b,H,P,N),
    "conv_x"/"conv_B"/"conv_C": (L,b,cw-1,dim)}}.  MoE: the reference's
    ``dense``, ``pre`` (n_super, period - 1, ...) and ``moe`` (n_super,
    ...) stacks are interleaved into layer order (:func:`_moe_layers`),
    under ``"mla"`` for MLA (leaves ``c`` (L,b,S,r) and ``krope``
    (L,b,S,rd)) and ``"kv"`` for GQA; the tree's own keys say which.
    Hybrid: the reference's ``mamba`` leaves (n_super, period, b, ...)
    are flattened to (L, b, ...) in layer order and ``shared`` keeps its
    (n_apps, b, S, hkv, dh) K/V."""
    device = resolve(device)
    if "shared" in np_state:
        return {"mamba": {k: to_torch(np.reshape(
                    v, (-1,) + np.shape(v)[2:]), device)
                          for k, v in np_state["mamba"].items()},
                "shared": _convert(np_state["shared"], device)}
    if "moe" not in np_state:
        return _convert(np_state, device)
    names = tuple(np_state["moe"])
    key = "mla" if "c" in names else "kv"
    return {key: {name: to_torch(_moe_layers(np_state, name), device)
                  for name in names}}


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x)


def assert_exact(a, b) -> None:
    """Ints and bytes: equal in shape and in every bit."""
    a, b = _as_np(a), _as_np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def assert_close(a, b, tol: float) -> None:
    """Floats: compared in float32 within ``tol`` absolute and relative."""
    a = _as_np(a).astype(np.float32)
    b = _as_np(b).astype(np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)
