"""Conversion between the JAX reference's trees and the port's, plus
parity helpers for the tests that compare the two packages.

The bridge takes the JAX trees as numpy (``jax.tree.map(np.asarray,
tree)``), so this module imports neither ``jax`` nor ``repro``.
``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``, so bf16 arrays go
through their uint16 bits: ``np.asarray(x).view(np.uint16)`` and then
``.view(torch.bfloat16)``.  The reference stacks block parameters along
a leading layer axis (an MoE model in two stacks, ``dense_blocks`` for
the first ``first_k_dense`` layers and ``super_blocks.moe`` for the
rest, and its decode state in ``dense`` and ``moe``; the hybrid's Mamba2
blocks and their state as (n_super, period)); the port keeps one dict per
layer and one state stack over all layers, so the blocks are unstacked
and the state stacks joined or flattened here.  Like every entry point of
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
    parameters: ``blocks`` (dense family, or the SSM family's Mamba2
    blocks), or ``dense_blocks`` then ``super_blocks["moe"]`` (MoE
    family, period 1), or the hybrid's (n_super, period) Mamba2 blocks,
    unstacked into one list in layer order; the hybrid's
    ``shared_block`` is converted once."""
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
        if cfg.moe.period != 1:
            raise NotImplementedError(
                f"{cfg.name}: MoE period {cfg.moe.period} is not ported")
        n_dense = cfg.moe.first_k_dense
        stacks = [(np_tree["dense_blocks"], i) for i in range(n_dense)] + \
            [(np_tree["super_blocks"]["moe"], i)
             for i in range(cfg.n_layers - n_dense)]
    else:
        stacks = [(np_tree["blocks"], i) for i in range(cfg.n_layers)]
    out["blocks"] = [_convert(_unstack(tree, i), device)
                     for tree, i in stacks]
    return out


def state_from_jax(np_state: Dict, device="cuda") -> Dict:
    """Decode state.  Dense GQA: both packages use {"kv": {"k","v":
    (L,b,S,hkv,dh)}}; SSM: both use {"mamba": {"ssm": (L,b,H,P,N),
    "conv_x"/"conv_B"/"conv_C": (L,b,cw-1,dim)}}.  MoE (period 1): the
    reference's ``dense`` and
    ``moe`` stacks are joined along the layer axis, under ``"mla"`` for
    MLA (leaves ``c`` (L,b,S,r) and ``krope`` (L,b,S,rd)) and ``"kv"``
    for GQA; the tree's own keys say which.  Hybrid: the reference's
    ``mamba`` leaves (n_super, period, b, ...) are flattened to (L, b,
    ...) in layer order and ``shared`` keeps its (n_apps, b, S, hkv, dh)
    K/V."""
    device = resolve(device)
    if "shared" in np_state:
        return {"mamba": {k: to_torch(np.reshape(
                    v, (-1,) + np.shape(v)[2:]), device)
                          for k, v in np_state["mamba"].items()},
                "shared": _convert(np_state["shared"], device)}
    parts = [np_state[k] for k in ("dense", "moe") if k in np_state]
    if not parts:
        return _convert(np_state, device)
    key = "mla" if "c" in parts[0] else "kv"
    return {key: {name: to_torch(np.concatenate([p[name] for p in parts]),
                                 device)
                  for name in parts[0]}}


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
